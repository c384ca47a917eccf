// Tridiagonal LDL^T solve for one (n, q) block of right-hand sides:
//     L diag(dp) L^T X = B,  L unit lower bidiagonal with subdiagonal l.
//
// Replaces the TPU kernel mac_tpu/ops/pallas/tridiag_kernel.py
// (_tridiag_kernel through tridiag_solve_fused): the odometry-chain smoother
// of the banded two-level preconditioner, called twice per preconditioned
// CG step of every eigensolver outer iteration.
//
// The two substitutions are affine recurrences
//     forward:  y_i = b_i - l_i * y_{i-1}           (y_{-1} = 0)
//     backward: x_i = z_i - l_{i+1} * x_{i+1}       (x_n = 0), z = y / dp
// and affine maps compose as (c2, v2) o (c1, v1) = (c2 c1, v2 + c2 v1).
// One thread block owns one right-hand-side column. Each of its threads
// composes the map of a contiguous chunk of rows, a Hillis-Steele scan in
// shared memory composes the chunk maps, and each thread then re-sweeps its
// chunk from the incoming value. l_0 is never read, and the last row's
// backward coefficient is 0, so a ragged n needs no padding and the kernel
// does not rely on zero couplings inside the factor.
//
// What bounds it on the H100: latency, not bytes. At the main path's shape
// (n = 10000, q = 4) only q = 4 blocks run, on 4 of 132 SMs; each thread
// walks ceil(n / 1024) = 10 rows three times (compose, forward re-sweep,
// backward compose + re-sweep) with B read strided by q, and the two
// 10-step shared-memory scans each cost a __syncthreads() per step. The
// 0.3 MB of traffic is nothing next to that. Packing several columns per
// block or scanning with warp shuffles are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;

// Inclusive scan of affine maps over the threads of the block, in place.
// reverse = false composes thread t after threads 0..t-1 (forward order);
// reverse = true composes thread t after threads t+1..T-1.
__device__ void scan_maps(float* sc, float* sv, float& c, float& v,
                          bool reverse) {
  const int t = threadIdx.x;
  sc[t] = c;
  sv[t] = v;
  __syncthreads();
  for (int k = 1; k < kThreads; k <<= 1) {
    const int src = reverse ? t + k : t - k;
    const bool valid = reverse ? (src < kThreads) : (src >= 0);
    float pc = 1.0f, pv = 0.0f;
    if (valid) {
      pc = sc[src];
      pv = sv[src];
    }
    __syncthreads();
    if (valid) {
      // (c, v) o (pc, pv): this thread's map applied after the earlier one.
      v = v + c * pv;
      c = c * pc;
      sc[t] = c;
      sv[t] = v;
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads)
tridiag_solve_kernel(const float* __restrict__ dp, const float* __restrict__ l,
                     const float* __restrict__ B, float* __restrict__ X,
                     int n, int q) {
  __shared__ float sc[kThreads];
  __shared__ float sv[kThreads];
  const int col = blockIdx.x;
  const int t = threadIdx.x;
  const int chunk = (n + kThreads - 1) / kThreads;
  const int lo = min(n, t * chunk);
  const int hi = min(n, lo + chunk);

  // Forward: compose y_i = b_i + (-l_i) y_{i-1} over this chunk.
  float c = 1.0f, v = 0.0f;
  for (int i = lo; i < hi; ++i) {
    const float ci = (i == 0) ? 0.0f : -l[i];
    v = B[(size_t)i * q + col] + ci * v;
    c = ci * c;
  }
  scan_maps(sc, sv, c, v, false);
  // Value entering the chunk: the inclusive prefix of the previous thread
  // applied to y_{-1} = 0.
  float y = (t == 0) ? 0.0f : sv[t - 1];
  __syncthreads();
  for (int i = lo; i < hi; ++i) {
    const float ci = (i == 0) ? 0.0f : -l[i];
    y = B[(size_t)i * q + col] + ci * y;
    X[(size_t)i * q + col] = y / dp[i];
  }

  // Backward: compose x_i = z_i + (-l_{i+1}) x_{i+1} from the chunk's end.
  c = 1.0f;
  v = 0.0f;
  for (int i = hi - 1; i >= lo; --i) {
    const float ci = (i == n - 1) ? 0.0f : -l[i + 1];
    v = X[(size_t)i * q + col] + ci * v;
    c = ci * c;
  }
  scan_maps(sc, sv, c, v, true);
  float x = (t == kThreads - 1) ? 0.0f : sv[t + 1];
  for (int i = hi - 1; i >= lo; --i) {
    const float ci = (i == n - 1) ? 0.0f : -l[i + 1];
    x = X[(size_t)i * q + col] + ci * x;
    X[(size_t)i * q + col] = x;
  }
}

}  // namespace

// dp, l: (n,) float32; B, X: (n, q) float32, row-major and contiguous.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int tridiag_solve_f32(const float* dp, const float* l,
                                 const float* B, float* X, int n, int q,
                                 void* stream) {
  if (n <= 0 || q <= 0) return 0;
  tridiag_solve_kernel<<<q, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      dp, l, B, X, n, q);
  return static_cast<int>(cudaGetLastError());
}
