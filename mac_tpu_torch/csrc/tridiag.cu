// Tridiagonal LDL^T solve for one (n, q) block of right-hand sides:
//     L diag(dp) L^T X = B,  L unit lower bidiagonal with subdiagonal l.
// Two kernels: K1, whole rows (below), and K1b, segment-decoupled (further
// down).
//
// K1 replaces the TPU kernel mac_tpu/ops/pallas/tridiag_kernel.py
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

// ---------------------------------------------------------------------------
// K1b: the segment-decoupled solve.
//
// Replaces the TPU kernel mac_tpu/ops/pallas/tridiag_kernel.py
// (tridiag_solve_fused_blocked): the chain smoother of the matrix-free
// two-grid V-cycle (and of the banded preconditioner) once n > 32768, where
// the factor comes from the blocked LDL^T and its couplings are zero at
// every `block` boundary. The kernel forces l = 0 at each row with
// row % block == 0 itself, so the segments solve independently whatever the
// caller's l holds there -- the contract of the TPU kernel.
//
// The TPU ran Hillis-Steele lane scans over a grid of 256-row VMEM tiles
// because the whole-row kernel ran out of VMEM past n ~ 3e4. Here the
// independent unit is a (segment, column) pair: a grid of ceil(n / block) x q
// blocks (98 x 4 = 392 at n = 100000, q = 4), one thread per row of the
// segment. Each substitution is an inclusive scan of affine maps: a warp
// scan with shuffles, one step across the warps in shared memory, and the
// warp's prefix applied to each thread's map.
//
// What bounds it on the H100: latency, not bytes. At n = 100000, q = 4 the
// solve moves 4 MB (1.2 us at 3.35 TB/s) but takes 35-60 us: a block runs
// two 5-step warp scans, two cross-warp scans and four __syncthreads(), and
// B is read with a stride of q floats. Several columns per block, or a
// vectorised (n, q) row load, are later work.

constexpr unsigned kFullMask = 0xffffffffu;

// Inclusive scan of affine maps across the 32 lanes of a warp.
// reverse = false: lane i ends with map_i o ... o map_0;
// reverse = true:  lane i ends with map_i o ... o map_31.
__device__ __forceinline__ void warp_scan_maps(float& c, float& v, int lane,
                                               bool reverse) {
#pragma unroll
  for (int k = 1; k < 32; k <<= 1) {
    const float pc = reverse ? __shfl_down_sync(kFullMask, c, k)
                             : __shfl_up_sync(kFullMask, c, k);
    const float pv = reverse ? __shfl_down_sync(kFullMask, v, k)
                             : __shfl_up_sync(kFullMask, v, k);
    const bool valid = reverse ? (lane + k < 32) : (lane >= k);
    if (valid) {
      v = v + c * pv;
      c = c * pc;
    }
  }
}

// Scan of the warps' total maps, held in sc/sv[0..nw): run by warp 0, in
// place; lanes past nw take the identity map.
__device__ __forceinline__ void scan_warp_totals(float* sc, float* sv,
                                                 int lane, int nw,
                                                 bool reverse) {
  float c = lane < nw ? sc[lane] : 1.0f;
  float v = lane < nw ? sv[lane] : 0.0f;
  warp_scan_maps(c, v, lane, reverse);
  if (lane < nw) {
    sc[lane] = c;
    sv[lane] = v;
  }
}

__global__ void __launch_bounds__(kThreads)
tridiag_solve_blocked_kernel(const float* __restrict__ dp,
                             const float* __restrict__ l,
                             const float* __restrict__ B,
                             float* __restrict__ X, int n, int q, int block) {
  __shared__ float fc[32], fv[32], bc[32], bv[32];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int w = t >> 5;
  const int nw = blockDim.x >> 5;
  const int col = blockIdx.y;
  const long long row = static_cast<long long>(blockIdx.x) * block + t;
  const bool live = row < n;  // rows past n: l = 0, dp = 1, B = 0

  // Forward: y_i = b_i - l_i y_{i-1}; the segment's first row is decoupled.
  float c = (live && t != 0) ? -l[row] : 0.0f;
  float v = live ? B[row * q + col] : 0.0f;
  warp_scan_maps(c, v, lane, false);
  if (lane == 31) {
    fc[w] = c;
    fv[w] = v;
  }
  __syncthreads();
  if (w == 0) scan_warp_totals(fc, fv, lane, nw, false);
  __syncthreads();
  // y_{-1} = 0, so the value entering warp w is the v of warps 0..w-1.
  const float y = (w == 0) ? v : v + c * fv[w - 1];
  const float z = y / (live ? dp[row] : 1.0f);

  // Backward: x_i = z_i - l_{i+1} x_{i+1}; the segment's last row and row
  // n - 1 are decoupled.
  c = (t != block - 1 && row + 1 < n) ? -l[row + 1] : 0.0f;
  v = z;
  warp_scan_maps(c, v, lane, true);
  if (lane == 0) {
    bc[w] = c;
    bv[w] = v;
  }
  __syncthreads();
  if (w == 0) scan_warp_totals(bc, bv, lane, nw, true);
  __syncthreads();
  const float x = (w == nw - 1) ? v : v + c * bv[w + 1];
  if (live) X[row * q + col] = x;
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

// K1b. The same arrays; `block` (a multiple of 32, at most 1024) is the
// segment length. Returns cudaErrorInvalidValue for any other block.
extern "C" int tridiag_solve_blocked_f32(const float* dp, const float* l,
                                         const float* B, float* X, int n,
                                         int q, int block, void* stream) {
  if (block < 32 || block > kThreads || block % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0 || q <= 0) return 0;
  const dim3 grid((n + block - 1) / block, q);
  tridiag_solve_blocked_kernel<<<grid, block, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      dp, l, B, X, n, q, block);
  return static_cast<int>(cudaGetLastError());
}
