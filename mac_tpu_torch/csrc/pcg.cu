// K6: the update of TRACEMIN's inner preconditioned CG step, with column
// sums taken in a fixed order.
//
// Stands for no Pallas kernel: it is the body of pcg_fixed's fori_loop
// (mac_tpu/ops/cg.py:52-62) as XLA fuses it inside the reference's one
// compiled program -- the step sizes, the vector updates and the column
// dot products over an (n, q) block of right-hand sides (or R lanes of
// them, (R, n, q)). Run as PyTorch ops, one step of that body is about 20
// small kernels; here it is three launches:
//
//   k6_colsum     the column sums of A, or the column dots of A and M
//                 (M centred by its column means, M - msum / n, when msum
//                 is given: the V-cycle's output is Z = x - mean(x));
//   k6_update     alpha = rz / pap (0 where |pap| <= tiny), X += alpha P,
//                 R -= alpha AP, and the new R's column sums (the next
//                 V-cycle centres R by its means);
//   k6_direction  beta = rz_new / rz (0 where |rz| <= tiny), P = Z + beta P
//                 (P = Z at the first step), rz = rz_new, and the new P's
//                 column sums in float64 (the shift term of the next
//                 product, (c / n) 1 1^T P).
//
// Fixed-order sums. Every column sum is the same bits whatever order the
// blocks run in, so that a replayed graph is bitwise the eager solve: each
// block sums its rows in a fixed order (each thread a fixed stride of rows,
// then the threads' partials in index order) into float64, writes that
// partial to a buffer, and takes a ticket from an atomic counter that is
// used for nothing else; the block that takes the last ticket sums the
// partials in a fixed order (a warp per column: each lane a fixed stride of
// blocks in order, then a fixed butterfly over the lanes) and resets the
// counter to 0. The scalar
// coefficients are computed in the block's type T from the float64 sums
// rounded to T, as the plain version's sums in T are.
//
// What bounds it on the H100: bytes and launch latency. At (10000, 4)
// float32 an update moves 0.8 MB (0.24 us at 3.35 TB/s); each kernel is one
// wave of 40 blocks of 256 threads.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 256;  // rows per block

template <typename T>
__device__ __forceinline__ T tiny_of();
template <>
__device__ __forceinline__ float tiny_of<float>() {
  return 1.17549435082228750797e-38f;
}
template <>
__device__ __forceinline__ double tiny_of<double>() {
  return 2.2250738585072013831e-308;
}

// Products and sums rounded one at a time, as the plain version's separate
// tensor operations round them (no contraction into an fma).
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}

// a / b where |b| > tiny, else 0 (cg.py's _safe_div: a / where(big, b, 1)
// * big).
template <typename T>
__device__ __forceinline__ T safe_div(T a, T b) {
  const bool big = fabs(b) > tiny_of<T>();
  return mul_rn(a / (big ? b : T(1)), big ? T(1) : T(0));
}

// The mean msum / n rounded to T (a tensor's mean in T).
template <typename T>
__device__ __forceinline__ T mean_of(const double* msum, long long i, int n) {
  return static_cast<T>(msum[i] / static_cast<double>(n));
}

// The element (row i, column col) of the value whose column sums a kernel
// takes, by its mode.
enum SumOf { kSumA = 0, kDotAM = 1, kDotAMc = 2 };

// Per block: fixed-order column sums of f(row, col) over rows [r0, r1) for
// the columns [0, q) into part[(lane q + col) nblk + blk]. red: kThreads
// doubles of shared memory. f is called for rows in [r0, r1) only.
template <typename F>
__device__ void block_colsums(F f, int r0, int r1, int q, double* red,
                              double* part, long long lane, int nblk,
                              int blk) {
  const int t = threadIdx.x;
  for (int c0 = 0; c0 < q; c0 += kThreads) {
    const int cw = min(kThreads, q - c0);
    const int ns = kThreads / cw;
    const int col = c0 + t % cw;
    const int slot = t / cw;
    double acc = 0.0;
    if (slot < ns)
      for (int i = r0 + slot; i < r1; i += ns) acc += f(i, col);
    red[t] = acc;
    __syncthreads();
    if (t < cw) {
      double s = 0.0;
      for (int k = 0; k < ns; ++k) s += red[t + k * cw];
      part[(lane * q + c0 + t) * nblk + blk] = s;
    }
    __syncthreads();
  }
}

// True in the block that takes the last of `total` tickets: every other
// block has written its partials (and read what it reads) by then.
__device__ bool last_ticket(unsigned* ticket, unsigned total) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == total - 1;
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// In the last block: out[i] = the sum of part[i nblk + k] over k, for i <
// count, a warp per i: lane l sums k = l, l + 32, ... in order, then the
// lanes' sums add in a fixed butterfly (each lane ends with the same bits);
// then the ticket back to 0.
__device__ void finish_sums(const double* part, double* out, int count,
                            int nblk, unsigned* ticket) {
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x >> 5; i < count; i += blockDim.x >> 5) {
    double s = 0.0;
    for (int k = lane; k < nblk; k += 32)
      s += __ldcg(part + (long long)i * nblk + k);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) out[i] = s;
  }
  if (threadIdx.x == 0) *ticket = 0u;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
k6_colsum(const T* __restrict__ A, const T* __restrict__ M,
          const double* __restrict__ msum, int n, int q, int mode,
          double* part, double* out, unsigned* ticket) {
  __shared__ double red[kThreads];
  const long long lane = blockIdx.y;
  const int nblk = gridDim.x;
  const int r0 = blockIdx.x * kRows;
  const int r1 = min(n, r0 + kRows);
  A += lane * n * q;
  if (M != nullptr) M += lane * n * q;
  auto f = [&](int i, int col) -> double {
    const long long e = (long long)i * q + col;
    if (mode == kSumA) return static_cast<double>(A[e]);
    T m = M[e];
    if (mode == kDotAMc) m = m - mean_of<T>(msum, lane * q + col, n);
    return static_cast<double>(mul_rn(A[e], m));
  };
  block_colsums(f, r0, r1, q, red, part, lane, nblk, blockIdx.x);
  if (last_ticket(ticket, gridDim.x * gridDim.y))
    finish_sums(part, out, gridDim.y * q, nblk, ticket);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
k6_update(T* X, T* R, const T* __restrict__ P, const T* __restrict__ AP,
          const T* __restrict__ rz, const double* __restrict__ pap, int n,
          int q, double* part, double* rsum, unsigned* ticket) {
  __shared__ double red[kThreads];
  const long long lane = blockIdx.y;
  const int r0 = blockIdx.x * kRows;
  const int r1 = min(n, r0 + kRows);
  const long long off = lane * n * q;
  for (long long e = (long long)r0 * q + threadIdx.x; e < (long long)r1 * q;
       e += kThreads) {
    const int col = static_cast<int>(e % q);
    const T alpha = safe_div(rz[lane * q + col],
                             static_cast<T>(pap[lane * q + col]));
    X[off + e] = add_rn(X[off + e], mul_rn(alpha, P[off + e]));
    R[off + e] = R[off + e] - mul_rn(alpha, AP[off + e]);
  }
  if (rsum == nullptr) return;
  __syncthreads();  // this block's rows of R are written
  const T* Rl = R + off;
  auto f = [&](int i, int col) -> double {
    return static_cast<double>(Rl[(long long)i * q + col]);
  };
  block_colsums(f, r0, r1, q, red, part, lane, gridDim.x, blockIdx.x);
  if (last_ticket(ticket, gridDim.x * gridDim.y))
    finish_sums(part, rsum, gridDim.y * q, gridDim.x, ticket);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
k6_direction(T* P, const T* __restrict__ Z, const double* __restrict__ zsum,
             T* rz, const double* __restrict__ rz_new, int init, int n, int q,
             double* part, double* psum, unsigned* ticket) {
  __shared__ double red[kThreads];
  const long long lane = blockIdx.y;
  const int r0 = blockIdx.x * kRows;
  const int r1 = min(n, r0 + kRows);
  const long long off = lane * n * q;
  for (long long e = (long long)r0 * q + threadIdx.x; e < (long long)r1 * q;
       e += kThreads) {
    const int col = static_cast<int>(e % q);
    const long long lc = lane * q + col;
    T z = Z[off + e];
    if (zsum != nullptr) z = z - mean_of<T>(zsum, lc, n);
    if (init) {
      P[off + e] = z;
    } else {
      const T beta = safe_div(static_cast<T>(rz_new[lc]), rz[lc]);
      P[off + e] = add_rn(z, mul_rn(beta, P[off + e]));
    }
  }
  __syncthreads();  // this block's rows of P are written
  if (psum != nullptr) {
    const T* Pl = P + off;
    auto f = [&](int i, int col) -> double {
      return static_cast<double>(Pl[(long long)i * q + col]);
    };
    block_colsums(f, r0, r1, q, red, part, lane, gridDim.x, blockIdx.x);
  }
  // rz is read by every block above: the last one rewrites it.
  if (last_ticket(ticket, gridDim.x * gridDim.y)) {
    for (int i = threadIdx.x; i < gridDim.y * q; i += blockDim.x)
      rz[i] = static_cast<T>(rz_new[i]);
    if (psum != nullptr) {
      finish_sums(part, psum, gridDim.y * q, gridDim.x, ticket);
    } else if (threadIdx.x == 0) {
      *ticket = 0u;
    }
  }
}

dim3 grid_of(int n, int lanes) {
  return dim3((n + kRows - 1) / kRows, lanes);
}

template <typename T>
int colsum_launch(const T* A, const T* M, const double* msum, int n, int q,
                  int lanes, double* part, double* out, unsigned* ticket,
                  void* stream) {
  if (n <= 0 || q <= 0 || lanes <= 0) return 0;
  const int mode = M == nullptr ? kSumA : msum == nullptr ? kDotAM : kDotAMc;
  k6_colsum<T><<<grid_of(n, lanes), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(A, M, msum, n, q, mode,
                                                      part, out, ticket);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int update_launch(T* X, T* R, const T* P, const T* AP, const T* rz,
                  const double* pap, int n, int q, int lanes, double* part,
                  double* rsum, unsigned* ticket, void* stream) {
  if (n <= 0 || q <= 0 || lanes <= 0) return 0;
  k6_update<T><<<grid_of(n, lanes), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(X, R, P, AP, rz, pap, n,
                                                      q, part, rsum, ticket);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int direction_launch(T* P, const T* Z, const double* zsum, T* rz,
                     const double* rz_new, int init, int n, int q, int lanes,
                     double* part, double* psum, unsigned* ticket,
                     void* stream) {
  if (n <= 0 || q <= 0 || lanes <= 0) return 0;
  k6_direction<T><<<grid_of(n, lanes), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      P, Z, zsum, rz, rz_new, init, n, q, part, psum, ticket);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Every array is (lanes, n, q) row-major and contiguous in T (float: _f32,
// double: _f64), every sum (lanes, q) float64; `part` holds lanes * q *
// ceil(n / 256) float64 partials; `ticket` one unsigned counter at 0, which
// each launch leaves at 0. A null pointer leaves out what it names. Each
// returns the launch's cudaError_t (0 on success).
#define K6_EXPORTS(T, S)                                                     \
  extern "C" int pcg_colsum_##S(const T* A, const T* M, const double* msum, \
                                int n, int q, int lanes, double* part,       \
                                double* out, unsigned* ticket,               \
                                void* stream) {                              \
    return colsum_launch<T>(A, M, msum, n, q, lanes, part, out, ticket,      \
                            stream);                                         \
  }                                                                          \
  extern "C" int pcg_update_##S(T* X, T* R, const T* P, const T* AP,         \
                                const T* rz, const double* pap, int n,       \
                                int q, int lanes, double* part,              \
                                double* rsum, unsigned* ticket,              \
                                void* stream) {                              \
    return update_launch<T>(X, R, P, AP, rz, pap, n, q, lanes, part, rsum,   \
                            ticket, stream);                                 \
  }                                                                          \
  extern "C" int pcg_direction_##S(T* P, const T* Z, const double* zsum,     \
                                   T* rz, const double* rz_new, int init,    \
                                   int n, int q, int lanes, double* part,    \
                                   double* psum, unsigned* ticket,           \
                                   void* stream) {                           \
    return direction_launch<T>(P, Z, zsum, rz, rz_new, init, n, q, lanes,    \
                               part, psum, ticket, stream);                  \
  }

K6_EXPORTS(float, f32)
K6_EXPORTS(double, f64)
