// LDL^T factorisation of a symmetric tridiagonal matrix T with diagonal d
// and off-diagonal e:  T = L diag(dp) L^T,  L unit lower bidiagonal with
// subdiagonal l (l_0 = 0). The pivots follow the continued-fraction
// recurrence
//     dp_i = d_i - e_{i-1}^2 / dp_{i-1}                  (e_{-1} = 0)
// and l_i = e_{i-1} / dp_{i-1}. Two kernels, both computing in float64
// whatever the element type T of d, e, dp and l:
//   K3  tridiag_ldl_{f32,f64}:          the exact factor of the whole chain;
//   K3b tridiag_ldl_blocked_{f32,f64}:  the segment-decoupled factor, each
//       `block`-row segment factored on its own (the coupling into a
//       segment's first row dropped).
// Both floor the pivots after the recurrence at 8 eps(T) max(d), the max
// taken over the lane's d, and write dp and l in T.
//
// Replace: the JAX package computes these pivots inside its compiled
// program, not in a Pallas kernel: the exact factor as one
// jax.lax.associative_scan of projective 2x2 maps (mac_tpu/ops/tridiag.py:
// 105, tridiag_ldl), the blocked one as one rolled jax.lax.scan of length
// `block` over all segments at once (mac_tpu/ops/tridiag.py:153,
// tridiag_ldl_blocked). Every Frank-Wolfe step of the banded and the
// matrix-free routes refactors the odometry chain through one of them.
//
// Lanes: d (R, n) and e (R, n - 1) at lane strides dstride and estride
// (elements; 0 shares one chain among the lanes), rows contiguous; dp and
// l (R, n) contiguous. One thread block per lane, one launch in all.
//
// What bounds them on the H100: the chain of dependent operations, not
// bytes. K3b's recurrence is `block` dependent float64 divisions per
// segment (128 on the banded route, 1024 on the matrix-free one), while
// its bytes (16 n for float32) take 0.5 us at n = 100000 and 3.35 TB/s.
// K3's chain is its rows per chunk, twice, around a serial pass over the
// chunks.
//
// The rows reach the threads through shared memory (walk_segments): a
// thread per segment, a tile of 128 bytes of every segment at a time,
// copied in by the whole block in coalesced runs (cp.async) while the
// threads work on the tile before, and the results copied out the same
// way. Against each thread loading and storing its own rows directly,
// this takes 12% (block 128) and 21% (block 1024) off K3b's device time
// and 18% off K3's at 32768 rows, and adds 37% to K3's at 2500 (two copy
// round trips; kernel_ab.py, NVIDIA H100 80GB HBM3 at 700 W). What is
// left is the chain: about 250 ns a step of float64 division and
// subtraction, 0.0328 ms at city10000's 128-step factor.
//
// K3b's design: one thread per segment runs the recurrence in row order
// with correctly rounded division and subtraction (__ddiv_rn, __dsub_rn:
// nothing to contract into an FMA, whatever the flags), e_i^2 squared in
// T as the plain version squares it, so the result is bitwise equal to
// the plain version. The floor needs the lane's max(d) before any output
// is written: the block reduces it first, reading d in 16-byte vectors.
//
// K3's design: one block per lane; the lane's rows cut into up to 1024
// chunks of at least 16 rows. (1) A thread per chunk composes its rows'
// maps x -> d_i - e2_i / x as 2x2 matrices [[d_i, -e2_i], [1, 0]]
// (projective: rescaling by a power of two changes nothing and rounds
// nothing). (2) One thread carries the vector (D_{i-1}, D_{i-2}) of
// leading minors, up to scale, through the chunks' maps in order: the
// vector entering each chunk. (3) A thread per chunk runs the three-term
// recurrence D_i = d_i D_{i-1} - e2_i D_{i-2} from that vector and takes
// dp_i = D_i / D_{i-1}. The dependent chain is multiply-adds; the
// divisions hang off it. A block scan would shorten step 2 to 10 levels,
// but a product of two long products rounds the minors' ratio in its
// minor direction (4.3e-13 relative from an extended-precision referee on
// city10000's chains, where this pass stays near 2e-14). Not bitwise the
// plain doubling scan: within 1e-13 relative of the referee in float64,
// at most one float32 ulp from the plain scan.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // a block per lane; every thread a segment
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChunks = 1024;  // K3's chunks of a lane
constexpr int kK3Rows = 16;       // K3's rows a chunk, at least
constexpr unsigned kFullMask = 0xffffffffu;

// torch.maximum / amax: NaN wins, else the larger (a when equal).
__device__ __forceinline__ double max_nan(double a, double b) {
  if (a != a || b != b) return a != a ? a : b;
  return a < b ? b : a;
}

template <typename T>
struct Traits;
template <>
struct Traits<float> {
  static constexpr double eps = 0x1p-23;  // torch.finfo(torch.float32).eps
  using Vec = float4;
  static constexpr int kVec = 4;
  static __device__ double widen(float x) { return static_cast<double>(x); }
  static __device__ float narrow(double x) { return __double2float_rn(x); }
  // e^2 as the blocked plain version squares it: in T, then widened.
  static __device__ double square_in_t(float x) {
    return static_cast<double>(__fmul_rn(x, x));
  }
  static __device__ double vec_max(const float4& v, double m) {
    return max_nan(max_nan(m, max_nan(widen(v.x), widen(v.y))),
                   max_nan(widen(v.z), widen(v.w)));
  }
};
template <>
struct Traits<double> {
  static constexpr double eps = 0x1p-52;  // torch.finfo(torch.float64).eps
  using Vec = double2;
  static constexpr int kVec = 2;
  static __device__ double widen(double x) { return x; }
  static __device__ double narrow(double x) { return x; }
  static __device__ double square_in_t(double x) { return __dmul_rn(x, x); }
  static __device__ double vec_max(const double2& v, double m) {
    return max_nan(m, max_nan(v.x, v.y));
  }
};

// max(d) over the lane's n rows, on every thread of the block. d is read
// in 16-byte vectors when it is 16-byte aligned. red holds kWarps + 1
// doubles.
template <typename T>
__device__ double lane_max(const T* __restrict__ d, int n, double* red) {
  using Tr = Traits<T>;
  using Vec = typename Tr::Vec;
  double m = -INFINITY;
  int head = 0;
  if ((reinterpret_cast<uintptr_t>(d) & 15) == 0) {
    const Vec* dv = reinterpret_cast<const Vec*>(d);
    const int nv = n / Tr::kVec;
    int i = threadIdx.x;
    for (; i + 3 * kThreads < nv; i += 4 * kThreads) {
      const Vec a = dv[i], b = dv[i + kThreads], c = dv[i + 2 * kThreads],
                f = dv[i + 3 * kThreads];
      m = Tr::vec_max(f, Tr::vec_max(c, Tr::vec_max(b, Tr::vec_max(a, m))));
    }
    for (; i < nv; i += kThreads) m = Tr::vec_max(dv[i], m);
    head = nv * Tr::kVec;
  }
  for (int i = head + threadIdx.x; i < n; i += kThreads)
    m = max_nan(m, Tr::widen(d[i]));
#pragma unroll
  for (int k = 16; k > 0; k >>= 1)
    m = max_nan(m, __shfl_xor_sync(kFullMask, m, k));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < kWarps ? red[lane] : -INFINITY;
#pragma unroll
    for (int k = 16; k > 0; k >>= 1)
      m = max_nan(m, __shfl_xor_sync(kFullMask, m, k));
    if (lane == 0) red[kWarps] = m;
  }
  __syncthreads();
  return red[kWarps];
}

// Rows of a tile: one 128-byte line of each segment.
template <typename T>
__host__ __device__ constexpr int tile_rows() {
  return 128 / sizeof(T);
}

// Dynamic shared memory of the staging: two buffers of a tile of d and
// of e for kThreads segments, each segment's rows at an odd pitch.
template <typename T>
__host__ __device__ constexpr int stage_bytes() {
  return 2 * 2 * kThreads * (tile_rows<T>() + 1) * sizeof(T);
}

// The lane's rows as nseg segments of seg_len rows (the last one ragged),
// kThreads segments at a time, thread s running segment g0 + s in row
// order: body(segment, i, i0, i1, d_i, e_i, dslot, eslot) for its rows i
// of [i0, i1) (e_i undefined for i = n - 1). The rows reach the threads
// through shared memory, a tile of 128 bytes of every segment at a time,
// copied in coalesced runs by the whole block (cp.async) while the
// threads work on the tile before. With kStore, what the body leaves in
// dslot and eslot goes back out as dp_i and l_{i+1}, again in coalesced
// runs: no thread touches device memory row by row.
template <typename T, bool kStore, typename Body>
__device__ __forceinline__ void walk_segments(const T* __restrict__ d,
                                              const T* __restrict__ e,
                                              T* __restrict__ dp,
                                              T* __restrict__ l, int n,
                                              int seg_len, int nseg, T* stage,
                                              Body body) {
  constexpr int H = tile_rows<T>();
  constexpr int P = H + 1;           // pitch: conflict-free across segments
  constexpr int A = kThreads * P;    // one array of one buffer
  const int ntile = (seg_len - 1) / H + 1;
  for (int g0 = 0; g0 < nseg; g0 += kThreads) {
    const int G = min(kThreads, nseg - g0);
    // Element j of a tile: segment j / H, row j % H of the tile.
    auto copy_in = [&](int k, int b) {
      T* sd = stage + 2 * b * A;
      T* se = sd + A;
      for (int j = threadIdx.x; j < G * H; j += kThreads) {
        const int s = j / H, r = j - s * H;
        const long long row =
            static_cast<long long>(g0 + s) * seg_len + k * H + r;
        if (k * H + r < seg_len && row < n) {
          __pipeline_memcpy_async(sd + s * P + r, d + row, sizeof(T));
          if (row < n - 1)
            __pipeline_memcpy_async(se + s * P + r, e + row, sizeof(T));
        }
      }
      __pipeline_commit();
    };
    copy_in(0, 0);
    __pipeline_wait_prior(0);
    __syncthreads();
    for (int k = 0; k < ntile; ++k) {
      const int b = k & 1;
      if (k + 1 < ntile) copy_in(k + 1, b ^ 1);
      T* sd = stage + 2 * b * A;
      T* se = sd + A;
      if (threadIdx.x < G) {
        const int s = threadIdx.x;
        const long long i0 = static_cast<long long>(g0 + s) * seg_len;
        const long long i1 = i0 + seg_len < n ? i0 + seg_len : n;
        const long long t0 = i0 + static_cast<long long>(k) * H;
        const long long rest = i1 - t0;
        const int h = rest <= 0 ? 0 : rest < H ? static_cast<int>(rest) : H;
        for (int r = 0; r < h; ++r)
          body(g0 + s, static_cast<int>(t0) + r, static_cast<int>(i0),
               static_cast<int>(i1), sd[s * P + r], se[s * P + r],
               sd + s * P + r, se + s * P + r);
      }
      __syncthreads();
      if (kStore) {
        for (int j = threadIdx.x; j < G * H; j += kThreads) {
          const int s = j / H, r = j - s * H;
          const long long row =
              static_cast<long long>(g0 + s) * seg_len + k * H + r;
          if (k * H + r < seg_len && row < n) {
            dp[row] = sd[s * P + r];
            if (row + 1 < n) l[row + 1] = se[s * P + r];
          }
        }
      }
      __pipeline_wait_prior(0);
      __syncthreads();
    }
  }
}

// ---------------------------------------------------------------------------
// K3b: the segment-decoupled factor, bitwise the plain version's.

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ldl_blocked_kernel(const T* __restrict__ d, const T* __restrict__ e,
                       T* __restrict__ dp, T* __restrict__ l, int n,
                       int block, long long dstride, long long estride) {
  using Tr = Traits<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ double red[kWarps + 1];
  const long long lane = blockIdx.x;
  d += lane * dstride;
  e += lane * estride;
  dp += lane * n;
  l += lane * n;
  const double pivot_floor =
      __dmul_rn(8.0 * Tr::eps, lane_max(d, n, red));
  if (threadIdx.x == 0) l[0] = T(0);
  double prev = 1.0;
  T e_prev = T(0);
  walk_segments<T, true>(
      d, e, dp, l, n, block, (n - 1) / block + 1,
      reinterpret_cast<T*>(smem),
      [&](int, int i, int i0, int i1, T di, T ei, T* dslot, T* eslot) {
        // Every segment starts afresh: e2 = 0 and prev = 1.0 at its row 0.
        const double e2 = i == i0 ? 0.0 : Tr::square_in_t(e_prev);
        prev = __dsub_rn(Tr::widen(di), __ddiv_rn(e2, i == i0 ? 1.0 : prev));
        const double f = max_nan(prev, pivot_floor);
        *dslot = Tr::narrow(f);
        // l_{i+1} = e_i / dp_i, the coupling cut at the next segment's start.
        *eslot = Tr::narrow(__ddiv_rn(i + 1 == i1 ? 0.0 : Tr::widen(ei), f));
        e_prev = ei;
      });
}

// ---------------------------------------------------------------------------
// K3: the exact factor.

// A projective 2x2 map [[a, b], [c, d]].
struct Map {
  double a, b, c, d;
};

// Rescale by the power of two that brings the largest magnitude into
// [1, 2) once it leaves [2^-64, 2^64] (always, with always = true): exact,
// and the ratios are what count.
__device__ __forceinline__ void renorm(double& a, double& b, double& c,
                                       double& d, bool always = false) {
  const double m = fmax(fmax(fabs(a), fabs(b)), fmax(fabs(c), fabs(d)));
  if ((always || m > 0x1p64 || m < 0x1p-64) && m > 0.0 && isfinite(m)) {
    const int k = -ilogb(m);
    a = scalbn(a, k);
    b = scalbn(b, k);
    c = scalbn(c, k);
    d = scalbn(d, k);
  }
}

__device__ __forceinline__ void renorm(double& a, double& b) {
  double c = 0.0, d = 0.0;
  renorm(a, b, c, d);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ldl_kernel(const T* __restrict__ d, const T* __restrict__ e,
               T* __restrict__ dp, T* __restrict__ l, int n, long long dstride,
               long long estride) {
  using Tr = Traits<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ double red[kWarps + 1];
  __shared__ Map maps[kMaxChunks];
  const long long lane_id = blockIdx.x;
  d += lane_id * dstride;
  e += lane_id * estride;
  dp += lane_id * n;
  l += lane_id * n;
  T* stage = reinterpret_cast<T*>(smem);
  const double pivot_floor =
      __dmul_rn(8.0 * Tr::eps, lane_max(d, n, red));
  const int nchunk = min(kMaxChunks, (n - 1) / kK3Rows + 1);
  const int chunk = (n - 1) / nchunk + 1;
  const int nseg = (n - 1) / chunk + 1;  // chunks that hold rows

  // 1. Each chunk's maps x -> d_i - e2_i / x as 2x2 matrices [[d_i, -e2_i],
  // [1, 0]], composed (the last row's leftmost) and normalised.
  {
    Map m{1.0, 0.0, 0.0, 1.0};
    double e_prev = 0.0;
    walk_segments<T, false>(
        d, e, dp, l, n, chunk, nseg, stage,
        [&](int s, int i, int i0, int i1, T di, T ei, T*, T*) {
          if (i == i0) {
            m = Map{1.0, 0.0, 0.0, 1.0};
            e_prev = i0 > 0 ? Tr::widen(e[i0 - 1]) : 0.0;
          }
          const double e2 = i == 0 ? 0.0 : e_prev * e_prev;
          const double x = Tr::widen(di);
          const double a = fma(x, m.a, -(e2 * m.c));
          const double b = fma(x, m.b, -(e2 * m.d));
          m.c = m.a;
          m.d = m.b;
          m.a = a;
          m.b = b;
          renorm(m.a, m.b, m.c, m.d, i + 1 == i1);  // entries below 2 at the
          if (i + 1 == i1) maps[s] = m;              // end: step 2 grows its
          e_prev = Tr::widen(ei);                    // vector 4x a chunk at most
        });
  }
  __syncthreads();

  // 2. One thread carries the vector of leading minors (D_{i-1}, D_{i-2}),
  // up to scale, across the chunks in order, applying each chunk's map to
  // it, and leaves each chunk's incoming vector in the chunk's (a, c).
  // A product of two long products would round the minors' ratio in its
  // minor direction (4.3e-13 relative on city10000's chains); a vector
  // through one chunk's map does not (near 2e-14).
  if (threadIdx.x == 0) {
    double v0 = 1.0, v1 = 0.0;
    for (int k = 0; k < nseg; k += 8) {
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        if (k + u < nseg) {
          const Map q = maps[k + u];
          maps[k + u].a = v0;
          maps[k + u].c = v1;
          const double w0 = fma(q.a, v0, q.b * v1);
          const double w1 = fma(q.c, v0, q.d * v1);
          v0 = w0;
          v1 = w1;
        }
      }
      renorm(v0, v1);  // at most 4^8 larger
    }
    l[0] = T(0);
  }
  __syncthreads();

  // 3. The three-term recurrence D_i = d_i D_{i-1} - e2_i D_{i-2} over each
  // chunk's rows from its incoming minors, each pivot the ratio of two.
  double v0 = 0.0, v1 = 0.0, e_prev = 0.0;
  walk_segments<T, true>(
      d, e, dp, l, n, chunk, nseg, stage,
      [&](int s, int i, int i0, int, T di, T ei, T* dslot, T* eslot) {
        if (i == i0) {
          v0 = maps[s].a;
          v1 = maps[s].c;
          e_prev = i0 > 0 ? Tr::widen(e[i0 - 1]) : 0.0;
        }
        const double e2 = i == 0 ? 0.0 : e_prev * e_prev;
        const double v = fma(Tr::widen(di), v0, -(e2 * v1));
        const double f = max_nan(v / v0, pivot_floor);
        v1 = v0;
        v0 = v;
        renorm(v0, v1);
        *dslot = Tr::narrow(f);
        if (i + 1 < n) *eslot = Tr::narrow(Tr::widen(ei) / f);
        e_prev = Tr::widen(ei);
      });
}

// Both kernels take more than the default 48 KB of dynamic shared memory:
// raised once per instantiation, at its first launch.
template <typename T>
int ldl_launch(const T* d, const T* e, T* dp, T* l, int n, int lanes,
               long long dstride, long long estride, void* stream) {
  if (n < 1 || lanes < 1) return cudaErrorInvalidValue;
  static const cudaError_t attr = cudaFuncSetAttribute(
      ldl_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      stage_bytes<T>());
  if (attr != cudaSuccess) return static_cast<int>(attr);
  ldl_kernel<T><<<lanes, kThreads, stage_bytes<T>(),
                  static_cast<cudaStream_t>(stream)>>>(d, e, dp, l, n,
                                                       dstride, estride);
  return cudaGetLastError();
}

template <typename T>
int ldl_blocked_launch(const T* d, const T* e, T* dp, T* l, int n, int lanes,
                       long long dstride, long long estride, int block,
                       void* stream) {
  if (n < 1 || lanes < 1 || block < 1) return cudaErrorInvalidValue;
  static const cudaError_t attr = cudaFuncSetAttribute(
      ldl_blocked_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      stage_bytes<T>());
  if (attr != cudaSuccess) return static_cast<int>(attr);
  ldl_blocked_kernel<T><<<lanes, kThreads, stage_bytes<T>(),
                          static_cast<cudaStream_t>(stream)>>>(
      d, e, dp, l, n, block, dstride, estride);
  return cudaGetLastError();
}

}  // namespace

// K3. d (lanes, n) at lane stride dstride, e (lanes, n - 1) at estride,
// dp and l (lanes, n) contiguous. Returns the launch's cudaError_t (0 on
// success; cudaErrorInvalidValue for n < 1 or lanes < 1).
extern "C" int tridiag_ldl_f32(const float* d, const float* e, float* dp,
                               float* l, int n, int lanes, long long dstride,
                               long long estride, void* stream) {
  return ldl_launch(d, e, dp, l, n, lanes, dstride, estride, stream);
}

extern "C" int tridiag_ldl_f64(const double* d, const double* e, double* dp,
                               double* l, int n, int lanes, long long dstride,
                               long long estride, void* stream) {
  return ldl_launch(d, e, dp, l, n, lanes, dstride, estride, stream);
}

// K3b. The same arrays; `block` >= 1 rows a segment.
extern "C" int tridiag_ldl_blocked_f32(const float* d, const float* e,
                                       float* dp, float* l, int n, int lanes,
                                       long long dstride, long long estride,
                                       int block, void* stream) {
  return ldl_blocked_launch(d, e, dp, l, n, lanes, dstride, estride, block,
                            stream);
}

extern "C" int tridiag_ldl_blocked_f64(const double* d, const double* e,
                                       double* dp, double* l, int n,
                                       int lanes, long long dstride,
                                       long long estride, int block,
                                       void* stream) {
  return ldl_blocked_launch(d, e, dp, l, n, lanes, dstride, estride, block,
                            stream);
}
