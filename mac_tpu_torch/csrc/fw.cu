// K9 and K10: the body of a Frank-Wolfe step, after the eigensolve.
//
// Stand for no Pallas kernel: the reference runs this body as XLA ops
// inside its one compiled program, the lax.while_loop of
// mac_tpu/optimization/frankwolfe.py:137. Run as PyTorch ops it is about
// forty launches and a host read of the stop test a step; here it is two
// launches and no read:
//
//   k9_oracle  the supergradient g_e = (w_e d_e) d_e with d_e = v[i_e] -
//              v[j_e] over the candidates (mac_tpu/solvers/mac.py:1465-
//              1468), v the column 0 of the Ritz block X (n, q) row-major,
//              and the LP oracle s = the indicator of the top-k entries of
//              g, ties to the lower index (lax.top_k in
//              mac_tpu/optimization/constraints.py:20; the port's plain
//              version is a stable descending sort);
//   k10_update the rest of the body (frankwolfe.py:97-133): the dual bound
//              u = min(u, f + g . (s - x)), the gradient and gap stop
//              tests, the Cesaro tail average, the step x + gamma (s - x)
//              unless stop, gamma = 2 / (it + 2) in double rounded to the
//              type, the flags done |= stop and it += 1, and the next
//              step's candidate weights where(x > tol, x, 0) w_cand
//              (mac.py:935-936,957-959) written into the eigensolve's own
//              weight vector; and ||g|| where asked (a check's output).
//
// Every product and sum of an element is rounded on its own, as the plain
// version's separate tensor operations round it (no contraction into an
// fma): g, x, the tail average and the weights are bitwise the plain
// version's. The two reductions of K10 (the dot and the squared norm) are
// summed in double in a fixed order (a thread's elements in order, a warp's
// xor butterfly, the warps in order), so two calls are bitwise equal; they
// agree with the plain version's cuBLAS dot and norm to rounding. The tail
// average's division by the count goes through the count's reciprocal
// rounded to the type, as PyTorch's CUDA division by a host scalar (the
// plain loop's `/ float(cnt)`) computes it.
//
// K9's selection is a radix select in one block of 1024 threads: the keys
// are g's bits mapped so that their unsigned order is the plain version's
// descending order (negatives below positives, -0.0 as +0.0, every NaN
// above +inf and equal to each other, as torch.sort puts NaN first), taken
// 8 bits at a time from the top (4 passes in float32, 8 in float64), each
// pass a shared-memory histogram of the keys that match the digits chosen
// so far and one warp's scan of it for the digit where the count from the
// top reaches k. That gives the threshold key T and how many keys equal to
// T the selection takes; when that is all of them, s = (key >= T);
// otherwise a block-wide prefix count of the equal keys in index order
// takes the lowest indices. Nothing is left in device memory between
// launches but g and s, so a replayed graph is bitwise an eager call.
//
// What bounds them on the H100: latency. At the main path's sizes (m =
// 10688 to 50000) the bytes are 0.1-1.4 MB, well under a microsecond at
// 3.35 TB/s; one block walks them in a few passes from L2. Spreading them
// over the card (a grid-wide select and a cooperative K10) is a later
// redesign.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;  // one block, both kernels (fw.py THREADS)
constexpr int kWarps = kThreads / 32;
constexpr int kDigitBits = 8;
constexpr int kBins = 1 << kDigitBits;
constexpr unsigned kFull = 0xffffffffu;

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
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ float div_rn(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ double div_rn(double a, double b) {
  return __ddiv_rn(a, b);
}
__device__ __forceinline__ float to_type(double a, float) {
  return __double2float_rn(a);
}
__device__ __forceinline__ double to_type(double a, double) { return a; }

// The radix key of a value: its order as unsigned is the descending order
// of the plain version's stable sort (NaN first, -0.0 equal to +0.0).
template <typename T>
struct Key;
template <>
struct Key<float> {
  using K = unsigned;
  static constexpr int kBits = 32;
  __device__ static K of(float x) {
    if (x != x) return 0xffffffffu;
    unsigned b = __float_as_uint(x);
    if (b == 0x80000000u) b = 0u;
    return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  }
};
template <>
struct Key<double> {
  using K = unsigned long long;
  static constexpr int kBits = 64;
  __device__ static K of(double x) {
    if (x != x) return ~0ull;
    unsigned long long b = static_cast<unsigned long long>(
        __double_as_longlong(x));
    if (b == 0x8000000000000000ull) b = 0ull;
    return (b >> 63) ? ~b : (b | 0x8000000000000000ull);
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    k9_oracle(const T* __restrict__ V, int q, const int2* __restrict__ ends,
              const T* __restrict__ wc, int m, int k, T* g,
              T* __restrict__ s) {
  using K = typename Key<T>::K;
  constexpr int kBits = Key<T>::kBits;
  __shared__ unsigned hist[kBins];
  __shared__ unsigned warp_count[kWarps];
  __shared__ K s_prefix;
  __shared__ unsigned s_need, s_equal;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  K prefix = 0;
  unsigned need = static_cast<unsigned>(k), equal = 0;
  for (int pass = 0; pass < kBits / kDigitBits; ++pass) {
    const int shift = kBits - kDigitBits * (pass + 1);
    for (int b = tid; b < kBins; b += kThreads) hist[b] = 0u;
    __syncthreads();
    for (int i = tid; i < m; i += kThreads) {
      T gi;
      if (pass == 0) {
        // The gradient, once: each thread reads back only what it wrote.
        const int2 e = ends[i];
        const T d = sub_rn(V[static_cast<long long>(e.x) * q],
                           V[static_cast<long long>(e.y) * q]);
        gi = mul_rn(mul_rn(wc[i], d), d);
        g[i] = gi;
      } else {
        gi = g[i];
      }
      const K key = Key<T>::of(gi);
      if (pass == 0 || (key >> (shift + kDigitBits)) ==
                           (prefix >> (shift + kDigitBits)))
        atomicAdd(&hist[static_cast<unsigned>(key >> shift) & (kBins - 1)],
                  1u);
    }
    __syncthreads();
    if (warp == 0) {
      // Lane l holds bins kBins - 1 - 8l - j, j = 0..7 (the top first);
      // the first lane whose running count from the top reaches `need`
      // holds the digit.
      unsigned c[kBins / 32], tot = 0u;
#pragma unroll
      for (int j = 0; j < kBins / 32; ++j) {
        c[j] = hist[kBins - 1 - (kBins / 32) * lane - j];
        tot += c[j];
      }
      unsigned incl = tot;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const unsigned t = __shfl_up_sync(kFull, incl, off);
        if (lane >= off) incl += t;
      }
      const int at = __ffs(__ballot_sync(kFull, incl >= need)) - 1;
      if (lane == at) {
        unsigned cum = incl - tot;
        for (int j = 0; j < kBins / 32; ++j) {
          if (cum + c[j] >= need) {
            const unsigned digit = kBins - 1 - (kBins / 32) * lane - j;
            s_prefix = prefix | (static_cast<K>(digit) << shift);
            s_need = need - cum;
            s_equal = c[j];
            break;
          }
          cum += c[j];
        }
      }
    }
    __syncthreads();
    prefix = s_prefix;
    need = s_need;
    equal = s_equal;
    __syncthreads();  // every thread has read them before the next pass
  }
  // prefix is the threshold key; the selection takes every key above it
  // and `need` of the `equal` keys equal to it, the lowest indices first.
  if (need == equal) {
    for (int i = tid; i < m; i += kThreads)
      s[i] = Key<T>::of(g[i]) >= prefix ? T(1) : T(0);
    return;
  }
  unsigned taken = 0u;  // equal keys in the chunks before this one
  for (int base = 0; base < m; base += kThreads) {
    const int i = base + tid;
    K key = 0;
    if (i < m) key = Key<T>::of(g[i]);
    const bool eq = i < m && key == prefix;
    const unsigned bal = __ballot_sync(kFull, eq);
    if (lane == 0) warp_count[warp] = __popc(bal);
    __syncthreads();
    unsigned before = taken + __popc(bal & ((1u << lane) - 1u)), total = 0u;
    for (int w = 0; w < kWarps; ++w) {
      const unsigned cw = warp_count[w];
      if (w < warp) before += cw;
      total += cw;
    }
    if (i < m) s[i] = (key > prefix || (eq && before < need)) ? T(1) : T(0);
    taken += total;
    __syncthreads();  // warp_count is rewritten by the next chunk
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    k10_update(const T* __restrict__ f, const T* __restrict__ g,
               const T* __restrict__ s, T* __restrict__ x, T* u,
               T* __restrict__ xavg, int* counters, unsigned char* done,
               T* __restrict__ w, const T* __restrict__ wc, int m,
               double grad_tol, double gap_tol, int tail_from,
               double mask_tol, T* norm_out) {
  __shared__ double part[2][kWarps];
  __shared__ T s_gamma, s_rcp;
  __shared__ int s_stop, s_take;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  double dot = 0.0, sq = 0.0;
  for (int i = tid; i < m; i += kThreads) {
    const double gi = static_cast<double>(g[i]);
    dot += gi * static_cast<double>(sub_rn(s[i], x[i]));
    sq += gi * gi;
  }
#pragma unroll
  for (int off = 16; off; off >>= 1) {
    dot += __shfl_xor_sync(kFull, dot, off);
    sq += __shfl_xor_sync(kFull, sq, off);
  }
  if (lane == 0) {
    part[0][warp] = dot;
    part[1][warp] = sq;
  }
  __syncthreads();
  if (tid == 0) {
    double dsum = 0.0, ssum = 0.0;
    for (int i = 0; i < kWarps; ++i) {
      dsum += part[0][i];
      ssum += part[1][i];
    }
    const T fv = *f, uo = *u;
    const T cand = add_rn(fv, to_type(dsum, T()));
    // torch.minimum: NaN if either is NaN.
    const T un = (uo != uo || cand != cand) ? cand + uo
                                            : (cand < uo ? cand : uo);
    const T af = fabs(fv);
    const T clamped = af > T(1) ? T(1) : af;  // NaN stays NaN
    const T norm = to_type(sqrt(ssum), T());
    if (norm_out != nullptr) *norm_out = norm;
    bool stop = norm < mul_rn(to_type(grad_tol, T()), clamped);
    if (gap_tol > 0.0)
      stop = stop || sub_rn(un, fv) < mul_rn(to_type(gap_tol, T()), af);
    const int it = counters[0];
    const bool take = tail_from >= 0 && it >= tail_from;
    const int cnt = counters[1] + (take ? 1 : 0);
    s_gamma = to_type(2.0 / (static_cast<double>(it) + 2.0), T());
    s_rcp = take ? div_rn(T(1), static_cast<T>(cnt)) : T(0);
    s_stop = stop;
    s_take = take;
    *u = un;
    counters[0] = it + 1;
    counters[1] = cnt;
    *done = static_cast<unsigned char>(*done | (stop ? 1 : 0));
  }
  __syncthreads();
  const T gamma = s_gamma, rcp = s_rcp, tol = to_type(mask_tol, T());
  const bool stop = s_stop, take = s_take;
  for (int i = tid; i < m; i += kThreads) {
    const T xi = x[i];
    if (take) {
      const T a = xavg[i];
      xavg[i] = add_rn(a, mul_rn(sub_rn(xi, a), rcp));
    }
    const T xn = stop ? xi : add_rn(xi, mul_rn(gamma, sub_rn(s[i], xi)));
    x[i] = xn;
    w[i] = mul_rn(xn > tol ? xn : T(0), wc[i]);
  }
}

}  // namespace

#define FW_EXPORT(T, S)                                                      \
  extern "C" int fw_oracle_##S(const T* V, int q, const int* ends,           \
                               const T* wc, int m, int k, T* g, T* s,        \
                               void* stream) {                               \
    k9_oracle<T><<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(     \
        V, q, reinterpret_cast<const int2*>(ends), wc, m, k, g, s);          \
    return static_cast<int>(cudaGetLastError());                             \
  }                                                                          \
  extern "C" int fw_update_##S(const T* f, const T* g, const T* s, T* x,     \
                               T* u, T* xavg, int* counters,                 \
                               unsigned char* done, T* w, const T* wc,       \
                               int m, double grad_tol, double gap_tol,       \
                               int tail_from, double mask_tol, T* norm,      \
                               void* stream) {                               \
    k10_update<T><<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(    \
        f, g, s, x, u, xavg, counters, done, w, wc, m, grad_tol, gap_tol,    \
        tail_from, mask_tol, norm);                                          \
    return static_cast<int>(cudaGetLastError());                             \
  }

FW_EXPORT(float, f32)
FW_EXPORT(double, f64)
