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
// l (R, n) contiguous. One launch in all.
//
// What bounds them on the H100: a chain of dependent float64 operations,
// not bytes (16 n bytes for float32 take 0.5 us at n = 100000 and 3.35
// TB/s). tridiag_ldl_step_probe_{f32,f64} runs each chain alone on one
// thread, operands in registers, so that its step can be timed: K3b's
// pivot step (one correctly rounded division, one subtraction: 60 ns,
// 119 cycles, on an H100 at 700 W) and K3's carry step (a 2-vector
// through a chunk's map: 16 ns). A kernel's chain bound is the probe's
// step times the steps of the shortest chain that its method needs
// (K3b's block; K3's chunk walks and carry at the chunk length that makes
// them shortest, not its own); the *_phases entry points run the kernels
// with clock64() stamps of their phases.
//
// K3b's design: warp-specialised blocks of 32 segments, 16 warps. Warp 0
// holds the chain, one thread a segment, and does nothing but the
// recurrence
//     prev = d_i - e2_i / prev    (__ddiv_rn, __dsub_rn; e2 squared in T)
// in row order, reading d and e from, and writing each unfloored pivot
// to, a ring of 7 slots of 32 rows of every segment in shared memory.
// Twelve finisher warps stage the rows into the ring (coalesced loads,
// issued before they wait), read the lane's max(d) while the chain
// starts, then for each slot the chain has filled floor the pivots,
// narrow them, divide l_{i+1} = e_i / dp_i (__ddiv_rn; at each segment's
// cut a zero of dp_i's sign, as 0 / dp_i gives it, without the division's
// slow path), store dp and l in coalesced runs, and stage the slot's next
// rows. Warps 4, 8 and 12, which would share the chain's scheduler
// (warp w issues on sub-partition w mod 4), return at once. The groups
// hand each slot over through two named barriers (rows in: the finishers
// arrive, the chain waits; pivots out: the reverse), so the chain never
// waits for a block-wide barrier, the floor, a store or device memory. A
// segment's first row is d - 0 without the division (0 / 1.0, whose zero
// quotient takes the slow path); rows past a segment's end read d = 2,
// e = 1, so that the chain runs on without a branch and in the normal
// range. The same operations on the same operands as the plain version,
// in the same order for each row: bitwise equal to it.
//
// K3's design: one block per lane; the lane's rows cut into up to 1024
// chunks of at least 16 rows. (1) A thread per chunk composes its rows'
// maps x -> d_i - e2_i / x as 2x2 matrices [[d_i, -e2_i], [1, 0]]
// (projective: rescaling by a power of two changes nothing and rounds
// nothing). (2) One thread carries the vector (D_{i-1}, D_{i-2}) of
// leading minors, up to scale, through the chunks' maps in order: the
// vector entering each chunk. (3) A thread per chunk runs the three-term
// recurrence D_i = d_i D_{i-1} - e2_i D_{i-2} from that vector; then
// dp_i = D_i / D_{i-1} and l_{i+1} = e_i / dp_i. A block scan would
// shorten step 2 to 10 levels, but a product of two long products rounds
// the minors' ratio in its minor direction (4.3e-13 relative from an
// extended-precision referee on city10000's chains, where this pass stays
// near 2e-14). Up to 4096 rows (256 chunks of at most 16 rows) each
// thread holds its chunk in registers: staged in through shared memory
// in coalesced runs, the lane max taken from them, steps 1 and 3 on them,
// and step 3's two divisions a row taken off the thread's walk: the walk
// leaves D_i and D_{i-1} in shared memory and each thread divides the
// rows it staged. Past 4096 rows the chunks reach the threads through
// shared-memory tiles (walk_segments), 256 chunks at a time. A row's
// range test for the rescaling is a few integer operations on exponent
// fields, acted on a row later, off the chain of multiply-adds (the
// rescaling is exact, so when it happens changes nothing). The same
// arithmetic in either form: both call compose_row (step 1) and
// recur_row (step 3). Not bitwise the plain doubling scan: within 1e-13
// relative of the referee in float64, at most one float32 ulp from the
// plain scan.
//
// K3's range: the lagged range test lets a row's entries grow or shrink
// by two rows' factors past 2^+-64 before the rescaling, each row's
// factor at most |d_i| + e_{i-1}^2; the entries stay finite and normal
// while it lies in [2^-479, 2^479]. Every float32 chain does. A float64
// chain runs scaled by 2^-k, 2^k <= max(d) < 2^(k+1), its pivots scaled
// back (chain_scale): exact, so dp and l are the unscaled chain's bit for
// bit, and the chain's units, however large or small, never reach the
// range; it stays inside wherever |e_i| <= 2^239 max(d) and each row's
// factor, in the scaled chain, stays above 2^-479 (a chain scaled by any
// power of two stays inside if it was). Past it, float64 entries
// overflow or lose digits.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // K3: a block per lane
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChunks = 1024;  // K3's chunks of a lane
constexpr int kK3Rows = 16;       // K3's rows a chunk, at least
constexpr int kK3RegRows = 4096;  // K3 keeps its chunks in registers up to
constexpr int kPitch17 = kK3Rows + 1;  // K3's shared rows a chunk, padded
constexpr unsigned kFullMask = 0xffffffffu;

// K3b's block: 16 warps, warp 0 the chain of kSegs segments, warps 4, 8
// and 12 idle (they would issue on the chain's scheduler), the other
// kFinishWarps the finishers; they hand over a ring of kSlots slots of
// kSlotRows rows of every segment.
constexpr int kSegs = 32;
constexpr int kBlockWarps = 16;
constexpr int kFinishWarps = kBlockWarps - kBlockWarps / 4;
constexpr int kFinishThreads = 32 * kFinishWarps;
constexpr int kBlockThreads = 32 * kBlockWarps;
constexpr int kBarThreads = 32 + kFinishThreads;  // at every barrier
constexpr int kSlotRows = 32;
constexpr int kSlots = 7;              // named barriers 1-7 and 8-14
constexpr int kBarMax = 15;            // the finishers' own barrier
constexpr int kRingPitch = kSegs + 1;  // a slot row, padded: conflict-free
constexpr int kSlotElems = kSlotRows * kRingPitch;
constexpr int kPer = (kSegs * kSlotRows + kFinishThreads - 1) /
                     kFinishThreads;   // a finisher's rows a slot

// 0 / f as __ddiv_rn(0.0, f) gives it, without the slow path that a zero
// quotient takes: a zero of f's sign, NaN for f zero or NaN.
__device__ __forceinline__ double zero_over(double f) {
  return f != f || f == 0.0 ? __ddiv_rn(0.0, f) : copysign(0.0, f);
}

// torch.maximum / amax: NaN wins, else the larger (a when equal).
__device__ __forceinline__ double max_nan(double a, double b) {
  if (a != a || b != b) return a != a ? a : b;
  return a < b ? b : a;
}

__device__ __forceinline__ long long gtimer() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Named barriers: bar.sync waits, bar.arrive counts this warp in and goes
// on; either orders this thread's earlier shared-memory accesses before
// the barrier's completion for every thread that takes part.
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(count) : "memory");
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

__device__ __forceinline__ double warp_max(double m) {
#pragma unroll
  for (int k = 16; k > 0; k >>= 1)
    m = max_nan(m, __shfl_xor_sync(kFullMask, m, k));
  return m;
}

// max(d) over the lane's n rows, read by threads t = 0 .. kN - 1 of warps
// that reach barrier `bar` (kN threads) together; on each of them. d is
// read in 16-byte vectors, kU at a time, when it is 16-byte aligned. red
// holds kN / 32 doubles.
template <typename T, int kN, int kU>
__device__ double lane_max(const T* __restrict__ d, int n, double* red,
                           int t, int bar) {
  using Tr = Traits<T>;
  using Vec = typename Tr::Vec;
  double m = -INFINITY;
  int head = 0;
  if ((reinterpret_cast<uintptr_t>(d) & 15) == 0) {
    // kU loads in flight a thread, the ragged end included: every round
    // trip to memory serves kU vectors.
    const Vec* dv = reinterpret_cast<const Vec*>(d);
    const int nv = n / Tr::kVec;
    for (int i = t; i < nv; i += kU * kN) {
      Vec a[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u)
        if (i + u * kN < nv) a[u] = __ldg(dv + i + u * kN);
#pragma unroll
      for (int u = 0; u < kU; ++u)
        if (i + u * kN < nv) m = Tr::vec_max(a[u], m);
    }
    head = nv * Tr::kVec;
  }
  for (int i = head + t; i < n; i += kN) m = max_nan(m, Tr::widen(d[i]));
  m = warp_max(m);
  if ((t & 31) == 0) red[t >> 5] = m;
  bar_sync(bar, kN);
  m = red[0];
#pragma unroll
  for (int w = 1; w < kN / 32; ++w) m = max_nan(m, red[w]);
  return m;
}

// ---------------------------------------------------------------------------
// K3b: the segment-decoupled factor, bitwise the plain version's.

// A ring slot: rows r of segments s at [r * kRingPitch + s] of each array,
// d and e staged in by the finishers, the chain's unfloored pivots out.
template <typename T>
__host__ __device__ constexpr int slot_bytes() {
  return kSlotElems * (8 + 2 * static_cast<int>(sizeof(T)));
}

template <typename T>
struct Slot {
  double* prev;
  T *d, *e;
  __device__ Slot(unsigned char* ring, int b) {
    unsigned char* at = ring + b * slot_bytes<T>();
    prev = reinterpret_cast<double*>(at);
    d = reinterpret_cast<T*>(at + kSlotElems * 8);
    e = d + kSlotElems;
  }
};

// A finisher's share of a slot: element j = ft + u * kFinishThreads is row
// r = j % kSlotRows of segment s = j / kSlotRows, so that consecutive
// threads take consecutive rows (coalesced in device memory) and rows of
// one segment sit kRingPitch apart (no bank conflict). Each finisher
// stages in, and later finishes, the same elements of every slot: no
// finisher waits for another before refilling what it has finished.
struct Share {
  long long row[kPer], i1[kPer];
  int at[kPer];
  bool in[kPer];
  __device__ Share(int ft, int k, long long g0, long long nseg, int n,
                   int block) {
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int j = ft + u * kFinishThreads;
      const int s = j / kSlotRows, r = j % kSlotRows;
      const long long g = g0 + s;
      const long long i0 = g * block;
      i1[u] = g >= nseg ? i0 : i0 + block < n ? i0 + block : n;
      row[u] = i0 + static_cast<long long>(k) * kSlotRows + r;
      in[u] = j < kSegs * kSlotRows;
      at[u] = r * kRingPitch + s;
    }
  }
};

// The rows of a share from device memory: d_i and e_i, and past the
// segment's end d = 2 and e = 1, as the e of its last row (the coupling
// the segment drops). The chain runs there too, with no branch: prev =
// 2 - 1 / prev stays in the normal range (it tends to 1) and a division's
// quotient never falls to 0, which would take the slow path. Those pivots
// are never read.
template <typename T>
__device__ __forceinline__ void share_load(const Share& sh,
                                           const T* __restrict__ d,
                                           const T* __restrict__ e,
                                           T (&dv)[kPer], T (&ev)[kPer]) {
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    dv[u] = sh.in[u] && sh.row[u] < sh.i1[u] ? __ldg(d + sh.row[u]) : T(2);
    ev[u] = sh.in[u] && sh.row[u] + 1 < sh.i1[u] ? __ldg(e + sh.row[u])
                                                 : T(1);
  }
}

template <typename T>
__device__ __forceinline__ void share_store(const Share& sh, Slot<T> sl,
                                            const T (&dv)[kPer],
                                            const T (&ev)[kPer]) {
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    if (sh.in[u]) {
      sl.d[sh.at[u]] = dv[u];
      sl.e[sh.at[u]] = ev[u];
    }
  }
}

// Phase stamps (the *_phases entry points, kClock): clock64() durations of
// the first block into clk (16 long long); clk[0] their count, clk[14] the
// whole kernel's cycles, clk[15] its %globaltimer nanoseconds. K3b: [1]
// the finishers' lane max, [2] the chain, [3] the chain's waits for its
// rows, [4] the finishers' waits for the chain's pivots, [5] the
// finishers' tail after the chain's last step.
template <typename T, bool kClock>
__global__ void __launch_bounds__(kBlockThreads)
    ldl_blocked_kernel(const T* __restrict__ d, const T* __restrict__ e,
                       T* __restrict__ dp, T* __restrict__ l, int n,
                       int block, long long dstride, long long estride,
                       int nblk, long long* clk) {
  using Tr = Traits<T>;
  extern __shared__ __align__(16) unsigned char ring[];
  __shared__ double red[kFinishWarps];
  __shared__ long long chain_end;
  const long long t_start = kClock ? clock64() : 0;
  const long long g_start = kClock ? gtimer() : 0;
  const bool stamp = kClock && blockIdx.x == 0;
  const long long lane = blockIdx.x / nblk;
  const long long g0 = static_cast<long long>(blockIdx.x % nblk) * kSegs;
  d += lane * dstride;
  e += lane * estride;
  dp += lane * n;
  l += lane * n;
  const long long nseg = (n - 1) / block + 1;
  const int nslot = ((block < n ? block : n) - 1) / kSlotRows + 1;
  // Slot b's barriers: 1 + b, the rows staged in (the finishers arrive,
  // the chain waits); 1 + kSlots + b, the pivots out (the reverse).
  auto rows_in = [](int b) { return 1 + b; };
  auto pivots_out = [](int b) { return 1 + kSlots + b; };

  if (threadIdx.x < 32) {
    // The chain: segment g0 + s on thread s, nothing else on this warp.
    const int s = threadIdx.x;
    double prev = 0.0;
    T e_prev = T(0);
    long long waits = 0;
    for (int k = 0; k < nslot; ++k) {
      const int b = k % kSlots;
      const long long c = kClock ? clock64() : 0;
      bar_sync(rows_in(b), kBarThreads);
      if (kClock) waits += clock64() - c;
      const Slot<T> sl(ring, b);
      if (k == 0) {
        // A segment's row 0, d - 0 / 1.0, as d - 0: the division's zero
        // quotient would take its slow path.
        prev = __dsub_rn(Tr::widen(sl.d[s]), 0.0);
        sl.prev[s] = prev;
        e_prev = sl.e[s];
      }
#pragma unroll
      for (int r = 0; r < kSlotRows; ++r) {
        if (r > 0 || k > 0) {
          prev = __dsub_rn(Tr::widen(sl.d[r * kRingPitch + s]),
                           __ddiv_rn(Tr::square_in_t(e_prev), prev));
          sl.prev[r * kRingPitch + s] = prev;
          e_prev = sl.e[r * kRingPitch + s];
        }
      }
      if (stamp && s == 0 && k + 1 == nslot) chain_end = clock64();
      bar_arrive(pivots_out(b), kBarThreads);
    }
    if (stamp && s == 0) {
      clk[2] = chain_end - t_start;
      clk[3] = waits;
    }
    return;
  }

  // The finishers: the first slots' rows in, the floor, then for each slot
  // its pivots finished and its next rows in.
  const int warp = threadIdx.x >> 5;
  if (warp % 4 == 0) return;  // the chain's scheduler, the chain's alone
  const int ft = (warp - 1 - warp / 4) * 32 + (threadIdx.x & 31);
  T dv[kPer], ev[kPer];
  for (int k = 0; k < kSlots && k < nslot; ++k) {
    const Share sh(ft, k, g0, nseg, n, block);
    share_load(sh, d, e, dv, ev);
    share_store(sh, Slot<T>(ring, k), dv, ev);
    bar_arrive(rows_in(k), kBarThreads);
  }
  const double pivot_floor = __dmul_rn(
      8.0 * Tr::eps, lane_max<T, kFinishThreads, 8>(d, n, red, ft, kBarMax));
  const long long t_max = kClock ? clock64() : 0;
  if (g0 == 0 && ft == 0) l[0] = T(0);
  long long waits = 0;
  for (int k = 0; k < nslot; ++k) {
    const int b = k % kSlots;
    const Slot<T> sl(ring, b);
    const Share sh(ft, k, g0, nseg, n, block);
    const Share next(ft, k + kSlots, g0, nseg, n, block);
    const bool refill = k + kSlots < nslot;
    if (refill) share_load(next, d, e, dv, ev);  // before the wait
    const long long c = kClock ? clock64() : 0;
    bar_sync(pivots_out(b), kBarThreads);
    if (kClock) waits += clock64() - c;
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      if (sh.in[u] && sh.row[u] < sh.i1[u]) {
        const double f = max_nan(sl.prev[sh.at[u]], pivot_floor);
        dp[sh.row[u]] = Tr::narrow(f);
        // l_{i+1} = e_i / dp_i, the coupling cut at the next segment's
        // start.
        if (sh.row[u] + 1 < n)
          l[sh.row[u] + 1] = Tr::narrow(
              sh.row[u] + 1 < sh.i1[u]
                  ? __ddiv_rn(Tr::widen(sl.e[sh.at[u]]), f)
                  : zero_over(f));
      }
    }
    if (refill) {
      share_store(next, sl, dv, ev);
      bar_arrive(rows_in(b), kBarThreads);
    }
  }
  if (stamp && ft == 0) {
    const long long t_end = clock64();
    clk[0] = 5;
    clk[1] = t_max - t_start;
    clk[4] = waits;
    clk[5] = t_end - chain_end;
    clk[14] = t_end - t_start;
    clk[15] = gtimer() - g_start;
  }
}

// ---------------------------------------------------------------------------
// K3: the exact factor.

// A projective 2x2 map [[a, b], [c, d]].
struct Map {
  double a, b, c, d;
};

// 2^k for k in [-1022, 1023].
__device__ __forceinline__ double pow2(int k) {
  return __longlong_as_double(static_cast<long long>(k + 1023) << 52);
}

// ilogb(m) of a finite m > 0, subnormal too.
__device__ __forceinline__ int ilogb_pos(double m) {
  const long long bits = __double_as_longlong(m);
  const int ex = static_cast<int>(bits >> 52);
  return ex != 0 ? ex - 1023 : -1011 - __clzll(bits);
}

// K3 runs a float64 chain scaled by 2^-k, 2^k <= max(d) < 2^(k+1) (k = 0
// where max(d) is not positive and finite), and scales its pivots back:
// (down, up) = (2^-k, 2^k). Exact: every value of the recurrence is the
// unscaled one times a power of two, so dp and l are the unscaled chain's
// bit for bit, and the chain's units no longer reach the range (the
// header's K3's range). A float32 chain, whose units cannot, runs as it
// is: (1, 1).
template <typename T>
__device__ __forceinline__ void chain_scale(double mx, double& down,
                                            double& up) {
  if constexpr (sizeof(T) == 8) {
    const int k = mx > 0.0 && mx <= 0x1.fffffffffffffp1023
                      ? min(max(ilogb_pos(mx), -1022), 1022)
                      : 0;
    down = pow2(-k);
    up = pow2(k);
  } else {
    down = 1.0;
    up = 1.0;
  }
}

__device__ __forceinline__ double max_abs(double a, double b, double c,
                                          double d) {
  return fmax(fmax(fabs(a), fabs(b)), fmax(fabs(c), fabs(d)));
}

// Whether renorm rescales at largest magnitude m.
__device__ __forceinline__ bool wants_scale(double m, bool always = false) {
  return (always || m > 0x1p64 || m < 0x1p-64) && m > 0.0 && isfinite(m);
}

__device__ __forceinline__ int exp_field(double x) {
  return (__double2hiint(x) >> 20) & 0x7ff;
}

// renorm's range test on the exponent fields alone, in a few integer
// operations: an entry at or past 2^64 (or not finite), or every entry
// below 2^-64 and one of them normal. Where it differs from wants_scale
// (a largest magnitude of exactly 2^64; subnormal entries alone), a
// rescaling, which is exact, is only made or left out: the ratios, which
// are what count, do not change.
__device__ __forceinline__ bool out_of_range(double a, double b,
                                             double c = 0.0,
                                             double d = 0.0) {
  const int e = max(max(exp_field(a), exp_field(b)),
                    max(exp_field(c), exp_field(d)));
  return e >= 1023 + 64 || (e > 0 && e < 1023 - 64);
}

// Rescale by the power of two that brings the largest magnitude into
// [1, 2) once it leaves [2^-64, 2^64] (always, with always = true): exact,
// and the ratios are what count. Two multiplications by powers of two
// (2^-ilogb(m) may lie outside the normal range) in place of scalbn and
// ilogb, whose library code, inlined at every row, put thousands of
// instructions into step 1 of K3's register path.
__device__ __forceinline__ void renorm(double& a, double& b, double& c,
                                       double& d, bool always = false) {
  const double m = max_abs(a, b, c, d);
  if (wants_scale(m, always)) {
    const int k = -ilogb_pos(m), k1 = k >> 1;
    const double s1 = pow2(k1), s2 = pow2(k - k1);
    a = a * s1 * s2;
    b = b * s1 * s2;
    c = c * s1 * s2;
    d = d * s1 * s2;
  }
}

__device__ __forceinline__ void renorm(double& a, double& b,
                                       bool always = false) {
  double c = 0.0, d = 0.0;
  renorm(a, b, c, d, always);
}

// Step 1's row: the map x -> x_i - e2 / x composed onto q, the row's map
// leftmost (q unchanged where !in). The range test of the entries is
// acted on a row later (pending): off the chain of multiply-adds, and
// the rescaling is exact, so when it comes changes nothing but the range
// (the header's K3's range). With last, q is normalised as well.
__device__ __forceinline__ void compose_row(Map& q, double x, double e2,
                                            bool& pending, bool in = true,
                                            bool last = false) {
  const double a = fma(x, q.a, -(e2 * q.c));
  const double b = fma(x, q.b, -(e2 * q.d));
  q.c = in ? q.a : q.c;
  q.d = in ? q.b : q.d;
  q.a = in ? a : q.a;
  q.b = in ? b : q.b;
  if (pending || last) renorm(q.a, q.b, q.c, q.d, true);
  pending = out_of_range(q.a, q.b, q.c, q.d);
}

// Step 3's row: D_i = x_i D_{i-1} - e2 D_{i-2} from (v0, v1) = (D_{i-1},
// D_{i-2}) up to scale, returned; (v0, v1) moved on to (D_i, D_{i-1}),
// the range test acted on a row later as in compose_row.
__device__ __forceinline__ double recur_row(double& v0, double& v1, double x,
                                            double e2, bool& pending) {
  const double v = fma(x, v0, -(e2 * v1));
  v1 = v0;
  v0 = v;
  if (pending) renorm(v0, v1, true);
  pending = out_of_range(v0, v1);
  return v;
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

// K3 in registers: D_i and D_{i-1} of every row, kPitch17 a chunk.
constexpr int kRegBytes = 2 * kThreads * kPitch17 * 8;

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

// The chunks' maps composed (step 1), one thread carries the vector of
// leading minors (D_{i-1}, D_{i-2}), up to scale, across them in order,
// applying each chunk's map to it, and leaves each chunk's incoming vector
// in the chunk's (a, c) (step 2). A product of two long products would
// round the minors' ratio in its minor direction (4.3e-13 relative on
// city10000's chains); a vector through one chunk's map does not (near
// 2e-14). Each map is read 8 chunks ahead of its use and whole groups of
// 8 run without a branch but the range test's, taken on the vector after
// each group and acted on a chunk into the next (lagged, as in step 1), so
// the chain waits on its two multiply-adds a chunk alone.
__device__ __forceinline__ void carry(Map* maps, int nseg) {
  double v0 = 1.0, v1 = 0.0;
  bool pending = false;
  Map q[8];
#pragma unroll
  for (int u = 0; u < 8; ++u) q[u] = maps[u < nseg ? u : nseg - 1];
  int k = 0;
  for (; k + 8 <= nseg; k += 8) {  // whole groups: no branch
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const Map c = q[u];
      q[u] = maps[k + 8 + u < nseg ? k + 8 + u : nseg - 1];
      maps[k + u].a = v0;
      maps[k + u].c = v1;
      const double w0 = fma(c.a, v0, c.b * v1);
      const double w1 = fma(c.c, v0, c.d * v1);
      v0 = w0;
      v1 = w1;
      if (u == 0 && pending) renorm(v0, v1, true);  // lagged a chunk
    }
    pending = out_of_range(v0, v1);  // at most 4^8 larger
  }
#pragma unroll
  for (int u = 0; u < 7; ++u) {  // the last, partial group
    if (k + u < nseg) {
      maps[k + u].a = v0;
      maps[k + u].c = v1;
      const double w0 = fma(q[u].a, v0, q[u].b * v1);
      const double w1 = fma(q[u].c, v0, q[u].d * v1);
      v0 = w0;
      v1 = w1;
    }
  }
}

// K3's phase stamps (clk as for ldl_blocked_kernel): [1..4] its four
// phases, clk[13] its path (1 the chunks in registers: the loads, lane
// max and step 1, step 2, step 3's walk, the divisions and stores; 0 the
// staged tiles: the lane max, steps 1, 2 and 3).
template <typename T, int kRows, bool kClock>
__global__ void __launch_bounds__(kThreads)
    ldl_kernel(const T* __restrict__ d, const T* __restrict__ e,
               T* __restrict__ dp, T* __restrict__ l, int n, long long dstride,
               long long estride, long long* clk) {
  using Tr = Traits<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ double red[kWarps];
  __shared__ Map maps[kMaxChunks];
  const long long t_start = kClock ? clock64() : 0;
  const long long g_start = kClock ? gtimer() : 0;
  const long long lane_id = blockIdx.x;
  d += lane_id * dstride;
  e += lane_id * estride;
  dp += lane_id * n;
  l += lane_id * n;
  const int nchunk = min(kMaxChunks, (n - 1) / kK3Rows + 1);
  const int chunk = (n - 1) / nchunk + 1;
  const int nseg = (n - 1) / chunk + 1;  // chunks that hold rows
  long long t1 = 0, t2 = 0, t3 = 0;

  if constexpr (kRows > 0) {
    // Up to kThreads chunks of at most kRows rows: chunk t in registers.
    double* num = reinterpret_cast<double*>(smem);  // D_i
    double* den = num + kThreads * kPitch17;         // D_{i-1}
    const int t = threadIdx.x;
    const int i0 = t * chunk;
    const int h = t < nseg ? min(chunk, n - i0) : 0;
    // Row i's place in shared memory, chunk i / chunk at row i % chunk,
    // the quotient by a multiplication: exact for i < 2^20 / chunk, and
    // i < 4096 keeps the product in 32 bits.
    const unsigned recip = ((1u << 20) + chunk - 1) / chunk;
    auto place = [&](int i) {
      const int c = static_cast<int>((static_cast<unsigned>(i) * recip) >> 20);
      return c * kPitch17 + (i - c * chunk);
    };
    // The rows come in through shared memory (the num and den arrays,
    // free until step 3): the block reads d and e in coalesced runs, row i
    // to chunk i / chunk at row i % chunk, kPitch17 a chunk, and each
    // thread then reads its chunk without bank conflicts. (Each thread
    // reading its own rows from device memory made every load touch 32
    // lines.)
    // Rows t + u kThreads, u < kRows, to this thread: every load issued
    // before the first store, so that the block waits on device memory
    // once. The e of those rows stay for the divisions at the end.
    T ei[kRows];
    {
      T dv[kRows];
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        const int i = t + u * kThreads;
        dv[u] = i < n ? __ldg(d + i) : T(0);
        ei[u] = i < n - 1 ? __ldg(e + i) : T(0);
      }
      T* sd = reinterpret_cast<T*>(num);
      T* se = reinterpret_cast<T*>(den);
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        const int i = t + u * kThreads;
        const int at = place(i);
        if (i < n) sd[at] = dv[u];
        if (i < n - 1) se[at] = ei[u];
      }
      __syncthreads();
    }
    T dr[kRows], er[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      dr[r] = r < h ? reinterpret_cast<const T*>(num)[t * kPitch17 + r] : T(0);
      er[r] = r < h && i0 + r < n - 1
                  ? reinterpret_cast<const T*>(den)[t * kPitch17 + r]
                  : T(0);
    }
    double mr[kRows];  // the chunk's max, as a tree: depth 4, not 16
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      mr[r] = r < h ? Tr::widen(dr[r]) : -INFINITY;
#pragma unroll
    for (int w = 1; w < kRows; w *= 2)
#pragma unroll
      for (int r = 0; r + w < kRows; r += 2 * w)
        mr[r] = max_nan(mr[r], mr[r + w]);
    const double m = warp_max(mr[0]);
    if ((t & 31) == 0) red[t >> 5] = m;
    auto lane_max_of = [&] {
      double mx = red[0];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) mx = max_nan(mx, red[w]);
      return mx;
    };
    double down = 1.0, up = 1.0;
    if constexpr (sizeof(T) == 8) {  // the scale wants the max before step 1
      __syncthreads();
      chain_scale<T>(lane_max_of(), down, up);
    }
    const double e_in =
        h > 0 && i0 > 0
            ? Tr::widen(reinterpret_cast<const T*>(
                  den)[(t - 1) * kPitch17 + chunk - 1]) * down
            : 0.0;
    // 1. The chunk's maps x -> d_i - e2_i / x composed, the last row's
    // leftmost, and normalised (entries below 2: step 2 grows its vector
    // 4x a chunk at most). Every row runs, a row past the chunk selecting
    // the map unchanged.
    Map q{1.0, 0.0, 0.0, 1.0};
    double e_prev = e_in;
    bool pending = false;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const double e2 = i0 + r == 0 ? 0.0 : e_prev * e_prev;
      compose_row(q, Tr::widen(dr[r]) * down, e2, pending, r < h);
      e_prev = Tr::widen(er[r]) * down;
    }
    renorm(q.a, q.b, q.c, q.d, true);
    if (h > 0) maps[t] = q;
    __syncthreads();
    if (kClock) t1 = clock64();
    if (t == 0) carry(maps, nseg);  // 2.
    __syncthreads();
    if (kClock) t2 = clock64();
    const double pivot_floor = __dmul_rn(8.0 * Tr::eps, lane_max_of());
    // 3. The three-term recurrence D_i = d_i D_{i-1} - e2_i D_{i-2} over
    // the chunk's rows from its incoming minors; D_i and D_{i-1} to shared
    // memory, the divisions left to the block. Rows past the chunk run
    // too (d = e = 0 there), their minors never stored.
    {
      double v0 = maps[t < nseg ? t : 0].a, v1 = maps[t < nseg ? t : 0].c;
      e_prev = e_in;
      pending = false;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const double e2 = i0 + r == 0 ? 0.0 : e_prev * e_prev;
        const double below = v0;
        const double v =
            recur_row(v0, v1, Tr::widen(dr[r]) * down, e2, pending);
        if (r < h) {
          num[t * kPitch17 + r] = v;
          den[t * kPitch17 + r] = below;
        }
        e_prev = Tr::widen(er[r]) * down;
      }
    }
    __syncthreads();
    if (kClock) t3 = clock64();
    // dp_i = D_i / D_{i-1} (scaled back) floored, l_{i+1} = e_i / dp_i:
    // the rows this thread staged, their e still in registers.
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      const int i = t + u * kThreads;
      if (i < n) {
        const int at = place(i);
        const double f = max_nan(num[at] / den[at] * up, pivot_floor);
        dp[i] = Tr::narrow(f);
        if (i + 1 < n) l[i + 1] = Tr::narrow(Tr::widen(ei[u]) / f);
      }
    }
    if (t == 0) l[0] = T(0);
  } else {
    T* stage = reinterpret_cast<T*>(smem);
    // The lane's max(d), by the whole block.
    const double mx = lane_max<T, kThreads, 4>(d, n, red, threadIdx.x, 0);
    const double pivot_floor = __dmul_rn(8.0 * Tr::eps, mx);
    double down, up;
    chain_scale<T>(mx, down, up);
    if (kClock) t1 = clock64();
    // 1. Each chunk's maps composed and normalised, as above.
    {
      Map m{1.0, 0.0, 0.0, 1.0};
      double e_prev = 0.0;
      bool pending = false;
      walk_segments<T, false>(
          d, e, dp, l, n, chunk, nseg, stage,
          [&](int s, int i, int i0, int i1, T di, T ei, T*, T*) {
            if (i == i0) {
              m = Map{1.0, 0.0, 0.0, 1.0};
              e_prev = i0 > 0 ? Tr::widen(e[i0 - 1]) * down : 0.0;
              pending = false;
            }
            const double e2 = i == 0 ? 0.0 : e_prev * e_prev;
            compose_row(m, Tr::widen(di) * down, e2, pending, true,
                        i + 1 == i1);
            if (i + 1 == i1) maps[s] = m;
            e_prev = Tr::widen(ei) * down;
          });
    }
    __syncthreads();
    if (kClock) t2 = clock64();
    if (threadIdx.x == 0) {  // 2.
      carry(maps, nseg);
      l[0] = T(0);
    }
    __syncthreads();
    if (kClock) t3 = clock64();
    // 3. The three-term recurrence over each chunk's rows from its
    // incoming minors, each pivot the ratio of two.
    double v0 = 0.0, v1 = 0.0, e_prev = 0.0;
    bool pending = false;
    walk_segments<T, true>(
        d, e, dp, l, n, chunk, nseg, stage,
        [&](int s, int i, int i0, int, T di, T ei, T* dslot, T* eslot) {
          if (i == i0) {
            v0 = maps[s].a;
            v1 = maps[s].c;
            e_prev = i0 > 0 ? Tr::widen(e[i0 - 1]) * down : 0.0;
            pending = false;
          }
          const double e2 = i == 0 ? 0.0 : e_prev * e_prev;
          const double below = v0;
          const double v =
              recur_row(v0, v1, Tr::widen(di) * down, e2, pending);
          const double f = max_nan(v / below * up, pivot_floor);
          *dslot = Tr::narrow(f);
          if (i + 1 < n) *eslot = Tr::narrow(Tr::widen(ei) / f);
          e_prev = Tr::widen(ei) * down;
        });
  }
  if (kClock && threadIdx.x == 0 && blockIdx.x == 0) {
    const long long t_end = clock64();
    clk[0] = 4;
    clk[1] = t1 - t_start;
    clk[2] = t2 - t1;
    clk[3] = t3 - t2;
    clk[4] = t_end - t3;
    clk[13] = kRows > 0;
    clk[14] = t_end - t_start;
    clk[15] = gtimer() - g_start;
  }
}

// Both kernels may take more than the default 48 KB of dynamic shared
// memory: raised once per instantiation, at its first launch.
template <typename T, int kRows, bool kClock>
int ldl_launch_rows(const T* d, const T* e, T* dp, T* l, int n, int lanes,
                    long long dstride, long long estride, void* stream,
                    long long* clk) {
  constexpr int bytes = kRows > 0 ? kRegBytes : stage_bytes<T>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      ldl_kernel<T, kRows, kClock>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  ldl_kernel<T, kRows, kClock><<<lanes, kThreads, bytes,
                                 static_cast<cudaStream_t>(stream)>>>(
      d, e, dp, l, n, dstride, estride, clk);
  return cudaGetLastError();
}

template <typename T, bool kClock = false>
int ldl_launch(const T* d, const T* e, T* dp, T* l, int n, int lanes,
               long long dstride, long long estride, void* stream,
               long long* clk = nullptr) {
  if (n < 1 || lanes < 1) return cudaErrorInvalidValue;
  if (n <= kK3RegRows)
    return ldl_launch_rows<T, kK3Rows, kClock>(d, e, dp, l, n, lanes,
                                               dstride, estride, stream, clk);
  return ldl_launch_rows<T, 0, kClock>(d, e, dp, l, n, lanes, dstride,
                                       estride, stream, clk);
}

template <typename T, bool kClock = false>
int ldl_blocked_launch(const T* d, const T* e, T* dp, T* l, int n, int lanes,
                       long long dstride, long long estride, int block,
                       void* stream, long long* clk = nullptr) {
  if (n < 1 || lanes < 1 || block < 1) return cudaErrorInvalidValue;
  const long long nblk = ((n - 1) / block) / kSegs + 1;
  if (nblk * lanes >= (1LL << 31)) return cudaErrorInvalidValue;
  constexpr int bytes = kSlots * slot_bytes<T>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      ldl_blocked_kernel<T, kClock>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  ldl_blocked_kernel<T, kClock>
      <<<static_cast<unsigned>(nblk * lanes), kBlockThreads, bytes,
         static_cast<cudaStream_t>(stream)>>>(
          d, e, dp, l, n, block, dstride, estride, static_cast<int>(nblk),
          clk);
  return cudaGetLastError();
}

// The chains alone, on one thread, operands in registers in the normal
// range, from the arguments (so that nothing folds into a cheaper form):
// K3b's pivot step (which 0: prev = d - e^2 / prev, e squared in T) and
// K3's carry step (which 1: a 2-vector through the map [[d / 2, -e / 2],
// [1 / 2, 0]], renormalised every 8 steps as the kernel does), `steps`
// times; out[0] the chain's last value, out[1] the loop's clock64 cycles.
template <typename T>
__global__ void __launch_bounds__(32)
    step_probe_kernel(double* out, int steps, int which, double dv,
                      double ev) {
  using Tr = Traits<T>;
  if (threadIdx.x != 0) return;
  const T dt = static_cast<T>(dv), et = static_cast<T>(ev);
  double r = 0.0;
  long long c0 = 0, c1 = 0;
  if (which == 0) {
    double prev = 1.0;
    const double di = Tr::widen(dt), e2 = Tr::square_in_t(et);
    c0 = clock64();
    for (int i = 0; i < steps; ++i)
      prev = __dsub_rn(di, __ddiv_rn(e2, prev));
    c1 = clock64();
    r = prev;
  } else {
    const double a = 0.5 * Tr::widen(dt), b = -0.5 * Tr::widen(et), c = 0.5,
                 dd = 0.0 * Tr::widen(et);
    double v0 = 1.0, v1 = 0.0;
    c0 = clock64();
    for (int k = 0; k < steps; k += 8) {
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const double w0 = fma(a, v0, b * v1);
        const double w1 = fma(c, v0, dd * v1);
        v0 = w0;
        v1 = w1;
      }
      renorm(v0, v1);
    }
    c1 = clock64();
    r = v0 / v1;
  }
  out[0] = r;
  out[1] = static_cast<double>(c1 - c0);
}

template <typename T>
int step_probe(double* out, int steps, int which, double d, double e,
               void* stream) {
  if (steps < 0 || which < 0 || which > 1) return cudaErrorInvalidValue;
  step_probe_kernel<T><<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      out, steps, which, d, e);
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

// The kernels with their phase stamps, one launch: clk (16 long long) as
// ldl_blocked_kernel and ldl_kernel describe it.
extern "C" int tridiag_ldl_phases_f32(const float* d, const float* e,
                                      float* dp, float* l, int n, int lanes,
                                      long long dstride, long long estride,
                                      long long* clk, void* stream) {
  return ldl_launch<float, true>(d, e, dp, l, n, lanes, dstride, estride,
                                 stream, clk);
}

extern "C" int tridiag_ldl_phases_f64(const double* d, const double* e,
                                      double* dp, double* l, int n, int lanes,
                                      long long dstride, long long estride,
                                      long long* clk, void* stream) {
  return ldl_launch<double, true>(d, e, dp, l, n, lanes, dstride, estride,
                                  stream, clk);
}

extern "C" int tridiag_ldl_blocked_phases_f32(
    const float* d, const float* e, float* dp, float* l, int n, int lanes,
    long long dstride, long long estride, int block, long long* clk,
    void* stream) {
  return ldl_blocked_launch<float, true>(d, e, dp, l, n, lanes, dstride,
                                         estride, block, stream, clk);
}

extern "C" int tridiag_ldl_blocked_phases_f64(
    const double* d, const double* e, double* dp, double* l, int n,
    int lanes, long long dstride, long long estride, int block,
    long long* clk, void* stream) {
  return ldl_blocked_launch<double, true>(d, e, dp, l, n, lanes, dstride,
                                          estride, block, stream, clk);
}

// The chain probe: out (2 doubles), steps, which (0 K3b's step, 1 K3's),
// the operands d and e (2.5 and 1.0 keep both chains in the normal range:
// the pivot tends to 2, the vector to the map's eigenvector of 1).
extern "C" int tridiag_ldl_step_probe_f32(double* out, int steps, int which,
                                          double d, double e, void* stream) {
  return step_probe<float>(out, steps, which, d, e, stream);
}

extern "C" int tridiag_ldl_step_probe_f64(double* out, int steps, int which,
                                          double d, double e, void* stream) {
  return step_probe<double>(out, steps, which, d, e, stream);
}
