// K6: the update of TRACEMIN's inner preconditioned CG step, with column
// sums taken in a fixed order.
//
// Stands for no Pallas kernel: it is the body of pcg_fixed's fori_loop
// (mac_tpu/ops/cg.py:52-62) as XLA fuses it inside the reference's one
// compiled program -- the step sizes, the vector updates and the column
// dot products over an (n, q) block of right-hand sides (or R lanes of
// them, (R, n, q)). Run as PyTorch ops, one step of that body is about 20
// small kernels; here it is two launches a step, and a third kernel for
// the column sums the callers need elsewhere:
//
//   k6_update          alpha = rz / pap (0 where |pap| <= tiny), X += alpha
//                      P, R -= alpha AP, and the new R's column sums (the
//                      next V-cycle centres R by its means);
//   k6_direction_dots  rz_new = R . Z column by column (Z centred by its
//                      column means, Z - zsum / n, when zsum is given: the
//                      V-cycle's output is Z = x - mean(x)), then beta =
//                      rz_new / rz (0 where |rz| <= tiny), P = Z + beta P
//                      (P = Z at the first step), rz = rz_new, and the new
//                      P's column sums in float64 (the shift term of the
//                      next product, (c / n) 1 1^T P);
//   k6_colsum          the column sums of A, or the column dots of A and M
//                      (M centred by msum / n when msum is given): the
//                      start of a solve, K5's window sums, the ELL route's
//                      P . AP.
//
// Fixed-order sums. Every column sum is the same bits whatever order the
// blocks run in and however the items fall to blocks, so that a replayed
// graph is bitwise the eager solve: the rows are cut into items (and, past
// 4 columns, groups of 4 columns; and lanes) of kThreads = 128 rows, or of
// 256 where there would be more than kR2Items = 160 items of 128 (the rows
// of an item depend on the blocks' shape alone: 128 at city10000's (10000,
// 4), 256 with its 8 lanes and at the n = 100000 route's (100000, 4)); in
// an item each of kThreads threads adds its rows in order in float64 (rows
// t, t + kThreads), each warp adds its lanes by the xor butterfly (16, 8, 4,
// 2, 1; the transposing form below makes the same tree), and one thread a
// column adds the warps in index order into the item's partial. Then the
// partials of each column add in a fixed order: lane l of a warp adds items
// l, l + 32, ... in order, then the same butterfly. block_sum_model in
// ops/kernels/pcg.py is this order in numpy; the dots that
// k6_direction_dots takes are bitwise k6_colsum's on the same input. The
// scalar coefficients are computed in the block's type T from the float64
// sums rounded to T, as the plain version's sums in T are.
//
// What bounds it on the H100: latency. At (10000, 4) float32 a pass moves
// 0.3-0.8 MB (0.10-0.29 us at 3.35 TB/s) and does a few operations an
// element; an empty launch takes about 1.9 us of device time, and each
// trip through the memory system on a pass's serial chain a few hundred ns.
// So the design shortens that chain:
//   - a thread holds whole rows (one 16-byte load a row and array at q = 4
//     in float32, two in float64; element loads past the vector case), and
//     issues every load of the pass (and the scalars rz, pap and the means)
//     before its first store; every array is __restrict__ and no index is
//     divided per element;
//   - the column partials come from the values still in registers: a
//     warp's 4 (or 8) column sums go through one transposing butterfly (each
//     exchange halves the values a lane holds, 6 or 9 shuffles where a
//     butterfly a column takes 20 or 40), then the warps through shared
//     memory; nothing the pass stored is read back;
//   - no thread fences: after the block's barrier thread 0 takes the
//     ticket by one acquire-release atomic, which publishes the block's
//     partials, and the block that takes the last ticket loads all of them
//     with up to kSumLoads loads a thread in flight before it adds any;
//   - a block holds up to kMaxSlots items side by side (a slot of kThreads
//     threads each, one more for every kSlotItems = 160 items; no bit
//     depends on it), so that with lanes fewer blocks meet at the ticket;
//     the grid is one block a slot group up to the card's resident blocks
//     (the occupancy query), past which the blocks loop over items: 79
//     blocks of 128 threads at (10000, 4), 107 of 384 with 8 lanes;
//   - the direction pass takes the dots R . Z itself, which was a launch of
//     its own: each block writes its items' dot partials and arrives at a
//     grid barrier (an atomic and an acquire poll on a word of its own,
//     whose top bit flips once every block has arrived); then every block
//     sums its own columns' partials in the fixed order (so rz_new is the
//     same bits in every block, and col_sums's), forms beta, P and P's
//     partials, and takes one ticket; the slot that holds each column
//     group's first rows writes its rz_new and rz (every block read the old
//     rz before the barrier), the last block P's sums. The barrier needs
//     every block resident at once, so this kernel is launched
//     cooperatively (its grid capped by the occupancy query); a wait that
//     outlasts kMaxPolls polls traps rather than hang the card. At the
//     first step (P = Z) nothing waits: the dots and P's sums take one
//     ticket.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;    // threads a slot (an item; pcg.py THREADS)
constexpr int kWarps = kThreads / 32;  // warps a slot
constexpr int kR2Items = 160;    // items of kThreads rows past which an item
                                 // takes 2 kThreads (pcg.py R2_ITEMS)
constexpr int kCols = 4;         // columns a thread holds of a row
constexpr int kMaxSlots = 4;     // items a block holds at once
constexpr int kSlotItems = 160;  // items past which a block takes one more
                                 // slot
constexpr int kSumLoads = 16;            // a lane's loads of partials at once
constexpr unsigned kFull = 0xffffffffu;
constexpr long long kMaxPolls = 1ll << 22;

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

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ unsigned add_acq_rel(unsigned* p, unsigned v) {
  unsigned old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], %2;"
               : "=r"(old)
               : "l"(p), "r"(v)
               : "memory");
  return old;
}

__device__ __forceinline__ int flat_thread() {
  return threadIdx.y * blockDim.x + threadIdx.x;
}

// The value whose column sums k6_colsum takes, by its mode.
enum SumOf { kSumA = 0, kDotAM = 1, kDotAMc = 2 };

// An item: kChunk = kThreads * kR rows (kR rows a thread) of one group of
// kCols columns of one lane. Items go chunk first, then group, then lane.
// Past the last item, an empty one (nc 0, rows past n).
struct Item {
  int lane, col0, nc, chunk;
  long long row0;  // the item's first row, lane offset included
};

template <int kR>
struct Items {
  static constexpr int kChunk = kThreads * kR;
  int n, q, nchunks, ngroups, count;
  __device__ Items(int n_, int q_, int lanes)
      : n(n_), q(q_), nchunks((n_ + kChunk - 1) / kChunk),
        ngroups((q_ + kCols - 1) / kCols), count(nchunks * ngroups * lanes) {}
  __device__ Item at(int i) const {
    Item it;
    if (i >= count) {
      it.lane = it.col0 = it.nc = 0;
      it.chunk = nchunks;
      it.row0 = static_cast<long long>(nchunks) * kChunk;
      return it;
    }
    it.chunk = i % nchunks;
    const int rest = i / nchunks;
    const int group = ngroups == 1 ? 0 : rest % ngroups;
    it.lane = ngroups == 1 ? rest : rest / ngroups;
    it.col0 = group * kCols;
    it.nc = min(kCols, q - it.col0);
    it.row0 = static_cast<long long>(it.lane) * n +
              static_cast<long long>(it.chunk) * kChunk;
    return it;
  }
  // The item of this thread's slot in the block's round r.
  __device__ Item slot_item(int r) const {
    return at((r * gridDim.x + blockIdx.x) * blockDim.y + threadIdx.y);
  }
  // The rounds of items the block walks (the same in every block).
  __device__ int rounds() const {
    const int per = gridDim.x * blockDim.y;
    return (count + per - 1) / per;
  }
  // Whether the thread's k-th row of the item lies inside the lane.
  __device__ bool live(const Item& it, int k) const {
    return static_cast<long long>(it.chunk) * kChunk + k * kThreads +
               threadIdx.x < n;
  }
  // The element offset of the thread's k-th row of the item, column col0.
  __device__ long long off(const Item& it, int k) const {
    return (it.row0 + k * kThreads + threadIdx.x) * q + it.col0;
  }
};

// One row's kCols columns from a + off: a 16-byte load (two in float64) in
// the vector case, else nc element loads; 0 past nc.
template <typename T, bool kVec>
__device__ __forceinline__ void load_row(const T* __restrict__ a,
                                         long long off, int nc,
                                         T (&v)[kCols]) {
  if constexpr (kVec && sizeof(T) == 4) {
    const float4 x = *reinterpret_cast<const float4*>(a + off);
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
  } else if constexpr (kVec) {
    const double2 x = *reinterpret_cast<const double2*>(a + off);
    const double2 y = *reinterpret_cast<const double2*>(a + off + 2);
    v[0] = x.x;
    v[1] = x.y;
    v[2] = y.x;
    v[3] = y.y;
  } else {
#pragma unroll
    for (int j = 0; j < kCols; ++j) v[j] = j < nc ? a[off + j] : T(0);
  }
}

template <typename T, bool kVec>
__device__ __forceinline__ void store_row(T* __restrict__ a, long long off,
                                          int nc, const T (&v)[kCols]) {
  if constexpr (kVec && sizeof(T) == 4) {
    *reinterpret_cast<float4*>(a + off) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (kVec) {
    *reinterpret_cast<double2*>(a + off) = make_double2(v[0], v[1]);
    *reinterpret_cast<double2*>(a + off + 2) = make_double2(v[2], v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      if (j < nc) a[off + j] = v[j];
  }
}

// The item's rows of a (kR of the thread's), all loads issued together;
// rows past the lane are 0.
template <typename T, bool kVec, int kR>
__device__ __forceinline__ void load_rows(const T* __restrict__ a,
                                          const Items<kR>& g, const Item& it,
                                          T (&v)[kR][kCols]) {
#pragma unroll
  for (int k = 0; k < kR; ++k) {
    if (g.live(it, k)) {
      load_row<T, kVec>(a, g.off(it, k), it.nc, v[k]);
    } else {
#pragma unroll
      for (int j = 0; j < kCols; ++j) v[k][j] = T(0);
    }
  }
}

template <typename T, bool kVec, int kR>
__device__ __forceinline__ void store_rows(T* __restrict__ a,
                                           const Items<kR>& g, const Item& it,
                                           const T (&v)[kR][kCols]) {
#pragma unroll
  for (int k = 0; k < kR; ++k)
    if (g.live(it, k)) store_row<T, kVec>(a, g.off(it, k), it.nc, v[k]);
}

// The column means sum / n of the item's columns, rounded to T (a tensor's
// mean in T); 0 past nc or without sums.
template <typename T, int kR>
__device__ __forceinline__ void means_of(const double* __restrict__ sum,
                                         const Items<kR>& g, const Item& it,
                                         T (&m)[kCols]) {
#pragma unroll
  for (int j = 0; j < kCols; ++j)
    m[j] = sum != nullptr && j < it.nc
               ? static_cast<T>(sum[static_cast<long long>(it.lane) * g.q +
                                    it.col0 + j] /
                                static_cast<double>(g.n))
               : T(0);
}

// s[j] += the thread's rows of v, in row order (rows past the lane left
// out), in float64.
template <typename T, int kR>
__device__ __forceinline__ void add_rows(const Items<kR>& g, const Item& it,
                                         const T (&v)[kR][kCols],
                                         double (&s)[kCols]) {
#pragma unroll
  for (int k = 0; k < kR; ++k)
    if (g.live(it, k)) {
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[j] += static_cast<double>(v[k][j]);
    }
}

// A warp's sums of N values a lane (N a power of 2 up to 32): each
// exchange at offset 16, 8, ... sends the half of its values that the
// partner keeps, so the values a lane holds halve, then the plain butterfly
// over the offsets left. Every value is added in the tree of the butterfly
// 16, 8, 4, 2, 1 (the same bits); lane c * (32 / N) returns value c's sum.
template <int N>
__device__ __forceinline__ double warp_sums(double (&v)[N]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 16, h = N / 2; h >= 1; off >>= 1, h >>= 1) {
    const bool upper = (lane & off) != 0;
#pragma unroll
    for (int c = 0; c < h; ++c) {
      const double send = upper ? v[c] : v[c + h];
      const double keep = upper ? v[c + h] : v[c];
      v[c] = keep + __shfl_xor_sync(kFull, send, off);
    }
  }
#pragma unroll
  for (int off = 16 / N; off > 0; off >>= 1)
    v[0] += __shfl_xor_sync(kFull, v[0], off);
  return v[0];
}

// The block's partials of kS sets of column sums of its slots' items, from
// each thread's sums s: the warp sums, the warps through shared memory,
// then in each slot thread (u, j) adds the slot's warps in index order into
// base[u * set + (lane q + col0 + j) * nchunks + chunk]. `again`: an earlier
// round of this block used the shared memory.
template <int kS, int kR>
__device__ void block_partials(double (&s)[kS][kCols], double* base, int set,
                               const Items<kR>& g, const Item& it,
                               bool again) {
  constexpr int N = kS * kCols;
  __shared__ double ws[kMaxSlots][N][kWarps];
  const int lane = threadIdx.x & 31;
  double v[N];
#pragma unroll
  for (int u = 0; u < kS; ++u)
#pragma unroll
    for (int j = 0; j < kCols; ++j) v[u * kCols + j] = s[u][j];
  const double got = warp_sums<N>(v);
  if (again) __syncthreads();
  if (lane % (32 / N) == 0)
    ws[threadIdx.y][lane / (32 / N)][threadIdx.x >> 5] = got;
  __syncthreads();
  if (threadIdx.x < N) {
    const int u = threadIdx.x / kCols;
    const int j = threadIdx.x % kCols;
    if (j < it.nc) {
      double acc = 0.0;
#pragma unroll
      for (int k = 0; k < kWarps; ++k) acc += ws[threadIdx.y][threadIdx.x][k];
      base[u * set + (it.lane * g.q + it.col0 + j) * g.nchunks + it.chunk] =
          acc;
    }
  }
}

// True in the block that takes the last of `total` tickets of the counter
// (which that block resets). Thread 0 takes the ticket after the block's
// barrier by one acquire-release atomic: the block's writes before it (the
// partials) are visible to the block that takes the last ticket, whose
// reads after it see every block's.
__device__ bool last_ticket(unsigned* ticket, unsigned total) {
  __shared__ bool last;
  __syncthreads();
  if (flat_thread() == 0) last = add_acq_rel(ticket, 1u) == total - 1;
  __syncthreads();
  return last;
}

// Every block of the (cooperative) grid waits here until all have arrived;
// their writes before it are visible after it. bar's top bit flips once
// all nblocks have added (block 0 adds 2^31 - (nblocks - 1), the others 1),
// so the word needs no reset between launches.
__device__ void grid_barrier(unsigned* bar, unsigned nblocks) {
  __syncthreads();
  if (flat_thread() == 0) {
    const unsigned add = blockIdx.x == 0 ? 0x80000000u - (nblocks - 1) : 1u;
    const unsigned old = add_acq_rel(bar, add);
    long long polls = 0;
    while (((old ^ ld_acquire(bar)) & 0x80000000u) == 0)
      if (++polls > kMaxPolls) __trap();
  }
  __syncthreads();
}

// The sum of p[0 .. nchunks) in the fixed order (lane l adds p[l], p[l +
// 32], ... in order, then the butterfly), in every lane of the calling
// warp; kSumLoads loads a lane at once.
__device__ double column_sum(const double* p, int nchunks) {
  const int lane = threadIdx.x & 31;
  double acc = 0.0;
  for (int k0 = 0; k0 < nchunks; k0 += 32 * kSumLoads) {
    double v[kSumLoads];
#pragma unroll
    for (int u = 0; u < kSumLoads; ++u) {
      const int k = k0 + lane + 32 * u;
      v[u] = k < nchunks ? __ldcg(p + k) : 0.0;
    }
#pragma unroll
    for (int u = 0; u < kSumLoads; ++u)
      if (k0 + lane + 32 * u < nchunks) acc += v[u];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(kFull, acc, off);
  return acc;
}

// In the last block: out[c] = the sum of part[c nchunks + k] over the items
// k, for c < count, a warp a column (warp w: columns w, w + warps, ...):
// lane l adds k = l, l + 32, ... in order, then the butterfly. A warp with
// one column takes column_sum's lean loop; with more, its loads go
// kSumLoads a lane at once across its columns (the general form's
// bookkeeping is slower where one column would do: PERF.md section 6).
// With rz, also rz[c] = out[c] rounded to T for c < rzcount.
template <typename T>
__device__ void finish_sums(const double* part, double* out, int count,
                            int nchunks, T* rz, int rzcount) {
  const int lane = threadIdx.x & 31;
  const int w = flat_thread() >> 5;
  const int nw = blockDim.x * blockDim.y >> 5;
  if (count <= nw) {  // a column a warp at most: column_sum's lean loads
    if (w < count) {
      const double acc = column_sum(part + w * nchunks, nchunks);
      if (lane == 0) {
        out[w] = acc;
        if (rz != nullptr && w < rzcount) rz[w] = static_cast<T>(acc);
      }
    }
    return;
  }
  const int m = (nchunks + 31) >> 5;  // partials a lane, per column
  const int ncw = (count - w + nw - 1) / nw;
  // Flat load e = j m + i: column w + j nw, partial lane + 32 i.
  int j0 = 0, i0 = 0;
  double acc = 0.0;
  for (int e0 = 0; e0 < ncw * m; e0 += kSumLoads) {
    double v[kSumLoads];
    int j = j0, i = i0;
#pragma unroll
    for (int u = 0; u < kSumLoads; ++u) {
      const int k = lane + 32 * i;
      v[u] = j < ncw && k < nchunks
                 ? __ldcg(part + (w + j * nw) * nchunks + k)
                 : 0.0;
      if (++i == m) {
        i = 0;
        ++j;
      }
    }
    j = j0;
    i = i0;
#pragma unroll
    for (int u = 0; u < kSumLoads; ++u) {
      if (j < ncw) {
        if (i == 0) acc = 0.0;
        if (lane + 32 * i < nchunks) acc += v[u];
        if (i == m - 1) {
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            acc += __shfl_xor_sync(kFull, acc, off);
          const int c = w + j * nw;
          if (lane == 0) {
            out[c] = acc;
            if (rz != nullptr && c < rzcount) rz[c] = static_cast<T>(acc);
          }
        }
      }
      if (++i == m) {
        i = 0;
        ++j;
      }
    }
    j0 = j;
    i0 = i;
  }
}

template <typename T, bool kVec, int kR>
__global__ void __launch_bounds__(kThreads* kMaxSlots)
k6_colsum(const T* __restrict__ A, const T* __restrict__ M,
          const double* __restrict__ msum, int n, int q, int lanes, int mode,
          double* part, double* out, unsigned* ticket) {
  const Items<kR> g(n, q, lanes);
  for (int r = 0; r < g.rounds(); ++r) {
    const Item it = g.slot_item(r);
    T a[kR][kCols], b[kR][kCols], mean[kCols];
    load_rows<T, kVec, kR>(A, g, it, a);
    if (mode != kSumA) load_rows<T, kVec, kR>(M, g, it, b);
    means_of<T, kR>(mode == kDotAMc ? msum : nullptr, g, it, mean);
    if (mode != kSumA) {
#pragma unroll
      for (int k = 0; k < kR; ++k)
#pragma unroll
        for (int j = 0; j < kCols; ++j)
          a[k][j] = mul_rn(a[k][j], b[k][j] - mean[j]);
    }
    double s[1][kCols] = {};
    add_rows<T, kR>(g, it, a, s[0]);
    block_partials<1, kR>(s, part, 0, g, it, r > 0);
  }
  if (last_ticket(ticket, gridDim.x)) {
    finish_sums<T>(part, out, lanes * q, g.nchunks, nullptr, 0);
    if (flat_thread() == 0) *ticket = 0u;
  }
}

template <typename T, bool kVec, int kR>
__global__ void __launch_bounds__(kThreads* kMaxSlots)
k6_update(T* __restrict__ X, T* __restrict__ R, const T* __restrict__ P,
          const T* __restrict__ AP, const T* __restrict__ rz,
          const double* __restrict__ pap, int n, int q, int lanes,
          double* part, double* rsum, unsigned* ticket) {
  const Items<kR> g(n, q, lanes);
  for (int r = 0; r < g.rounds(); ++r) {
    const Item it = g.slot_item(r);
    T x[kR][kCols], rr[kR][kCols], p[kR][kCols], ap[kR][kCols], alpha[kCols];
    const int lc = it.lane * q + it.col0;
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      alpha[j] = j < it.nc ? safe_div(rz[lc + j], static_cast<T>(pap[lc + j]))
                           : T(0);
    // R and AP first: R's sums wait on them alone.
    load_rows<T, kVec, kR>(R, g, it, rr);
    load_rows<T, kVec, kR>(AP, g, it, ap);
    load_rows<T, kVec, kR>(X, g, it, x);
    load_rows<T, kVec, kR>(P, g, it, p);
#pragma unroll
    for (int k = 0; k < kR; ++k)
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        x[k][j] = add_rn(x[k][j], mul_rn(alpha[j], p[k][j]));
        rr[k][j] = rr[k][j] - mul_rn(alpha[j], ap[k][j]);
      }
    store_rows<T, kVec, kR>(X, g, it, x);
    store_rows<T, kVec, kR>(R, g, it, rr);
    if (rsum != nullptr) {
      double s[1][kCols] = {};
      add_rows<T, kR>(g, it, rr, s[0]);
      block_partials<1, kR>(s, part, 0, g, it, r > 0);
    }
  }
  if (rsum == nullptr) return;
  if (last_ticket(ticket, gridDim.x)) {
    finish_sums<T>(part, rsum, lanes * q, g.nchunks, nullptr, 0);
    if (flat_thread() == 0) *ticket = 0u;
  }
}

// out: rz_new (lanes q), then P's sums (lanes q); part: the dots' partials
// (lanes q nchunks), then P's. Launched cooperatively (every block
// resident): unless init, the blocks meet at a grid barrier on `bar` once
// the dots' partials are written.
template <typename T, bool kVec, int kR>
__global__ void __launch_bounds__(kThreads* kMaxSlots)
k6_direction_dots(T* __restrict__ P, const T* __restrict__ R,
                  const T* __restrict__ Z, const double* __restrict__ zsum,
                  T* rz, int init, int n, int q, int lanes, double* part,
                  double* out, int psums, unsigned* ticket, unsigned* bar) {
  __shared__ double rzn[kMaxSlots][kCols];
  const Items<kR> g(n, q, lanes);
  const int count = lanes * q;
  const int set = count * g.nchunks;
  const int rounds = g.rounds();
  // The first round's centred Z, P and old rz stay in registers for the
  // second half.
  T zc[kR][kCols], pc[kR][kCols], rz0[kCols];
  for (int r = 0; r < rounds; ++r) {
    const Item it = g.slot_item(r);
    const int lc = it.lane * q + it.col0;
    T rr[kR][kCols], z[kR][kCols], mean[kCols];
    load_rows<T, kVec, kR>(R, g, it, rr);
    load_rows<T, kVec, kR>(Z, g, it, z);
    if (!init && r == 0) {
      load_rows<T, kVec, kR>(P, g, it, pc);
#pragma unroll
      for (int j = 0; j < kCols; ++j) rz0[j] = j < it.nc ? rz[lc + j] : T(1);
    }
    means_of<T, kR>(zsum, g, it, mean);
#pragma unroll
    for (int k = 0; k < kR; ++k)
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        z[k][j] = z[k][j] - mean[j];
        rr[k][j] = mul_rn(rr[k][j], z[k][j]);
      }
    if (r == 0 && !init) {
#pragma unroll
      for (int k = 0; k < kR; ++k)
#pragma unroll
        for (int j = 0; j < kCols; ++j) zc[k][j] = z[k][j];
    }
    if (init) {
      store_rows<T, kVec, kR>(P, g, it, z);
      if (psums) {
        double s[2][kCols] = {};
        add_rows<T, kR>(g, it, rr, s[0]);
        add_rows<T, kR>(g, it, z, s[1]);
        block_partials<2, kR>(s, part, set, g, it, r > 0);
        continue;
      }
    }
    double s[1][kCols] = {};
    add_rows<T, kR>(g, it, rr, s[0]);
    block_partials<1, kR>(s, part, 0, g, it, r > 0);
  }
  if (!init) {
    grid_barrier(bar, gridDim.x);
    for (int r = 0; r < rounds; ++r) {
      const Item it = g.slot_item(r);
      const int lc = it.lane * q + it.col0;
      if (r > 0) {
        T mean[kCols];
        load_rows<T, kVec, kR>(Z, g, it, zc);
        load_rows<T, kVec, kR>(P, g, it, pc);
#pragma unroll
        for (int j = 0; j < kCols; ++j)
          rz0[j] = j < it.nc ? rz[lc + j] : T(1);
        means_of<T, kR>(zsum, g, it, mean);
#pragma unroll
        for (int k = 0; k < kR; ++k)
#pragma unroll
          for (int j = 0; j < kCols; ++j) zc[k][j] = zc[k][j] - mean[j];
        __syncthreads();  // rzn's last round is read
      }
      // rz_new of the item's columns, a warp of the slot a column.
      for (int j = threadIdx.x >> 5; j < it.nc; j += kWarps) {
        const double v = column_sum(part + (lc + j) * g.nchunks, g.nchunks);
        if ((threadIdx.x & 31) == 0) rzn[threadIdx.y][j] = v;
      }
      __syncthreads();
      // Every block has read the old rz: with one round, the slot that
      // holds an item's first chunk writes its columns' rz_new and rz.
      if (rounds == 1 && it.chunk == 0 && threadIdx.x < it.nc) {
        const double v = rzn[threadIdx.y][threadIdx.x];
        out[lc + threadIdx.x] = v;
        rz[lc + threadIdx.x] = static_cast<T>(v);
      }
      T beta[kCols];
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        beta[j] = j < it.nc ? safe_div(static_cast<T>(rzn[threadIdx.y][j]),
                                       rz0[j])
                            : T(0);
#pragma unroll
      for (int k = 0; k < kR; ++k)
#pragma unroll
        for (int j = 0; j < kCols; ++j)
          pc[k][j] = add_rn(zc[k][j], mul_rn(beta[j], pc[k][j]));
      store_rows<T, kVec, kR>(P, g, it, pc);
      if (psums) {
        double s[1][kCols] = {};
        add_rows<T, kR>(g, it, pc, s[0]);
        block_partials<1, kR>(s, part + set, 0, g, it, r > 0);
      }
    }
  }
  // The last block sums P's partials and, unless the blocks wrote them
  // above, rz_new's, and rewrites rz (read by every block above).
  if (last_ticket(ticket, gridDim.x)) {
    if (init || rounds > 1)
      finish_sums<T>(part, out, (psums ? 2 : 1) * count, g.nchunks, rz,
                     count);
    else if (psums)
      finish_sums<T>(part + set, out + count, count, g.nchunks,
                     static_cast<T*>(nullptr), 0);
    if (flat_thread() == 0) *ticket = 0u;
  }
}

// The blocks of `kernel` (`threads` threads, no dynamic shared memory)
// that the current device holds at once: the occupancy query times its
// SMs, asked once per kernel, block size and device. 0 if the query fails.
int resident_blocks(const void* kernel, int threads) {
  struct Entry {
    const void* kernel;
    int threads, device, blocks;
  };
  static Entry table[128];
  static int used = 0;
  int dev = 0, sms = 0, per = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  for (int i = 0; i < used; ++i)
    if (table[i].kernel == kernel && table[i].threads == threads &&
        table[i].device == dev)
      return table[i].blocks;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kernel, threads,
                                                    0) != cudaSuccess)
    return 0;
  if (used < 128) table[used++] = {kernel, threads, dev, sms * per};
  return sms * per;
}

// A launch's shape: kR = 2 rows a thread past kR2Items items of one row
// (fewer, larger items where there are many), a slot an item, one more slot
// a block for every kSlotItems items (up to kMaxSlots), one block for each
// group of slots up to the resident blocks. grid 0 if the query failed or
// the items overflow an int.
struct Shape {
  int rows;  // kR
  dim3 grid, block;
};

long long items_of(int n, int q, int lanes, int rows) {
  const int chunk = kThreads * rows;
  return static_cast<long long>((n + chunk - 1) / chunk) *
         ((q + kCols - 1) / kCols) * lanes;
}

int rows_of(int n, int q, int lanes) {
  return items_of(n, q, lanes, 1) > kR2Items ? 2 : 1;
}

Shape shape_of(const void* kernel, int rows, int n, int q, int lanes) {
  const long long items = items_of(n, q, lanes, rows);
  const long long slots = items / kSlotItems + 1;
  const int per = static_cast<int>(slots < kMaxSlots ? slots : kMaxSlots);
  const int cap = resident_blocks(kernel, kThreads * per);
  const long long blocks = (items + per - 1) / per;
  Shape s;
  s.rows = rows;
  s.block = dim3(kThreads, per);
  s.grid = dim3(items >= (1ll << 31) ? 0
                                     : static_cast<unsigned>(
                                           blocks < cap ? blocks : cap));
  return s;
}

bool aligned(int q, const void* a, const void* b = nullptr,
             const void* c = nullptr, const void* d = nullptr) {
  return q % kCols == 0 &&
         (reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
          reinterpret_cast<uintptr_t>(c) | reinterpret_cast<uintptr_t>(d)) %
                 16 ==
             0;
}

// The instantiation of a kernel template K for (vector loads, rows).
#define K6_PICK(K, T, vec, rows)                                  \
  ((vec) ? ((rows) == 2 ? K<T, true, 2> : K<T, true, 1>)          \
         : ((rows) == 2 ? K<T, false, 2> : K<T, false, 1>))

template <typename T>
int colsum_launch(const T* A, const T* M, const double* msum, int n, int q,
                  int lanes, double* part, double* out, unsigned* ticket,
                  void* stream) {
  if (n <= 0 || q <= 0 || lanes <= 0) return 0;
  const int mode = M == nullptr ? kSumA : msum == nullptr ? kDotAM : kDotAMc;
  const int rows = rows_of(n, q, lanes);
  auto kernel = K6_PICK(k6_colsum, T, aligned(q, A, M), rows);
  const Shape s =
      shape_of(reinterpret_cast<const void*>(kernel), rows, n, q, lanes);
  if (s.grid.x == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  kernel<<<s.grid, s.block, 0, static_cast<cudaStream_t>(stream)>>>(
      A, M, msum, n, q, lanes, mode, part, out, ticket);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int update_launch(T* X, T* R, const T* P, const T* AP, const T* rz,
                  const double* pap, int n, int q, int lanes, double* part,
                  double* rsum, unsigned* ticket, void* stream) {
  if (n <= 0 || q <= 0 || lanes <= 0) return 0;
  const int rows = rows_of(n, q, lanes);
  auto kernel = K6_PICK(k6_update, T, aligned(q, X, R, P, AP), rows);
  const Shape s =
      shape_of(reinterpret_cast<const void*>(kernel), rows, n, q, lanes);
  if (s.grid.x == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  kernel<<<s.grid, s.block, 0, static_cast<cudaStream_t>(stream)>>>(
      X, R, P, AP, rz, pap, n, q, lanes, part, rsum, ticket);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int direction_dots_launch(T* P, const T* R, const T* Z, const double* zsum,
                          T* rz, int init, int n, int q, int lanes,
                          double* part, double* out, int psums,
                          unsigned* ticket, unsigned* bar, void* stream) {
  if (n <= 0 || q <= 0 || lanes <= 0) return 0;
  const int rows = rows_of(n, q, lanes);
  auto kernel = K6_PICK(k6_direction_dots, T, aligned(q, P, R, Z), rows);
  const Shape s =
      shape_of(reinterpret_cast<const void*>(kernel), rows, n, q, lanes);
  if (s.grid.x == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = s.grid;
  cfg.blockDim = s.block;
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute coop[1];
  coop[0].id = cudaLaunchAttributeCooperative;
  coop[0].val.cooperative = 1;
  cfg.attrs = coop;
  cfg.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, kernel, P, R, Z, zsum, rz, init, n, q, lanes,
                         part, out, psums, ticket, bar);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Every array is (lanes, n, q) row-major and contiguous in T (float: _f32,
// double: _f64), every sum (lanes, q) float64; `part` holds lanes * q *
// ceil(n / kThreads) float64 partials (twice that for pcg_direction_dots, whose
// `out` is rz_new then P's sums, 2 * lanes * q); `ticket` one unsigned
// counter at 0, which each launch leaves at 0; `bar` the direction pass's
// barrier word (0 at first; only that kernel touches it). A null pointer
// leaves out what it names. Each returns the launch's cudaError_t (0 on
// success).
#define K6_EXPORTS(T, S)                                                      \
  extern "C" int pcg_colsum_##S(const T* A, const T* M, const double* msum,  \
                                int n, int q, int lanes, double* part,        \
                                double* out, unsigned* ticket,                \
                                void* stream) {                               \
    return colsum_launch<T>(A, M, msum, n, q, lanes, part, out, ticket,       \
                            stream);                                          \
  }                                                                           \
  extern "C" int pcg_update_##S(T* X, T* R, const T* P, const T* AP,          \
                                const T* rz, const double* pap, int n,        \
                                int q, int lanes, double* part,               \
                                double* rsum, unsigned* ticket,               \
                                void* stream) {                               \
    return update_launch<T>(X, R, P, AP, rz, pap, n, q, lanes, part, rsum,    \
                            ticket, stream);                                  \
  }                                                                           \
  extern "C" int pcg_direction_dots_##S(                                      \
      T* P, const T* R, const T* Z, const double* zsum, T* rz, int init,      \
      int n, int q, int lanes, double* part, double* out, int psums,          \
      unsigned* ticket, unsigned* bar, void* stream) {                        \
    return direction_dots_launch<T>(P, R, Z, zsum, rz, init, n, q, lanes,     \
                                    part, out, psums, ticket, bar, stream);   \
  }

K6_EXPORTS(float, f32)
K6_EXPORTS(double, f64)
