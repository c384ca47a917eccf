// Tridiagonal LDL^T solve for an (n, q) block of right-hand sides:
//     L diag(dp) L^T X = B,  L unit lower bidiagonal with subdiagonal l.
// Two kernels: K1, whole rows, and K1b, segment-decoupled (further down);
// and K1p, the V-cycle's smoother with its gathers through the permutation,
// on K1's body for an exact factor and on K1b's for a decoupled one.
// All take R lanes in one launch: B and X (R, n, q), and dp, l either one
// factor per lane (R, n), at a lane stride fstride = n, or one factor that
// every lane shares (n,), fstride = 0. R = 1 is the single solve.
//
// The two substitutions are affine recurrences
//     forward:  y_i = b_i - l_i * y_{i-1}           (y_{-1} = 0)
//     backward: x_i = z_i - l_{i+1} * x_{i+1}       (x_n = 0), z = y / dp
// and affine maps compose as (c2, v2) o (c1, v1) = (c2 c1, v2 + c2 v1).
//
// Both kernels are templates on the element type T and are exported twice:
// float (the *_f32 entry points, the float32 routes) and double (*_f64, the
// float64 routes: the banded operator in float64, the float64 ELL V-cycle,
// GreedyESP's tridiagonal-part solves). The double instantiation is the
// same design with 8-byte elements: K1's shared-memory tile holds half the
// rows, K1b moves a row of four values as two 16-byte halves, and its
// pivots' reciprocals are correctly rounded.

#include <cooperative_groups.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFullMask = 0xffffffffu;

// Inclusive scan of affine maps across the 32 lanes of a warp.
// reverse = false: lane i ends with map_i o ... o map_0;
// reverse = true:  lane i ends with map_i o ... o map_31.
// T is float or double (a double shuffle is two 32-bit shuffles).
template <typename T>
__device__ __forceinline__ void warp_scan_maps(T& c, T& v, int lane,
                                               bool reverse) {
#pragma unroll
  for (int k = 1; k < 32; k <<= 1) {
    const T pc = reverse ? __shfl_down_sync(kFullMask, c, k)
                         : __shfl_up_sync(kFullMask, c, k);
    const T pv = reverse ? __shfl_down_sync(kFullMask, v, k)
                         : __shfl_up_sync(kFullMask, v, k);
    const bool valid = reverse ? (lane + k < 32) : (lane >= k);
    if (valid) {
      v = v + c * pv;
      c = c * pc;
    }
  }
}

// The same scan over lanes cut into segments of `seg` lanes: a lane
// composes only the maps of its own segment.
template <typename T>
__device__ __forceinline__ void warp_scan_maps_segmented(T& c, T& v, int lane,
                                                         int seg,
                                                         bool reverse) {
  const int s0 = (lane / seg) * seg;
  const int s1 = s0 + seg - 1;
#pragma unroll
  for (int k = 1; k < 32; k <<= 1) {
    const T pc = reverse ? __shfl_down_sync(kFullMask, c, k)
                         : __shfl_up_sync(kFullMask, c, k);
    const T pv = reverse ? __shfl_down_sync(kFullMask, v, k)
                         : __shfl_up_sync(kFullMask, v, k);
    const bool valid = reverse ? (lane + k <= s1) : (lane - k >= s0);
    if (valid) {
      v = v + c * pv;
      c = c * pc;
    }
  }
}

// Four consecutive values of a row: a float4 (16 bytes), or for double two
// 16-byte halves (32 bytes, moved as two 16-byte loads or stores).
struct alignas(16) Double4 {
  double x, y, z, w;
};
template <typename T>
struct Vec4;
template <>
struct Vec4<float> {
  using type = float4;
};
template <>
struct Vec4<double> {
  using type = Double4;
};
template <typename T>
__device__ __forceinline__ typename Vec4<T>::type vec4(T x, T y, T z, T w) {
  typename Vec4<T>::type v;
  v.x = x;
  v.y = y;
  v.z = z;
  v.w = w;
  return v;
}

// ---------------------------------------------------------------------------
// K1: the whole-row solve.
//
// Replaces the TPU kernel mac_tpu/ops/pallas/tridiag_kernel.py
// (_tridiag_kernel through tridiag_solve_fused): the odometry-chain smoother
// of the banded two-level preconditioner, called twice per preconditioned
// CG step of every eigensolver outer iteration (640 launches per city10000
// solve, at n = 10000, q = 4), and every exact factor at any n.
//
// What bounds it on the H100: latency. At (10000, 4) the solve moves
// 0.4 MB (0.12 us at 3.35 TB/s); what costs is the chain of dependent
// steps -- scans, barriers, the hand-off between blocks -- and the
// instructions every thread issues whatever its share of rows. The first
// port (one 1024-thread block per column, Hillis-Steele scans with 20
// __syncthreads(), B read at a stride of q, z through device memory) ran
// on 4 of 132 SMs: 0.0369 ms of device time at (10000, 4).
//
// The design: one thread-block cluster of 16 blocks of 256 threads
// (distributed shared memory joins them; 16 is a non-portable cluster
// size, which the H100 schedules). Block k owns the contiguous rows
// [k span, (k + 1) span) for all q columns. Its slice of B, dp and l
// arrive in shared memory by cp.async, all in flight at once, B
// transposed to columns at an odd stride so that the lanes of a warp,
// each walking its own odd-length chunk of rows, hit distinct banks. Each
// column has P threads: a thread composes the affine map of its chunk, a
// warp-shuffle scan and a segmented shuffle scan of the warp totals give
// each thread the map from the tile's start to its chunk, and the thread
// keeps that map in shared memory. Across the cluster each block
// publishes its total map per column; after a cluster barrier each block
// fetches the totals of the blocks before it (forward) or after it
// (backward) through map_shared_rank in one round and composes them. Each
// thread then re-sweeps its chunk once from the incoming value. z stays in
// shared memory between the substitutions and X is written once: device
// traffic is the bound's own bytes. Where a block's rows do not fit its
// shared memory (an exact factor at (33000, 40) or (100000, 4)), the block
// walks tiles of its rows in two passes per substitution (compose, then
// apply), z going through X. Columns run in passes of up to 8 per block
// (256 threads), and blocks wider than 128 columns in launches of 128. The
// coupling coefficients are read as given (l_0 is never read, the last
// row's backward coefficient is 0), so the kernel does not rely on zero
// couplings. Measured (kernel_ab.py, NVIDIA H100 80GB HBM3 at 700 W):
// 0.0107 ms of device time at (10000, 4) against 0.0369 ms for the first
// port in the same process. The time tracks the instructions each SM
// issues, so a tuning run picked 256 threads in 16 blocks over 128 or 512
// threads in 8 or 16; a later sweep edits the two constants below.
//
// Lanes (the budget sweep's R factors, GreedyEig's shared factor on a wide
// block): one launch holds a cluster for every (column group, lane) pair,
// side by side in the grid (16, groups, R), so clusters that used to run
// one launch after another now run together on the card's SMs.

constexpr int kCluster = 16;            // blocks per cluster (non-portable)
constexpr int kK1Threads = 256;         // threads per block
constexpr int kSmemBytes = 200 * 1024;  // dynamic shared memory cap
constexpr int kMaxQ = 128;              // columns per launch
// K1p's shared memory beyond K1's cap: its column sums' kK1Threads + kMaxQ
// doubles ahead of K1's layout, and its means (kMaxQ elements) after it.
constexpr int kPermHeadBytes = (kK1Threads + kMaxQ) * 8;
constexpr int kPermExtraBytes = kPermHeadBytes + kMaxQ * 8;

// Block-wide transposing copies between a (rows x q) run of device memory
// at row stride ld (coalesced) and the tile in shared memory, column-major
// at column stride lds. lds is odd, and so is a thread's chunk of rows ch,
// so the 32 lanes of a warp, walking rows ch apart, hit 32 distinct banks.
// tile_in issues asynchronous copies (cp.async), all in flight at once;
// the caller waits for them.
// Thread t walks the elements t, t + blockDim, ... of the row-major run,
// as (row, column) pairs stepped without a division per element.
struct RowWalk {
  int r, c, dr, dc, q;
  __device__ RowWalk(int q_) : q(q_) {
    r = threadIdx.x / q;
    c = threadIdx.x - r * q;
    dr = blockDim.x / q;
    dc = blockDim.x - dr * q;
  }
  __device__ void next() {
    r += dr;
    c += dc;
    if (c >= q) {
      c -= q;
      ++r;
    }
  }
};

template <typename T>
__device__ __forceinline__ void tile_in(T* s, int lds, const T* g, int ld,
                                        int rows, int q) {
  for (RowWalk e(q); e.r < rows; e.next())
    __pipeline_memcpy_async(s + e.c * lds + e.r,
                            g + (long long)e.r * ld + e.c, sizeof(T));
}

template <typename T>
__device__ __forceinline__ void tile_out(T* g, int ld, const T* s, int lds,
                                         int rows, int q) {
  for (RowWalk e(q); e.r < rows; e.next())
    g[(long long)e.r * ld + e.c] = s[e.c * lds + e.r];
}

// Per-block layout of the column passes: P threads per column (a multiple
// of 32), cpp columns per pass, npass passes.
struct Columns {
  int P, cpp, npass;
};

// The maps of one substitution over the tile of `rows` rows in shared
// memory (global rows g0 + i; column col at sB + col * lds), for every
// column:
//   forward:  y_i = b_i + cf_i y_{i-1}, cf_i = -l[g0 + i] (0 at row 0);
//   backward: x_i = z_i + cb_i x_{i+1}, cb_i = -l[g0 + i + 1] (0 at row
//             n - 1).
// sl[i] = l[g0 + i] for i in [0, rows] (sl[rows] past n is never read).
// Thread t's chunk of rows gets in (xc, xv)[pass * blockDim + t] the map
// from the value entering the tile (forward: y before its first row;
// backward: x after its last row) to the value entering the chunk;
// (tc, tv)[col] get the tile's total map; and when acc_c is not null the
// total is composed into (acc_c, acc_v): forward acc = tile o acc, backward
// acc = acc o tile (tiles are walked first to last).
template <typename T, bool kForward>
__device__ void tile_compose(const T* sB, int lds, const T* sl, int rows,
                             long long g0, int n, int q, Columns cols, T* xc,
                             T* xv, T* tc, T* tv, T* acc_c, T* acc_v, T* wc,
                             T* wv) {
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int w = t >> 5;
  const int nw = blockDim.x >> 5;
  const int j = t / cols.P;
  const int p = t - j * cols.P;
  const int wpc = cols.P >> 5;                   // warps per column
  const int seg0 = (w / wpc) * wpc;              // the column's first warp
  const int ch = ((rows + cols.P - 1) / cols.P) | 1;  // rows per thread
  const int lo = min(rows, p * ch);
  const int hi = min(rows, lo + ch);
  for (int pass = 0; pass < cols.npass; ++pass) {
    const int col = pass * cols.cpp + j;
    const bool live = j < cols.cpp && col < q;   // uniform across a warp
    T c = T(1), v = T(0);
    if (live) {
      if (kForward) {
        for (int i = lo; i < hi; ++i) {
          const T cf = (g0 + i == 0) ? T(0) : -sl[i];
          v = sB[col * lds + i] + cf * v;
          c = cf * c;
        }
      } else {
        for (int i = hi - 1; i >= lo; --i) {
          const T cb = (g0 + i == n - 1) ? T(0) : -sl[i + 1];
          v = sB[col * lds + i] + cb * v;
          c = cb * c;
        }
      }
    }
    warp_scan_maps(c, v, lane, !kForward);
    // The lanes before this one (in the substitution's order) within the
    // warp: the neighbour's inclusive map.
    T nc = kForward ? __shfl_up_sync(kFullMask, c, 1)
                        : __shfl_down_sync(kFullMask, c, 1);
    T nv = kForward ? __shfl_up_sync(kFullMask, v, 1)
                        : __shfl_down_sync(kFullMask, v, 1);
    if (lane == (kForward ? 0 : 31)) {
      nc = T(1);
      nv = T(0);
    }
    if (lane == (kForward ? 31 : 0)) {
      wc[w] = c;
      wv[w] = v;
    }
    __syncthreads();
    if (w == 0) {
      T sc = lane < nw ? wc[lane] : T(1);
      T sv = lane < nw ? wv[lane] : T(0);
      warp_scan_maps_segmented(sc, sv, lane, wpc, !kForward);
      if (lane < nw) {
        wc[lane] = sc;
        wv[lane] = sv;
      }
    }
    __syncthreads();
    if (live) {
      // The warps before this one within the column.
      const bool first = kForward ? (w == seg0) : (w == seg0 + wpc - 1);
      const T pc = first ? T(1) : wc[kForward ? w - 1 : w + 1];
      const T pv = first ? T(0) : wv[kForward ? w - 1 : w + 1];
      xc[pass * blockDim.x + t] = nc * pc;
      xv[pass * blockDim.x + t] = nv + nc * pv;
      if (p == 0) {
        const int tw = kForward ? seg0 + wpc - 1 : seg0;
        const T ttc = wc[tw], ttv = wv[tw];
        tc[col] = ttc;
        tv[col] = ttv;
        if (acc_c != nullptr) {
          if (kForward) {
            acc_v[col] = ttv + ttc * acc_v[col];
            acc_c[col] = ttc * acc_c[col];
          } else {
            acc_v[col] = acc_v[col] + acc_c[col] * ttv;
            acc_c[col] = acc_c[col] * ttc;
          }
        }
      }
    }
    __syncthreads();  // wc and wv are free for the next pass
  }
}

// Re-sweeps each thread's chunk from carry[col], the value entering the
// tile, through the map tile_compose left in (xc, xv): forward writes
// z_i = y_i / dp_i over b_i, backward x_i over z_i. No barrier.
template <typename T, bool kForward>
__device__ void tile_apply(T* sB, int lds, const T* sdp, const T* sl,
                           int rows, long long g0, int n, int q, Columns cols,
                           const T* xc, const T* xv, const T* carry) {
  const int t = threadIdx.x;
  const int j = t / cols.P;
  const int p = t - j * cols.P;
  const int ch = ((rows + cols.P - 1) / cols.P) | 1;
  const int lo = min(rows, p * ch);
  const int hi = min(rows, lo + ch);
  for (int pass = 0; pass < cols.npass; ++pass) {
    const int col = pass * cols.cpp + j;
    if (j >= cols.cpp || col >= q) continue;
    const int m = pass * blockDim.x + t;
    T x = xv[m] + xc[m] * carry[col];
    if (kForward) {
      for (int i = lo; i < hi; ++i) {
        const T cf = (g0 + i == 0) ? T(0) : -sl[i];
        x = sB[col * lds + i] + cf * x;
        sB[col * lds + i] = x / sdp[i];
      }
    } else {
      for (int i = hi - 1; i >= lo; --i) {
        const T cb = (g0 + i == n - 1) ? T(0) : -sl[i + 1];
        x = sB[col * lds + i] + cb * x;
        sB[col * lds + i] = x;
      }
    }
  }
}

// The value entering this block, per column, from the other blocks' total
// maps (tot_c, tot_v) in distributed shared memory: forward composes
// blocks 0 .. rank - 1 in order onto y_{-1} = 0, backward blocks
// nblk - 1 .. rank + 1 onto x_n = 0. The remote values come over in one
// round into (gc, gv), then each column composes them locally.
// The backward exchange, the last remote read, then arrives at the cluster
// barrier that the kernel waits on before it exits (no block may leave
// while another reads its shared memory), so that barrier's latency hides
// behind the backward substitution.
template <typename T, bool kForward>
__device__ void exchange(cg::cluster_group& cluster, T* tot_c, T* tot_v,
                         T* gc, T* gv, T* carry, int q) {
  cluster.sync();
  const int rank = static_cast<int>(cluster.block_rank());
  const int nblk = static_cast<int>(cluster.num_blocks());
  for (int i = threadIdx.x; i < nblk * q; i += blockDim.x) {
    const int k = i / q;
    if (kForward ? k < rank : k > rank) {
      gc[i] = cluster.map_shared_rank(tot_c, k)[i - k * q];
      gv[i] = cluster.map_shared_rank(tot_v, k)[i - k * q];
    }
  }
  if (!kForward)
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  __syncthreads();
  for (int col = threadIdx.x; col < q; col += blockDim.x) {
    T x = T(0);
    if (kForward) {
      for (int k = 0; k < rank; ++k)
        x = gv[k * q + col] + gc[k * q + col] * x;
    } else {
      for (int k = nblk - 1; k > rank; --k)
        x = gv[k * q + col] + gc[k * q + col] * x;
    }
    carry[col] = x;
  }
  __syncthreads();
}

// K1p, K1's permuted entry: the V-cycle's smoother in the original node
// order of B and X held in the operator's (RCM) order. Row j of the chain
// is row iperm[j] of B and of X: the solve loads B[iperm[j]] less B's
// column mean (the cycle's centring, from bsum) and stores x_j to
// X[iperm[j]], or adds it there (`add`); then X's column sums (float64,
// fixed order: per block, then the block that takes the last ticket sums
// the blocks' partials in block order) go to osum. Two bodies, by the
// factor:
//   cluster (an exact factor: sphere2500's, every banded graph of at most
//     4096 nodes): K1's body (kPerm = true; K1's instantiation compiles none
//     of this), each thread moving whole rows of B and X through iperm (a
//     16-byte load a row at q = 4 float32). The rows do not fit shared
//     memory past K1's whole-row limit: z goes through the natural-order
//     scratch Z. Bitwise K1 on the gathered input.
//   segment (a factor decoupled every `seg` rows, the blocked LDL^T of
//     every banded graph past 4096 nodes): K1b's body, further down.
// Whether this block took the last of `total` tickets of the counter (left
// at 0 again by the caller): every write before it of the threads that
// pass `wrote` is visible to the block that did.
__device__ bool last_ticket(unsigned* ticket, unsigned total,
                            bool wrote = true) {
  __shared__ bool last;
  if (wrote) __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == total - 1;
  __syncthreads();
  if (last) __threadfence();
  return last;
}

template <typename T>
struct PermArgs {
  const int* iperm;    // (n,) original row -> row of B and X
  const double* bsum;  // (lanes, ld) B's column sums to centre by, or null
  T* Z;                // (lanes, n, ld) scratch of the cluster body's tiles
  int add;             // X[iperm[j]] += x_j
  double* part;        // (lanes, ld, blocks) X's column sums per block, or null
  double* osum;        // (lanes, ld) their totals
  unsigned* ticket;    // one counter at 0, left at 0
};

// B and X hold R lanes of (n, ld); the cluster at (blockIdx.y, blockIdx.z)
// solves the column group of up to kMaxQ columns starting at column
// kMaxQ * blockIdx.y of lane blockIdx.z, whose factor starts fstride
// elements into dp and l per lane. T is float or double.
template <typename T, bool kPerm>
__global__ void __launch_bounds__(kK1Threads)
tridiag_solve_kernel(const T* __restrict__ dp, const T* __restrict__ l,
                     const T* __restrict__ B, T* X, int n, int ld,
                     int span, int tile_rows, long long fstride,
                     PermArgs<T> pa) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // K1p: kK1Threads + kMaxQ doubles for its column sums, and the means.
  double* red = reinterpret_cast<double*>(smem_raw);
  double* bacc = red + kK1Threads;
  T* smem = reinterpret_cast<T*>(kPerm ? smem_raw + kPermHeadBytes
                                       : smem_raw);
  cg::cluster_group cluster = cg::this_cluster();
  const int j0 = kMaxQ * static_cast<int>(blockIdx.y);
  const int q = min(kMaxQ, ld - j0);  // this cluster's columns
  const long long lane = blockIdx.z;
  dp += lane * fstride;
  l += lane * fstride;
  B += lane * n * ld + j0;
  X += lane * n * ld + j0;
  T* zbuf = X;  // z between the substitutions in the tiled branch
  using V4 = typename Vec4<T>::type;
  // K1p moves a row's columns four at a time where every row of B and X
  // starts 16-byte aligned.
  const bool rowvec =
      kPerm && ld % 4 == 0 &&
      ((reinterpret_cast<uintptr_t>(B) | reinterpret_cast<uintptr_t>(X)) % 16)
          == 0;
  if (kPerm) {
    if (pa.Z != nullptr) {
      pa.Z += lane * n * ld + j0;
      zbuf = pa.Z;
    }
    if (pa.bsum != nullptr) pa.bsum += lane * ld + j0;
  }
  const int rank = static_cast<int>(cluster.block_rank());
  const int t = threadIdx.x;
  const int nw = blockDim.x >> 5;
  Columns cols;
  cols.cpp = min(q, nw);
  cols.P = (nw / cols.cpp) * 32;
  cols.npass = (q + cols.cpp - 1) / cols.cpp;

  const int lds = tile_rows + 1;                     // odd
  T* sB = smem;                              // q * lds
  T* sdp = sB + q * lds;                     // tile_rows
  T* sl = sdp + tile_rows;                   // tile_rows + 1
  T* wc = sl + tile_rows + 1;                // 32
  T* wv = wc + 32;                           // 32
  T* xc = wv + 32;                           // npass * blockDim
  T* xv = xc + cols.npass * blockDim.x;      // npass * blockDim
  T* tc = xv + cols.npass * blockDim.x;      // q each below
  T* tv = tc + q;
  T* carry = tv + q;
  T* fc = carry + q;                         // forward totals
  T* fv = fc + q;
  T* bc = fv + q;                            // backward totals
  T* bv = bc + q;
  T* gc = bv + q;                            // nblk * q each
  T* gv = gc + cluster.num_blocks() * q;
  T* smean = gv + cluster.num_blocks() * q;  // K1p: q

  const long long r0 = min((long long)rank * span, (long long)n);
  const long long r1 = min(r0 + span, (long long)n);
  const int rows = static_cast<int>(r1 - r0);
  const int ntiles = (rows + tile_rows - 1) / tile_rows;
  const bool resident = ntiles <= 1;  // the tile stays in shared memory

  for (int i = t; i < q; i += blockDim.x) {
    fc[i] = T(1);
    fv[i] = T(0);
    bc[i] = T(1);
    bv[i] = T(0);
    if (kPerm) {
      smean[i] = pa.bsum != nullptr
                     ? static_cast<T>(pa.bsum[i] / static_cast<double>(n))
                     : T(0);
      bacc[i] = 0.0;
    }
  }
  if (kPerm) __syncthreads();
  auto start = [&](int k) { return r0 + (long long)k * tile_rows; };
  auto len = [&](int k) {
    return static_cast<int>(min((long long)tile_rows, r1 - start(k)));
  };
  // Tile k into shared memory: `src` (B, or z from X), dp, and l over one
  // row more.
  auto load = [&](int k, const T* src) {
    const long long ts = start(k);
    const int tr = len(k);
    if (kPerm && src == B) {  // B's rows through iperm, whole, centred
      for (int i = t; i < tr; i += blockDim.x) {
        const T* row = B + (long long)pa.iperm[ts + i] * ld;
        int c = 0;
        if (rowvec)
          for (; c + 4 <= q; c += 4) {
            const V4 b = *reinterpret_cast<const V4*>(row + c);
            sB[c * lds + i] = b.x - smean[c];
            sB[(c + 1) * lds + i] = b.y - smean[c + 1];
            sB[(c + 2) * lds + i] = b.z - smean[c + 2];
            sB[(c + 3) * lds + i] = b.w - smean[c + 3];
          }
        for (; c < q; ++c) sB[c * lds + i] = row[c] - smean[c];
      }
    } else {
      tile_in(sB, lds, src + ts * ld, ld, tr, q);
    }
    for (int i = t; i < tr; i += blockDim.x)
      __pipeline_memcpy_async(sdp + i, dp + ts + i, sizeof(T));
    for (int i = t; i <= tr; i += blockDim.x) {
      if (ts + i < n)
        __pipeline_memcpy_async(sl + i, l + ts + i, sizeof(T));
      else
        sl[i] = T(0);
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
  };
  auto store = [&](int k) {
    tile_out(zbuf + start(k) * ld, ld, sB, lds, len(k), q);
    __syncthreads();
  };
  // The solve's rows leave: K1 writes them in order, K1p through iperm
  // (adding into X with `add`), then adds the tile's column sums of what
  // it wrote to bacc in a fixed order.
  auto store_out = [&](int k) {
    if (!kPerm) {
      tile_out(X + start(k) * ld, ld, sB, lds, len(k), q);
      __syncthreads();
      return;
    }
    const long long ts = start(k);
    const int tr = len(k);
    for (int i = t; i < tr; i += blockDim.x) {  // whole rows through iperm
      T* row = X + (long long)pa.iperm[ts + i] * ld;
      int c = 0;
      if (rowvec)
        for (; c + 4 <= q; c += 4) {
          V4 v = vec4<T>(sB[c * lds + i], sB[(c + 1) * lds + i],
                         sB[(c + 2) * lds + i], sB[(c + 3) * lds + i]);
          if (pa.add) {
            const V4 o = *reinterpret_cast<const V4*>(row + c);
            v = vec4<T>(o.x + v.x, o.y + v.y, o.z + v.z, o.w + v.w);
          }
          *reinterpret_cast<V4*>(row + c) = v;
          sB[c * lds + i] = v.x;
          sB[(c + 1) * lds + i] = v.y;
          sB[(c + 2) * lds + i] = v.z;
          sB[(c + 3) * lds + i] = v.w;
        }
      for (; c < q; ++c) {
        T v = sB[c * lds + i];
        if (pa.add) v = row[c] + v;
        row[c] = v;
        sB[c * lds + i] = v;
      }
    }
    __syncthreads();
    if (pa.part == nullptr) return;
    for (int c0 = 0; c0 < q; c0 += kK1Threads) {
      const int cw = min(kK1Threads, q - c0);
      const int ns = kK1Threads / cw;
      const int col = c0 + t % cw;
      double acc = 0.0;
      if (t / cw < ns)
        for (int i = t / cw; i < tr; i += ns)
          acc += static_cast<double>(sB[col * lds + i]);
      red[t] = acc;
      __syncthreads();
      if (t < cw) {
        double s = 0.0;
        for (int k2 = 0; k2 < ns; ++k2) s += red[t + k2 * cw];
        bacc[c0 + t] += s;
      }
      __syncthreads();
    }
  };
  // After a tile's apply (and a barrier): carry leaves the tile.
  auto advance = [&]() {
    for (int i = t; i < q; i += blockDim.x)
      carry[i] = tv[i] + tc[i] * carry[i];
    __syncthreads();
  };

  auto compose_fwd = [&](int k, T* acc_c, T* acc_v) {
    tile_compose<T, true>(sB, lds, sl, len(k), start(k), n, q, cols, xc, xv, tc,
                       tv, acc_c, acc_v, wc, wv);
  };
  auto compose_bwd = [&](int k, T* acc_c, T* acc_v) {
    tile_compose<T, false>(sB, lds, sl, len(k), start(k), n, q, cols, xc, xv, tc,
                        tv, acc_c, acc_v, wc, wv);
  };

  // Forward, pass 1: the block's total map per column. A resident tile
  // keeps its thread maps for pass 2.
  for (int k = 0; k < ntiles; ++k) {
    load(k, B);
    compose_fwd(k, fc, fv);
  }
  exchange<T, true>(cluster, fc, fv, gc, gv, carry, q);
  // Forward, pass 2: z; then the backward maps of each tile of z.
  for (int k = 0; k < ntiles; ++k) {
    if (!resident) {
      load(k, B);
      compose_fwd(k, nullptr, nullptr);
    }
    tile_apply<T, true>(sB, lds, sdp, sl, len(k), start(k), n, q, cols, xc, xv,
                     carry);
    __syncthreads();
    if (!resident) advance();
    compose_bwd(k, bc, bv);
    if (!resident) store(k);
  }
  exchange<T, false>(cluster, bc, bv, gc, gv, carry, q);
  // Backward: x over z, last tile first; X written once per row.
  for (int k = ntiles - 1; k >= 0; --k) {
    if (!resident) {
      load(k, zbuf);
      compose_bwd(k, nullptr, nullptr);
    }
    tile_apply<T, false>(sB, lds, sdp, sl, len(k), start(k), n, q, cols, xc, xv,
                      carry);
    __syncthreads();
    if (!resident) advance();
    store_out(k);
  }
  if (kPerm && pa.part != nullptr) {
    // This block's column sums, then (in the block with the last ticket)
    // every block's in block order.
    const int nblk = static_cast<int>(cluster.num_blocks());
    for (int i = t; i < q; i += blockDim.x)
      pa.part[(lane * ld + j0 + i) * nblk + rank] = bacc[i];
    if (last_ticket(pa.ticket, gridDim.x * gridDim.y * gridDim.z)) {
      const int count = static_cast<int>(gridDim.z) * ld;
      for (int i = t; i < count; i += blockDim.x) {
        double s = 0.0;
        for (int k = 0; k < nblk; ++k)
          s += __ldcg(pa.part + (long long)i * nblk + k);
        pa.osum[i] = s;
      }
      if (t == 0) *pa.ticket = 0u;
    }
  }
  // No block leaves while another may still read its shared memory.
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// K1b: the segment-decoupled solve.
//
// Replaces the TPU kernel mac_tpu/ops/pallas/tridiag_kernel.py
// (tridiag_solve_fused_blocked): the chain smoother of the matrix-free
// two-grid V-cycle (and of the banded preconditioner) once n > 32768, where
// the factor comes from the blocked LDL^T and its couplings are zero at
// every `block` boundary. The kernel takes l = 0 at each row with
// row % block == 0 itself, so the segments solve independently whatever the
// caller's l holds there -- the contract of the TPU kernel. Rows past n
// behave as l = 0, dp = 1, B = 0.
//
// What bounds it on the H100: latency, not bytes. At n = 100000, q = 4 the
// solve moves 4 MB (1.2 us at 3.35 TB/s), and an empty kernel behind the
// same wrapper already takes 1.8 us of device time. What costs beyond that
// is the number of memory instructions and sectors of each warp, then
// the chain of dependent steps in a block's lifetime and the number of
// waves the grid takes. The first port (one 1024-thread block per (segment,
// column), one row per thread, B read at a stride of q, four
// __syncthreads(), the warp totals scanned by warp 0 alone, an IEEE
// division per entry) ran 392 blocks in 1.5 waves: 0.0066 ms.
//
// The design: one block per segment and group of four columns (98 blocks at
// n = 100000, q = 4: one wave on 132 SMs), four consecutive rows per
// thread. At q = 4 a warp's 128 rows of B are 2 KB in a row: the warp loads
// them as coalesced float4s into a swizzled tile of shared memory, each
// lane takes its four rows from there, and X leaves the same way; dp and l
// arrive as one float4 each per thread. (A lane loading its own four rows
// directly touches twice the sectors in four times the cache lines per
// instruction: 0.0051 ms against 0.0035.) At other q % 4 == 0 a thread
// loads a float4 per row, and at any other q or alignment value by value.
// The thread composes the affine map of its rows in registers -- the
// coefficient part once for all columns, the value part per column -- a
// shuffle scan runs over the threads' maps, the warp totals go to shared
// memory, and after one __syncthreads() every warp composes the totals of
// the warps before it (forward) or after it (backward) itself. The thread
// then re-sweeps its rows from the incoming value. z = y / dp is a product
// with the pivot's reciprocal, one per row for all columns (sixteen IEEE
// divisions per thread, each with its branch, cost 1.5 us), and stays in
// registers between the two substitutions; X is written once. Two
// barriers in all; the scans and barriers together cost 0.35 us. Measured
// (kernel_ab.py, NVIDIA H100 80GB HBM3 at 700 W): 0.0035 ms of device time
// at (100000, 4) against 0.0066 ms for the first port in the same process;
// 2 and 8 rows per thread and 8 columns per block were slower. Lanes add
// the grid's third dimension, (segments, column groups, R).

constexpr int kMaxBlock = 1024;  // the longest segment
constexpr int kRows = 4;         // consecutive rows per thread
constexpr int kCols = 4;         // columns per block: four values of a row
constexpr int kK1bThreads = kMaxBlock / kRows;
constexpr int kSegThreads = 128;  // K1p's segment body: threads a block,
constexpr int kSumChunk = 4096;   // its last block's partials a chunk,
constexpr int kSumLoads = 32;     // and loads a thread in flight
constexpr int kK1bWarps = kK1bThreads / 32;
static_assert(kRows == 4 && kCols == 4, "K1b's loads and its tile's swizzle");

// How a block moves its rows of B and X:
//   kScalar: value by value, any q and any alignment;
//   kVector: four values per row (q % 4 == 0, all four arrays 16-byte
//            aligned);
//   kTile:   q == 4 and aligned, where a warp's 128 rows lie in a row:
//            coalesced rows (lane after lane) through shared memory, from
//            which each lane takes its four consecutive rows.
enum RowMoves { kScalar, kVector, kTile };

// Where row f of a warp's tile lies in shared memory: lanes storing rows
// 32 k + lane and lanes fetching rows 4 lane + i both spread over all banks.
__device__ __forceinline__ int tile_slot(int f) { return f ^ ((f >> 3) & 3); }

// warp_scan_maps for maps that share their coefficient c over kCols values.
template <typename T>
__device__ __forceinline__ void warp_scan_maps_cols(T& c, T (&v)[kCols],
                                                    int lane, bool reverse) {
#pragma unroll
  for (int k = 1; k < 32; k <<= 1) {
    const T pc = reverse ? __shfl_down_sync(kFullMask, c, k)
                         : __shfl_up_sync(kFullMask, c, k);
    const bool valid = reverse ? (lane + k < 32) : (lane >= k);
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const T pv = reverse ? __shfl_down_sync(kFullMask, v[j], k)
                           : __shfl_up_sync(kFullMask, v[j], k);
      if (valid) v[j] = v[j] + c * pv;
    }
    if (valid) c = c * pc;
  }
}

// The map of the lanes before this one in the substitution's order (the
// neighbour's inclusive map; the identity for the first lane).
template <typename T>
__device__ __forceinline__ void neighbour_map(T c, const T (&v)[kCols],
                                              int lane, bool reverse, T& nc,
                                              T (&nv)[kCols]) {
  const bool first = lane == (reverse ? 31 : 0);
  nc = reverse ? __shfl_down_sync(kFullMask, c, 1)
               : __shfl_up_sync(kFullMask, c, 1);
  if (first) nc = T(1);
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    nv[j] = reverse ? __shfl_down_sync(kFullMask, v[j], 1)
                    : __shfl_up_sync(kFullMask, v[j], 1);
    if (first) nv[j] = T(0);
  }
}

// 1 / x for a normal positive x (a pivot). float: the approximate
// reciprocal and one Newton step, within an ulp or two of the quotient and,
// unlike an IEEE division, without a branch. double: the correctly rounded
// reciprocal.
__device__ __forceinline__ float reciprocal(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return fmaf(r, fmaf(-x, r, 1.0f), r);
}
__device__ __forceinline__ double reciprocal(double x) { return __drcp_rn(x); }

// The factor of a thread's kRows consecutive rows from g0 (row r0 of a
// segment of `rows` rows inside n): cf[i] = -l of its row i, the forward
// coefficient of row i and the backward coefficient of row i - 1, 0 at the
// segment's first row and past its last row inside n (which also cuts the
// backward pass at the segment's last row and at row n - 1); rd[i] the
// pivot's reciprocal (1 past the rows). `vec`: dp and l 16-byte aligned
// at g0, one vector load each.
template <typename T>
__device__ __forceinline__ void segment_factor(const T* dp, const T* l,
                                               long long g0, int r0,
                                               int rows, bool vec,
                                               T (&cf)[kRows + 1],
                                               T (&rd)[kRows]) {
  using V4 = typename Vec4<T>::type;
  if (vec && r0 + kRows <= rows) {
    const V4 l4 = *reinterpret_cast<const V4*>(l + g0);
    const V4 d4 = *reinterpret_cast<const V4*>(dp + g0);
    cf[0] = r0 != 0 ? -l4.x : T(0);
    cf[1] = -l4.y;
    cf[2] = -l4.z;
    cf[3] = -l4.w;
    rd[0] = reciprocal(d4.x);
    rd[1] = reciprocal(d4.y);
    rd[2] = reciprocal(d4.z);
    rd[3] = reciprocal(d4.w);
  } else {
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const bool live = r0 + i < rows;
      cf[i] = (r0 + i != 0 && live) ? -l[g0 + i] : T(0);
      rd[i] = live ? reciprocal(dp[g0 + i]) : T(1);
    }
  }
  cf[kRows] = r0 + kRows < rows ? -l[g0 + kRows] : T(0);
}

// The two substitutions of one segment over its warps w0 .. w0 + nws - 1
// of the block, each thread's kRows rows of kCols columns in v (B in, X
// out). Forward: y_i = b_i + cf_i y_{i-1}; the thread's map, the scan over
// the warp, the segment's warps before this one, then the rows again from
// the incoming value; z = y / dp replaces b (a product with the pivot's
// reciprocal). Backward: x_i = z_i + cf_{i+1} x_{i+1}, the same steps from
// the last row to the first; x replaces z. fc, fv, bc, bv: the block's
// warps' total maps (kK1bWarps each), in shared memory. Two
// __syncthreads() of the whole block.
template <typename T>
__device__ __forceinline__ void segment_solve(const T (&cf)[kRows + 1],
                                              const T (&rd)[kRows],
                                              T (&v)[kRows][kCols], T* fc,
                                              T (*fv)[kCols], T* bc,
                                              T (*bv)[kCols], int w0,
                                              int nws) {
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int wl = w - w0;  // the warp within its segment
  T c = T(1), t[kCols], nc, nt[kCols], in[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) t[j] = T(0);
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
#pragma unroll
    for (int j = 0; j < kCols; ++j) t[j] = v[i][j] + cf[i] * t[j];
    c = cf[i] * c;
  }
  warp_scan_maps_cols(c, t, lane, false);
  neighbour_map(c, t, lane, false, nc, nt);
  if (lane == 31) {
    fc[w] = c;
#pragma unroll
    for (int j = 0; j < kCols; ++j) fv[w][j] = t[j];
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kCols; ++j) in[j] = T(0);
#pragma unroll
  for (int k = 0; k < kK1bWarps - 1; ++k) {
    if (k < wl) {
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        in[j] = fv[w0 + k][j] + fc[w0 + k] * in[j];
    }
  }
#pragma unroll
  for (int j = 0; j < kCols; ++j) in[j] = nt[j] + nc * in[j];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      in[j] = v[i][j] + cf[i] * in[j];
      v[i][j] = in[j] * rd[i];
    }
  }

  c = T(1);
#pragma unroll
  for (int j = 0; j < kCols; ++j) t[j] = T(0);
#pragma unroll
  for (int i = kRows - 1; i >= 0; --i) {
#pragma unroll
    for (int j = 0; j < kCols; ++j) t[j] = v[i][j] + cf[i + 1] * t[j];
    c = cf[i + 1] * c;
  }
  warp_scan_maps_cols(c, t, lane, true);
  neighbour_map(c, t, lane, true, nc, nt);
  if (lane == 0) {
    bc[w] = c;
#pragma unroll
    for (int j = 0; j < kCols; ++j) bv[w][j] = t[j];
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kCols; ++j) in[j] = T(0);
#pragma unroll
  for (int k = kK1bWarps - 1; k > 0; --k) {
    if (k > wl && k < nws) {
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        in[j] = bv[w0 + k][j] + bc[w0 + k] * in[j];
    }
  }
#pragma unroll
  for (int j = 0; j < kCols; ++j) in[j] = nt[j] + nc * in[j];
#pragma unroll
  for (int i = kRows - 1; i >= 0; --i) {
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      in[j] = v[i][j] + cf[i + 1] * in[j];
      v[i][j] = in[j];
    }
  }
}

template <typename T, RowMoves kMoves>
__global__ void __launch_bounds__(kK1bThreads)
tridiag_solve_blocked_kernel(const T* __restrict__ dp,
                             const T* __restrict__ l,
                             const T* __restrict__ B, T* __restrict__ X,
                             int n, int q, int block, long long fstride) {
  using V4 = typename Vec4<T>::type;
  {  // lane blockIdx.z: its factor and its (n, q) block
    const long long lane = blockIdx.z;
    dp += lane * fstride;
    l += lane * fstride;
    B += lane * n * q;
    X += lane * n * q;
  }
  __shared__ T fc[kK1bWarps], fv[kK1bWarps][kCols];
  __shared__ T bc[kK1bWarps], bv[kK1bWarps][kCols];
  __shared__ V4 tiles[kMoves == kTile ? kK1bThreads * kRows : 1];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const long long seg0 = static_cast<long long>(blockIdx.x) * block;
  // The segment's rows inside n, this thread's first row in the segment and
  // in the arrays, the block's first column.
  const int rows = static_cast<int>(min(static_cast<long long>(block),
                                        n - seg0));
  const int r0 = threadIdx.x * kRows;
  const long long g0 = seg0 + r0;
  const int j0 = blockIdx.y * kCols;
  // kTile: the warp's tile, its first row in the segment, its rows of B, X.
  V4* tile = tiles + (kMoves == kTile ? w * 32 * kRows : 0);
  const int t0 = w * 32 * kRows;
  const V4* Bt = reinterpret_cast<const V4*>(B) + seg0 + t0;
  V4* Xt = reinterpret_cast<V4*>(X) + seg0 + t0;
  const V4 zero4 = vec4<T>(T(0), T(0), T(0), T(0));

  T cf[kRows + 1], rd[kRows], v[kRows][kCols];
  if (kMoves == kTile) {
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const int f = 32 * k + lane;
      tile[tile_slot(f)] = t0 + f < rows ? Bt[f] : zero4;
    }
  }
  segment_factor(dp, l, g0, r0, rows, kMoves != kScalar, cf, rd);
  if (kMoves == kTile) __syncwarp();
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const bool live = r0 + i < rows;
    const T* row = B + (g0 + i) * q + j0;
    if (kMoves == kScalar) {
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        v[i][j] = (live && j0 + j < q) ? row[j] : T(0);
    } else {
      V4 b4 = zero4;
      if (kMoves == kTile)
        b4 = tile[tile_slot(kRows * lane + i)];
      else if (live)
        b4 = *reinterpret_cast<const V4*>(row);
      v[i][0] = b4.x;
      v[i][1] = b4.y;
      v[i][2] = b4.z;
      v[i][3] = b4.w;
    }
  }

  segment_solve(cf, rd, v, fc, fv, bc, bv, 0, blockDim.x >> 5);

  if (kMoves == kTile) {
    __syncwarp();  // every lane has taken its rows of B from the tile
#pragma unroll
    for (int i = 0; i < kRows; ++i)
      tile[tile_slot(kRows * lane + i)] =
          vec4<T>(v[i][0], v[i][1], v[i][2], v[i][3]);
    __syncwarp();
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const int f = 32 * k + lane;
      if (t0 + f < rows) Xt[f] = tile[tile_slot(f)];
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    if (r0 + i >= rows) continue;
    T* row = X + (g0 + i) * q + j0;
    if (kMoves == kVector) {
      *reinterpret_cast<V4*>(row) = vec4<T>(v[i][0], v[i][1], v[i][2],
                                            v[i][3]);
    } else {
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        if (j0 + j < q) row[j] = v[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// K1p's segment body: K1b's solve with K1p's gathers, for a factor decoupled
// every `seg` rows (the blocked LDL^T that ops.banded builds for every
// banded graph past 4096 nodes: city10000's 79 segments of 128 rows).
//
// What held K1p back on such factors: the cluster body solves the whole chain
// on 16 of 132 SMs with a cross-block exchange of affine maps, moved B and X a
// value at a time through iperm and summed X's columns with two barriers per
// column group: 16.2 us of device time at (10000, 4) on an H100 (700 W), where
// its byte bound is 0.13 us. Taking l = 0 at every segment start, the solve is
// seg-row chains that share nothing, the contract of K1b; the reference itself
// sends such factors to its segment kernel past 32768 rows
// (mac_tpu/ops/tridiag.py). The permutation is not local (consecutive chain
// rows lie a median of 97 RCM rows apart on city10000), so the rows stay
// gathers: what the body does about them is to load them whole and all at once
// from a block per segment.
//
// The design: K1b's threads for each (segment, group of kCols columns, lane), a
// warp at seg 128, a block a segment; where the column sums are asked for, a
// block holds up to kSegThreads / (those threads) segments, four at seg 128, so
// that fewer blocks take part in the sums' ticket and the last block has more
// threads (one segment a block is faster without the sums, several with them:
// 3.7 against 4.2 us, and 17.3 against 10.9 with 8 lanes, at (10000, 4) float32
// on an H100). A thread loads iperm for its kRows consecutive chain rows as one
// vector, then B's rows through it, whole (one 16-byte load a row at q = 4
// float32, two in float64), and in the adding form X's old rows beside them,
// all in flight at once; B is centred by bsum / n. The thread's rows stay in
// registers through K1b's solve (segment_solve, the same code: bitwise K1b on
// the gathered, centred input), then leave through iperm by whole rows, added
// to X's old rows in the adding form. X's column sums: each thread adds its
// rows in order (float64), the warp by a fixed xor butterfly (16, 8, 4, 2, 1),
// a segment its warps in order, a block its segments in order into part[(lane,
// column), block]; the block with the last ticket loads those partials into
// shared memory, all at once (a chunk at a time past kSumChunk), and a thread a
// column adds them in block order (tridiag.py's k1p_segment_sum_model is this
// order in numpy). No atomics but the ticket.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kK1bThreads)
tridiag_solve_perm_seg_kernel(const T* __restrict__ dp,
                              const T* __restrict__ l,
                              const T* __restrict__ B, T* X, int n, int q,
                              int seg, long long fstride, PermArgs<T> pa) {
  using V4 = typename Vec4<T>::type;
  const long long lane_id = blockIdx.z;
  dp += lane_id * fstride;
  l += lane_id * fstride;
  B += lane_id * n * q;
  X += lane_id * n * q;
  __shared__ T fc[kK1bWarps], fv[kK1bWarps][kCols];
  __shared__ T bc[kK1bWarps], bv[kK1bWarps][kCols];
  __shared__ double wsum[kK1bWarps][kCols];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  // The thread's segment (sg, its place sl in the block), its warps and
  // the thread's rows in it; a segment past n has no rows.
  const int tps = ((seg + kRows - 1) / kRows + 31) & ~31;
  const int nseg = (n + seg - 1) / seg;
  const int sl = threadIdx.x / tps;
  const int sg = blockIdx.x * (blockDim.x / tps) + sl;
  const int nws = tps >> 5;
  const int w0 = sl * nws;
  const long long seg0 = static_cast<long long>(sg) * seg;
  const int rows = static_cast<int>(
      max(0LL, min(static_cast<long long>(seg), n - seg0)));
  const int r0 = (threadIdx.x - sl * tps) * kRows;
  const long long g0 = seg0 + r0;
  const int j0 = blockIdx.y * kCols;
  const V4 zero4 = vec4<T>(T(0), T(0), T(0), T(0));

  // The thread's rows of B and X (row iperm[g0 + i]); past n, row 0 (never
  // moved).
  int src[kRows];
  if (kVec && r0 + kRows <= rows) {
    const int4 p4 = *reinterpret_cast<const int4*>(pa.iperm + g0);
    src[0] = p4.x;
    src[1] = p4.y;
    src[2] = p4.z;
    src[3] = p4.w;
  } else {
#pragma unroll
    for (int i = 0; i < kRows; ++i)
      src[i] = r0 + i < rows ? pa.iperm[g0 + i] : 0;
  }
  T v[kRows][kCols], xo[kRows][kCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const bool live = r0 + i < rows;
    const long long off = static_cast<long long>(src[i]) * q + j0;
    if (kVec) {
      const V4 b4 = live ? *reinterpret_cast<const V4*>(B + off) : zero4;
      const V4 x4 = live && pa.add ? *reinterpret_cast<const V4*>(X + off)
                                   : zero4;
      v[i][0] = b4.x;
      v[i][1] = b4.y;
      v[i][2] = b4.z;
      v[i][3] = b4.w;
      xo[i][0] = x4.x;
      xo[i][1] = x4.y;
      xo[i][2] = x4.z;
      xo[i][3] = x4.w;
    } else {
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const bool in = live && j0 + j < q;
        v[i][j] = in ? B[off + j] : T(0);
        xo[i][j] = in && pa.add ? X[off + j] : T(0);
      }
    }
  }
  T cf[kRows + 1], rd[kRows];
  segment_factor(dp, l, g0, r0, rows, kVec, cf, rd);
  if (pa.bsum != nullptr) {
    T mean[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      mean[j] = j0 + j < q ? static_cast<T>(pa.bsum[lane_id * q + j0 + j] /
                                            static_cast<double>(n))
                           : T(0);
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        if (r0 + i < rows && j0 + j < q) v[i][j] = v[i][j] - mean[j];
  }

  segment_solve(cf, rd, v, fc, fv, bc, bv, w0, nws);

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    if (r0 + i >= rows) continue;
    if (pa.add) {
#pragma unroll
      for (int j = 0; j < kCols; ++j) v[i][j] = xo[i][j] + v[i][j];
    }
    T* row = X + static_cast<long long>(src[i]) * q + j0;
    if (kVec) {
      *reinterpret_cast<V4*>(row) = vec4<T>(v[i][0], v[i][1], v[i][2],
                                            v[i][3]);
    } else {
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        if (j0 + j < q) row[j] = v[i][j];
    }
  }
  if (pa.part == nullptr) return;
  double s[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    s[j] = 0.0;
#pragma unroll
    for (int i = 0; i < kRows; ++i)
      if (r0 + i < rows) s[j] += static_cast<double>(v[i][j]);
#pragma unroll
    for (int k = 16; k > 0; k >>= 1)
      s[j] += __shfl_xor_sync(kFullMask, s[j], k);
  }
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < kCols; ++j) wsum[w][j] = s[j];
  }
  __syncthreads();
  // The block's partial: each of its segments' sum (its warps in order),
  // the segments in order.
  const int nblk = gridDim.x;
  const bool writer = threadIdx.x < kCols && j0 + threadIdx.x < q;
  if (writer) {
    double acc = 0.0;
    for (int b = 0; b < static_cast<int>(blockDim.x) / tps; ++b) {
      if (blockIdx.x * (blockDim.x / tps) + b >= nseg) break;
      double part = 0.0;
      for (int k = 0; k < nws; ++k) part += wsum[b * nws + k][threadIdx.x];
      acc += part;
    }
    pa.part[(lane_id * q + j0 + threadIdx.x) * nblk + blockIdx.x] = acc;
  }
  // Only the partials must be visible to the last block (x reaches the
  // next kernel at the launch boundary).
  if (!last_ticket(pa.ticket, gridDim.x * gridDim.y * gridDim.z, writer))
    return;
  // The partials come into shared memory by chunks of at most kSumChunk,
  // kSumLoads loads a thread in flight before their stores; a thread a
  // column then adds them in block order.
  extern __shared__ double buf[];
  const int count = static_cast<int>(gridDim.z) * q;
  const int cpc =
      min(static_cast<int>(blockDim.x), max(1, kSumChunk / nblk));
  const int spc = min(nblk, kSumChunk / cpc);
  for (int c0 = 0; c0 < count; c0 += cpc) {
    const int cc = min(cpc, count - c0);
    double acc = 0.0;
    for (int s0 = 0; s0 < nblk; s0 += spc) {
      const int sc = min(spc, nblk - s0);
      for (int e0 = threadIdx.x; e0 < cc * sc;
           e0 += kSumLoads * blockDim.x) {
        double v[kSumLoads];
#pragma unroll
        for (int u = 0; u < kSumLoads; ++u) {
          const int e = e0 + u * blockDim.x;
          const int c = e / sc;
          if (e < cc * sc)
            v[u] = __ldcg(pa.part + static_cast<long long>(c0 + c) * nblk +
                          s0 + e - c * sc);
        }
#pragma unroll
        for (int u = 0; u < kSumLoads; ++u)
          if (e0 + u * blockDim.x < cc * sc) buf[e0 + u * blockDim.x] = v[u];
      }
      __syncthreads();
      if (threadIdx.x < cc)
        for (int k = 0; k < sc; ++k) acc += buf[threadIdx.x * sc + k];
      __syncthreads();
    }
    if (threadIdx.x < cc) pa.osum[c0 + threadIdx.x] = acc;
  }
  if (threadIdx.x == 0) *pa.ticket = 0u;
}

// K1's (kPerm = false) or K1p's (true) function attributes for element
// type T: the dynamic shared memory cap and the non-portable cluster size.
// The first error, or cudaSuccess.
template <typename T, bool kPerm>
cudaError_t k1_setup() {
  const cudaError_t err = cudaFuncSetAttribute(
      tridiag_solve_kernel<T, kPerm>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes + (kPerm ? kPermExtraBytes : 0));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(tridiag_solve_kernel<T, kPerm>,
                              cudaFuncAttributeNonPortableClusterSizeAllowed,
                              1);
}

template <typename T, bool kPerm>
int k1_launch(const T* dp, const T* l, const T* B, T* X, int n, int q,
              int lanes, long long fstride, void* stream,
              PermArgs<T> pa = PermArgs<T>{}) {
  if (n <= 0 || q <= 0 || lanes <= 0) return 0;
  static const cudaError_t setup = k1_setup<T, kPerm>();
  if (setup != cudaSuccess) return static_cast<int>(setup);
  const int nblk = kCluster;
  // Rows per block and per tile, multiples of 4 (the tile's column stride,
  // tile_rows + 1, is then odd).
  const int span = ((n + nblk - 1) / nblk + 3) & ~3;
  // Shared memory for the widest group (the first): a narrower last group
  // lays its tile out in less, at the same tile_rows.
  const int qg = q < kMaxQ ? q : kMaxQ;
  const int nw = kK1Threads / 32;
  const int cpp = qg < nw ? qg : nw;
  const int npass = (qg + cpp - 1) / cpp;
  // wc, wv; xc, xv; tc, tv, carry and the four totals; gc, gv; sl's row
  // and the padding row of the tile. In elements of T: with 8-byte
  // elements a block holds half the rows, so the tiled branch starts at
  // about half of float's n. K1p takes K1's tile rows, so that its tiles
  // and their carries are K1's, and adds above K1's cap its column sums'
  // doubles (head) and its means (qg).
  const int head = kPerm ? kPermHeadBytes : 0;
  const int fixed = 64 + 2 * npass * kK1Threads + 7 * qg + 2 * nblk * qg
                    + 1 + qg;
  const int fit =
      ((kSmemBytes / static_cast<int>(sizeof(T)) - fixed) / (qg + 2)) & ~3;
  const int tile_rows = span < fit ? span : fit;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nblk, (q + kMaxQ - 1) / kMaxQ, lanes);
  cfg.blockDim = dim3(kK1Threads);
  cfg.dynamicSmemBytes =
      head + static_cast<size_t>(tile_rows * (qg + 2) + fixed +
                                 (kPerm ? qg : 0)) * sizeof(T);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute cluster_dim[1];
  cluster_dim[0].id = cudaLaunchAttributeClusterDimension;
  cluster_dim[0].val.clusterDim.x = nblk;
  cluster_dim[0].val.clusterDim.y = 1;
  cluster_dim[0].val.clusterDim.z = 1;
  cfg.attrs = cluster_dim;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, tridiag_solve_kernel<T, kPerm>, dp, l, B, X, n, q, span,
      tile_rows, fstride, pa);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int k1b_launch(const T* dp, const T* l, const T* B, T* X, int n, int q,
               int lanes, long long fstride, int block, void* stream) {
  if (block < 32 || block > kMaxBlock || block % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0 || q <= 0 || lanes <= 0) return 0;
  const dim3 grid((n + block - 1) / block, (q + kCols - 1) / kCols, lanes);
  const int threads = ((block + kRows - 1) / kRows + 31) & ~31;
  // Every lane's first row keeps the base pointers' alignment when the lane
  // strides (n q for B and X, fstride for dp and l) are multiples of 4.
  const bool aligned =
      (reinterpret_cast<uintptr_t>(dp) | reinterpret_cast<uintptr_t>(l) |
       reinterpret_cast<uintptr_t>(B) | reinterpret_cast<uintptr_t>(X)) % 16
          == 0 &&
      fstride % 4 == 0;
  auto kernel = !aligned || q % 4 != 0
                    ? tridiag_solve_blocked_kernel<T, kScalar>
                : q == 4 ? tridiag_solve_blocked_kernel<T, kTile>
                         : tridiag_solve_blocked_kernel<T, kVector>;
  kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      dp, l, B, X, n, q, block, fstride);
  return static_cast<int>(cudaGetLastError());
}

// K1p's segment body: the grid (segments, column groups, lanes), K1b's
// threads for `seg` rows; whole-row moves (kVec) where q % 4 == 0 and dp,
// l, iperm, B and X are 16-byte aligned at every lane.
template <typename T>
int k1p_seg_launch(const T* dp, const T* l, const T* B, T* X, int n, int q,
                   int lanes, long long fstride, int seg, PermArgs<T> pa,
                   void* stream) {
  if (seg < 32 || seg > kMaxBlock || seg % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0 || q <= 0 || lanes <= 0) return 0;
  const int tps = ((seg + kRows - 1) / kRows + 31) & ~31;
  const int spb =
      pa.part != nullptr && tps < kSegThreads ? kSegThreads / tps : 1;
  const int nseg = (n + seg - 1) / seg;
  const dim3 grid((nseg + spb - 1) / spb, (q + kCols - 1) / kCols, lanes);
  const int threads = tps * spb;
  const bool aligned =
      (reinterpret_cast<uintptr_t>(dp) | reinterpret_cast<uintptr_t>(l) |
       reinterpret_cast<uintptr_t>(B) | reinterpret_cast<uintptr_t>(X) |
       reinterpret_cast<uintptr_t>(pa.iperm)) % 16 == 0 &&
      fstride % 4 == 0;
  auto kernel = aligned && q % 4 == 0
                    ? tridiag_solve_perm_seg_kernel<T, true>
                    : tridiag_solve_perm_seg_kernel<T, false>;
  // The last block's chunk of partials (the sums only).
  const long long partials = static_cast<long long>(lanes) * q * grid.x;
  const size_t smem =
      pa.part == nullptr
          ? 0
          : sizeof(double) * static_cast<size_t>(
                                 partials < kSumChunk ? partials : kSumChunk);
  kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      dp, l, B, X, n, q, seg, fstride, pa);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K1. B, X: (lanes, n, q) float32 (_f32) or float64 (_f64), row-major and
// contiguous; dp, l: of the same type, lane r's factor at dp + r * fstride
// (fstride = n: a factor per lane; fstride = 0: one factor (n,) for every
// lane). One launch on `stream` of a cluster per (group of up to kMaxQ
// columns, lane); returns the first CUDA error of the set-up or the launch
// (0 on success); a card that cannot schedule the cluster fails the launch.
extern "C" int tridiag_solve_f32(const float* dp, const float* l,
                                 const float* B, float* X, int n, int q,
                                 int lanes, long long fstride, void* stream) {
  return k1_launch<float, false>(dp, l, B, X, n, q, lanes, fstride, stream);
}

extern "C" int tridiag_solve_f64(const double* dp, const double* l,
                                 const double* B, double* X, int n, int q,
                                 int lanes, long long fstride, void* stream) {
  return k1_launch<double, false>(dp, l, B, X, n, q, lanes, fstride, stream);
}

// K1p. As K1, with iperm (n,) int32, B's column sums bsum (lanes, q)
// float64 or null (no centring), add (X[iperm[j]] += x_j when non-zero),
// and, unless part is null, X's column sums after the solve into osum
// (lanes, q) float64 through part (the blocks' partials) and ticket (one
// counter at 0, left at 0). tridiag_solve_perm_*: the cluster body, with
// the scratch Z (lanes, n, q) of its tiles, part lanes * q * 16 float64.
// tridiag_solve_perm_seg_*: the segment body for a factor decoupled every
// `seg` rows (a multiple of 32 up to 1024; else cudaErrorInvalidValue), part
// lanes * q * ceil(n / seg) float64.
#define K1P_EXPORT(T, S)                                                    \
  extern "C" int tridiag_solve_perm_##S(                                    \
      const T* dp, const T* l, const T* B, T* X, int n, int q, int lanes,   \
      long long fstride, const int* iperm, const double* bsum, T* Z,        \
      int add, double* part, double* osum, unsigned* ticket,                \
      void* stream) {                                                       \
    PermArgs<T> pa = {iperm, bsum, Z, add, part, osum, ticket};             \
    return k1_launch<T, true>(dp, l, B, X, n, q, lanes, fstride, stream,    \
                              pa);                                          \
  }                                                                         \
  extern "C" int tridiag_solve_perm_seg_##S(                                \
      const T* dp, const T* l, const T* B, T* X, int n, int q, int lanes,   \
      long long fstride, int seg, const int* iperm, const double* bsum,     \
      int add, double* part, double* osum, unsigned* ticket,                \
      void* stream) {                                                       \
    PermArgs<T> pa = {iperm, bsum, nullptr, add, part, osum, ticket};       \
    return k1p_seg_launch<T>(dp, l, B, X, n, q, lanes, fstride, seg, pa,    \
                             stream);                                       \
  }

K1P_EXPORT(float, f32)
K1P_EXPORT(double, f64)

// K1b. The same arrays and lanes; `block` (a multiple of 32, at most 1024)
// is the segment length. The grid is (segments, column groups, lanes).
// Returns cudaErrorInvalidValue for any other block, else the launch's
// error (0 on success).
extern "C" int tridiag_solve_blocked_f32(const float* dp, const float* l,
                                         const float* B, float* X, int n,
                                         int q, int lanes, long long fstride,
                                         int block, void* stream) {
  return k1b_launch(dp, l, B, X, n, q, lanes, fstride, block, stream);
}

extern "C" int tridiag_solve_blocked_f64(const double* dp, const double* l,
                                         const double* B, double* X, int n,
                                         int q, int lanes, long long fstride,
                                         int block, void* stream) {
  return k1b_launch(dp, l, B, X, n, q, lanes, fstride, block, stream);
}
