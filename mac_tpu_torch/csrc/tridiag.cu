// Tridiagonal LDL^T solve for one (n, q) block of right-hand sides:
//     L diag(dp) L^T X = B,  L unit lower bidiagonal with subdiagonal l.
// Two kernels: K1, whole rows, and K1b, segment-decoupled (further down).
//
// The two substitutions are affine recurrences
//     forward:  y_i = b_i - l_i * y_{i-1}           (y_{-1} = 0)
//     backward: x_i = z_i - l_{i+1} * x_{i+1}       (x_n = 0), z = y / dp
// and affine maps compose as (c2, v2) o (c1, v1) = (c2 c1, v2 + c2 v1).

#include <cooperative_groups.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kThreads = 1024;

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

// The same scan over lanes cut into segments of `seg` lanes: a lane
// composes only the maps of its own segment.
__device__ __forceinline__ void warp_scan_maps_segmented(float& c, float& v,
                                                         int lane, int seg,
                                                         bool reverse) {
  const int s0 = (lane / seg) * seg;
  const int s1 = s0 + seg - 1;
#pragma unroll
  for (int k = 1; k < 32; k <<= 1) {
    const float pc = reverse ? __shfl_down_sync(kFullMask, c, k)
                             : __shfl_up_sync(kFullMask, c, k);
    const float pv = reverse ? __shfl_down_sync(kFullMask, v, k)
                             : __shfl_up_sync(kFullMask, v, k);
    const bool valid = reverse ? (lane + k <= s1) : (lane - k >= s0);
    if (valid) {
      v = v + c * pv;
      c = c * pc;
    }
  }
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

constexpr int kCluster = 16;            // blocks per cluster (non-portable)
constexpr int kK1Threads = 256;         // threads per block
constexpr int kSmemBytes = 200 * 1024;  // dynamic shared memory cap
constexpr int kMaxQ = 128;              // columns per launch

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

__device__ __forceinline__ void tile_in(float* s, int lds, const float* g,
                                        int ld, int rows, int q) {
  for (RowWalk e(q); e.r < rows; e.next())
    __pipeline_memcpy_async(s + e.c * lds + e.r,
                            g + (long long)e.r * ld + e.c, sizeof(float));
}

__device__ __forceinline__ void tile_out(float* g, int ld, const float* s,
                                         int lds, int rows, int q) {
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
template <bool kForward>
__device__ void tile_compose(const float* sB, int lds, const float* sl,
                             int rows, long long g0, int n, int q,
                             Columns cols,
                             float* xc, float* xv, float* tc, float* tv,
                             float* acc_c, float* acc_v, float* wc,
                             float* wv) {
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
    float c = 1.0f, v = 0.0f;
    if (live) {
      if (kForward) {
        for (int i = lo; i < hi; ++i) {
          const float cf = (g0 + i == 0) ? 0.0f : -sl[i];
          v = sB[col * lds + i] + cf * v;
          c = cf * c;
        }
      } else {
        for (int i = hi - 1; i >= lo; --i) {
          const float cb = (g0 + i == n - 1) ? 0.0f : -sl[i + 1];
          v = sB[col * lds + i] + cb * v;
          c = cb * c;
        }
      }
    }
    warp_scan_maps(c, v, lane, !kForward);
    // The lanes before this one (in the substitution's order) within the
    // warp: the neighbour's inclusive map.
    float nc = kForward ? __shfl_up_sync(kFullMask, c, 1)
                        : __shfl_down_sync(kFullMask, c, 1);
    float nv = kForward ? __shfl_up_sync(kFullMask, v, 1)
                        : __shfl_down_sync(kFullMask, v, 1);
    if (lane == (kForward ? 0 : 31)) {
      nc = 1.0f;
      nv = 0.0f;
    }
    if (lane == (kForward ? 31 : 0)) {
      wc[w] = c;
      wv[w] = v;
    }
    __syncthreads();
    if (w == 0) {
      float sc = lane < nw ? wc[lane] : 1.0f;
      float sv = lane < nw ? wv[lane] : 0.0f;
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
      const float pc = first ? 1.0f : wc[kForward ? w - 1 : w + 1];
      const float pv = first ? 0.0f : wv[kForward ? w - 1 : w + 1];
      xc[pass * blockDim.x + t] = nc * pc;
      xv[pass * blockDim.x + t] = nv + nc * pv;
      if (p == 0) {
        const int tw = kForward ? seg0 + wpc - 1 : seg0;
        const float ttc = wc[tw], ttv = wv[tw];
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
template <bool kForward>
__device__ void tile_apply(float* sB, int lds, const float* sdp,
                           const float* sl, int rows, long long g0, int n,
                           int q, Columns cols,
                           const float* xc, const float* xv,
                           const float* carry) {
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
    float x = xv[m] + xc[m] * carry[col];
    if (kForward) {
      for (int i = lo; i < hi; ++i) {
        const float cf = (g0 + i == 0) ? 0.0f : -sl[i];
        x = sB[col * lds + i] + cf * x;
        sB[col * lds + i] = x / sdp[i];
      }
    } else {
      for (int i = hi - 1; i >= lo; --i) {
        const float cb = (g0 + i == n - 1) ? 0.0f : -sl[i + 1];
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
template <bool kForward>
__device__ void exchange(cg::cluster_group& cluster, float* tot_c,
                         float* tot_v, float* gc, float* gv, float* carry,
                         int q) {
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
    float x = 0.0f;
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

// B and X hold q columns at row stride ld (a column group of a wider block
// when ld > q).
__global__ void __launch_bounds__(kK1Threads)
tridiag_solve_kernel(const float* __restrict__ dp, const float* __restrict__ l,
                     const float* __restrict__ B, float* X, int n, int q,
                     int ld, int span, int tile_rows) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int t = threadIdx.x;
  const int nw = blockDim.x >> 5;
  Columns cols;
  cols.cpp = min(q, nw);
  cols.P = (nw / cols.cpp) * 32;
  cols.npass = (q + cols.cpp - 1) / cols.cpp;

  const int lds = tile_rows + 1;                     // odd
  float* sB = smem;                                  // q * lds
  float* sdp = sB + q * lds;                         // tile_rows
  float* sl = sdp + tile_rows;                       // tile_rows + 1
  float* wc = sl + tile_rows + 1;                    // 32
  float* wv = wc + 32;                               // 32
  float* xc = wv + 32;                               // npass * blockDim
  float* xv = xc + cols.npass * blockDim.x;          // npass * blockDim
  float* tc = xv + cols.npass * blockDim.x;          // q each below
  float* tv = tc + q;
  float* carry = tv + q;
  float* fc = carry + q;                             // forward totals
  float* fv = fc + q;
  float* bc = fv + q;                                // backward totals
  float* bv = bc + q;
  float* gc = bv + q;                                // nblk * q each
  float* gv = gc + cluster.num_blocks() * q;

  const long long r0 = min((long long)rank * span, (long long)n);
  const long long r1 = min(r0 + span, (long long)n);
  const int rows = static_cast<int>(r1 - r0);
  const int ntiles = (rows + tile_rows - 1) / tile_rows;
  const bool resident = ntiles <= 1;  // the tile stays in shared memory

  for (int i = t; i < q; i += blockDim.x) {
    fc[i] = 1.0f;
    fv[i] = 0.0f;
    bc[i] = 1.0f;
    bv[i] = 0.0f;
  }
  auto start = [&](int k) { return r0 + (long long)k * tile_rows; };
  auto len = [&](int k) {
    return static_cast<int>(min((long long)tile_rows, r1 - start(k)));
  };
  // Tile k into shared memory: `src` (B, or z from X), dp, and l over one
  // row more.
  auto load = [&](int k, const float* src) {
    const long long ts = start(k);
    const int tr = len(k);
    tile_in(sB, lds, src + ts * ld, ld, tr, q);
    for (int i = t; i < tr; i += blockDim.x)
      __pipeline_memcpy_async(sdp + i, dp + ts + i, sizeof(float));
    for (int i = t; i <= tr; i += blockDim.x) {
      if (ts + i < n)
        __pipeline_memcpy_async(sl + i, l + ts + i, sizeof(float));
      else
        sl[i] = 0.0f;
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
  };
  auto store = [&](int k) {
    tile_out(X + start(k) * ld, ld, sB, lds, len(k), q);
    __syncthreads();
  };
  // After a tile's apply (and a barrier): carry leaves the tile.
  auto advance = [&]() {
    for (int i = t; i < q; i += blockDim.x)
      carry[i] = tv[i] + tc[i] * carry[i];
    __syncthreads();
  };

  auto compose_fwd = [&](int k, float* acc_c, float* acc_v) {
    tile_compose<true>(sB, lds, sl, len(k), start(k), n, q, cols, xc, xv, tc,
                       tv, acc_c, acc_v, wc, wv);
  };
  auto compose_bwd = [&](int k, float* acc_c, float* acc_v) {
    tile_compose<false>(sB, lds, sl, len(k), start(k), n, q, cols, xc, xv, tc,
                        tv, acc_c, acc_v, wc, wv);
  };

  // Forward, pass 1: the block's total map per column. A resident tile
  // keeps its thread maps for pass 2.
  for (int k = 0; k < ntiles; ++k) {
    load(k, B);
    compose_fwd(k, fc, fv);
  }
  exchange<true>(cluster, fc, fv, gc, gv, carry, q);
  // Forward, pass 2: z; then the backward maps of each tile of z.
  for (int k = 0; k < ntiles; ++k) {
    if (!resident) {
      load(k, B);
      compose_fwd(k, nullptr, nullptr);
    }
    tile_apply<true>(sB, lds, sdp, sl, len(k), start(k), n, q, cols, xc, xv,
                     carry);
    __syncthreads();
    if (!resident) advance();
    compose_bwd(k, bc, bv);
    if (!resident) store(k);
  }
  exchange<false>(cluster, bc, bv, gc, gv, carry, q);
  // Backward: x over z, last tile first; X written once per row.
  for (int k = ntiles - 1; k >= 0; --k) {
    if (!resident) {
      load(k, X);
      compose_bwd(k, nullptr, nullptr);
    }
    tile_apply<false>(sB, lds, sdp, sl, len(k), start(k), n, q, cols, xc, xv,
                      carry);
    __syncthreads();
    if (!resident) advance();
    store(k);
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
// solve moves 4 MB (1.2 us at 3.35 TB/s) but takes 6.8 us of device time:
// a block runs two 5-step warp scans, two cross-warp scans and four
// __syncthreads(), and B is read with a stride of q. Several columns per
// block, or a vectorised (n, q) row load, are later work.

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

// K1's function attributes: the dynamic shared memory cap and the
// non-portable cluster size. The first error, or cudaSuccess.
cudaError_t k1_setup() {
  const cudaError_t err = cudaFuncSetAttribute(
      tridiag_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(tridiag_solve_kernel,
                              cudaFuncAttributeNonPortableClusterSizeAllowed,
                              1);
}

}  // namespace

// K1. dp, l: (n,) float32; B, X: (n, q) float32, row-major and contiguous.
// Launches one cluster on `stream` per group of up to kMaxQ columns and
// returns the first CUDA error of the set-up or a launch (0 on success); a
// card that cannot schedule the cluster fails the launch.
extern "C" int tridiag_solve_f32(const float* dp, const float* l,
                                 const float* B, float* X, int n, int q,
                                 void* stream) {
  if (n <= 0 || q <= 0) return 0;
  static const cudaError_t setup = k1_setup();
  if (setup != cudaSuccess) return static_cast<int>(setup);
  const int nblk = kCluster;
  // Rows per block and per tile, multiples of 4 (the tile's column stride,
  // tile_rows + 1, is then odd).
  const int span = ((n + nblk - 1) / nblk + 3) & ~3;
  for (int j0 = 0; j0 < q; j0 += kMaxQ) {
    const int qg = q - j0 < kMaxQ ? q - j0 : kMaxQ;
    const int nw = kK1Threads / 32;
    const int cpp = qg < nw ? qg : nw;
    const int npass = (qg + cpp - 1) / cpp;
    // wc, wv; xc, xv; tc, tv, carry and the four totals; gc, gv; sl's row
    // and the padding row of the tile.
    const int fixed = 64 + 2 * npass * kK1Threads + 7 * qg + 2 * nblk * qg
                      + 1 + qg;
    const int fit = ((kSmemBytes / 4 - fixed) / (qg + 2)) & ~3;
    const int tile_rows = span < fit ? span : fit;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(nblk);
    cfg.blockDim = dim3(kK1Threads);
    cfg.dynamicSmemBytes =
        static_cast<size_t>(tile_rows * (qg + 2) + fixed) * sizeof(float);
    cfg.stream = static_cast<cudaStream_t>(stream);
    cudaLaunchAttribute cluster_dim[1];
    cluster_dim[0].id = cudaLaunchAttributeClusterDimension;
    cluster_dim[0].val.clusterDim.x = nblk;
    cluster_dim[0].val.clusterDim.y = 1;
    cluster_dim[0].val.clusterDim.z = 1;
    cfg.attrs = cluster_dim;
    cfg.numAttrs = 1;
    const cudaError_t err = cudaLaunchKernelEx(
        &cfg, tridiag_solve_kernel, dp, l, B + j0, X + j0, n, qg, q, span,
        tile_rows);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
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
