// K5, the block-banded product L(w) V, and K7, the coarse correction of the
// banded two-level V-cycle.
//
// ---------------------------------------------------------------------------
// K5. Stands for no Pallas kernel: it is mac_tpu.ops.banded.banded_apply
// (mac_tpu/ops/banded.py:466-521), the einsums that XLA fuses inside the
// reference's compiled program. L(w) is held as its transposed upper block
// diagonals ut (half+1, nb, 128, 128), ut[t][b][c][r] = L[128 b + r,
// 128 (b + t) + c] (t = 0: the strict upper part of the diagonal block), and
// its diagonal deg (nb, 128). Block row b of the product, against the
// window-centred input Vc = V - cb (cb the mean of V over the 2 half + 1
// blocks of b's window, zeros past the ends; exact for any cb since the
// rows of L sum to zero inside the window):
//     out_b = deg_b * Vc_b + ut[0][b]^T Vc_b + ut[0][b] Vc_b
//           + sum over t of ut[t][b]^T Vc_{b+t} + ut[t][b-t] Vc_{b-t},
// in that order, each product summed over its 128 columns. The kernel reads
// ut[t][b] where the direct product needs it and ut[t][b-t] where the
// transposed one does: no window stack and no shifted copy of ut is built
// (the plain version, PyTorch's, builds both).
//
// Epilogues (all in the plain version's order of operations):
//   plain     y = L V;
//   inner     y = (L V + shift) + sigma V, shift = (c / n) 1 1^T V with the
//             column means in float64 (lobpcg._shift_term);
//   residual  out = (B - mean(B)) - y, B's centring optional (the V-cycle's
//             residuals of the centred right-hand side);
// and, with any of them, the column dots of V and out (P . AP of the CG
// step) in float64, summed in a fixed order (per block, then the last block
// to take a ticket sums the blocks' partials in K6's fixed order).
// Where the plain version takes its size-gated branch (huge windows: the
// window means from a cumsum of per-block sums), the wrapper hands the
// kernel those means (cb), computed as that branch computes them.
//
// Two bodies, one grid shape: a block per (rows inside a block row, column
// tile, lane), so any q and any number of lanes (the budget sweep's
// (R, n, q), the outer iteration's (n, 3q), the coarse assembly's n x nc):
//   narrow (q <= 16: the CG step's (n, 4)): 32 rows by up to 8 columns;
//     every term's centred block of V staged in shared memory at once, then
//     each warp takes an eighth of the terms' columns, a row a lane, reading
//     ut straight from device memory (each element once) into register
//     sums, and the warps' sums add in warp order;
//   wide (q > 16): 64 rows by 64 columns, a 4 x 4 register tile a thread;
//     each term stages its piece of ut (transposed where the product reads
//     its rows) and the centred block of V in shared memory.
// What bounds it on the H100: bytes. ut is read once where the direct
// product takes it and once more (from L2) for the transposed one:
// 15.5 MB at city10000, 4.6 us at 3.35 TB/s; the nc-column coarse
// assembly is bound by its operations (6.5 GFLOP, 0.097 ms).
//
// ---------------------------------------------------------------------------
// K7. Stands for no Pallas kernel: the coarse correction of the reference's
// V-cycle (mac_tpu/ops/banded.py:793-800), x += P Lc^-1 R r, with R summing
// s consecutive original-order rows (aggregate a holds rows a s .. a s +
// s - 1 of the original order, RCM row iperm[j] for original row j) and P
// its transpose. Two launches:
//   k7_restrict  one block per chunk of kAggs aggregates (and column tile,
//                lane): the chunk's restricted sums rc (gathered through
//                iperm, in float64), then its share of Lc^-1 rc, the columns
//                of Lc^-1 for its aggregates, into a float64 partial per
//                chunk;
//   k7_prolong   one block per chunk again: each aggregate's xc as the sum
//                of the chunks' partials in chunk order, rounded to T, added
//                into the rows of x that the aggregate holds (each RCM row
//                once).
// What bounds it: Lc^-1's bytes (1 MB at nc = 500 in float32, 0.3 us) and
// two launches.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BS = 128;
constexpr int kThreads = 256;
constexpr int kSmemCap = 220 * 1024;

// Products and sums rounded one at a time where the plain version rounds
// each tensor operation (no contraction into an fma).
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

__device__ bool last_ticket(unsigned* ticket, unsigned total) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == total - 1;
  __syncthreads();
  if (last) __threadfence();
  return last;
}

template <typename T>
struct K5Args {
  const T* ut;          // lanes of (half+1, nb, BS, BS)
  long long ut_lane;
  const T* deg;         // lanes of (nb, BS)
  long long deg_lane;
  const T* V;           // lanes of (n, q)
  long long v_lane;     // 0: one V for every lane
  T* out;               // (lanes, n, q)
  const T* B;           // residual form: lanes of (n, q), or null
  long long b_lane;
  const double* bsum;   // (lanes, q): B's centring, or null
  const double* vsum;   // (lanes, q): inner form's shift (V's column sums)
  const T* c;           // the shift's coefficient per lane (stride c_lane)
  long long c_lane;
  const T* sigma;       // sigma per lane (stride s_lane), or null
  long long s_lane;
  const T* cb;          // (lanes, nb, q) window means given, or null
  double* part;         // dot partials (lanes, q, gridDim.x), or null
  double* dot;          // (lanes, q)
  unsigned* ticket;
  int n, q, nb, half;
};

// The window means of block row b over the columns [c0, c0 + qn) of V
// (already offset by c0) into cbs, in T: each thread sums a fixed stride of
// the window's rows of one column in float64, then the threads' partials
// add in order; or the wrapper's means (a.cb). qt: the tile's columns
// (qn <= qt, blockDim.x % qt == 0). red: blockDim.x doubles.
template <typename T>
__device__ void window_means(const K5Args<T>& a, const T* V, int b, int c0,
                             int qn, int qt, long long lane, T* cbs,
                             double* red) {
  const int t = threadIdx.x;
  if (a.cb != nullptr) {
    if (t < qn) cbs[t] = a.cb[(lane * a.nb + b) * a.q + c0 + t];
    __syncthreads();
    return;
  }
  const int ns = blockDim.x / qt;
  const int col = t % qt, slot = t / qt;
  const long long lo = max(0LL, (long long)(b - a.half) * BS);
  const long long hi = min((long long)a.n, (long long)(b + a.half + 1) * BS);
  double acc = 0.0;
  if (col < qn)
    for (long long g = lo + slot; g < hi; g += ns)
      acc += static_cast<double>(V[g * a.q + col]);
  red[t] = acc;
  __syncthreads();
  if (t < qn) {
    double sum = 0.0;
    for (int k = 0; k < ns; ++k) sum += red[t + k * qt];
    cbs[t] = static_cast<T>(sum / static_cast<double>((2 * a.half + 1) * BS));
  }
  __syncthreads();
}

// Term k of block row b: 0 ut[0][b]^T Vc_b, 1 ut[0][b] Vc_b, then for t = 1
// .. half ut[t][b]^T Vc_{b+t} (direct) and ut[t][b-t] Vc_{b-t}: the block
// of V it reads (bv, < 0 for none: the plain version adds zeros) and the
// piece of ut (read as U[c][r] when direct, U[r][c] otherwise).
struct Term {
  int tt, bv, bu;
  bool direct;
};

__device__ __forceinline__ Term term_of(int k, int b) {
  Term m;
  m.tt = k < 2 ? 0 : (k - 2) / 2 + 1;
  m.direct = (k % 2) == 0;
  m.bv = m.direct ? b + m.tt : b - m.tt;
  m.bu = m.direct ? b : b - m.tt;
  return m;
}

// The epilogue of one output (row, col) from L V's value acc and V's
// value v0 there (module comment); writes out and returns it.
template <typename T>
__device__ __forceinline__ T k5_out(const K5Args<T>& a, T acc, T v0,
                                    long long lane, long long row, int col) {
  T y = acc;
  const long long lc = lane * a.q + col;
  if (a.vsum != nullptr) {
    const double c64 = static_cast<double>(a.c[lane * a.c_lane]);
    y = add_rn(y, static_cast<T>(c64 * (a.vsum[lc] /
                                        static_cast<double>(a.n))));
  }
  if (a.sigma != nullptr)
    y = add_rn(y, mul_rn(a.sigma[lane * a.s_lane], v0));
  if (a.B != nullptr) {
    T bb = a.B[lane * a.b_lane + row * a.q + col];
    if (a.bsum != nullptr)
      bb = bb - static_cast<T>(a.bsum[lc] / static_cast<double>(a.n));
    y = bb - y;
  }
  a.out[lane * (long long)a.n * a.q + row * a.q + col] = y;
  return y;
}

// After each block has written its column dots' partials: the block that
// takes the last ticket sums them in a fixed order, K6's (a warp per
// column: each lane a fixed stride of blocks in order, then a fixed
// butterfly over the lanes).
template <typename T>
__device__ void k5_finish_dots(const K5Args<T>& a) {
  if (!last_ticket(a.ticket, gridDim.x * gridDim.y * gridDim.z)) return;
  const int count = static_cast<int>(gridDim.z) * a.q;
  const int nblk = static_cast<int>(gridDim.x);
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x >> 5; i < count; i += blockDim.x >> 5) {
    double sum = 0.0;
    for (int k = lane; k < nblk; k += 32)
      sum += __ldcg(a.part + (long long)i * nblk + k);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) a.dot[i] = sum;
  }
  if (threadIdx.x == 0) *a.ticket = 0u;
}

// Narrow blocks (q up to 16; the CG step's (n, 4)): a block of kNarrowRows
// rows by QT columns, kNarrowThreads threads. Every term's centred block
// of V is staged in shared memory at once; warp w then takes the w-th
// eighth of the terms' 128 columns, lane r row r0 + r, into QT register
// sums. A direct term's piece is read straight from device memory (a row
// of 32 lanes is 128 contiguous bytes); a transposed term's rows are
// contiguous along c instead, so the warp reads them 32 columns at a time
// with its lanes along c (coalesced) into a 32 x 33 tile of its own in
// shared memory, and each lane then walks its row there. The warps' sums
// add in warp order after the degree term.
constexpr int kNarrowRows = 32;
constexpr int kNarrowThreads = 256;
constexpr int kWarps = kNarrowThreads / 32;
constexpr int kTile = 32 * 33;  // a warp's transposing tile

template <typename T, int QT>
__global__ void __launch_bounds__(kNarrowThreads) k5_narrow(K5Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* red = reinterpret_cast<double*>(smem_raw);  // kNarrowThreads
  T* cbs = reinterpret_cast<T*>(red + kNarrowThreads);  // 16
  T* wsum = cbs + 16;                                 // kWarps * 32 * QT
  T* tiles = wsum + kWarps * kNarrowRows * QT;        // kWarps * kTile
  T* Vs = tiles + kWarps * kTile;                     // nterms * BS * QT
  const int per_row = BS / kNarrowRows;
  const int b = blockIdx.x / per_row;
  const int r0 = (blockIdx.x % per_row) * kNarrowRows;
  const int c0 = blockIdx.y * QT;
  const int qn = min(QT, a.q - c0);
  const long long lane = blockIdx.z;
  const int n = a.n, q = a.q, nb = a.nb;
  const int nterms = 2 * a.half + 2;
  const T* ut = a.ut + lane * a.ut_lane;
  const T* deg = a.deg + lane * a.deg_lane;
  const T* V = a.V + lane * a.v_lane + c0;
  const int t = threadIdx.x;

  window_means(a, V, b, c0, qn, QT, lane, cbs, red);
  for (int e = t; e < nterms * BS * QT; e += kNarrowThreads) {
    const int k = e / (BS * QT);
    const int c = (e / QT) % BS, j = e % QT;
    const Term m = term_of(k, b);
    const long long g = (long long)m.bv * BS + c;
    const T v = (m.bv >= 0 && m.bv < nb && g < n && j < qn) ? V[g * q + j]
                                                            : T(0);
    Vs[e] = v - cbs[j < qn ? j : 0];
  }
  __syncthreads();

  const int w = t >> 5, lr = t & 31;
  T acc[QT];
#pragma unroll
  for (int j = 0; j < QT; ++j) acc[j] = T(0);
  const int per_warp = nterms * BS / kWarps;
  const int g0 = w * per_warp, g1 = g0 + per_warp;
  for (int k = g0 / BS; k * BS < g1; ++k) {
    const Term m = term_of(k, b);
    if (m.bv < 0) continue;
    const int cs = max(g0, k * BS) - k * BS;
    const int ce = min(g1, (k + 1) * BS) - k * BS;
    const T* U = ut + ((long long)m.tt * nb + m.bu) * BS * BS;
    const T* vs = Vs + k * BS * QT;
    if (m.direct) {
      const T* u = U + r0 + lr;
#pragma unroll 8
      for (int c = cs; c < ce; ++c) {
        const T x = __ldg(u + c * BS);
#pragma unroll
        for (int j = 0; j < QT; ++j) acc[j] += x * vs[c * QT + j];
      }
    } else {  // cs and ce are multiples of 32
      T* tile = tiles + w * kTile;
      for (int cb = cs; cb < ce; cb += 32) {
        const T* u = U + r0 * BS + cb + lr;
#pragma unroll 8
        for (int r = 0; r < 32; ++r) tile[lr * 33 + r] = __ldg(u + r * BS);
        __syncwarp();
#pragma unroll 8
        for (int cc = 0; cc < 32; ++cc) {
          const T x = tile[cc * 33 + lr];
#pragma unroll
          for (int j = 0; j < QT; ++j)
            acc[j] += x * vs[(cb + cc) * QT + j];
        }
        __syncwarp();
      }
    }
  }
#pragma unroll
  for (int j = 0; j < QT; ++j) wsum[(w * kNarrowRows + lr) * QT + j] = acc[j];
  __syncthreads();

  double p = 0.0;
  if (t < kNarrowRows * QT) {
    const int r = t / QT, j = t % QT;
    const long long row = (long long)b * BS + r0 + r;
    if (row < n && j < qn) {
      const T v0 = V[row * q + j];
      T o = mul_rn(deg[(long long)b * BS + r0 + r], v0 - cbs[j]);
      for (int w2 = 0; w2 < kWarps; ++w2)
        o = add_rn(o, wsum[(w2 * kNarrowRows + r) * QT + j]);
      const T y = k5_out(a, o, v0, lane, row, c0 + j);
      p = static_cast<double>(mul_rn(v0, y));
    }
  }
  if (a.part == nullptr) return;
  __syncthreads();  // red is free again
  red[t] = p;
  __syncthreads();
  if (t < qn) {
    double sum = 0.0;
    for (int r = 0; r < kNarrowRows; ++r) sum += red[r * QT + t];
    a.part[(lane * q + c0 + t) * gridDim.x + blockIdx.x] = sum;
  }
  k5_finish_dots(a);
}

// Wide blocks (q past 16: the coarse assembly's nc columns, the outer
// iteration's 3q at q = 11): a block of 64 rows by 64 columns, each thread
// a 4 x 4 tile of outputs. Each term stages its 128 x 64 piece of ut as
// S[c][r] (the transposed product's rows transposed on the way in) and the
// centred 128 x 64 block of V in shared memory; each thread sums its 16
// outputs' 128 products in registers, and the term's sums add to the
// outputs in term order, after the degree term.
constexpr int kWideRows = 64;
constexpr int kWideCols = 64;
constexpr int kLdS = kWideRows + 4;

// Four consecutive values from 16-byte-aligned shared memory in vector
// loads (one for float, two for double).
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
}
__device__ __forceinline__ void load4(const double* p, double (&v)[4]) {
  const double2 x = *reinterpret_cast<const double2*>(p);
  const double2 y = *reinterpret_cast<const double2*>(p + 2);
  v[0] = x.x;
  v[1] = x.y;
  v[2] = y.x;
  v[3] = y.y;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) k5_wide(K5Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* red = reinterpret_cast<double*>(smem_raw);  // kThreads
  T* cbs = reinterpret_cast<T*>(red + kThreads);      // kWideCols
  T* S = cbs + kWideCols;                             // BS * kLdS
  T* Vs = S + BS * kLdS;                              // BS * kWideCols
  const int per_row = BS / kWideRows;
  const int b = blockIdx.x / per_row;
  const int r0 = (blockIdx.x % per_row) * kWideRows;
  const int c0 = blockIdx.y * kWideCols;
  const int qn = min(kWideCols, a.q - c0);
  const long long lane = blockIdx.z;
  const int n = a.n, q = a.q, nb = a.nb;
  const int nterms = 2 * a.half + 2;
  const T* ut = a.ut + lane * a.ut_lane;
  const T* deg = a.deg + lane * a.deg_lane;
  const T* V = a.V + lane * a.v_lane + c0;
  const int t = threadIdx.x;
  const int tr = t / 16, tc = t % 16;

  window_means(a, V, b, c0, qn, kWideCols, lane, cbs, red);
  T acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long row = (long long)b * BS + r0 + tr * 4 + i;
    const T d = deg[(long long)b * BS + r0 + tr * 4 + i];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = tc * 4 + j;
      const T v0 = (row < n && col < qn) ? V[row * q + col] : T(0);
      acc[i][j] = mul_rn(d, v0 - cbs[col < qn ? col : 0]);
    }
  }
  for (int k = 0; k < nterms; ++k) {
    const Term m = term_of(k, b);
    if (m.bv < 0) continue;
    const T* U = ut + ((long long)m.tt * nb + m.bu) * BS * BS;
    __syncthreads();  // the previous term's reads are done
    for (int e = t; e < BS * kWideCols; e += kThreads) {
      const int c = e / kWideCols, j = e % kWideCols;
      const long long g = (long long)m.bv * BS + c;
      const T v = (m.bv < nb && g < n && j < qn) ? V[g * q + j] : T(0);
      Vs[e] = v - cbs[j < qn ? j : 0];
    }
    if (m.direct) {
      for (int e = t; e < BS * kWideRows; e += kThreads) {
        const int c = e / kWideRows, rr = e % kWideRows;
        S[c * kLdS + rr] = U[c * BS + r0 + rr];
      }
    } else {
      for (int e = t; e < BS * kWideRows; e += kThreads) {
        const int rr = e / BS, c = e % BS;
        S[c * kLdS + rr] = U[(r0 + rr) * BS + c];
      }
    }
    __syncthreads();
    T sum[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sum[i][j] = T(0);
#pragma unroll 4
    for (int c = 0; c < BS; ++c) {
      T x[4], y[4];
      load4(S + c * kLdS + tr * 4, x);
      load4(Vs + c * kWideCols + tc * 4, y);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sum[i][j] += x[i] * y[j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = add_rn(acc[i][j], sum[i][j]);
  }

  double p[4] = {0.0, 0.0, 0.0, 0.0};  // column dots over this thread's rows
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long row = (long long)b * BS + r0 + tr * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = tc * 4 + j;
      if (row < n && col < qn) {
        const T v0 = V[row * q + col];
        const T y = k5_out(a, acc[i][j], v0, lane, row, c0 + col);
        p[j] += static_cast<double>(mul_rn(v0, y));
      }
    }
  }
  if (a.part == nullptr) return;
  __syncthreads();  // S is free: 16 x 64 doubles of partials
  double* cs = reinterpret_cast<double*>(S);
#pragma unroll
  for (int j = 0; j < 4; ++j) cs[tr * kWideCols + tc * 4 + j] = p[j];
  __syncthreads();
  if (t < qn) {
    double sum = 0.0;
    for (int r = 0; r < 16; ++r) sum += cs[r * kWideCols + t];
    a.part[(lane * q + c0 + t) * gridDim.x + blockIdx.x] = sum;
  }
  k5_finish_dots(a);
}

template <typename T, int QT>
int k5_narrow_launch(K5Args<T> a, int lanes, cudaStream_t st) {
  const size_t smem =
      kNarrowThreads * sizeof(double) +
      (16 + kWarps * kNarrowRows * QT + kWarps * kTile +
       (2 * a.half + 2) * BS * QT) *
          sizeof(T);
  static const cudaError_t setup = cudaFuncSetAttribute(
      k5_narrow<T, QT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemCap);
  if (setup != cudaSuccess) return static_cast<int>(setup);
  if (smem > kSmemCap) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(a.nb * (BS / kNarrowRows), (a.q + QT - 1) / QT, lanes);
  k5_narrow<T, QT><<<grid, kNarrowThreads, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int k5_launch(K5Args<T> a, int lanes, void* stream) {
  if (a.n <= 0 || a.q <= 0 || lanes <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a.q <= 1) return k5_narrow_launch<T, 1>(a, lanes, st);
  if (a.q <= 2) return k5_narrow_launch<T, 2>(a, lanes, st);
  if (a.q <= 4) return k5_narrow_launch<T, 4>(a, lanes, st);
  if (a.q <= 16) return k5_narrow_launch<T, 8>(a, lanes, st);
  static const cudaError_t setup = cudaFuncSetAttribute(
      k5_wide<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemCap);
  if (setup != cudaSuccess) return static_cast<int>(setup);
  const size_t smem = kThreads * sizeof(double) +
                      (kWideCols + BS * kLdS + BS * kWideCols) * sizeof(T);
  const dim3 grid(a.nb * (BS / kWideRows),
                  (a.q + kWideCols - 1) / kWideCols, lanes);
  k5_wide<T><<<grid, kThreads, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// K7.

constexpr int kAggs = 16;  // aggregates per block
constexpr int kCols = 32;  // columns per tile

template <typename T>
__global__ void __launch_bounds__(kThreads)
k7_restrict(const T* __restrict__ r, const int* __restrict__ iperm,
            const T* __restrict__ Lc_inv, long long lc_lane,
            double* xcp, int n, int q, int nc, int s) {
  __shared__ double rc[kAggs * kCols];
  const int chunk = blockIdx.x;
  const int nchunk = gridDim.x;
  const int c0 = blockIdx.y * kCols;
  const int qc = min(kCols, q - c0);
  const long long lane = blockIdx.z;
  r += lane * n * q + c0;
  Lc_inv += lane * lc_lane;
  const int a0 = chunk * kAggs;
  for (int e = threadIdx.x; e < kAggs * qc; e += kThreads) {
    const int a = e / qc, j = e - (e / qc) * qc;
    double acc = 0.0;
    if (a0 + a < nc) {
      const long long j0 = (long long)(a0 + a) * s;
      const long long j1 = min(j0 + s, (long long)n);
      for (long long jj = j0; jj < j1; ++jj)
        acc += static_cast<double>(r[(long long)iperm[jj] * q + j]);
    }
    rc[a * qc + j] = acc;
  }
  __syncthreads();
  const int na = min(kAggs, nc - a0);
  double* out = xcp + (lane * nchunk + chunk) * (long long)nc * q + c0;
  for (int e = threadIdx.x; e < nc * qc; e += kThreads) {
    const int i = e / qc, j = e - (e / qc) * qc;
    const T* row = Lc_inv + (long long)i * nc + a0;
    double acc = 0.0;
    for (int a = 0; a < na; ++a)
      acc += static_cast<double>(row[a]) * rc[a * qc + j];
    out[(long long)i * q + j] = acc;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
k7_prolong(T* x, const int* __restrict__ iperm,
           const double* __restrict__ xcp, int n, int q, int nc, int s) {
  __shared__ T xc[kAggs * kCols];
  const int chunk = blockIdx.x;
  const int nchunk = gridDim.x;
  const int c0 = blockIdx.y * kCols;
  const int qc = min(kCols, q - c0);
  const long long lane = blockIdx.z;
  x += lane * n * q + c0;
  const int a0 = chunk * kAggs;
  const double* part = xcp + lane * nchunk * (long long)nc * q + c0;
  for (int e = threadIdx.x; e < kAggs * qc; e += kThreads) {
    const int a = e / qc, j = e - (e / qc) * qc;
    double acc = 0.0;
    if (a0 + a < nc)
      for (int k = 0; k < nchunk; ++k)
        acc += part[((long long)k * nc + a0 + a) * q + j];
    xc[a * qc + j] = static_cast<T>(acc);
  }
  __syncthreads();
  const int per_agg = s * qc;
  for (int e = threadIdx.x; e < kAggs * per_agg; e += kThreads) {
    const int a = e / per_agg;
    const int rem = e - a * per_agg;
    const long long jj = (long long)(a0 + a) * s + rem / qc;
    const int j = rem - (rem / qc) * qc;
    if (a0 + a < nc && jj < n) {
      T* dst = x + (long long)iperm[jj] * q + j;
      *dst = add_rn(*dst, xc[a * qc + j]);
    }
  }
}

template <typename T>
int k7_launch(const T* r, T* x, const int* iperm, const T* Lc_inv,
              long long lc_lane, double* xcp, int n, int q, int nc, int s,
              int lanes, void* stream) {
  if (n <= 0 || q <= 0 || nc <= 0 || lanes <= 0) return 0;
  const dim3 grid((nc + kAggs - 1) / kAggs, (q + kCols - 1) / kCols, lanes);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  k7_restrict<T><<<grid, kThreads, 0, st>>>(r, iperm, Lc_inv, lc_lane, xcp, n,
                                            q, nc, s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  k7_prolong<T><<<grid, kThreads, 0, st>>>(x, iperm, xcp, n, q, nc, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K5. ut, deg, V, out, B in T (float: _f32, double: _f64), row-major and
// contiguous per lane, at the lane strides given (0: one array for every
// lane); out (lanes, n, q). Null pointers leave the epilogue's parts out
// (see above); part must hold lanes * q * nb * 4 float64 and ticket one
// unsigned counter at 0 (left at 0) where dot is asked for. Returns the
// launch's cudaError_t (0 on success).
#define K5_EXPORT(T, S)                                                     \
  extern "C" int banded_product_##S(                                        \
      const T* ut, long long ut_lane, const T* deg, long long deg_lane,     \
      const T* V, long long v_lane, T* out, const T* B, long long b_lane,   \
      const double* bsum, const double* vsum, const T* c, long long c_lane, \
      const T* sigma, long long s_lane, const T* cb, double* part,          \
      double* dot, unsigned* ticket, int n, int q, int nb, int half,        \
      int lanes, void* stream) {                                            \
    K5Args<T> a = {ut,   ut_lane, deg,    deg_lane, V,    v_lane, out,     \
                   B,    b_lane,  bsum,   vsum,     c,    c_lane, sigma,   \
                   s_lane, cb,    part,   dot,      ticket, n,    q,       \
                   nb,   half};                                           \
    return k5_launch<T>(a, lanes, stream);                                  \
  }

K5_EXPORT(float, f32)
K5_EXPORT(double, f64)

// K7. r (the residual) and x (updated in place) (lanes, n, q) in T, Lc_inv
// lanes of (nc, nc) at lane stride lc_lane (0: shared), iperm (n,) int32,
// xcp a float64 scratch of lanes * ceil(nc / 16) * nc * q. Two launches;
// returns the first cudaError_t (0 on success).
#define K7_EXPORT(T, S)                                                      \
  extern "C" int coarse_correct_##S(const T* r, T* x, const int* iperm,      \
                                    const T* Lc_inv, long long lc_lane,      \
                                    double* xcp, int n, int q, int nc,       \
                                    int s, int lanes, void* stream) {        \
    return k7_launch<T>(r, x, iperm, Lc_inv, lc_lane, xcp, n, q, nc, s,      \
                        lanes, stream);                                      \
  }

K7_EXPORT(float, f32)
K7_EXPORT(double, f64)
