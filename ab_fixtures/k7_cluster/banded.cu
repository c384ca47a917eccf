// A/B fixture for kernel_ab.py --cg-only (a VARIANT_DIR): csrc/banded.cu
// with K7 as one launch of a thread-block cluster per (column tile, lane)
// (the K7 section below), the first design tried for the one-launch coarse
// correction. Its results are bitwise the shipped K7's; it is timed beside
// it (its export takes the shipped K7's arguments and leaves the rc
// scratch unused). K5 here is the shipped K5.
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
// Two bodies, one launch per product, a block per (rows of a block row,
// column tile, lane), so any q and any number of lanes (the budget sweep's
// (R, n, q), the outer iteration's (n, 3q), the coarse assembly's n x nc).
// Both stream ut and V through a ring of shared-memory stages filled by
// cp.async (16-byte copies spread over the block's threads, a commit group
// a stage), rows padded so that the reads that follow are free of bank
// conflicts; no stage is transposed by stores, the transposition is in
// the read pattern. The direct product's piece of a tile is strided (a
// segment of each of the tile's 128 rows): a bulk copy would take it as
// one copy per segment.
//
//   narrow (q <= 16: the CG step's (n, 4) and (n, 11), the V-cycle's
//     residuals, the lanes, float64). Bound by bytes: ut, 15.5 MB at
//     city10000 in float32 (4.7 us at 3.35 TB/s) against q / 2 operations
//     a byte, below the card's ridge; each tile is read by the block row
//     above it and the one below (the second read from L2). A block of 32
//     rows by every column (up to 16, so that ut is streamed once a
//     product, not once per 8 columns), nb * 4 blocks of 8 warps. Its first
//     instructions put V's window (2 half + 1 blocks) and its first two
//     stages in flight (a stage: a term's 128 columns in float, half of
//     them in double); the means come from the staged window (float64,
//     each thread a fixed stride of rows, a fixed butterfly over a warp,
//     the warps in order), and V is centred as it is read. Warp s sums,
//     for row r0 + lane, the products over the 16-byte units s, s + 8, ...
//     of each stage: a direct piece is stored [c][r] (a warp's 32 rows
//     contiguous), a transposed one [r][c] with rows 132 (float) or 66
//     (double) apart, so that a quarter-warp's 16-byte loads on 8 rows cover
//     the 32 banks; V's rows are broadcasts. The 8 slices' sums add in slice
//     order after the degree term.
//   wide (q > 16: the coarse assembly's L R at nc = 500 columns, the outer
//     iteration's (n, 3q) past q = 5). Bound by operations (6.5 GFLOP at
//     nc = 500). On the tensor cores, as the reference runs this product on
//     the TPU's matrix unit at precision=HIGHEST: block row b's terms are one
//     product of K = (2 half + 2) 128 against a 64-column tile of the centred
//     V; a block is the whole block row by 64 columns, 8 warps of 32 x 32.
//     float: mma.sync m16n8k8 TF32 with each operand split as hi + lo (hi =
//     TF32(x), lo = TF32(x - hi)) and the three products lo hi, hi lo, hi hi
//     ("3xTF32", about 22 bits of each operand; one TF32 product keeps 10
//     bits of ut and is not used); each 32-column chunk sums in its own
//     accumulators, which add to the output's in float32 rounded to nearest,
//     so the tensor cores' truncating additions span 12 products. double:
//     mma.sync m8n8k4 (DMMA, float64 products and sums). A stage holds a
//     chunk's 128 x KC piece of ut, [c][r] when direct and [r][c] when
//     transposed, and the KC x 64 raw rows of V; V is centred as its
//     fragment is read. The window means come from the block's own loads of
//     the window (20 16-byte loads, or 32 single ones, in flight a thread)
//     while the first stages arrive; the
//     epilogue loads an m-tile's V (and B) at once before it stores.
//
// ---------------------------------------------------------------------------
// K7. Stands for no Pallas kernel: the coarse correction of the reference's
// V-cycle (mac_tpu/ops/banded.py:793-800), x += P Lc^-1 R r, with R summing
// s consecutive original-order rows (aggregate a holds rows a s .. a s +
// s - 1 of the original order, RCM row iperm[j] for original row j) and P
// its transpose. Its arithmetic (float64 sums, every sum in a fixed order):
// rc[a] = the aggregate's rows of r added in row order; xc[i] = the sum of
// chunk partials in chunk order, the partial of chunk k the products
// Lc^-1[i][a] rc[a] (fma) over its kAggs aggregates a in order; x's rows
// += xc rounded to T. One launch, see the K7 section below.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int BS = 128;
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

// B's value at (row, col) for the residual form (0 without B).
template <typename T>
__device__ __forceinline__ T k5_b(const K5Args<T>& a, long long lane,
                                  long long row, int col) {
  return a.B != nullptr ? a.B[lane * a.b_lane + row * a.q + col] : T(0);
}

// The epilogue of one output (row, col) from L V's value acc, V's value
// v0 and B's bb there (module comment); writes out and returns it.
template <typename T>
__device__ __forceinline__ T k5_out(const K5Args<T>& a, T acc, T v0, T bb,
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
    if (a.bsum != nullptr)
      bb = bb - static_cast<T>(a.bsum[lc] / static_cast<double>(a.n));
    y = bb - y;
  }
  a.out[lane * (long long)a.n * a.q + row * a.q + col] = y;
  return y;
}

// After each block has written its column dots' partials: the block that
// takes the last ticket sums them in a fixed order, K6's (a warp per
// column: each lane a fixed stride of blocks in order, 8 loads in flight,
// then a fixed butterfly over the lanes).
template <typename T>
__device__ void k5_finish_dots(const K5Args<T>& a) {
  if (!last_ticket(a.ticket, gridDim.x * gridDim.y * gridDim.z)) return;
  const int count = static_cast<int>(gridDim.z) * a.q;
  const int nblk = static_cast<int>(gridDim.x);
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x >> 5; i < count; i += blockDim.x >> 5) {
    double sum = 0.0;
    for (int k0 = lane; k0 < nblk; k0 += 8 * 32) {
      double x[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int k = k0 + 32 * u;
        x[u] = k < nblk ? __ldcg(a.part + (long long)i * nblk + k) : 0.0;
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) sum += x[u];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) a.dot[i] = sum;
  }
  if (threadIdx.x == 0) *a.ticket = 0u;
}

// Asynchronous copies into shared memory (cp.async): 16 bytes, or E of
// 4 or 8, zero-filled past `bytes` (0 reads nothing); a commit group per
// ring stage, and the wait for all but the N newest groups.
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
template <int E>
__device__ __forceinline__ void cp_elem(void* dst, const void* src,
                                        int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "n"(E), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// N consecutive values, in 16-byte loads where N fills them (the address
// then 16-byte aligned), else one at a time.
template <int N>
__device__ __forceinline__ void ld_vec(const float* p, float (&v)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 x = *reinterpret_cast<const float4*>(p + i);
      v[i] = x.x;
      v[i + 1] = x.y;
      v[i + 2] = x.z;
      v[i + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = p[i];
  }
}
template <int N>
__device__ __forceinline__ void ld_vec(const double* p, double (&v)[N]) {
  if constexpr (N % 2 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 2) {
      const double2 x = *reinterpret_cast<const double2*>(p + i);
      v[i] = x.x;
      v[i + 1] = x.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = p[i];
  }
}

// ---------------------------------------------------------------------------
// K5's narrow body (q <= 16). A block of kNarrowRows rows of one block row
// and QT columns; warp s is slice s of kSlices, lane r row r0 + r.
constexpr int kNarrowMaxQ = 16;
constexpr int kNarrowRows = 32;
constexpr int kNarrowThreads = 256;
constexpr int kSlices = kNarrowThreads / kNarrowRows;
constexpr int kNarrowRed = 2 * kNarrowThreads;         // doubles
constexpr int kNarrowRing = kNarrowRed * 8 + 16 * 8;  // bytes before the ring

template <typename T, int QT>
struct Narrow {
  static constexpr int CU = 16 / sizeof(T);  // elements in 16 bytes
  // A stage: KCH of a term's 128 columns c (16.9 KB), stored direct [c][r]
  // (a warp's row of 32 lanes is contiguous) or transposed [r][c] with rows
  // LDT apart (a quarter-warp's 16-byte loads on 8 rows cover the 32
  // banks); STAGES of them, STAGES - 1 in flight ahead of the one in use.
  static constexpr int KCH = sizeof(T) == 4 ? BS : BS / 2;
  static constexpr int LDD = kNarrowRows;
  static constexpr int LDT = KCH + (sizeof(T) == 4 ? 4 : 2);
  static constexpr int STAGE =
      KCH * LDD > kNarrowRows * LDT ? KCH * LDD : kNarrowRows * LDT;
  static constexpr int STAGES = QT <= 8 ? 3 : 2;
  static constexpr int CHUNKS = BS / KCH;           // stages a term
  static constexpr int UNITS = KCH / CU / kSlices;  // 16-byte units a lane
  static constexpr int EPI = (kNarrowRows * QT + kNarrowThreads - 1) /
                             kNarrowThreads;  // outputs a thread
};

template <typename T, int QT>
size_t narrow_smem(int half) {
  using L = Narrow<T, QT>;
  return kNarrowRing + (static_cast<size_t>(L::STAGES) * L::STAGE +
                        static_cast<size_t>(2 * half + 1) * BS * QT) *
                           sizeof(T);
}

template <typename T, int QT>
__global__ void __launch_bounds__(kNarrowThreads, 3) k5_narrow(K5Args<T> a,
                                                               int vec) {
  using L = Narrow<T, QT>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* red = reinterpret_cast<double*>(smem_raw);  // kNarrowRed
  T* cbs = reinterpret_cast<T*>(red + kNarrowRed);    // QT
  T* ring = reinterpret_cast<T*>(smem_raw + kNarrowRing);
  T* Vw = ring + L::STAGES * L::STAGE;  // the window, (2 half + 1) BS x QT
  constexpr int per_row = BS / kNarrowRows;
  const int b = blockIdx.x / per_row;
  const int r0 = (blockIdx.x % per_row) * kNarrowRows;
  const int c0 = blockIdx.y * QT;
  const int qn = min(QT, a.q - c0);
  const long long lane = blockIdx.z;
  const int n = a.n, q = a.q, nb = a.nb, half = a.half;
  const int nchunks = (2 * half + 2) * L::CHUNKS;
  const int wrows = (2 * half + 1) * BS;
  const T* ut = a.ut + lane * a.ut_lane;
  const T* deg = a.deg + lane * a.deg_lane;
  const T* V = a.V + lane * a.v_lane + c0;
  const int t = threadIdx.x;

  // Chunk i (term i / CHUNKS, its columns c from KCH (i % CHUNKS)) into
  // ring stage i % STAGES: direct, the block's 32 rows r of each row c of
  // the tile; transposed, the tile's rows r0 .. r0 + 31 over those c.
  auto load = [&](int i) {
    const Term m = term_of(i / L::CHUNKS, b);
    if (m.bv < 0) return;
    const int k0 = (i % L::CHUNKS) * L::KCH;
    T* st = ring + (i % L::STAGES) * L::STAGE;
    const T* U = ut + ((long long)m.tt * nb + m.bu) * BS * BS;
    if (m.direct) {
      constexpr int per = kNarrowRows / L::CU;
      for (int e = t; e < L::KCH * per; e += kNarrowThreads) {
        const int c = e / per, p = (e % per) * L::CU;
        cp16(st + c * L::LDD + p, U + (k0 + c) * BS + r0 + p, 16);
      }
    } else {
      constexpr int per = L::KCH / L::CU;
      for (int e = t; e < kNarrowRows * per; e += kNarrowThreads) {
        const int rr = e / per, p = (e % per) * L::CU;
        cp16(st + rr * L::LDT + p, U + (r0 + rr) * BS + k0 + p, 16);
      }
    }
  };

  // V's window of block row b (blocks b - half .. b + half, zeros past V's
  // rows and columns) into Vw first, then the first chunks: one commit
  // group each, V's the oldest.
  const long long w0 = (long long)(b - half) * BS;
  if (vec) {
    constexpr int per = QT / L::CU;
    for (int e = t; e < wrows * per; e += kNarrowThreads) {
      const int i = e / per, j = (e % per) * L::CU;
      const long long g = w0 + i;
      const bool ok = g >= 0 && g < n && j < qn;
      cp16(Vw + i * QT + j, ok ? V + g * q + j : V, ok ? 16 : 0);
    }
  } else {
    for (int e = t; e < wrows * QT; e += kNarrowThreads) {
      const int i = e / QT, j = e % QT;
      const long long g = w0 + i;
      const bool ok = g >= 0 && g < n && j < qn;
      cp_elem<sizeof(T)>(Vw + e, ok ? V + g * q + j : V,
                         ok ? static_cast<int>(sizeof(T)) : 0);
    }
  }
  cp_commit();
#pragma unroll
  for (int s = 0; s < L::STAGES - 1; ++s) {
    if (s < nchunks) load(s);
    cp_commit();
  }

  // The epilogue's inputs from device memory, in flight from here: this
  // thread's outputs e = t + 256 k (row e / QT, column e % QT).
  T dg[L::EPI], bb[L::EPI];
#pragma unroll
  for (int k = 0; k < L::EPI; ++k) {
    const int e = t + k * kNarrowThreads, rr = e / QT, j = e % QT;
    const long long row = (long long)b * BS + r0 + rr;
    const bool ok = e < kNarrowRows * QT && row < n && j < qn;
    dg[k] = ok ? deg[(long long)b * BS + r0 + rr] : T(0);
    bb[k] = ok ? k5_b(a, lane, row, c0 + j) : T(0);
  }

  // The window's means over each column in float64 (each thread a fixed
  // stride of rows; then the strides of a warp by a fixed butterfly and
  // the 8 warps in order, or, where QT does not divide a warp, 8 partial
  // sums of the strides in order and those 8 in order), or the wrapper's.
  cp_wait<L::STAGES - 1>();
  __syncthreads();
  T v0[L::EPI];
#pragma unroll
  for (int k = 0; k < L::EPI; ++k) {
    const int e = t + k * kNarrowThreads;
    v0[k] = e < kNarrowRows * QT ? Vw[(half * BS + r0) * QT + e] : T(0);
  }
  if (a.cb != nullptr) {
    if (t < qn) cbs[t] = a.cb[(lane * nb + b) * q + c0 + t];
  } else {
    constexpr int ns = kNarrowThreads / QT;
    const int col = t % QT, slot = t / QT;
    double acc = 0.0;
    if (slot < ns && col < qn)
      for (int i = slot; i < wrows; i += ns)
        acc += static_cast<double>(Vw[i * QT + col]);
    if constexpr (32 % QT == 0) {
#pragma unroll
      for (int off = QT; off < 32; off <<= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if ((t & 31) < QT) red[(t >> 5) * QT + col] = acc;
      __syncthreads();
      if (t < qn) {
        double sum = 0.0;
#pragma unroll
        for (int k = 0; k < kNarrowThreads / 32; ++k) sum += red[k * QT + t];
        cbs[t] = static_cast<T>(sum / static_cast<double>(wrows));
      }
    } else {
      red[t] = acc;
      __syncthreads();
      if (t < 8 * QT) {
        double sum = 0.0;
        for (int k = slot; k < ns; k += 8) sum += red[k * QT + col];
        red[kNarrowThreads + t] = sum;
      }
      __syncthreads();
      if (t < qn) {
        double sum = 0.0;
#pragma unroll
        for (int k = 0; k < 8; ++k) sum += red[kNarrowThreads + k * QT + t];
        cbs[t] = static_cast<T>(sum / static_cast<double>(wrows));
      }
    }
  }
  __syncthreads();
  T cbr[QT];
#pragma unroll
  for (int j = 0; j < QT; ++j) cbr[j] = j < qn ? cbs[j] : T(0);

  // The chunks through the ring: lane r of warp s sums its row's products
  // over the 16-byte units s, s + 8, ... of each chunk's columns, each
  // value of V centred as it is read (V - cb, as the plain version rounds
  // it).
  const int r = t & 31, s = t >> 5;
  T acc[QT];
#pragma unroll
  for (int j = 0; j < QT; ++j) acc[j] = T(0);
  for (int i = 0; i < nchunks; ++i) {
    cp_wait<L::STAGES - 2>();
    __syncthreads();
    if (i + L::STAGES - 1 < nchunks) load(i + L::STAGES - 1);
    cp_commit();
    const Term m = term_of(i / L::CHUNKS, b);
    if (m.bv < 0) continue;
    const T* st = ring + (i % L::STAGES) * L::STAGE;
    const T* vs = Vw + ((m.bv - b + half) * BS + (i % L::CHUNKS) * L::KCH) *
                           QT;
#pragma unroll
    for (int u = 0; u < L::UNITS; ++u) {
      const int c = (s + kSlices * u) * L::CU;
      T x[L::CU];
      if (m.direct) {
#pragma unroll
        for (int kk = 0; kk < L::CU; ++kk) x[kk] = st[(c + kk) * L::LDD + r];
      } else {
        ld_vec(st + r * L::LDT + c, x);
      }
#pragma unroll
      for (int kk = 0; kk < L::CU; ++kk) {
        T v[QT];
        ld_vec(vs + (c + kk) * QT, v);
#pragma unroll
        for (int j = 0; j < QT; ++j) acc[j] += x[kk] * (v[j] - cbr[j]);
      }
    }
  }
  cp_wait<0>();
  __syncthreads();  // the ring is free: the slices' sums
  T* wsum = ring;   // [s][r][QT]
#pragma unroll
  for (int j = 0; j < QT; ++j) wsum[(s * kNarrowRows + r) * QT + j] = acc[j];
  __syncthreads();

  // The degree term, then the slices' sums in slice order; the column
  // dots' products into red, summed over the block's rows in order.
#pragma unroll
  for (int k = 0; k < L::EPI; ++k) {
    const int e = t + k * kNarrowThreads, rr = e / QT, j = e % QT;
    const long long row = (long long)b * BS + r0 + rr;
    double p = 0.0;
    if (e < kNarrowRows * QT && row < n && j < qn) {
      T o = mul_rn(dg[k], v0[k] - cbs[j]);
#pragma unroll
      for (int s2 = 0; s2 < kSlices; ++s2)
        o = add_rn(o, wsum[s2 * kNarrowRows * QT + e]);
      const T y = k5_out(a, o, v0[k], bb[k], lane, row, c0 + j);
      p = static_cast<double>(mul_rn(v0[k], y));
    }
    if (e < kNarrowRows * QT) red[e] = p;
  }
  if (a.part == nullptr) return;
  __syncthreads();
  if (t < qn) {
    double sum = 0.0;
    for (int rr = 0; rr < kNarrowRows; ++rr) sum += red[rr * QT + t];
    a.part[(lane * q + c0 + t) * gridDim.x + blockIdx.x] = sum;
  }
  k5_finish_dots(a);
}

// ---------------------------------------------------------------------------
// K5's wide body (q > 16). A block of a whole block row (128 rows) by
// kWideCols columns, 8 warps of 32 x 32 outputs (warp w: rows 32 (w % 4),
// columns 32 (w / 4)), on the tensor cores; the terms' 128 columns c in
// chunks of KC through a ring of STAGES stages, each the chunk's piece of
// ut (A, 128 x KC, [c][r] when direct, [r][c] otherwise) and of V's block
// (B, KC x kWideCols, raw: centred as it is read).
constexpr int kWideRows = BS;
constexpr int kWideCols = 64;
constexpr int kWideThreads = 256;
constexpr int kWideRing = kWideThreads * 8 + kWideCols * 8;

template <typename T>
struct Wide;
template <>
struct Wide<float> {  // 3xTF32 m16n8k8
  static constexpr int KC = 32, LDAD = 136, LDAT = 36, LDB = 72;
};
template <>
struct Wide<double> {  // DMMA m8n8k4
  static constexpr int KC = 16, LDAD = 132, LDAT = 20, LDB = 68;
};
template <typename T>
struct WideRing {
  static constexpr int KC = Wide<T>::KC;
  static constexpr int CU = 16 / sizeof(T);
  static constexpr int ASTAGE = KC * Wide<T>::LDAD > BS * Wide<T>::LDAT
                                    ? KC * Wide<T>::LDAD
                                    : BS * Wide<T>::LDAT;
  static constexpr int STAGE = ASTAGE + KC * Wide<T>::LDB;
  static constexpr int STAGES = 3;
  static constexpr int CH = BS / KC;  // chunks a term
};

template <typename T>
size_t wide_smem() {
  return kWideRing + static_cast<size_t>(WideRing<T>::STAGES) *
                         WideRing<T>::STAGE * sizeof(T);
}

__device__ __forceinline__ unsigned to_tf32(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
// x as hi + lo, each a TF32 value: hi = x rounded to TF32, lo = the rest
// (exact in float32) rounded to TF32.
__device__ __forceinline__ void split_tf32(float x, unsigned& hi,
                                           unsigned& lo) {
  hi = to_tf32(x);
  lo = to_tf32(__fsub_rn(x, __uint_as_float(hi)));
}
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma_f64(double (&d)[2], double a, double b) {
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0,%1}, {%2}, {%3}, "
      "{%0,%1};\n"
      : "+d"(d[0]), "+d"(d[1])
      : "d"(a), "d"(b));
}

// The warp's outputs: float, 2 x 4 tiles of 16 x 8 (mma's C: rows g and g +
// 8, columns 2 tq and 2 tq + 1 of each); double, 4 x 4 tiles of 8 x 8 (rows
// g, columns 2 tq, 2 tq + 1). MT: the warp's m-tiles, TM: their rows.
template <typename T>
struct WideAcc;
template <>
struct WideAcc<float> {
  static constexpr int MT = 2, TM = 16, E = 4;
};
template <>
struct WideAcc<double> {
  static constexpr int MT = 4, TM = 8, E = 2;
};

// One KC-column chunk on the tensor cores, float: per 8 columns, each
// operand split into hi + lo and the three products lo hi, hi lo, hi hi
// summed into the chunk's own accumulators, which then add to acc in
// float32 (rounded to nearest, so the tensor cores' own additions span one
// chunk).
template <bool DIRECT>
__device__ __forceinline__ void wide_chunk(float (&acc)[2][4][4],
                                           const float* As, const float* Bs,
                                           const float (&cbr)[4], int m0,
                                           int n0, int g, int tq) {
  using W = Wide<float>;
  float sub[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sub[i][j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < W::KC; kk += 8) {
    unsigned bhi[4][2], blo[4][2];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int col = n0 + nt * 8 + g;
      split_tf32(__fsub_rn(Bs[(kk + tq) * W::LDB + col], cbr[nt]), bhi[nt][0],
                 blo[nt][0]);
      split_tf32(__fsub_rn(Bs[(kk + tq + 4) * W::LDB + col], cbr[nt]),
                 bhi[nt][1], blo[nt][1]);
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int row = m0 + mt * 16 + g;
      float x[4];
      if (DIRECT) {
        x[0] = As[(kk + tq) * W::LDAD + row];
        x[1] = As[(kk + tq) * W::LDAD + row + 8];
        x[2] = As[(kk + tq + 4) * W::LDAD + row];
        x[3] = As[(kk + tq + 4) * W::LDAD + row + 8];
      } else {
        x[0] = As[row * W::LDAT + kk + tq];
        x[1] = As[(row + 8) * W::LDAT + kk + tq];
        x[2] = As[row * W::LDAT + kk + tq + 4];
        x[3] = As[(row + 8) * W::LDAT + kk + tq + 4];
      }
      unsigned ahi[4], alo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) split_tf32(x[e], ahi[e], alo[e]);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        mma_tf32(sub[mt][nt], alo, bhi[nt][0], bhi[nt][1]);
        mma_tf32(sub[mt][nt], ahi, blo[nt][0], blo[nt][1]);
        mma_tf32(sub[mt][nt], ahi, bhi[nt][0], bhi[nt][1]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[i][j][e] = __fadd_rn(acc[i][j][e], sub[i][j][e]);
}

// The same for double: DMMA (float64 products and sums) straight into acc.
template <bool DIRECT>
__device__ __forceinline__ void wide_chunk(double (&acc)[4][4][2],
                                           const double* As,
                                           const double* Bs,
                                           const double (&cbr)[4], int m0,
                                           int n0, int g, int tq) {
  using W = Wide<double>;
#pragma unroll
  for (int kk = 0; kk < W::KC; kk += 4) {
    double bf[4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
      bf[nt] = __dsub_rn(Bs[(kk + tq) * W::LDB + n0 + nt * 8 + g], cbr[nt]);
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      const int row = m0 + mt * 8 + g;
      const double x = DIRECT ? As[(kk + tq) * W::LDAD + row]
                              : As[row * W::LDAT + kk + tq];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) mma_f64(acc[mt][nt], x, bf[nt]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kWideThreads, 2) k5_wide(K5Args<T> a,
                                                           int vec) {
  using W = Wide<T>;
  using R = WideRing<T>;
  using C = WideAcc<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* red = reinterpret_cast<double*>(smem_raw);  // kWideThreads
  T* cbs = reinterpret_cast<T*>(red + kWideThreads);  // kWideCols
  T* ring = reinterpret_cast<T*>(smem_raw + kWideRing);
  const int b = blockIdx.x;
  const int c0 = blockIdx.y * kWideCols;
  const int qn = min(kWideCols, a.q - c0);
  const long long lane = blockIdx.z;
  const int n = a.n, q = a.q, nb = a.nb, half = a.half;
  const int nchunks = (2 * half + 2) * R::CH;
  const T* ut = a.ut + lane * a.ut_lane;
  const T* deg = a.deg + lane * a.deg_lane;
  const T* V = a.V + lane * a.v_lane + c0;
  const int t = threadIdx.x;

  // Chunk i (term i / CH, its columns c from KC (i % CH)) into stage i %
  // STAGES: A as the term reads it; B the rows of V's block bv, zeros past
  // V's rows and columns (16-byte copies where V's rows are 16-byte
  // aligned, else an element a copy).
  auto load = [&](int i) {
    const Term m = term_of(i / R::CH, b);
    if (m.bv < 0) return;
    const int k0 = (i % R::CH) * R::KC;
    T* As = ring + (i % R::STAGES) * R::STAGE;
    T* Bs = As + R::ASTAGE;
    const T* U = ut + ((long long)m.tt * nb + m.bu) * BS * BS;
    if (m.direct) {
      constexpr int per = BS / R::CU;
      for (int e = t; e < R::KC * per; e += kWideThreads) {
        const int c = e / per, p = (e % per) * R::CU;
        cp16(As + c * W::LDAD + p, U + (k0 + c) * BS + p, 16);
      }
    } else {
      constexpr int per = R::KC / R::CU;
      for (int e = t; e < BS * per; e += kWideThreads) {
        const int rr = e / per, p = (e % per) * R::CU;
        cp16(As + rr * W::LDAT + p, U + rr * BS + k0 + p, 16);
      }
    }
    const long long g0 = (long long)m.bv * BS + k0;
    const bool inside = m.bv < nb;
    if (vec) {
      constexpr int per = kWideCols / R::CU;
      for (int e = t; e < R::KC * per; e += kWideThreads) {
        const int c = e / per, j = (e % per) * R::CU;
        const long long g = g0 + c;
        const bool ok = inside && g < n && j < qn;
        cp16(Bs + c * W::LDB + j, ok ? V + g * q + j : V, ok ? 16 : 0);
      }
    } else {
      for (int e = t; e < R::KC * kWideCols; e += kWideThreads) {
        const int c = e / kWideCols, j = e % kWideCols;
        const long long g = g0 + c;
        const bool ok = inside && g < n && j < qn;
        cp_elem<sizeof(T)>(Bs + c * W::LDB + j, ok ? V + g * q + j : V,
                           ok ? static_cast<int>(sizeof(T)) : 0);
      }
    }
  };
#pragma unroll
  for (int s = 0; s < R::STAGES - 1; ++s) {
    if (s < nchunks) load(s);
    cp_commit();
  }

  // While the first chunks arrive: the window means of the block's
  // columns (zero past them), or the wrapper's. Each thread sums in
  // float64 a fixed stride of the window's rows of its columns (16-byte
  // loads where V's rows allow them, else one column), a batch of loads in
  // flight at a time; the strides' sums (in the last ring stage, free
  // until the loop's first turn) then add in order.
  if (a.cb != nullptr) {
    if (t < kWideCols)
      cbs[t] = t < qn ? a.cb[(lane * nb + b) * q + c0 + t] : T(0);
  } else {
    double* sums = reinterpret_cast<double*>(ring + (R::STAGES - 1) *
                                                        R::STAGE);
    const long long lo = max(0LL, (long long)(b - half) * BS);
    const long long hi = min((long long)n, (long long)(b + half + 1) * BS);
    int nr;
    if (vec) {
      constexpr int ng = kWideCols / R::CU, batch = 20;
      nr = kWideThreads / ng;
      const int cg = t % ng, rg = t / ng, j0 = cg * R::CU;
      double acc[R::CU];
#pragma unroll
      for (int u = 0; u < R::CU; ++u) acc[u] = 0.0;
      for (long long g0 = lo + rg; g0 < hi; g0 += (long long)nr * batch) {
        T x[batch][R::CU];
#pragma unroll
        for (int k = 0; k < batch; ++k) {
          const long long g = g0 + (long long)k * nr;
          if (g < hi && j0 < qn) {
            ld_vec(V + g * q + j0, x[k]);
          } else {
#pragma unroll
            for (int u = 0; u < R::CU; ++u) x[k][u] = T(0);
          }
        }
#pragma unroll
        for (int k = 0; k < batch; ++k)
#pragma unroll
          for (int u = 0; u < R::CU; ++u) acc[u] += static_cast<double>(x[k][u]);
      }
#pragma unroll
      for (int u = 0; u < R::CU; ++u) sums[rg * kWideCols + j0 + u] = acc[u];
    } else {
      constexpr int batch = 32;
      nr = kWideThreads / kWideCols;
      const int col = t % kWideCols, rg = t / kWideCols;
      double acc = 0.0;
      for (long long g0 = lo + rg; g0 < hi; g0 += (long long)nr * batch) {
        T x[batch];
#pragma unroll
        for (int k = 0; k < batch; ++k) {
          const long long g = g0 + (long long)k * nr;
          x[k] = g < hi && col < qn ? V[g * q + col] : T(0);
        }
#pragma unroll
        for (int k = 0; k < batch; ++k) acc += static_cast<double>(x[k]);
      }
      sums[rg * kWideCols + col] = acc;
    }
    __syncthreads();
    if (t < kWideCols) {
      double sum = 0.0;
      for (int k = 0; k < nr; ++k) sum += sums[k * kWideCols + t];
      cbs[t] = t < qn ? static_cast<T>(
                            sum / static_cast<double>((2 * half + 1) * BS))
                      : T(0);
    }
  }
  __syncthreads();

  const int w = t >> 5, ln = t & 31, g = ln >> 2, tq = ln & 3;
  const int m0 = (w & 3) * 32, n0 = (w >> 2) * 32;
  T cbr[4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) cbr[nt] = cbs[n0 + nt * 8 + g];
  T acc[C::MT][4][C::E];
#pragma unroll
  for (int i = 0; i < C::MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < C::E; ++e) acc[i][j][e] = T(0);
  for (int i = 0; i < nchunks; ++i) {
    cp_wait<R::STAGES - 2>();
    __syncthreads();
    if (i + R::STAGES - 1 < nchunks) load(i + R::STAGES - 1);
    cp_commit();
    const Term m = term_of(i / R::CH, b);
    if (m.bv < 0) continue;
    const T* As = ring + (i % R::STAGES) * R::STAGE;
    if (m.direct)
      wide_chunk<true>(acc, As, As + R::ASTAGE, cbr, m0, n0, g, tq);
    else
      wide_chunk<false>(acc, As, As + R::ASTAGE, cbr, m0, n0, g, tq);
  }
  cp_wait<0>();

  // Epilogue: the degree term first, then the products; each column's dot
  // over the thread's rows in order, the warp's 8 row groups by a fixed
  // butterfly, the four row warps in order.
  double p[4][2];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) p[nt][0] = p[nt][1] = 0.0;
#pragma unroll
  for (int mt = 0; mt < C::MT; ++mt) {
    // This m-tile's inputs from device memory first, all in flight.
    T vv[C::E][4], bv[C::E][4], dv[C::E];
#pragma unroll
    for (int e = 0; e < C::E; ++e) {
      const long long row = (long long)b * BS + m0 + mt * C::TM + g +
                            8 * (e >> 1);
      dv[e] = row < n ? deg[row] : T(0);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = n0 + nt * 8 + 2 * tq + (e & 1);
        const bool ok = row < n && col < qn;
        vv[e][nt] = ok ? V[row * q + col] : T(0);
        bv[e][nt] = ok ? k5_b(a, lane, row, c0 + col) : T(0);
      }
    }
#pragma unroll
    for (int e = 0; e < C::E; ++e) {
      const long long row = (long long)b * BS + m0 + mt * C::TM + g +
                            8 * (e >> 1);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = n0 + nt * 8 + 2 * tq + (e & 1);
        if (row >= n || col >= qn) continue;
        const T o = add_rn(mul_rn(dv[e], vv[e][nt] - cbs[col]),
                           acc[mt][nt][e]);
        const T y = k5_out(a, o, vv[e][nt], bv[e][nt], lane, row, c0 + col);
        p[nt][e & 1] += static_cast<double>(mul_rn(vv[e][nt], y));
      }
    }
  }
  if (a.part == nullptr) return;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int off = 4; off < 32; off <<= 1)
        p[nt][h] += __shfl_xor_sync(0xffffffffu, p[nt][h], off);
  __syncthreads();  // red is free again
  if (g == 0)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        red[(w & 3) * kWideCols + n0 + nt * 8 + 2 * tq + h] = p[nt][h];
  __syncthreads();
  if (t < qn) {
    double sum = 0.0;
    for (int k = 0; k < 4; ++k) sum += red[k * kWideCols + t];
    a.part[(lane * q + c0 + t) * gridDim.x + blockIdx.x] = sum;
  }
  k5_finish_dots(a);
}

template <typename T, int QT>
int k5_narrow_launch(K5Args<T> a, int lanes, cudaStream_t st) {
  const size_t smem = narrow_smem<T, QT>(a.half);
  static const cudaError_t setup = cudaFuncSetAttribute(
      k5_narrow<T, QT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemCap);
  if (setup != cudaSuccess) return static_cast<int>(setup);
  if (smem > kSmemCap) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(a.nb * (BS / kNarrowRows), (a.q + QT - 1) / QT, lanes);
  constexpr int cu = 16 / sizeof(T);
  const int vec = QT == a.q && a.q % cu == 0 && a.v_lane % cu == 0 &&
                  reinterpret_cast<uintptr_t>(a.V) % 16 == 0;
  k5_narrow<T, QT><<<grid, kNarrowThreads, smem, st>>>(a, vec);
  return static_cast<int>(cudaGetLastError());
}

// The narrow body's column tile: the least of 1, 2, 4, 8, 12, 16 that
// holds q, halved while the window (2 half + 1 blocks of it) and the ring
// overflow shared memory.
template <typename T>
int narrow_qt(int q, int half) {
  int qt = q <= 1 ? 1 : q <= 2 ? 2 : q <= 4 ? 4 : q <= 8 ? 8 : q <= 12 ? 12
                                                                       : 16;
  auto fits = [&](int k) {
    switch (k) {
      case 1: return narrow_smem<T, 1>(half) <= kSmemCap;
      case 2: return narrow_smem<T, 2>(half) <= kSmemCap;
      case 4: return narrow_smem<T, 4>(half) <= kSmemCap;
      case 8: return narrow_smem<T, 8>(half) <= kSmemCap;
      case 12: return narrow_smem<T, 12>(half) <= kSmemCap;
      default: return narrow_smem<T, 16>(half) <= kSmemCap;
    }
  };
  while (qt > 1 && !fits(qt)) qt = qt == 12 ? 8 : qt / 2;
  return qt;
}

template <typename T>
int k5_launch(K5Args<T> a, int lanes, void* stream) {
  if (a.n <= 0 || a.q <= 0 || lanes <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a.q <= kNarrowMaxQ) {
    switch (narrow_qt<T>(a.q, a.half)) {
      case 1: return k5_narrow_launch<T, 1>(a, lanes, st);
      case 2: return k5_narrow_launch<T, 2>(a, lanes, st);
      case 4: return k5_narrow_launch<T, 4>(a, lanes, st);
      case 8: return k5_narrow_launch<T, 8>(a, lanes, st);
      case 12: return k5_narrow_launch<T, 12>(a, lanes, st);
      default: return k5_narrow_launch<T, 16>(a, lanes, st);
    }
  }
  static const cudaError_t setup = cudaFuncSetAttribute(
      k5_wide<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemCap);
  if (setup != cudaSuccess) return static_cast<int>(setup);
  constexpr int cu = 16 / sizeof(T);
  const int vec = a.q % cu == 0 && a.v_lane % cu == 0 &&
                  reinterpret_cast<uintptr_t>(a.V) % 16 == 0;
  const dim3 grid(a.nb, (a.q + kWideCols - 1) / kWideCols, lanes);
  k5_wide<T><<<grid, kWideThreads, wide_smem<T>(), st>>>(a, vec);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// K7: the coarse correction in one launch.
//
// What held the first design back (two launches, 32 blocks at nc = 500):
// its restrict's blocks each multiplied their 16 columns of Lc^-1 into a
// float64 partial of the whole nc x q result, 512 KB at q = 4 written and
// read back by a second launch (as many bytes as Lc^-1 itself), and every
// load of Lc^-1 waited for the gathers of r: 21.4 us of device time at
// (10000, 4) on an H100 (700 W), 47x its bound (Lc^-1's bytes, 0.3 us, and
// the rows of r and x).
//
// The design: a cluster of C = ceil(nc / 32) blocks (16 at nc = 500, a
// non-portable size the H100 schedules) per (column tile, lane); block b
// owns the A = ceil(nc / C) aggregates from b A, both as rows of r to
// restrict and as rows of Lc^-1 and of xc.
//   1. Its first instructions put its A rows of Lc^-1 in flight into shared
//      memory (cp.async, 16-byte copies where the rows allow), rows ldl
//      elements apart with ldl T's bytes = 16 mod 128, so that eight lanes'
//      16-byte reads of eight rows cover the 32 banks. They do not depend
//      on r.
//   2. It restricts its aggregates: their rows of r gathered whole through
//      iperm (16-byte loads where q and the tile allow), staged in passes
//      of rows_pass rows, each (aggregate, column) added in row order in
//      float64 into its rc in shared memory.
//   3. After a cluster barrier, every block copies the other blocks' rc
//      over distributed shared memory: each has the whole rc (nc x qt).
//   4. Its rows of xc = Lc^-1 rc, four columns a pass: a warp's lanes take
//      32 rows, its warps the chunks of kAggs aggregates; each lane's
//      chunk partial goes to shared memory, then the partials of each
//      (row, column) add in chunk order, rounded to T.
//   5. The prolong: each of its aggregates' rows of x, whole through iperm,
//      += xc.
// No float64 partial of the whole result goes through device memory. The
// arithmetic and its order are the first design's (the module note
// above): the results are bitwise those of its two launches.

// Four consecutive values of a row: a float4 (16 bytes), or for double two
// 16-byte halves.
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

constexpr int kAggs = 16;         // aggregates per chunk of a dot product
constexpr int kK7Threads = 256;
constexpr int kK7Rows = 32;       // aggregates per block, at most
constexpr int kK7MaxCluster = 16;
constexpr int kK7Pass = 4;        // columns per product pass
constexpr int kK7MaxQtFloat = 16;
constexpr int kK7MaxQtDouble = 8;

__host__ __device__ inline int up16(int b) { return (b + 15) & ~15; }

// One block's shared memory (byte offsets): rc (nc rows of rs doubles),
// the work area (the staged rows of r, then the chunk partials), xc (A
// rows of qt T), Lc^-1's rows (A rows of ldl T, and 32 bytes of slack
// for the last row's vector reads).
struct K7Layout {
  int work, xc, lc, total;
};

__host__ __device__ inline K7Layout k7_layout(int nc, int rs, int qt, int A,
                                              int ldl, int rows_pass,
                                              int ss, int sz) {
  const int nchunk = (nc + kAggs - 1) / kAggs;
  const int part = nchunk * A * kK7Pass * 8;
  const int stage = rows_pass * ss * sz;
  K7Layout L;
  L.work = up16(nc * rs * 8);
  L.xc = L.work + up16(part > stage ? part : stage);
  L.lc = L.xc + up16(A * qt * sz);
  L.total = L.lc + A * ldl * sz + 32;
  return L;
}

template <typename T>
struct K7Args {
  const T* r;
  T* x;
  const int* iperm;
  const T* Lc_inv;
  long long lc_lane;
  int n, q, nc, s;
  int qt;         // columns per cluster (its tile)
  int rs;         // rc's row stride: qt rounded up to kK7Pass
  int ss;         // a staged row's stride: qt rounded up to 4
  int A;          // aggregates per block
  int ldl;        // row stride of the staged Lc^-1 rows (elements)
  int rows_pass;  // rows of r staged per pass
  int copy;       // bytes per cp.async copy of Lc^-1: 16 or sizeof(T)
  int vec;        // r's and x's rows move four columns at a time
};

template <typename T>
__global__ void __launch_bounds__(kK7Threads)
k7_kernel(K7Args<T> a) {
  using V4 = typename Vec4<T>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int t = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = t & 31;
  const int w = t >> 5;
  const int nw = nt >> 5;
  const int nc = a.nc, s = a.s, q = a.q, qt = a.qt, rs = a.rs, A = a.A;
  const int c0 = blockIdx.y * qt;
  const int qc = min(qt, q - c0);
  const long long ln = blockIdx.z;
  const T* r = a.r + ln * a.n * q + c0;
  T* x = a.x + ln * a.n * q + c0;
  const T* Lc = a.Lc_inv + ln * a.lc_lane;
  const int a0 = rank * A;
  const int na = max(0, min(A, nc - a0));
  const K7Layout L = k7_layout(nc, rs, qt, A, a.ldl, a.rows_pass, a.ss,
                               sizeof(T));
  double* rc = reinterpret_cast<double*>(smem);
  T* stage = reinterpret_cast<T*>(smem + L.work);
  double* part = reinterpret_cast<double*>(smem + L.work);
  T* xc = reinterpret_cast<T*>(smem + L.xc);
  T* lc = reinterpret_cast<T*>(smem + L.lc);

  // 1. Lc^-1's rows a0 .. a0 + na into shared memory, in flight.
  {
    const int per = a.copy / static_cast<int>(sizeof(T));  // elements a copy
    const int cpr = (nc + per - 1) / per;                  // copies a row
    for (int e = t; e < na * cpr; e += nt) {
      const int i = e / cpr;
      const int c = (e - i * cpr) * per;
      T* dst = lc + static_cast<long long>(i) * a.ldl + c;
      const T* src = Lc + static_cast<long long>(a0 + i) * nc + c;
      if (a.copy == 16)
        cp16(dst, src, 16);
      else
        cp_elem<static_cast<int>(sizeof(T))>(dst, src, sizeof(T));
    }
    cp_commit();
  }

  // 2. Restrict: rc[a][j] over the aggregates' rows in row order.
  const long long rlo = static_cast<long long>(a0) * s;
  const long long rhi =
      min(static_cast<long long>(a0 + na) * s, static_cast<long long>(a.n));
  const int R = rhi > rlo ? static_cast<int>(rhi - rlo) : 0;
  for (int e = t; e < na * rs; e += nt) rc[a0 * rs + e] = 0.0;
  for (int p0 = 0; p0 < R; p0 += a.rows_pass) {
    const int pr = min(a.rows_pass, R - p0);
    for (int i = t; i < pr; i += nt) {  // whole rows through iperm
      const T* row = r + static_cast<long long>(a.iperm[rlo + p0 + i]) * q;
      T* dst = stage + i * a.ss;
      if (a.vec) {
        for (int c = 0; c < qc; c += 4)
          *reinterpret_cast<V4*>(dst + c) =
              *reinterpret_cast<const V4*>(row + c);
      } else {
        for (int c = 0; c < qc; ++c) dst[c] = row[c];
      }
    }
    __syncthreads();
    for (int e = t; e < na * qc; e += nt) {
      const int ag = e / qc;
      const int j = e - ag * qc;
      const int lo = max(0, ag * s - p0);
      const int hi = min(pr, ag * s + s - p0);
      if (lo < hi) {
        double acc = rc[(a0 + ag) * rs + j];
        for (int i = lo; i < hi; ++i)
          acc += static_cast<double>(stage[i * a.ss + j]);
        rc[(a0 + ag) * rs + j] = acc;
      }
    }
    __syncthreads();
  }

  // 3. The other blocks' rc over distributed shared memory.
  cluster.sync();
  for (int e = t; e < nc * rs; e += nt) {
    const int k = (e / rs) / A;
    if (k != rank) rc[e] = cluster.map_shared_rank(rc, k)[e];
  }
  // The last remote read: arrive now, wait before leaving (no block may
  // leave while another reads its shared memory).
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  cp_wait<0>();
  __syncthreads();

  // 4. xc = Lc^-1 rc for the block's rows, kK7Pass columns a pass.
  const int nchunk = (nc + kAggs - 1) / kAggs;
  for (int cp = 0; cp < qc; cp += kK7Pass) {
    const int pc = min(kK7Pass, qc - cp);
    for (int i0 = 0; i0 < na; i0 += 32) {
      const int i = i0 + lane;
      for (int k = w; k < nchunk; k += nw) {
        if (i >= na) continue;
        const int base = k * kAggs;
        const int cnt = min(kAggs, nc - base);
        const T* lrow = lc + static_cast<long long>(i) * a.ldl + base;
        double acc[kK7Pass] = {0.0, 0.0, 0.0, 0.0};
#pragma unroll
        for (int m = 0; m < kAggs / 4; ++m) {
          if (4 * m >= cnt) break;
          const V4 c4 = *reinterpret_cast<const V4*>(lrow + 4 * m);
          const T cv[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            if (4 * m + u < cnt) {
              const double lv = static_cast<double>(cv[u]);
              const double* rr = rc + (base + 4 * m + u) * rs + cp;
#pragma unroll
              for (int j = 0; j < kK7Pass; ++j)
                acc[j] = fma(lv, rr[j], acc[j]);
            }
          }
        }
#pragma unroll
        for (int j = 0; j < kK7Pass; ++j)
          part[((k * A) + i) * kK7Pass + j] = acc[j];
      }
    }
    __syncthreads();
    for (int e = t; e < na * pc; e += nt) {
      const int i = e / pc;
      const int j = e - i * pc;
      double tot = 0.0;
      for (int k = 0; k < nchunk; ++k) tot += part[((k * A) + i) * kK7Pass + j];
      xc[i * qt + cp + j] = static_cast<T>(tot);
    }
    __syncthreads();
  }

  // 5. Prolong: x's rows of the block's aggregates += xc.
  for (int i = t; i < R; i += nt) {
    const long long jj = rlo + i;
    const T* add = xc + (static_cast<int>(jj / s) - a0) * qt;
    T* row = x + static_cast<long long>(a.iperm[jj]) * q;
    if (a.vec) {
      for (int c = 0; c < qc; c += 4) {
        const V4 o = *reinterpret_cast<const V4*>(row + c);
        *reinterpret_cast<V4*>(row + c) =
            vec4<T>(add_rn(o.x, add[c]), add_rn(o.y, add[c + 1]),
                    add_rn(o.z, add[c + 2]), add_rn(o.w, add[c + 3]));
      }
    } else {
      for (int c = 0; c < qc; ++c) row[c] = add_rn(row[c], add[c]);
    }
  }
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

template <typename T>
cudaError_t k7_setup() {
  const cudaError_t err = cudaFuncSetAttribute(
      k7_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemCap);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(
      k7_kernel<T>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

template <typename T>
int k7_launch(const T* r, T* x, const int* iperm, const T* Lc_inv,
              long long lc_lane, int n, int q, int nc, int s, int lanes,
              void* stream) {
  if (n <= 0 || q <= 0 || nc <= 0 || lanes <= 0) return 0;
  if (nc > kK7MaxCluster * kK7Rows)
    return static_cast<int>(cudaErrorInvalidValue);
  static const cudaError_t setup = k7_setup<T>();
  if (setup != cudaSuccess) return static_cast<int>(setup);
  constexpr int sz = static_cast<int>(sizeof(T));
  K7Args<T> a = {r, x, iperm, Lc_inv, lc_lane, n, q, nc, s};
  const int C = min(kK7MaxCluster, (nc + kK7Rows - 1) / kK7Rows);
  a.A = (nc + C - 1) / C;
  // Lc^-1's staged rows: 16 bytes mod 128 apart (conflict-free 16-byte
  // reads of eight rows), 16-byte copies where every row allows them.
  int ldl_bytes = up16(nc * sz);
  while (ldl_bytes % 128 != 16) ldl_bytes += 16;
  a.ldl = ldl_bytes / sz;
  const bool lc_aligned = (nc * sz) % 16 == 0 && (lc_lane * sz) % 16 == 0 &&
                          reinterpret_cast<uintptr_t>(Lc_inv) % 16 == 0;
  a.copy = lc_aligned ? 16 : sz;
  const int nchunk = (nc + kAggs - 1) / kAggs;
  int qt = min(q, sz == 4 ? kK7MaxQtFloat : kK7MaxQtDouble);
  K7Layout L;
  for (;;) {
    a.qt = qt;
    a.rs = (qt + kK7Pass - 1) / kK7Pass * kK7Pass;
    a.ss = (qt + 3) & ~3;
    a.rows_pass = max(kK7Threads, nchunk * a.A * kK7Pass * 8 / (a.ss * sz));
    L = k7_layout(nc, a.rs, qt, a.A, a.ldl, a.rows_pass, a.ss, sz);
    if (L.total <= kSmemCap || qt == 1) break;
    qt = qt > 4 ? qt - 4 : qt - 1;
  }
  if (L.total > kSmemCap) return static_cast<int>(cudaErrorInvalidValue);
  a.vec = q % 4 == 0 && a.qt % 4 == 0 &&
          ((reinterpret_cast<uintptr_t>(r) | reinterpret_cast<uintptr_t>(x)) %
           16) == 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, (q + a.qt - 1) / a.qt, lanes);
  cfg.blockDim = dim3(kK7Threads);
  cfg.dynamicSmemBytes = L.total;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute cluster_dim[1];
  cluster_dim[0].id = cudaLaunchAttributeClusterDimension;
  cluster_dim[0].val.clusterDim.x = C;
  cluster_dim[0].val.clusterDim.y = 1;
  cluster_dim[0].val.clusterDim.z = 1;
  cfg.attrs = cluster_dim;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, k7_kernel<T>, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K5. ut, deg, V, out, B in T (float: _f32, double: _f64), row-major and
// contiguous per lane, at the lane strides given (0: one array for every
// lane); out (lanes, n, q). Null pointers leave the epilogue's parts out
// (see above); part must hold lanes * q * nb * 4 float64 (the narrow
// body's blocks; the wide body takes nb of them) and ticket one unsigned
// counter at 0 (left at 0) where dot is asked for. Returns the
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
// nc at most 512. One launch; returns its cudaError_t (0 on success;
// cudaErrorInvalidValue past 512 aggregates).
#define K7_EXPORT(T, S)                                                      \
  extern "C" int coarse_correct_##S(const T* r, T* x, const int* iperm,      \
                                    const T* Lc_inv, long long lc_lane,      \
                                    double* /* rc, not used */, int n,       \
                                    int q, int nc, int s, int lanes,         \
                                    void* stream) {                          \
    return k7_launch<T>(r, x, iperm, Lc_inv, lc_lane, n, q, nc, s, lanes,    \
                        stream);                                             \
  }

K7_EXPORT(float, f32)
K7_EXPORT(double, f64)
