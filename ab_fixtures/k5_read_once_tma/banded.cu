// A design step of K5's narrow body, kept as kernel_ab.py's A/B fixture
// (python3 kernel_ab.py --banded-only OLD_DIR ab_fixtures/k5_read_once_tma);
// the package never builds it. Its narrow body (q <= 16, "K5's narrow
// body" below) reads each 128 x 128 tile of ut once, by TMA bulk copies
// (cp.async.bulk with mbarriers) of 16-row pieces, for both of the tile's
// terms, into a scratch of terms that the last block of each block row sums
// in order; its wide body is an earlier state of the shipped one. Its
// banded_product_* takes that scratch after the ticket (kernel_ab.py hands
// it one). Slower than the shipped body at (10000, 4): PERF.md section 6.
//
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
// Both stream their operands through a ring of shared-memory stages filled
// by cp.async (16-byte copies spread over the block's threads, a commit
// group a stage): the direct product's piece of a tile is strided (a
// segment of each of the tile's 128 rows), which a bulk copy would take as
// one copy per segment.
//
//   narrow (q <= 16: the CG step's (n, 4) and (n, 11), the V-cycle's
//     residuals, the lanes, float64). Bound by bytes: ut, 15.5 MB at
//     city10000 in float32 (4.7 us at 3.35 TB/s) against q / 2 operations
//     a byte, below the card's ridge. A block of 16 rows by every column
//     (up to 16: ut is streamed once a product, not once per column tile),
//     nb * 8 blocks, 256 threads. Its first instructions put the terms'
//     pieces of ut in flight (direct: 16 of each tile row's 128 elements,
//     transposed: 16 whole rows), 3 (float) or 2 (double) ahead of the term
//     in use; meanwhile the block stages V's window (2 half + 1 blocks) in
//     shared memory, takes its means (float64, a fixed stride of rows a
//     thread, then the threads in order) and centres it in place. Thread
//     (slice s, row r) sums its row's products over the 16-byte units s, s +
//     16, ... of each term's 128 columns: a direct piece is stored [c][r]
//     with rows 20 (float) apart, so the two half-warps' rows fall 16 banks
//     apart; a transposed one [r][c] with rows 132 (float) or 130 (double)
//     apart, so a quarter-warp's 16-byte loads on 8 rows cover the 32
//     banks; the centred V rows are broadcasts. The 16 slices' sums add in
//     slice order after the degree term.
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
//     transposed, and the KC x 64 raw rows of V, each with rows padded so
//     that the fragments' loads are free of bank conflicts (the transposition
//     is in the read pattern); V is centred as its fragment is read, and the
//     window means come from the block's own loads of the window, 16 in
//     flight a thread, while the first stages arrive.
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

// Take `add` of the `total` tickets; whether this block took the last.
__device__ bool last_ticket(unsigned* ticket, unsigned total, unsigned add) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, add) == total - add;
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
  double* part;         // dot partials (lanes, q, nb), or null
  double* dot;          // (lanes, q)
  unsigned* ticket;
  T* terms;             // narrow body: (lanes, nb, 2 half + 2, split, BS, q)
  int n, q, nb, half;
  int split;            // narrow body: blocks a tile (k5_split)
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

// After each block has written its column dots' partials (nblk per lane
// and column, `total` tickets in all, this block's `add` of them): the
// block that takes the last ticket sums them in a fixed order, K6's (a warp per
// column: each lane a fixed stride of blocks in order, 8 loads in flight,
// then a fixed butterfly over the lanes).
template <typename T>
__device__ void k5_finish_dots(const K5Args<T>& a, unsigned total,
                               unsigned add, int nblk) {
  if (!last_ticket(a.ticket, total, add)) return;
  const int count = static_cast<int>(gridDim.z) * a.q;
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
// K5's narrow body (q <= 16): a block per tile ut[tt][bp] of ut (and column
// tile, lane), which it reads once for both of its terms: the direct one,
// ut[tt][bp]^T Vc_{bp+tt} of block row bp, and the transposed one,
// ut[tt][bp] Vc_bp of block row bx = bp + tt (tt = 0: both of row bp).
// Each term's 128 x QT product goes to a scratch of terms (a.terms); the
// last of a block row's 2 half + 2 terms to arrive (a counter per block
// row) sums them in term order after the degree term and takes the
// epilogue.
constexpr int kNarrowMaxQ = 16;
constexpr int kNarrowThreads = 256;
constexpr int kPieceRows = 16;            // rows c of a tile a ring stage holds
constexpr int kPieces = BS / kPieceRows;
// The block rows' counters (lanes x column tiles x nb at most): zero when
// the library loads, each left at zero by the block that sums its row.
constexpr int kRowCounters = 1 << 18;
__device__ unsigned g_row_count[kRowCounters];

template <typename T, int QT>
struct Narrow {
  static constexpr int CU = 16 / sizeof(T);  // elements in 16 bytes
  // Ring stages: a whole tile's pieces in flight where shared memory
  // leaves two blocks an SM, else half of them.
  static constexpr int STAGES =
      sizeof(T) == 4 ? (QT <= 8 ? 8 : 4) : (QT <= 4 ? 4 : 2);
  static constexpr int PIECE = kPieceRows * BS;  // elements of a stage
  static constexpr int TUNITS = BS / CU / 16;    // a T lane's 16-byte units
  static constexpr int EPI = (BS * QT + kNarrowThreads - 1) / kNarrowThreads;
  static constexpr int RED = BS * QT > 512 ? BS * QT : 512;  // doubles
  // Bytes before the ring: the stages' mbarriers, red, the two means.
  static constexpr int HEAD = 64 + RED * 8 + 2 * kNarrowMaxQ * 8;
};

// A block's ring stages: STAGES, or its pieces where they are fewer.
template <typename T, int QT>
__host__ __device__ int narrow_stages(int split) {
  return Narrow<T, QT>::STAGES < kPieces / split ? Narrow<T, QT>::STAGES
                                                 : kPieces / split;
}

template <typename T, int QT>
size_t narrow_smem(int half, int split) {
  using L = Narrow<T, QT>;
  return L::HEAD +
         (static_cast<size_t>(narrow_stages<T, QT>(split)) * L::PIECE +
          2 * BS * QT + static_cast<size_t>(3 * half + 1) * BS * QT) *
             sizeof(T);
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar,
                                          unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}
// This thread's arrival at the mbarrier, adding `tx` bytes that its
// current phase also waits for.
__device__ __forceinline__ void mbar_expect(unsigned long long* bar,
                                            unsigned tx) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)),
      "r"(tx)
      : "memory");
}
// Wait until the mbarrier's phase of parity `parity` has completed; a
// wait that never ends traps after about 2^26 polls (a fault, not a hung
// card).
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  const unsigned addr = smem_addr(bar);
  for (unsigned polls = 0;; ++polls) {
    unsigned done;
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 26)) __trap();
  }
}
// A TMA bulk copy of `bytes` contiguous bytes into this block's shared
// memory, completing on the mbarrier.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// The window means of the 2 half + 1 blocks of V's window at `win`
// ([rows][QT], zeros past V) into cb (0 past qn), in float64: each thread
// a fixed stride of rows of one column; then the strides of a warp by a
// fixed butterfly and the 8 warps in order, or, where QT does not divide a
// warp, 8 partial sums of the strides in order and those 8 in order.
template <typename T, int QT>
__device__ void narrow_means(const T* win, int wrows, int qn, double* red,
                             T* cb) {
  const int t = threadIdx.x;
  constexpr int ns = kNarrowThreads / QT;
  const int col = t % QT, slot = t / QT;
  double acc = 0.0;
  if (slot < ns && col < qn)
    for (int i = slot; i < wrows; i += ns)
      acc += static_cast<double>(win[i * QT + col]);
  if constexpr (32 % QT == 0) {
#pragma unroll
    for (int off = QT; off < 32; off <<= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if ((t & 31) < QT) red[(t >> 5) * QT + col] = acc;
    __syncthreads();
    if (t < QT) {
      double sum = 0.0;
#pragma unroll
      for (int k = 0; k < kNarrowThreads / 32; ++k) sum += red[k * QT + t];
      cb[t] = t < qn ? static_cast<T>(sum / static_cast<double>(wrows))
                     : T(0);
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
    if (t < QT) {
      double sum = 0.0;
#pragma unroll
      for (int k = 0; k < 8; ++k) sum += red[kNarrowThreads + k * QT + t];
      cb[t] = t < qn ? static_cast<T>(sum / static_cast<double>(wrows))
                     : T(0);
    }
  }
  __syncthreads();
}

template <typename T, int QT>
__global__ void __launch_bounds__(kNarrowThreads) k5_narrow(K5Args<T> a,
                                                            int vec) {
  using L = Narrow<T, QT>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned long long* bars = reinterpret_cast<unsigned long long*>(smem_raw);
  double* red = reinterpret_cast<double*>(smem_raw + 64);
  T* cbs = reinterpret_cast<T*>(smem_raw + 64 + L::RED * 8);  // [2][16]
  const int split = a.split, part = blockIdx.x % split;
  const int nstage = narrow_stages<T, QT>(split);
  T* ring = reinterpret_cast<T*>(smem_raw + L::HEAD);
  T* VD = ring + nstage * L::PIECE;  // [BS][QT]: the direct term's V
  T* VT = VD + BS * QT;                 // [QT][BS]: the transposed term's
  T* Vw = VT + QT * BS;                 // [(2 half + 1 + tt) BS][QT]
  __shared__ int fin[2];
  const int n = a.n, q = a.q, nb = a.nb, half = a.half;
  const int nterms = 2 * half + 2;
  const int tile = blockIdx.x / split;
  const int tt = tile / nb, bp = tile % nb, bx = bp + tt;
  const int npiece = kPieces / split, p0 = part * npiece;  // this block's
  const bool tuse = bx < nb;  // the transposed term has a row
  const int kd = tt == 0 ? 0 : 2 * tt, kt = kd + 1;
  const int c0 = blockIdx.y * QT;
  const int qn = min(QT, q - c0);
  const long long lane = blockIdx.z;
  const long long rows0 = (lane * gridDim.y + blockIdx.y) * nb;
  const T* U = a.ut + lane * a.ut_lane + (long long)tile * BS * BS +
               p0 * L::PIECE;
  const T* deg = a.deg + lane * a.deg_lane;
  const T* V = a.V + lane * a.v_lane + c0;
  // [nb][nterms][split][BS][q]: a term's product, the direct one in the
  // split's parts (over their rows c), the transposed one in part 0.
  T* S = a.terms + lane * nb * nterms * split * BS * q + c0;
  const int t = threadIdx.x;

  // This block's pieces of the tile stream from its first instruction, 16
  // rows c (contiguous) a stage; then V's window.
  constexpr unsigned piece_bytes = L::PIECE * sizeof(T);
  if (t == 0) {
    for (int s = 0; s < nstage; ++s) mbar_init(&bars[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int p = 0; p < nstage; ++p) {
      mbar_expect(&bars[p], piece_bytes);
      bulk_load(ring + p * L::PIECE, U + p * L::PIECE, piece_bytes, &bars[p]);
    }
  }
  // V's blocks bp - half .. bx + half (zeros past V's rows and columns):
  // both terms' windows.
  const int wrows = (2 * half + 1 + tt) * BS;
  const long long w0 = (long long)(bp - half) * BS;
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
  cp_wait<0>();
  __syncthreads();

  // cb of row bp (cbs[0..]) and of row bx (cbs[16..]), or the wrapper's.
  T* cbd = cbs;
  T* cbt = tt == 0 ? cbs : cbs + kNarrowMaxQ;
  if (a.cb != nullptr) {
    if (t < QT) {
      cbd[t] = t < qn ? a.cb[(lane * nb + bp) * q + c0 + t] : T(0);
      if (tt > 0 && tuse)
        cbt[t] = t < qn ? a.cb[(lane * nb + bx) * q + c0 + t] : T(0);
    }
    __syncthreads();
  } else {
    narrow_means<T, QT>(Vw, (2 * half + 1) * BS, qn, red, cbd);
    if (tt > 0 && tuse)
      narrow_means<T, QT>(Vw + tt * BS * QT, (2 * half + 1) * BS, qn, red,
                          cbt);
  }
  // The terms' centred V (V - cb, as the plain version rounds it): the
  // direct term's block bp + tt by row bp's means, [c][j]; the transposed
  // term's block bp by row bx's, [j][r].
  for (int e = t; e < BS * QT; e += kNarrowThreads) {
    const int c = e / QT, j = e % QT;
    VD[e] = j < qn ? Vw[((tt + half) * BS + c) * QT + j] - cbd[j] : T(0);
    if (tuse)
      VT[j * BS + c] = j < qn ? Vw[(half * BS + c) * QT + j] - cbt[j] : T(0);
  }
  __syncthreads();

  // The pieces. Direct: thread (row r, half cs) sums over the piece's rows
  // c 8 cs .. 8 cs + 7. Transposed: the 16 lanes of a half-warp take one
  // row c of the piece, each its 16-byte units l16, l16 + 16, ... of the
  // row's 128 r, then add by a fixed butterfly; the row's sum is complete.
  const int r = t & (BS - 1), cs = t >> 7;
  const int l16 = t & 15, tr = t >> 4;
  T accd[QT];
#pragma unroll
  for (int j = 0; j < QT; ++j) accd[j] = T(0);
  for (int p = 0; p < npiece; ++p) {
    const int s = p % nstage;
    mbar_wait(&bars[s], (p / nstage) & 1);
    const T* st = ring + s * L::PIECE;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int cl = cs * 8 + i;
      const T x = st[cl * BS + r];
      T v[QT];
      ld_vec(VD + ((p0 + p) * kPieceRows + cl) * QT, v);
#pragma unroll
      for (int j = 0; j < QT; ++j) accd[j] += x * v[j];
    }
    if (tuse) {
      T acct[QT];
#pragma unroll
      for (int j = 0; j < QT; ++j) acct[j] = T(0);
#pragma unroll
      for (int i = 0; i < L::TUNITS; ++i) {
        const int u = (l16 + 16 * i) * L::CU;
        T x[L::CU];
        ld_vec(st + tr * BS + u, x);
#pragma unroll
        for (int j = 0; j < QT; ++j) {
          T v[L::CU];
          ld_vec(VT + j * BS + u, v);
#pragma unroll
          for (int kk = 0; kk < L::CU; ++kk) acct[j] += x[kk] * v[kk];
        }
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
#pragma unroll
        for (int j = 0; j < QT; ++j)
          acct[j] += __shfl_xor_sync(0xffffffffu, acct[j], off);
      if (l16 == 0)
        for (int j = 0; j < qn; ++j)
          S[((long long)bx * nterms + kt) * split * BS * q +
            ((p0 + p) * kPieceRows + tr) * q + j] = acct[j];
    }
    __syncthreads();  // the stage is read: its next piece
    if (t == 0 && p + nstage < npiece) {
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      mbar_expect(&bars[s], piece_bytes);
      bulk_load(ring + s * L::PIECE, U + (p + nstage) * L::PIECE,
                piece_bytes, &bars[s]);
    }
  }
  T* dsum = ring;  // [2][BS][QT]: the direct term's two halves
#pragma unroll
  for (int j = 0; j < QT; ++j) dsum[t * QT + j] = accd[j];
  __syncthreads();
  for (int e = t; e < BS * QT; e += kNarrowThreads) {
    const int rr = e / QT, j = e % QT;
    if (j < qn)
      S[(((long long)bp * nterms + kd) * split + part) * BS * q + rr * q +
        j] = add_rn(dsum[e], dsum[BS * QT + e]);
  }

  // Count the terms in; the block that brings a row's last sums it.
  __threadfence();
  __syncthreads();
  if (t == 0) {
    const unsigned need_d = split * (half + 1 + min(bp, half));
    fin[0] = atomicAdd(&g_row_count[rows0 + bp], 1u) == need_d - 1;
    fin[1] = 0;
    if (tt > 0 && tuse) {
      const unsigned need_t = split * (half + 1 + min(bx, half));
      fin[1] = atomicAdd(&g_row_count[rows0 + bx], 1u) == need_t - 1;
    }
  }
  __syncthreads();
  int rows_done = 0;
  for (int f = 0; f < 2; ++f) {
    if (!fin[f]) continue;
    ++rows_done;
    __threadfence();
    const int x = f == 0 ? bp : bx;
    const T* cbx = f == 0 ? cbd : cbt;
    const T* Sx = S + (long long)x * nterms * split * BS * q;
    const T* vx = Vw + (x - bp + half) * BS * QT;
#pragma unroll
    for (int k = 0; k < L::EPI; ++k) {
      const int e = t + k * kNarrowThreads, rr = e / QT, j = e % QT;
      const long long row = (long long)x * BS + rr;
      double pd = 0.0;
      if (e < BS * QT && row < n && j < qn) {
        const T dg = deg[row], bb = k5_b(a, lane, row, c0 + j);
        const T v0 = vx[e];
        T o = mul_rn(dg, v0 - cbx[j]);
        // The terms in order, each the sum of its parts in order (a
        // direct term's split parts; one otherwise); their values are
        // loaded 16 at a time before they are added.
        int kk = 0, pt = 0;
        T cur = T(0);
        while (kk < nterms) {
          T v[16];
          bool first[16], last[16];
          int m = 0;
#pragma unroll
          for (int u = 0; u < 16; ++u) {
            if (kk >= nterms) break;
            const Term mt = term_of(kk, x);
            const int np = mt.bv < 0 ? 0 : (mt.direct ? split : 1);
            if (np == 0) {  // a transposed term past the first block row
              ++kk;
              continue;
            }
            v[m] = __ldcg(Sx + ((long long)kk * split + pt) * BS * q +
                          rr * q + j);
            first[m] = pt == 0;
            last[m] = pt + 1 == np;
            ++m;
            if (++pt == np) {
              pt = 0;
              ++kk;
            }
          }
#pragma unroll
          for (int u = 0; u < 16; ++u) {
            if (u >= m) break;
            cur = first[u] ? v[u] : add_rn(cur, v[u]);
            if (last[u]) o = add_rn(o, cur);
          }
        }
        const T y = k5_out(a, o, v0, bb, lane, row, c0 + j);
        pd = static_cast<double>(mul_rn(v0, y));
      }
      if (e < BS * QT) red[e] = pd;
    }
    __syncthreads();
    if (a.part != nullptr && t < qn) {
      double sum = 0.0;
      for (int rr = 0; rr < BS; ++rr) sum += red[rr * QT + t];
      a.part[(lane * q + c0 + t) * nb + x] = sum;
    }
    if (t == 0) g_row_count[rows0 + x] = 0u;
    __syncthreads();
  }
  if (a.part != nullptr && rows_done > 0)
    k5_finish_dots(a, static_cast<unsigned>(gridDim.y * gridDim.z) * nb,
                   rows_done, nb);
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
    a.part[(lane * q + c0 + t) * nb + b] = sum;
  }
  k5_finish_dots(a, gridDim.x * gridDim.y * gridDim.z, 1u, nb);
}

// The narrow body's blocks a tile of ut: the least of 1, 2, 4, 8 that
// gives kSplitBlocks blocks (one for each of the H100's 132 SMs), each over
// 8 / split of the tile's pieces.
constexpr int kSplitBlocks = 132;
int k5_split(int half, int nb, int lanes) {
  int split = 1;
  while (split < 8 &&
         static_cast<long long>(half + 1) * nb * lanes * split < kSplitBlocks)
    split *= 2;
  return split;
}

template <typename T, int QT>
int k5_narrow_launch(K5Args<T> a, int lanes, cudaStream_t st) {
  a.split = k5_split(a.half, a.nb, lanes);
  const size_t smem = narrow_smem<T, QT>(a.half, a.split);
  static const cudaError_t setup = cudaFuncSetAttribute(
      k5_narrow<T, QT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemCap);
  if (setup != cudaSuccess) return static_cast<int>(setup);
  const int ntile = (a.q + QT - 1) / QT;
  if (smem > kSmemCap || a.terms == nullptr ||
      static_cast<long long>(lanes) * ntile * a.nb > kRowCounters)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((a.half + 1) * a.nb * a.split, ntile, lanes);
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
int narrow_qt(int q, int half, int split) {
  int qt = q <= 1 ? 1 : q <= 2 ? 2 : q <= 4 ? 4 : q <= 8 ? 8 : q <= 12 ? 12
                                                                       : 16;
  auto fits = [&](int k) {
    switch (k) {
      case 1: return narrow_smem<T, 1>(half, split) <= kSmemCap;
      case 2: return narrow_smem<T, 2>(half, split) <= kSmemCap;
      case 4: return narrow_smem<T, 4>(half, split) <= kSmemCap;
      case 8: return narrow_smem<T, 8>(half, split) <= kSmemCap;
      case 12: return narrow_smem<T, 12>(half, split) <= kSmemCap;
      default: return narrow_smem<T, 16>(half, split) <= kSmemCap;
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
    switch (narrow_qt<T>(a.q, a.half, k5_split(a.half, a.nb, lanes))) {
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
// (see above); part must hold lanes * q * nb float64 and ticket one
// unsigned counter at 0 (left at 0) where dot is asked for; for q <= 16,
// terms lanes * nb * (2 half + 2) * k5_split(half, nb, lanes) * 128 * q T
// of scratch. Returns the
// launch's cudaError_t (0 on success).
#define K5_EXPORT(T, S)                                                     \
  extern "C" int banded_product_##S(                                        \
      const T* ut, long long ut_lane, const T* deg, long long deg_lane,     \
      const T* V, long long v_lane, T* out, const T* B, long long b_lane,   \
      const double* bsum, const double* vsum, const T* c, long long c_lane, \
      const T* sigma, long long s_lane, const T* cb, double* part,          \
      double* dot, unsigned* ticket, T* terms, int n, int q, int nb,        \
      int half, int lanes, void* stream) {                                  \
    K5Args<T> a = {ut,     ut_lane, deg,  deg_lane, V,      v_lane, out,   \
                   B,      b_lane,  bsum, vsum,     c,      c_lane, sigma, \
                   s_lane, cb,      part, dot,      ticket, terms,  n,     \
                   q,      nb,      half, 1};                              \
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
