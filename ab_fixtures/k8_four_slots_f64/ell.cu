// A design step of K8 kept for kernel_ab.py --ell-only's VARIANT_DIR: the
// shipped csrc/ell.cu with its float64 instantiation walking 4 slots a trip
// under __launch_bounds__(128, 4) (at most 128 registers: 4 blocks a SM,
// two waves at (100000, 4)), where the shipped one walks 2 under (128, 6)
// (at most 80: one wave). Its outputs are bitwise the shipped kernel's.

// K8, the ELL product L(w) V of the matrix-free route.
//
// Stands for no Pallas kernel: it is mac_tpu.ops.laplacian._ell_apply
// (mac_tpu/ops/laplacian.py:169-181), a gather and an einsum that XLA fuses
// inside the reference's compiled program. The graph is held as padded
// adjacency (ELLPACK) tables, slot-major: slot k of node i holds a
// neighbour nbr[k][i] (int32) and that edge's weight w[k][i]; a node's
// filled slots come first, cnt[i] of them (int32), and the padding after
// them holds neighbour node 0 and weight 0. The product is taken in the
// difference form
//     (L V)_i = sum over k < cnt_i of w_ik (V_i - V_nbr_ik),
// never as deg_i V_i - sum w V_nbr: smooth eigenvectors make that form
// cancel two O(deg |V|) terms down to O(lambda |V|) in float32, while the
// neighbour differences of close values are exact. Each output sums its
// slots in slot order in the block's type T, the difference, the product
// and the sum each rounded on its own (no contraction into an fma), so two
// calls, and a replayed graph and the eager call, are the same bits.
//
// Walking each row only to its count leaves out nothing but padding, which the
// full walk to dmax adds as 0 x (V_i - V_0): a +-0 on finite V, added to a sum
// that is nonzero or +0 (a sum that starts at +0 is never -0 in
// round-to-nearest), which leaves the sum's bits as they were. So on finite V
// the outputs are bitwise those of a walk over every slot (the kernel before
// the count table, on row-major tables). Where V holds an Inf or a NaN at node
// 0 or at a row with padding, the full walk's padding makes that row NaN and
// this walk may not: that is the one case where the two differ.
//
// Epilogues, in the plain version's order of operations (K5's):
//   plain     y = L V;
//   inner     y = (L V + shift) + sigma V, shift = (c / n) 1 1^T V with the
//             column means in float64 from V's column sums vsum
//             (lobpcg._shift_term: c times vsum / n, then rounded to T);
//   residual  out = (B - bsum / n) - y, B's centring optional (the
//             V-cycle's residuals of the centred right-hand side);
// and, with any of them, the column dots of V and out (P . AP of the CG
// step) in float64: a block's partial of a column is its rows' products
// (V times out rounded to T, then widened) added by a warp, lane l the rows
// l, l + 32, ... in order, then the xor butterfly 16, 8, 4, 2, 1; the block
// that takes the last ticket of the device's counter adds the blocks'
// partials in the same order (K5's and K6's last-block order). dot_model in
// ops/kernels/ell.py is this order in numpy.
//
// Lanes (the budget sweep's R weight vectors, one operator each): V, B and
// out (R, n, q), the weight table one per lane or shared (lane stride 0);
// the neighbour and count tables are the topology's, shared by every lane.
//
// Design. A thread is a (row, group of 4 columns) of a lane; a block of 128
// threads holds rb = 128 / gt rows by gt column groups (gt the groups of q,
// up to 128), consecutive threads the groups of one row, so that the
// gathers of a neighbour's row by a row's threads are one contiguous read
// (GreedyEig's flat (n, 256) block, whose threads of a row share one count
// and never diverge), and at q = 4 a thread a row, 128 rows a block. What
// bounds it at the n = 100000 expander (dmax 12, a mean degree of 3.0, a
// warp of 32 rows 5.5 filled slots at most on average) is the chain of
// dependent trips through L2 and the number of slot iterations, so:
//   * the tables are slot-major (the weight table comes so from the one
//     gather a Frank-Wolfe step, ops.laplacian.lap_weight_table): a warp's
//     load of slot k for its 32 rows is one contiguous 128-byte line, where
//     row-major tables took 12 lines for it;
//   * a row walks only its cnt filled slots, kSlots at a time (4 in float,
//     2 in double): the ids and weights of the first kSlots slots are
//     loaded beside the count (they lie in the tables whatever the count),
//     then each trip issues its gathers of V's rows (a row is one 16-byte
//     load at q = 4 in float, two in double; element loads where q is not
//     a multiple of 4 or a pointer is not 16-byte aligned) and the next
//     trip's ids and weights before its first subtraction. A float warp
//     whose largest count is <= 8 takes two trips (0.46x of the full
//     walk's slot iterations there);
//   * __launch_bounds__ caps the registers so that a whole grid at
//     (100000, 4), 782 blocks, is resident in one wave (6 blocks of 128 on
//     each of 132 SMs, at most 80 registers), in float and in double,
//     where 4 slots a trip at 80 registers spilled and 112 registers
//     (4 blocks a SM, two waves) were slower than 2 slots a trip
//     (ops/kernels/ell.py's `occupancy` asks the runtime; chip_smoke.py
//     prints registers, resident blocks and waves);
//   * the dots' ticket is one acquire-release atomic by thread 0 after the
//     block's barrier (pcg.cu's), no thread fence; the last block issues
//     all of a lane's loads of partials (up to kSumLoads) before its first
//     add: one trip through L2 up to 32 kSumLoads blocks.
// The least bytes of the work at (100000, 4) float32 are 6.0 MB (2m ids
// and weights, the counts, V and the output): 1.8 us at 3.35 TB/s; V's
// gathered rows come from L2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // a block's threads
constexpr int kCols = 4;       // a thread's columns
constexpr int kSumLoads = 32;  // the last block's loads of partials a lane

// Slots a trip (their gathers in flight at once) and the blocks a SM that
// __launch_bounds__ asks for, by type.
template <typename T>
struct Walk;
template <>
struct Walk<float> {
  static constexpr int kSlots = 4;
  static constexpr int kMinBlocks = 6;
};
template <>
struct Walk<double> {
  static constexpr int kSlots = 4;
  static constexpr int kMinBlocks = 4;
};

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

__device__ __forceinline__ unsigned add_acq_rel(unsigned* p, unsigned v) {
  unsigned old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], %2;"
               : "=r"(old)
               : "l"(p), "r"(v)
               : "memory");
  return old;
}

// True in the block that takes the last of `total` tickets of the counter.
// Thread 0 takes the ticket after the block's barrier by one
// acquire-release atomic: the block's writes before it (the partials) are
// visible to the block that takes the last ticket, whose reads after it
// see every block's (pcg.cu's last_ticket).
__device__ bool last_ticket(unsigned* ticket, unsigned total) {
  __shared__ bool last;
  __syncthreads();
  if (threadIdx.x == 0) last = add_acq_rel(ticket, 1u) == total - 1;
  __syncthreads();
  return last;
}

template <typename T>
struct K8Args {
  const int* nbr;       // (dmax, n) int32, slot-major, the topology's
  const int* cnt;       // (n,) int32: each row's filled slots
  const T* w;           // lanes of (dmax, n), slot-major
  long long w_lane;     // 0: one table for every lane
  const T* V;           // lanes of (n, q)
  long long v_lane;     // 0: one V for every lane
  T* out;               // (lanes, n, q)
  const T* B;           // residual form: lanes of (n, q), or null
  long long b_lane;
  const double* bsum;   // (lanes, q): B's centring, or null
  const double* vsum;   // (lanes, q): the inner form's shift, or null
  const T* c;           // the shift's coefficient per lane (stride c_lane)
  long long c_lane;
  const T* sigma;       // sigma per lane (stride s_lane), or null
  long long s_lane;
  double* part;         // dot partials (lanes, q, gridDim.x), or null
  double* dot;          // (lanes, q)
  unsigned* ticket;
  int n, q, dmax;
  int gt;               // column groups a block
  int rb;               // rows a block
  int vec;              // rows of V, B and out move as 16-byte vectors
};

// Four values of a row from p: vector loads (16-byte aligned p), or the
// first qc elements (zeros past them).
__device__ __forceinline__ void load4(const float* p, bool vec, int qc,
                                      float (&v)[kCols]) {
  if (vec) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
  } else {
#pragma unroll
    for (int c = 0; c < kCols; ++c) v[c] = c < qc ? __ldg(p + c) : 0.0f;
  }
}
__device__ __forceinline__ void load4(const double* p, bool vec, int qc,
                                      double (&v)[kCols]) {
  if (vec) {
    const double2 x = __ldg(reinterpret_cast<const double2*>(p));
    const double2 y = __ldg(reinterpret_cast<const double2*>(p) + 1);
    v[0] = x.x;
    v[1] = x.y;
    v[2] = y.x;
    v[3] = y.y;
  } else {
#pragma unroll
    for (int c = 0; c < kCols; ++c) v[c] = c < qc ? __ldg(p + c) : 0.0;
  }
}

__device__ __forceinline__ void store4(float* p, bool vec, int qc,
                                       const float (&v)[kCols]) {
  if (vec) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      if (c < qc) p[c] = v[c];
  }
}
__device__ __forceinline__ void store4(double* p, bool vec, int qc,
                                       const double (&v)[kCols]) {
  if (vec) {
    reinterpret_cast<double2*>(p)[0] = make_double2(v[0], v[1]);
    reinterpret_cast<double2*>(p)[1] = make_double2(v[2], v[3]);
  } else {
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      if (c < qc) p[c] = v[c];
  }
}

// The ids and weights of slots k0 .. k0 + S - 1 of a row (nbr and w at the
// row's slot 0, slot k at k * n), those at or past `end` as 0.
template <typename T, int S>
__device__ __forceinline__ void load_slots(const int* nbr, const T* w,
                                           long long n, int k0, int end,
                                           int (&id)[S], T (&wk)[S]) {
#pragma unroll
  for (int u = 0; u < S; ++u) {
    const bool in = k0 + u < end;
    const long long at = static_cast<long long>(k0 + u) * n;
    id[u] = in ? __ldg(nbr + at) : 0;
    wk[u] = in ? __ldg(w + at) : T(0);
  }
}

// The block that takes the last ticket adds the blocks' partials of every
// column: a warp a column, lane l the blocks l, l + 32, ... in order, up to
// kSumLoads of them loaded before the first add, then the xor butterfly; it
// leaves the counter at 0.
__device__ void finish_dots(double* part, double* dot, unsigned* ticket,
                            int count) {
  if (!last_ticket(ticket, gridDim.x * gridDim.y * gridDim.z)) return;
  const int nblk = static_cast<int>(gridDim.x);
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x >> 5; i < count; i += blockDim.x >> 5) {
    const double* p = part + static_cast<long long>(i) * nblk;
    double sum = 0.0;
    for (int k0 = lane; k0 < nblk; k0 += kSumLoads * 32) {
      double x[kSumLoads];
#pragma unroll
      for (int u = 0; u < kSumLoads; ++u) {
        const int k = k0 + 32 * u;
        x[u] = k < nblk ? __ldcg(p + k) : 0.0;
      }
#pragma unroll
      for (int u = 0; u < kSumLoads; ++u) sum += x[u];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) dot[i] = sum;
  }
  if (threadIdx.x == 0) *ticket = 0u;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, Walk<T>::kMinBlocks)
    k8_product(K8Args<T> a) {
  constexpr int S = Walk<T>::kSlots;
  __shared__ double red[kThreads * kCols];  // the dots' products [row][col]
  const int gt = a.gt, rb = a.rb;
  const int tr = threadIdx.x / gt;
  const int tg = threadIdx.x - tr * gt;
  const long long lane = blockIdx.z;
  const long long row = static_cast<long long>(blockIdx.x) * rb + tr;
  const int c0 = (blockIdx.y * gt + tg) * kCols;
  const bool active = tr < rb && row < a.n && c0 < a.q;
  const int qc = active ? min(kCols, a.q - c0) : 0;
  const bool vec = a.vec != 0;
  T v0[kCols] = {}, y[kCols] = {};
  if (active) {
    const long long n = a.n;
    const T* V = a.V + lane * a.v_lane;
    const int* nbr = a.nbr + row;
    const T* w = a.w + lane * a.w_lane + row;
    const long long at = row * a.q + c0;
    // The count and the first S slots at once: those slots lie in the
    // tables whatever the row's count (padding: node 0, weight 0), and
    // nothing past the count is gathered or added.
    const int cnt = min(__ldg(a.cnt + row), a.dmax);
    int id[S];
    T wk[S];
    load_slots<T, S>(nbr, w, n, 0, a.dmax, id, wk);
    T bb[kCols] = {};
    load4(V + at, vec, qc, v0);
    if (a.B != nullptr) load4(a.B + lane * a.b_lane + at, vec, qc, bb);
    T acc[kCols] = {};
    for (int k0 = 0; k0 < cnt; k0 += S) {
      T vn[S][kCols];
#pragma unroll
      for (int u = 0; u < S; ++u)
        if (k0 + u < cnt)
          load4(V + static_cast<long long>(id[u]) * a.q + c0, vec, qc,
                vn[u]);
      int nid[S];  // the next trip's slots, in flight with the gathers
      T nw[S];
      load_slots<T, S>(nbr, w, n, k0 + S, cnt, nid, nw);
#pragma unroll
      for (int u = 0; u < S; ++u)
        if (k0 + u < cnt) {
#pragma unroll
          for (int c = 0; c < kCols; ++c)
            acc[c] = add_rn(acc[c], mul_rn(wk[u], sub_rn(v0[c], vn[u][c])));
        }
#pragma unroll
      for (int u = 0; u < S; ++u) {
        id[u] = nid[u];
        wk[u] = nw[u];
      }
    }
    // The epilogue, as K5's (k5_out).
    const long long lq = lane * a.q + c0;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      T yc = acc[c];
      if (c < qc) {
        if (a.vsum != nullptr) {
          const double c64 = static_cast<double>(a.c[lane * a.c_lane]);
          yc = add_rn(yc, static_cast<T>(c64 * (a.vsum[lq + c] /
                                               static_cast<double>(a.n))));
        }
        if (a.sigma != nullptr)
          yc = add_rn(yc, mul_rn(a.sigma[lane * a.s_lane], v0[c]));
        if (a.B != nullptr) {
          T b = bb[c];
          if (a.bsum != nullptr)
            b = sub_rn(b, static_cast<T>(a.bsum[lq + c] /
                                         static_cast<double>(a.n)));
          yc = sub_rn(b, yc);
        }
      }
      y[c] = yc;
    }
    store4(a.out + lane * static_cast<long long>(a.n) * a.q + at, vec, qc, y);
  }
  if (a.part == nullptr) return;

  // The dots: each row's products into red, then a warp a column adds the
  // block's rows (lane l: rows l, l + 32, ...) and the xor butterfly.
  const int qw = gt * kCols;
  if (tr < rb) {
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      red[tr * qw + tg * kCols + c] =
          c < qc ? static_cast<double>(mul_rn(v0[c], y[c])) : 0.0;
  }
  __syncthreads();
  const int wid = threadIdx.x >> 5, ln = threadIdx.x & 31;
  for (int j = wid; j < qw; j += kThreads / 32) {
    const int col = blockIdx.y * qw + j;
    if (col >= a.q) break;
    double s = 0.0;
    for (int r = ln; r < rb; r += 32) s += red[r * qw + j];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    if (ln == 0)
      a.part[(lane * a.q + col) * static_cast<long long>(gridDim.x) +
             blockIdx.x] = s;
  }
  finish_dots(a.part, a.dot, a.ticket, static_cast<int>(gridDim.z) * a.q);
}

template <typename T>
int k8_launch(K8Args<T> a, int lanes, void* stream) {
  if (a.n <= 0 || a.q <= 0 || lanes <= 0) return 0;
  if (a.dmax <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int groups = (a.q + kCols - 1) / kCols;
  a.gt = groups < kThreads ? groups : kThreads;
  a.rb = kThreads / a.gt;
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(a.V) |
                         reinterpret_cast<uintptr_t>(a.out) |
                         reinterpret_cast<uintptr_t>(a.B);
  a.vec = a.q % kCols == 0 && ptrs % 16 == 0 && a.v_lane % kCols == 0 &&
          a.b_lane % kCols == 0;
  const dim3 grid((a.n + a.rb - 1) / a.rb, (groups + a.gt - 1) / a.gt,
                  lanes);
  k8_product<T>
      <<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int k8_occupancy(int* regs, int* blocks) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, k8_product<T>);
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = attr.numRegs;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, k8_product<T>, kThreads, 0));
}

}  // namespace

// K8. nbr (dmax, n) int32 and cnt (n,) int32 (ops.laplacian.GraphOperator's
// slot_nbr and slot_count); w (dmax, n) slot-major and V, out, B (n, q)
// row-major in T (float: _f32, double: _f64), contiguous per lane, at the
// lane strides given (0: one array for every lane); out (lanes, n, q). Null
// pointers leave the epilogue's parts out (see above); part must hold
// lanes * q * ceil(n / rb) float64 (rb = 128 / min(ceil(q / 4), 128)) and
// ticket one unsigned counter at 0 (left at 0) where dot is asked for.
// Returns the launch's cudaError_t (0 on success).
#define K8_EXPORT(T, S)                                                      \
  extern "C" int ell_product_##S(                                            \
      const int* nbr, const int* cnt, const T* w, long long w_lane,          \
      const T* V, long long v_lane, T* out, const T* B, long long b_lane,    \
      const double* bsum, const double* vsum, const T* c, long long c_lane,  \
      const T* sigma, long long s_lane, double* part, double* dot,           \
      unsigned* ticket, int n, int q, int dmax, int lanes, void* stream) {   \
    K8Args<T> a = {nbr,   cnt,    w,      w_lane, V,     v_lane, out,        \
                   B,     b_lane, bsum,   vsum,   c,     c_lane, sigma,      \
                   s_lane, part,  dot,    ticket, n,     q,      dmax,       \
                   0,     0,      0};                                         \
    return k8_launch<T>(a, lanes, stream);                                   \
  }                                                                          \
  /* The kernel's registers a thread and its resident blocks a SM (the     \
     runtime's occupancy of a 128-thread block); no launch. */             \
  extern "C" int ell_product_occupancy_##S(int* regs, int* blocks) {         \
    return k8_occupancy<T>(regs, blocks);                                    \
  }

K8_EXPORT(float, f32)
K8_EXPORT(double, f64)
