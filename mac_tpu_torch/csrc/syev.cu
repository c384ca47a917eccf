// K4: the eigenpairs of a batch of symmetric matrices of any order, by
// cyclic Jacobi rotations. Two bodies, one arithmetic:
//   sym_eig_{f32,f64}(H, evals, V, k, batch, stream), k <= 32: one warp a
//     matrix, the matrix in registers (the warp body);
//   sym_eig_wide_{f32,f64}(H, evals, V, work, k, batch, stream), any k
//     (K4w): one thread block a matrix, A and V in dynamic shared memory
//     (work NULL) or in a global workspace (work: batch x
//     sym_eig_wide_scratch_bytes_* bytes, 16-byte aligned).
// H (batch, k, k) contiguous; evals (batch, k) ascending, ties in index
// order; V (batch, k, k) with V[:, i, j] the i-th entry of the eigenvector
// of evals[:, j] (torch.linalg.eigh's layout). The arithmetic stays in H's
// type.
//
// Sign convention: each eigenvector column is scaled by -1 where needed so
// that its entry of largest magnitude (the first such row on ties) is
// positive.
//
// Replace: the JAX package runs the Rayleigh-Ritz eigensolve of its
// TRACEMIN as jnp.linalg.eigh inside the compiled solve (mac_tpu/ops/
// lobpcg.py:354 and :371 at the entry, :443 in every outer iteration), on
// the q x q and 3q x 3q matrices of a q-column block (4 x 4 and 12 x 12 at
// the default q = 4; any q up to n - 1), under vmap for its lanes. It is
// not a Pallas kernel; for matrices this small XLA computes it on the TPU
// by Jacobi rotations too. torch.linalg.eigh on a CUDA tensor
// (cuSOLVER's syevd) reads its error code back to the host, so a solve that
// called it could not be captured in a CUDA graph; this kernel reads
// nothing back.
//
// Algorithm: the parallel (round-robin) cyclic Jacobi method. With m = k
// rounded up to even (an odd k gets a zero row and column, whose rotations
// are all skipped), a sweep is m - 1 rounds; round r pairs slot i with
// slot m - 1 - i, where slot 0 holds index 0 and slot j >= 1 holds index
// ((j - 1 + r) mod (m - 1)) + 1; the m / 2 pairs (p < q) of a round are
// disjoint and rotate together: A <- J^T A J, V <- V J. Each rotation
// zeroes a_pq with Rutishauser's stable formulas:
//     t = sign(theta) / (|theta| + sqrt(theta^2 + 1)),
//         theta = (a_qq - a_pp) / (2 a_pq),
//       computed as 2 a_pq / (d + sign(d) hypot(d, 2 a_pq)), d = a_qq - a_pp
//       (the same number, and no overflow of theta^2);
//     c = 1 / hypot(t, 1),  s = t c,  tau = s / (1 + c)
//     x_p <- x_p - s (x_q + tau x_p),  x_q <- x_q + s (x_p - tau x_q)
// for the rows p, q of A, then its columns p, q and the columns of V;
// then a_pp <- a_pp - t a_pq, a_qq <- a_qq + t a_pq, a_pq = a_qp = 0.
// A rotation with a_pq = 0 (row p, column q) is skipped, and so are the
// row and column updates of one whose s is 0. The stop test runs on the
// device before every sweep: the off-diagonal Frobenius norm (each column
// summed in index order, then a butterfly over the warp) at most eps(T)
// times ||H||_F, or MAX_SWEEPS sweeps done. Then the eigenvalues (the
// diagonal) are ranked (ascending, ties by index) and written with their
// vectors. The plain version, mac_tpu_torch.ops.kernels.syev.sym_eig_plain,
// runs the same rounds in the same order with the same stop rule.
//
// What bounds it on the H100: a chain of dependent rounds, as K3's chain
// of pivots bounds it, not bytes (a 12 x 12 float64 matrix is 1152 bytes,
// 0.3 ns at 3.35 TB/s) or operations (about 4 m^3 a sweep). Each round
// waits for the one before: its parameters (two hypot, three IEEE
// divisions) need the a_pq and diagonal that the last round's updates
// left, and the updates need the parameters. sym_eig_round_probe_{f32,f64}
// time that irreducible chain alone (the parameter arithmetic and one
// shuffle exchange a round, one warp); chip_smoke.py's K4 bound is the
// rounds this H takes times that time.
//
// The warp body keeps everything between two parameter computations in
// registers and every index a compile-time constant:
//   * a template on the even size m (the launcher switches on it): the
//     rounds and the pairs of a round are unrolled, so every (p, q) is a
//     constant and no schedule table or modulo is left at run time;
//   * one warp a matrix, kWarps matrices a block: lane j holds column j of
//     A (a[i] = A[i][j]) and row j of V (v[c] = V[j][c]), in registers;
//   * the lanes p and q of a pair both compute its parameters, from the
//     same operands taken by shuffle from the same lanes (a_pq is lane q's
//     a[p]; each lane keeps its diagonal entry in a register dg beside the
//     column); every lane takes each pair's (s, tau) from lane p;
//   * the row update of rows p, q of A and the column update of V's
//     columns p, q are local to every lane (constant register indices);
//     the column update of A takes the partner's column by m shuffles;
//   * the parameters sit in a branch; the row updates are selects (and in
//     float32 the column update too);
//   * only the ranking and the output go through shared memory, once.
// One body serves every m up to 32. In float64 past m = 20 a lane's column
// of A and row of V (2 m doubles) outgrow its registers and ptxas spills;
// those sizes stay right and bitwise, only slower per round (TRACEMIN's
// default q = 4 gives m = 4 and 12).
// The roundings are the expressions above, written with the rotation's
// sign folded in for the column update (x + sigma s (y - sigma tau x),
// sigma -1 at p and +1 at q, exactly the two formulas after contraction),
// so the outputs do not depend on where a value lives: kernel_ab.py holds
// them bitwise against a build of the same rounds with A and V in shared
// memory. That the two lanes of a pair read their operands from the same
// lanes matters: selecting them locally (a_pp as this lane's dg or the
// partner's) let the compiler round the parameters otherwise on some
// inputs.
//
// No allocation, no host read: one launch, a warp per matrix.
//
// K4w, the wide body (sym_eig_wide_kernel<T, shared>): past m = 32 (a
// block of q >= 11 columns gives 3q >= 33) a matrix no longer fits a
// warp's registers. A cluster of two thread blocks takes one matrix, on
// neighbouring SMs (__cluster_dims__(2, 1, 1)): the A block holds A, the V
// block V^T, in dynamic shared memory while a block's share
// (wide_smem_bytes: the ring below, A twice and the parameters) fits the
// 232,448 bytes a block may opt into (m up to 168 in float32, 118 in
// float64, as the three-pass K4w did), else in the caller's global workspace
// (wide_scratch_bytes a matrix; the ring stays in shared memory). The two
// storage forms run one body over one layout. The same rounds in the same
// order as the warp body.
//   * Who owns what. The A block keeps A by slots: in round r the entry at
//     the row of slot s and the column of slot t sits in plane (side(s),
//     side(t)) at (pair(s), pair(t)) of h x h (h = m / 2; slot a < h is
//     side 0 of pair a, slot m - 1 - a side 1). A round's pairs are fixed
//     positions, every 2 x 2 block (the two rows of pair a by the two
//     columns of pair b) is four entries at a h + b of the planes, and a
//     warp's blocks are consecutive: no bank conflict. A is kept twice: a
//     round reads one copy and writes the other at the next round's slots
//     (slot j >= 2 goes to j - 1, slot 1 to m - 1, slot 0 stays; fixed
//     offsets away from pairs 0, 1 and h - 1), so at the start of every
//     sweep the slots are the indices again. Each thread of the block but
//     the last warps takes blocks (a, b) in turn: loads the four entries
//     once, applies pair a's row rotation and then pair b's column
//     rotation in registers, with the three-pass K4w's expressions (x +
//     sigma s (y - sigma tau x), sigma -1 at p and +1 at q, each skipped
//     where s is 0), and stores them once; then the threads with the
//     fewest blocks give each diagonal block (a = b) its new diagonal and
//     zeros where its pair acts. One block barrier a round; 896 threads at
//     most (the fastest of 512 to 1024 at order 96 on the H100, 72
//     registers, no spill).
//   * Where the parameters are published. The last warps are pushers:
//     pusher j computes the next round's pair j = (p, q) while the others
//     rotate: p and q sit in pairs u and v of this round, so its a_pq is
//     block (u, v)'s entry after this round's rotations (read from this
//     round's copy, which no thread writes, and rotated in registers), and
//     its a_pp and a_qq are this round's new diagonal where their pair
//     acts, else as they were. It writes (sigma s, sigma tau) of the pair's
//     side 0 (side 1's are their negatives), the new diagonal by side and
//     act into shared memory, in one of two buffers (this round's, the
//     next one's): computed once, by one thread, read by all. Round 0's
//     come from the matrix as loaded, by the same code with nothing
//     rotated.
//   * Where V's rotations run. The thread that moves pair j's diagonal
//     block hands the pair's (p, q, s, tau) to the V block by an
//     asynchronous store into distributed shared memory (st.async), into
//     a ring of slots in the V block; a slot's "full" mbarrier completes
//     when a round's bytes have landed, its "empty" mbarrier in the A
//     block when the V block's warps have applied it (their own st.async
//     of 4 bytes each; the A block's thread that waited for the slot arms
//     its next phase). The V block's warps each take a slab of 32 columns
//     of V^T (a lane a column) and every g-th pair of a round, in the
//     rounds' order, off A's chain; at the end the A block sends the
//     diagonal in place of a round (p = -1), and the V block ranks, signs
//     and writes the eigenpairs.
//   * Why the bits are the three-pass K4w's (commit 9f43cf3: the
//     parameters, then rows of A and V^T, then columns of A, two block
//     barriers a round). Each entry of A and V sees the same
//     expressions on the same operands in the same order (the row
//     rotation before the column rotation, the rounds in order, the
//     parameters from a_pp, a_qq and a_pq as the last round left them, the
//     same skips; moving an entry or negating a sign is exact), and the
//     stop test sums in that kernel's order: its thread t (t below its block
//     size, wide_stop_stride(m)) sums the squares of columns t, t + stride,
//     ... over the rows in index order, each warp adds its threads' sums by
//     a butterfly, and the warps' sums are added in warp order. For m <= 32
//     that is the warp body's order, so K4w forced onto a small matrix
//     gives the warp body's outputs bit for bit.
// What bounds it is the warp body's chain plus one block barrier a round
// (the pushers), or the blocks' 2 m^2 shared-memory accesses a round where
// those take longer; sym_eig_wide_round_probe_{f32,f64} times a round of
// the chain with two block barriers at a given block size (the bound's
// yardstick).

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>
#include <utility>

namespace {

constexpr int kMaxK = 32;
constexpr int kMaxSweeps = 30;
constexpr int kWarps = 4;  // matrices (warps) per block
constexpr unsigned kFullMask = 0xffffffffu;

template <typename T>
struct Eps;
template <>
struct Eps<float> {
  static __device__ float value() { return FLT_EPSILON; }
};
template <>
struct Eps<double> {
  static __device__ double value() { return DBL_EPSILON; }
};

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(kFullMask, v, off);
  return v;
}

__device__ __forceinline__ long long gtimer() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Index of slot `slot` in round r of a sweep over m (even) indices: a
// constant wherever slot and r are.
__host__ __device__ constexpr int slot_index(int slot, int r, int m) {
  return slot == 0 ? 0 : ((slot - 1 + r) % (m - 1)) + 1;
}

// The partner of index j < m in round R: j's slot s, the index at slot
// m - 1 - s.
template <int M, int R>
__device__ __forceinline__ int partner_of(int j) {
  if (j == 0) return R == 0 ? M - 1 : R;
  int s = j - R;
  if (s < 1) s += M - 1;
  int ps = M - 1 - s;
  if (ps == 0) return 0;
  int idx = ps + R;
  return idx > M - 1 ? idx - (M - 1) : idx;
}

// True when eigenvalue i comes before eigenvalue j: ascending, NaN last,
// ties (and NaNs among themselves) in index order.
template <typename T>
__device__ bool before(T di, int i, T dj, int j) {
  bool ni = isnan(di), nj = isnan(dj);
  if (ni != nj) return nj;
  if (!ni && di != dj) return di < dj;
  return i < j;
}

// Rows p, q of A (lane-local: this lane's column) and columns p, q of V
// (lane-local: this lane's row) under pair I of round R, whose (s, tau)
// lane p computed.
template <typename T, int M, int R, int I>
__device__ __forceinline__ void rotate_rows(T (&a)[M], T (&v)[M], T s,
                                            T tau) {
  constexpr int sa = slot_index(I, R, M), sb = slot_index(M - 1 - I, R, M);
  constexpr int p = sa < sb ? sa : sb, q = sa < sb ? sb : sa;
  const T si = __shfl_sync(kFullMask, s, p);
  const T ti = __shfl_sync(kFullMask, tau, p);
  const bool on = si != T(0);  // a skipped rotation leaves them as they are
  T x = a[p], y = a[q];
  a[p] = on ? x - si * (y + ti * x) : x;
  a[q] = on ? y + si * (x - ti * y) : y;
  x = v[p];
  y = v[q];
  v[p] = on ? x - si * (y + ti * x) : x;
  v[q] = on ? y + si * (x - ti * y) : y;
}

// One round R: parameters, rows of A and columns of V, columns of A, then
// Rutishauser's diagonal and the annihilated pair exactly zero. The
// parameters sit in a branch (the lanes of a skipped rotation do not
// divide); the row updates select the old values for a skipped rotation,
// so that no branch splits them into regions the compiler cannot schedule
// across. In float32 the column update and the diagonal select too; in
// float64 they stay branches, because selecting there made ptxas spill
// around the division's slow-path call (m = 4).
template <typename T, int M, int R, int... I>
__device__ __forceinline__ void jacobi_round(T (&a)[M], T (&v)[M], T& dg,
                                             int lane, bool live,
                                             std::integer_sequence<int, I...>) {
  const int pj = live ? partner_of<M, R>(lane) : lane;
  const bool is_p = lane < pj;
  const int lp = is_p ? lane : pj, lq = is_p ? pj : lane;
  // a[pj]: lane q's is A[p][q] (row p, column q). Both lanes of the pair
  // take a_pq from lane q, a_pp from lane p and a_qq from lane q, so that
  // both compute the parameters from the same operands in the same order.
  T mine = T(0);
#pragma unroll
  for (int i = 0; i < M; ++i)
    if (i == pj) mine = a[i];
  const T apq = __shfl_sync(kFullMask, mine, lq);
  const T app = __shfl_sync(kFullMask, dg, lp);
  const T aqq = __shfl_sync(kFullMask, dg, lq);
  const bool act = live && apq != T(0);
  T t = T(0), s = T(0), tau = T(0);
  if (act) {
    T d = aqq - app, a2 = apq + apq;
    t = a2 / (d + copysign(hypot(d, a2), d));
    T c = T(1) / hypot(t, T(1));
    s = t * c;
    tau = s / (T(1) + c);
  }
  (rotate_rows<T, M, R, I>(a, v, s, tau), ...);
  // Columns p, q of A: this lane's column and its partner's. sigma is -1
  // on lane p, +1 on lane q.
  const T ss = is_p ? -s : s, tt = is_p ? -tau : tau;
  const bool on = s != T(0);
  if constexpr (std::is_same<T, float>::value) {
#pragma unroll
    for (int i = 0; i < M; ++i) {
      const T y = __shfl_sync(kFullMask, a[i], pj);
      a[i] = on ? a[i] + ss * (y - tt * a[i]) : a[i];
    }
    dg = act ? (is_p ? app - t * apq : aqq + t * apq) : dg;
#pragma unroll
    for (int i = 0; i < M; ++i)
      a[i] = act && i == lane ? dg : act && i == pj ? T(0) : a[i];
  } else {
#pragma unroll
    for (int i = 0; i < M; ++i) {
      const T y = __shfl_sync(kFullMask, a[i], pj);
      if (on) a[i] = a[i] + ss * (y - tt * a[i]);
    }
    if (act) {
      dg = is_p ? app - t * apq : aqq + t * apq;
#pragma unroll
      for (int i = 0; i < M; ++i) {
        if (i == lane) a[i] = dg;
        if (i == pj) a[i] = T(0);
      }
    }
  }
}

template <typename T, int M, int... R>
__device__ __forceinline__ void jacobi_sweep(T (&a)[M], T (&v)[M], T& dg,
                                             int lane, bool live,
                                             std::integer_sequence<int, R...>) {
  (jacobi_round<T, M, R>(a, v, dg, lane, live,
                         std::make_integer_sequence<int, M / 2>()),
   ...);
}

template <typename T, int M>
__global__ void __launch_bounds__(32 * kWarps)
sym_eig_kernel(const T* __restrict__ H, T* __restrict__ evals,
               T* __restrict__ Vout, int k, int batch) {
  __shared__ T Vs[kWarps][M][M + 1];
  __shared__ T Ds[kWarps][M];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int mat = blockIdx.x * kWarps + warp;
  if (mat >= batch) return;  // the whole warp
  const bool live = lane < M;
  const T* Hb = H + (size_t)mat * k * k;

  // Load A (lane j holds column j), the identity into V (lane j row j);
  // a zero row and column pad an odd k.
  T a[M], v[M];
  T norm2 = T(0);
#pragma unroll
  for (int i = 0; i < M; ++i) {
    a[i] = (i < k && lane < k) ? Hb[i * k + lane] : T(0);
    v[i] = (i == lane) ? T(1) : T(0);
    norm2 += a[i] * a[i];
  }
  const T tol = Eps<T>::value() * sqrt(warp_sum(norm2));
  T dg = T(0);  // A[lane][lane]
#pragma unroll
  for (int i = 0; i < M; ++i)
    if (i == lane) dg = a[i];

  for (int sweep = 0; sweep < kMaxSweeps; ++sweep) {
    T off2 = T(0);
#pragma unroll
    for (int i = 0; i < M; ++i)
      if (live && i != lane) off2 += a[i] * a[i];
    if (sqrt(warp_sum(off2)) <= tol) break;  // the same on every lane
    jacobi_sweep<T, M>(a, v, dg, lane, live,
                       std::make_integer_sequence<int, M - 1>());
  }

  // V and the diagonal to shared memory; then the sign convention and the
  // ranks: lane j owns eigenpair j.
  T (*Vw)[M + 1] = Vs[warp];
  if (live) {
    Ds[warp][lane] = dg;
#pragma unroll
    for (int c = 0; c < M; ++c) Vw[lane][c] = v[c];
  }
  __syncwarp();
  if (lane < k) {
    int imax = 0;
    T vmax = fabs(Vw[0][lane]);
    for (int i = 1; i < k; ++i) {
      T x = fabs(Vw[i][lane]);
      if (x > vmax) {
        vmax = x;
        imax = i;
      }
    }
    if (Vw[imax][lane] < T(0))
      for (int i = 0; i < k; ++i) Vw[i][lane] = -Vw[i][lane];
  }
  __syncwarp();
  if (lane < k) {
    T d = Ds[warp][lane];
    int rank = 0;
    for (int i = 0; i < k; ++i)
      if (i != lane && before(Ds[warp][i], i, d, lane)) ++rank;
    T* eb = evals + (size_t)mat * k;
    T* vb = Vout + (size_t)mat * k * k;
    eb[rank] = d;
    for (int i = 0; i < k; ++i) vb[i * k + rank] = Vw[i][lane];
  }
}

template <typename T, int M>
int launch_m(const void* H, void* evals, void* V, int k, int batch,
             cudaStream_t stream) {
  const int blocks = (batch + kWarps - 1) / kWarps;
  sym_eig_kernel<T, M><<<blocks, 32 * kWarps, 0, stream>>>(
      (const T*)H, (T*)evals, (T*)V, k, batch);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* H, void* evals, void* V, int k, int batch,
           void* stream) {
  if (k < 1 || k > kMaxK || batch < 0) return (int)cudaErrorInvalidValue;
  if (batch == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  switch (k + (k & 1)) {
    case 2: return launch_m<T, 2>(H, evals, V, k, batch, st);
    case 4: return launch_m<T, 4>(H, evals, V, k, batch, st);
    case 6: return launch_m<T, 6>(H, evals, V, k, batch, st);
    case 8: return launch_m<T, 8>(H, evals, V, k, batch, st);
    case 10: return launch_m<T, 10>(H, evals, V, k, batch, st);
    case 12: return launch_m<T, 12>(H, evals, V, k, batch, st);
    case 14: return launch_m<T, 14>(H, evals, V, k, batch, st);
    case 16: return launch_m<T, 16>(H, evals, V, k, batch, st);
    case 18: return launch_m<T, 18>(H, evals, V, k, batch, st);
    case 20: return launch_m<T, 20>(H, evals, V, k, batch, st);
    case 22: return launch_m<T, 22>(H, evals, V, k, batch, st);
    case 24: return launch_m<T, 24>(H, evals, V, k, batch, st);
    case 26: return launch_m<T, 26>(H, evals, V, k, batch, st);
    case 28: return launch_m<T, 28>(H, evals, V, k, batch, st);
    case 30: return launch_m<T, 30>(H, evals, V, k, batch, st);
    default: return launch_m<T, 32>(H, evals, V, k, batch, st);
  }
}

// The irreducible chain of a round, alone: one warp, lanes in pairs; each
// round the parameter arithmetic of jacobi_round on (app, aqq, apq) and
// one shuffle exchange, the next round's apq made from this round's tau
// (kept in a normal range), so every round waits for the one before.
template <typename T>
__global__ void __launch_bounds__(32)
round_probe_kernel(T* out, int rounds) {
  const int lane = threadIdx.x;
  const T app = T(1) + T(0.25) * (lane & 7), aqq = T(2) - T(0.125) * (lane & 3);
  T apq = T(0.5);
  for (int r = 0; r < rounds; ++r) {
    T d = aqq - app, a2 = apq + apq;
    T t = a2 / (d + copysign(hypot(d, a2), d));
    T c = T(1) / hypot(t, T(1));
    T s = t * c;
    T tau = s / (T(1) + c);
    apq = __shfl_xor_sync(kFullMask, tau, 1) + T(0.5);
  }
  out[lane] = apq;
}

template <typename T>
int probe(void* out, int rounds, void* stream) {
  if (rounds < 0) return (int)cudaErrorInvalidValue;
  round_probe_kernel<T><<<1, 32, 0, (cudaStream_t)stream>>>((T*)out, rounds);
  return (int)cudaGetLastError();
}

// ---- K4w: a cluster of two thread blocks a matrix, any order ----

// Bytes of dynamic shared memory a block may opt into (H100, H200).
constexpr long long kSmemLimit = 232448;
// Slots of the ring through which K4w's A block hands each round's
// rotations to its V block (fewer on the workspace form where a slot of a
// very large order would not fit).
constexpr int kRing = 8;
// Bytes of the ring's head: kRing "full" and kRing "empty" mbarriers, and
// the word the V block's stores that free a slot write.
constexpr int kRingHead = 2 * 8 * kRing + 16;

// K4w's leading dimension of A and V^T at even order m: odd, so that a
// warp reading down a column of float32 entries meets no bank twice.
__host__ __device__ constexpr int wide_ld(int m) { return m + 1; }

// One rotation as the ring carries it: (s, tau) of pair (p, q), p < q; the
// end mark has p = -1 and the diagonal in (s, tau). 16 bytes in float32, 32
// in float64 (24 written), aligned to 16 for the vector stores.
template <typename T>
struct alignas(16) WideRec {
  T s, tau;
  int p, q;
};

// Bytes the A block writes into a slot a round (what its "full" mbarrier
// waits for).
template <typename T>
__host__ __device__ constexpr int wide_slot_tx(int m) {
  return (m / 2) * (2 * (int)sizeof(T) + 8);
}

// Bytes of the A block's parameters at even order m, rounded up to 16:
// in elements of T, two buffers (a round's and the next one's) of per pair
// (s, tau) and the new diagonal pair (2 x 4 x m / 2) and the stop test's
// per-warp sums (32); then two buffers of per pair act and per pair the
// moves of its rows and of its columns to the next round's slots (6 x m /
// 2 ints).
template <typename T>
__host__ __device__ constexpr long long wide_params_bytes(int m) {
  return ((4LL * m + 32) * (long long)sizeof(T)
          + 6LL * (m / 2) * (long long)sizeof(int) + 15) / 16 * 16;
}

// Bytes of the A block's region at even order m: A twice (the round's
// layout and the next one's, m x m each), then its parameters.
template <typename T>
__host__ __device__ constexpr long long wide_region_bytes(int m) {
  return 2LL * m * m * (long long)sizeof(T) + wide_params_bytes<T>(m);
}

// Bytes of K4w's workspace per matrix at even order m: the A block's
// region, then V^T (m x wide_ld(m)), rounded up to 16. More than the
// three-pass K4w's.
template <typename T>
__host__ __device__ constexpr long long wide_scratch_bytes(int m) {
  return wide_region_bytes<T>(m)
         + ((long long)m * wide_ld(m) * sizeof(T) + 15) / 16 * 16;
}

// Bytes of a slot of the ring: m / 2 rotations.
template <typename T>
__host__ __device__ constexpr long long wide_slot_bytes(int m) {
  return (long long)(m / 2) * sizeof(WideRec<T>);
}

// The ring's slots: on the shared-memory form as many as fit beside the A
// block's region, at most kRing (0 where none does: that form is refused);
// on the workspace form as many as fit, at most kRing.
template <typename T>
__host__ __device__ constexpr int wide_ring_slots(int m, bool shared) {
  const long long fit = (kSmemLimit - kRingHead
                         - (shared ? wide_region_bytes<T>(m) : 0))
                        / wide_slot_bytes<T>(m);
  return fit < 0 ? 0 : fit < kRing ? (int)fit : kRing;
}

// Bytes of the ring with `slots` slots (a multiple of 16).
template <typename T>
__host__ __device__ constexpr long long wide_ring_bytes(int m, int slots) {
  return kRingHead + slots * wide_slot_bytes<T>(m);
}

// Bytes of dynamic shared memory a block of the shared-memory form takes:
// the ring (at least a slot), then the A block's region; more than
// kSmemLimit where that form cannot take order m.
template <typename T>
__host__ __device__ constexpr long long wide_smem_bytes(int m) {
  const int slots = wide_ring_slots<T>(m, true);
  return wide_ring_bytes<T>(m, slots < 1 ? 1 : slots)
         + wide_region_bytes<T>(m);
}

// Threads of each block of K4w's cluster at most (72 registers each).
constexpr int kWideMaxThreads = 896;

// Threads of each block of K4w's cluster at even order m: a warp of
// pushers and one a 2 x 2 block of A, (m / 2)^2 of them, rounded up to a
// multiple of 32, at most kWideMaxThreads (a thread takes several blocks
// past m = 58). Every setting gives the same bits.
__host__ __device__ constexpr int wide_threads(int m) {
  const long long t = (long long)(m / 2) * (m / 2) + 63;
  return t >= kWideMaxThreads ? kWideMaxThreads : (int)(t / 32 * 32);
}

// The three-pass K4w's block size at even order m (m / 2 pairs of up to 16
// threads): the stop test sums as its threads did, whatever the block, so
// that its order, and with it every sweep count, stays its own at every
// order.
__host__ __device__ constexpr int wide_stop_stride(int m) {
  int lanes = 16;
  while (lanes > 1 && (long long)(m / 2) * lanes > 1024) lanes >>= 1;
  const long long t = (long long)(m / 2) * lanes;
  return t >= 1024 ? 1024 : (int)((t + 31) / 32 * 32);
}

// Warps of the V block a slab of 32 columns of V^T has (the warps beyond
// the slabs' share idle): each takes every g-th pair of a round, a lane a
// column.
__host__ __device__ constexpr int wide_slab_warps(int m, int nt) {
  const int slabs = (m + 31) / 32, g = nt / 32 / slabs;
  return g < 1 ? 1 : g;
}

// Warps of the V block that apply the rotations.
__host__ __device__ constexpr int wide_v_warps(int m, int nt) {
  const int w = (m + 31) / 32 * wide_slab_warps(m, nt);
  return w < nt / 32 ? w : nt / 32;
}

// Pairs a pass of the A block's pushers takes: min(m / 2, nt / 2); pusher
// j takes pairs j, j + np, .... The pushers are the block's last np
// threads rounded up to whole warps; the others take the other blocks.
__host__ __device__ constexpr int wide_pushers(int m, int nt) {
  return m / 2 < nt / 2 ? m / 2 : nt / 2;
}

// The A block's parameters, in the workspace's layout after the matrix:
// two buffers (a round's and the next one's) of per pair (s, tau) and (new
// a_pp, new a_qq) interleaved, the stop test's 32 sums, two buffers of
// per pair act.
template <typename T>
struct WideParams {
  T *f, *red;  // buffer b: (s, tau) at f + 4 h b, the new diagonal + 2 h
  int* n;      // buffer b's act at n + h b; the moves at n + 2 h, n + 4 h
  int h;
  __device__ WideParams(unsigned char* base, int m) : h(m / 2) {
    f = reinterpret_cast<T*>(base);
    red = f + 8 * h;
    n = reinterpret_cast<int*>(red + 32);
  }
  __device__ T* st(int b) const { return f + 4 * h * b; }
  __device__ T* dd(int b) const { return f + 4 * h * b + 2 * h; }
  __device__ int* act(int b) const { return n + h * b; }
  // Pair a's rows (sides 0, 1) and columns move by rows(a) and cols(a),
  // the planes folded in: an entry of block (a, b) at e + (2 sa + sb) h^2
  // goes to e + rows(a)[sa] + cols(b)[sb] of the other buffer.
  __device__ int2* rows() const { return reinterpret_cast<int2*>(n + 2 * h); }
  __device__ int2* cols() const { return reinterpret_cast<int2*>(n + 4 * h); }
};

template <typename T>
struct WideRing {
  unsigned long long *full, *empty;
  unsigned* sink;
  WideRec<T>* rec;  // slot b holds m / 2 rotations from rec + b * (m / 2)
  __device__ explicit WideRing(unsigned char* smem) {
    full = reinterpret_cast<unsigned long long*>(smem);
    empty = full + kRing;
    sink = reinterpret_cast<unsigned*>(empty + kRing);
    rec = reinterpret_cast<WideRec<T>*>(smem + kRingHead);
  }
};

template <typename T>
struct Vec2;
template <>
struct Vec2<float> {
  using type = float2;
};
template <>
struct Vec2<double> {
  using type = double2;
};

// ---- the cluster's primitives (sm_90): distributed shared memory,
// asynchronous stores into it and mbarriers ----

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

// The address, in the cluster's shared window, of what p is in this
// block's shared memory, in block `rank` of the cluster.
__device__ __forceinline__ unsigned peer(const void* p, unsigned rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out)
               : "r"(smem_u32(p)), "r"(rank));
  return out;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release;\n\t"
      "barrier.cluster.wait.acquire;" ::: "memory");
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar,
                                          unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// This thread's arrival at one of this block's mbarriers, adding `tx` bytes
// that the current phase also waits for.
__device__ __forceinline__ void mbar_expect(unsigned long long* bar,
                                            unsigned tx) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(tx)
      : "memory");
}

// Wait until the phase of parity `parity` of this block's mbarrier has
// completed; kCluster: acquire at cluster scope (what the other block's
// asynchronous stores wrote before they completed is seen), else at the
// block's (a wait that only orders this block's later writes). A wait
// that never ends traps after about 2^26 polls: a fault, not a hung card.
template <bool kCluster>
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  const unsigned addr = smem_u32(bar);
  for (unsigned polls = 0;; ++polls) {
    unsigned done;
    if (kCluster)
      asm volatile(
          "{\n\t.reg .pred p;\n\t"
          "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, "
          "[%1], %2;\n\t"
          "selp.u32 %0, 1, 0, p;\n\t}"
          : "=r"(done)
          : "r"(addr), "r"(parity)
          : "memory");
    else
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

// Asynchronous stores into the other block's shared memory (addr, mbar:
// cluster addresses), each adding its bytes to that block's mbarrier mbar.
__device__ __forceinline__ void st_async(unsigned addr, unsigned v,
                                         unsigned mbar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.u32 [%0], %1, "
      "[%2];" ::"r"(addr),
      "r"(v), "r"(mbar)
      : "memory");
}
__device__ __forceinline__ void st_async_rec(unsigned addr, float s,
                                             float tau, int p, int q,
                                             unsigned mbar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], "
      "{%1, %2, %3, %4}, [%5];" ::"r"(addr),
      "r"(__float_as_uint(s)), "r"(__float_as_uint(tau)), "r"(p), "r"(q),
      "r"(mbar)
      : "memory");
}
__device__ __forceinline__ void st_async_rec(unsigned addr, double s,
                                             double tau, int p, int q,
                                             unsigned mbar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f64 [%0], "
      "{%1, %2}, [%5];\n\t"
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.b32 "
      "[%0+16], {%3, %4}, [%5];" ::"r"(addr),
      "d"(s), "d"(tau), "r"(p), "r"(q), "r"(mbar)
      : "memory");
}

// The A block keeps A by slots, not by index: in round r the entry at the
// row of slot s and the column of slot t (slot s holding index
// slot_index(s, r, m)) sits in plane (side(s), side(t)) at (pair(s),
// pair(t)), where slot s < h is side 0 of pair s and slot m - 1 - a side 1
// of pair a (h = m / 2). A round's pairs are then fixed positions: pair a
// holds rows (a, 0) and (a, 1). Round 0 puts index i in slot i, so at the
// start of every sweep the slots are the indices.
__device__ __forceinline__ int wide_at(int a, int sa, int b, int sb, int h) {
  return ((2 * sa + sb) * h + a) * h + b;
}

// (pair, side) of slot s.
__device__ __forceinline__ int2 wide_slot_home(int s, int m) {
  const int h = m / 2;
  return s < h ? make_int2(s, 0) : make_int2(m - 1 - s, 1);
}

// Where index i's row and index c's column meet at the start of a sweep.
__device__ __forceinline__ int wide_home(int i, int c, int m) {
  const int2 hi = wide_slot_home(i, m), hc = wide_slot_home(c, m);
  return wide_at(hi.x, hi.y, hc.x, hc.y, m / 2);
}

// How far the rows of pair a's sides 0 and 1 move in a buffer of A by
// slots from one round to the next (h^2 a plane): slot a >= 2 to slot
// a - 1, slot 1 to slot m - 1 (side 1 of pair 0), slot m - 1 - a (a <= h
// - 2) to slot m - 2 - a, slot h to slot h - 1 (side 0 of pair h - 1).
__device__ __forceinline__ int2 wide_row_step(int a, int h) {
  const int h2 = h * h;
  return make_int2(a >= 2 ? -h : a == 1 ? 2 * h2 - h : 0,
                   a <= h - 2 ? h : h == 1 ? 0 : -2 * h2);
}

// The same for the columns of pair b's sides.
__device__ __forceinline__ int2 wide_col_step(int b, int h) {
  const int h2 = h * h;
  return make_int2(b >= 2 ? -1 : b == 1 ? h2 - 1 : 0,
                   b <= h - 2 ? 1 : h == 1 ? 0 : -h2);
}

// The (pair, side) of index x in round r.
__device__ __forceinline__ int2 wide_locate(int x, int r, int m) {
  if (x == 0) return make_int2(0, 0);
  int t = x - 1 - r;
  if (t < 0) t += m - 1;
  return wide_slot_home(t + 1, m);
}

// The sum of squares of A's entries (off: its off-diagonal entries) in the
// order stated in the header, the same on every thread: the three-pass
// K4w's thread t
// (t < wide_stop_stride(m), played by thread t mod the block) sums the
// columns t, t + stride, ... over the rows in index order, each of its
// warps adds its threads' sums by a butterfly, and the warps' sums are
// added in warp order.
template <typename T>
__device__ T wide_squares(const T* A, int m, bool off, T* red) {
  const int stride = wide_stop_stride(m), h = m / 2;
  for (int t0 = 0; t0 < stride; t0 += blockDim.x) {  // uniform
    const int t = t0 + threadIdx.x;
    T acc = T(0);
    if (t < stride)
      for (int c = t; c < m; c += stride) {
        // Column c's rows in index order: i < h at i h + c', the others at
        // 2 h^2 + (m - 1 - i) h + c' (c' column c's offset in its plane).
        // A skipped diagonal entry adds 0 * 0: acc is unchanged (never
        // -0), so the loops need no branch.
        const T* col = A + (c < h ? c : h * h + (m - 1 - c));
#pragma unroll 4
        for (int i = 0; i < h; ++i) {
          const T a = off && i == c ? T(0) : col[i * h];
          acc += a * a;
        }
#pragma unroll 4
        for (int i = h; i < m; ++i) {
          const T a = off && i == c ? T(0) : col[2 * h * h + (m - 1 - i) * h];
          acc += a * a;
        }
      }
    acc = warp_sum(acc);
    if ((threadIdx.x & 31) == 0 && t < stride) red[t >> 5] = acc;
  }
  __syncthreads();
  T total = red[0];
  for (int w = 1; w < stride / 32; ++w) total += red[w];
  __syncthreads();  // red is written again by the next sum
  return total;
}

// Named barrier `id` (1 to 15) of `count` threads.
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// slot_index(slot, r, m) without the division, for run-time m and r
// (slot < m, r < m - 1); the warp body's slot_index folds at compile time.
__device__ __forceinline__ int wide_slot(int slot, int r, int m) {
  if (slot == 0) return 0;
  const int x = slot - 1 + r;
  return (x < m - 1 ? x : x - (m - 1)) + 1;
}

// (p, q), p < q, of pair i in round r.
__device__ __forceinline__ int2 wide_pair(int i, int r, int m) {
  const int a = wide_slot(i, r, m), b = wide_slot(m - 1 - i, r, m);
  return make_int2(a < b ? a : b, a < b ? b : a);
}

// Pair j = (p, q)'s rotation from a_pp, a_qq and a_pq = A[p][q] as the
// last round left them, by the warp body's expressions, into buffer b of
// par by the pair's sides (s0p: side 0 holds p): (sigma s, sigma tau) of
// side 0 (sigma -1 at p, +1 at q; side 1's are their negatives), the new
// diagonal of sides 0 and 1, and act (a_pq != 0).
template <typename T>
__device__ __forceinline__ void wide_params(WideParams<T>& par, int b, int j,
                                            bool s0p, T app, T aqq, T apq) {
  T t = T(0), s = T(0), tau = T(0);
  if (apq != T(0)) {
    T d = aqq - app, a2 = apq + apq;
    t = a2 / (d + copysign(hypot(d, a2), d));
    T c = T(1) / hypot(t, T(1));
    s = t * c;
    tau = s / (T(1) + c);
  }
  const T dp = app - t * apq, dq = aqq + t * apq;
  using V2 = typename Vec2<T>::type;
  V2 st, dd;
  st.x = s0p ? -s : s;
  st.y = s0p ? -tau : tau;
  dd.x = s0p ? dp : dq;
  dd.y = s0p ? dq : dp;
  reinterpret_cast<V2*>(par.st(b))[j] = st;
  reinterpret_cast<V2*>(par.dd(b))[j] = dd;
  par.act(b)[j] = apq != T(0);
}

// The 2 x 2 block at the rows of pair a and the columns of pair b, by
// sides (x[2 sr + sc]): pair a's row rotation, then pair b's column
// rotation, each with side 0's (sigma s, sigma tau) (r0 = sa0, ta0) and
// side 1's their negatives, and skipped where s is 0: x + sigma s (y -
// sigma tau x) for each side x and its partner y, the three-pass K4w's
// row and column passes
// on the only entries they read, in their order and expressions.
template <typename T>
__device__ __forceinline__ void wide_rotate(T (&x)[4], T sa0, T ta0, T sb0,
                                            T tb0) {
  if (sa0 != T(0)) {
    const T sa1 = -sa0, ta1 = -ta0;
    const T n0 = x[0] + sa0 * (x[2] - ta0 * x[0]);
    const T n2 = x[2] + sa1 * (x[0] - ta1 * x[2]);
    const T n1 = x[1] + sa0 * (x[3] - ta0 * x[1]);
    const T n3 = x[3] + sa1 * (x[1] - ta1 * x[3]);
    x[0] = n0;
    x[1] = n1;
    x[2] = n2;
    x[3] = n3;
  }
  if (sb0 != T(0)) {
    const T sb1 = -sb0, tb1 = -tb0;
    const T n0 = x[0] + sb0 * (x[1] - tb0 * x[0]);
    const T n1 = x[1] + sb1 * (x[0] - tb1 * x[1]);
    const T n2 = x[2] + sb0 * (x[3] - tb0 * x[2]);
    const T n3 = x[3] + sb1 * (x[2] - tb1 * x[3]);
    x[0] = n0;
    x[1] = n1;
    x[2] = n2;
    x[3] = n3;
  }
}

// Block (a, b)'s four entries of a buffer of A by slots, by sides.
template <typename T>
__device__ __forceinline__ void wide_load4(const T* A, int a, int b, int h,
                                           T (&x)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) x[e] = A[wide_at(a, e >> 1, b, e & 1, h)];
}

// Block (a, b)'s four entries (by sides) into the next round's slots of
// the other buffer: e = a h + b, ra = rows(a), cb = cols(b).
template <typename T>
__device__ __forceinline__ void wide_store4(T* A, int e, int2 ra, int2 cb,
                                            const T (&x)[4]) {
  A[e + ra.x + cb.x] = x[0];
  A[e + ra.x + cb.y] = x[1];
  A[e + ra.y + cb.x] = x[2];
  A[e + ra.y + cb.y] = x[3];
}

// Phase stamps of one launch (the *_phases entry points, kClock), clock64()
// cycles of the first cluster into clk (16 long long): clk[0] the number
// of phases; the first pusher thread's [1] reads and rotations (what the
// next round's parameters wait for), [2] the next round's parameters, [3]
// its wait at the round's barrier; the last thread that moves a diagonal
// block's [4] waits for a free slot; thread 0's [5] blocks, [6] its wait at
// the barrier; [7] the stop test; the V block's thread 0's [8] waits for a
// round, [9] rotations; [10] nanoseconds from the A block's end mark to
// the V block's end (%globaltimer); [11] sweeps, [12] rounds, [13] the
// body (2), [14] the A block's cycles from its start to its end mark, [15]
// the same span in nanoseconds.
constexpr int kWideBody = 2;

template <typename T, bool kShared, bool kClock>
__device__ __forceinline__ void wide_body(const T* __restrict__ H,
                                          T* __restrict__ evals,
                                          T* __restrict__ Vout,
                                          unsigned char* work, int k, int m,
                                          int slots, long long* clk) {
  extern __shared__ __align__(16) unsigned char wide_smem[];
  using V2 = typename Vec2<T>::type;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int mat = blockIdx.x >> 1;
  const bool is_a = cluster_rank() == 0;
  const int h = m / 2, ld = wide_ld(m);
  const int vw = wide_v_warps(m, nt);
  unsigned char* const region =
      kShared ? wide_smem + wide_ring_bytes<T>(m, slots)
              : work + (size_t)mat * wide_scratch_bytes<T>(m);
  // The block's matrices: A twice, by slots (the A block); V^T (the V
  // block, after the A block's region on the workspace form).
  T* const X = reinterpret_cast<T*>(
      region + (kShared || is_a ? 0 : wide_region_bytes<T>(m)));
  WideParams<T> par(region + 2 * (size_t)m * m * sizeof(T), m);
  WideRing<T> ring(wide_smem);
  const unsigned tx = wide_slot_tx<T>(m);
  const bool stamp = kClock && mat == 0;
  const long long t_start = kClock ? clock64() : 0;
  const long long g_start = kClock ? gtimer() : 0;

  if (tid == 0) {
    for (int b = 0; b < slots; ++b) {
      mbar_init(&ring.full[b], 1);   // the V block's arrival, the A block's
      mbar_init(&ring.empty[b], 1);  // bytes; the A block's, the V block's
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cluster_sync();

  if (is_a) {
    // A = H with a zero row and column padding an odd k, by slots (round
    // 0: slot i holds index i).
    const T* Hb = H + (size_t)mat * k * k;
    for (size_t e = tid; e < (size_t)m * m; e += nt) {
      const int i = (int)(e / m), j = (int)(e - (size_t)i * m);
      X[wide_home(i, j, m)] = (i < k && j < k) ? Hb[(size_t)i * k + j]
                                               : T(0);
    }
    // The pushers are the last warps (np pairs a pass); the other threads
    // take the blocks of pairs (a, b), a != b, in turn.
    const int np = wide_pushers(m, nt), npw = (np + 31) / 32 * 32;
    const int pt = tid - (nt - npw), ng = nt - npw;
    const bool pusher = pt >= 0 && pt < np;
    const bool st0 = stamp && pt == 0, g0 = stamp && tid == 0;
    const bool gw0 = stamp && tid == ng - 1;
    // This thread's first block (a0, b0) and the step to its next.
    const int a0 = tid / h, b0 = tid - a0 * h, da = ng / h, db = ng - da * h;
    long long ck[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    // Round 0's parameters come from a round before it that rotates
    // nothing and moves nothing (buffer 1: s = 0, act = 0); the pairs'
    // moves, the same every round.
    if (pusher)
      for (int j = pt; j < h; j += np) {
        reinterpret_cast<V2*>(par.st(1))[j] = V2{T(0), T(0)};
        par.act(1)[j] = 0;
        const int2 dr = wide_row_step(j, h), dc = wide_col_step(j, h);
        par.rows()[j] = make_int2(dr.x, 2 * h * h + dr.y);
        par.cols()[j] = make_int2(dc.x, h * h + dc.y);
      }
    __syncthreads();
    const int2* const rows = par.rows();
    const int2* const cols = par.cols();
    const T tol = Eps<T>::value() * sqrt(wide_squares(X, m, false, par.red));
    int slot = 0, rounds = -1, sweep = 0, r = m - 2, ab = 0;
    unsigned lap = 0;  // parity of the slot's current use
    for (;;) {
      const bool real = rounds >= 0;
      const int cur = rounds & 1, nxt = cur ^ 1;
      const int rn = r + 1 < m - 1 ? r + 1 : 0;  // the next round
      const int rl = real ? r : 0;  // the round whose slots X holds
      const T* const A0 = X + (size_t)ab * m * m;  // this round's slots
      T* const A1 = X + (size_t)(ab ^ 1) * m * m;  // the next round's
      const V2* const st = reinterpret_cast<const V2*>(par.st(cur));
      const V2* const dd = reinterpret_cast<const V2*>(par.dd(cur));
      const int* const act = par.act(cur);
      const long long c1 = kClock ? clock64() : 0;
      long long c2 = c1, c3 = c1;
      if (pusher) {
        for (int j = pt; j < h; j += np) {
          // The next round's pair j = (p, q): p at (u, su), q at (v, sv)
          // of this round's slots. Its a_pq is block (u, v)'s entry (su,
          // sv) after this round's rotations; its a_pp and a_qq this
          // round's new diagonal where their pair acts, else as they were.
          const int2 pn = wide_pair(j, rn, m);
          const int2 lu = wide_locate(pn.x, rl, m),
                     lv = wide_locate(pn.y, rl, m);
          const int u = lu.x, v = lv.x, su = lu.y, sv = lv.y;
          const V2 stu = st[u], stv = st[v], ddu = dd[u], ddv = dd[v];
          const int au = act[u], av = act[v];
          const T rpp = A0[wide_at(u, su, u, su, h)];
          const T rqq = A0[wide_at(v, sv, v, sv, h)];
          T apq;
          if (u != v) {
            T x[4];
            wide_load4(A0, u, v, h, x);
            wide_rotate(x, stu.x, stu.y, stv.x, stv.y);
            const T x0 = su ? x[2] : x[0], x1 = su ? x[3] : x[1];
            apq = sv ? x1 : x0;
          } else {  // order 2: the pair itself, zeroed where it acts
            apq = au ? T(0) : A0[wide_at(u, su, u, sv, h)];
          }
          const T app = au ? (su ? ddu.y : ddu.x) : rpp;
          const T aqq = av ? (sv ? ddv.y : ddv.x) : rqq;
          if (st0) c2 = clock64();
          wide_params(par, nxt, j, wide_slot(j, rn, m) == pn.x, app, aqq, apq);
        }
        if (st0) c3 = clock64();
      }
      const long long c4 = kClock ? clock64() : 0;
      // The other threads: every block (a, b), a != b, of this round into
      // the next round's slots of the other buffer, rotated; block (a, b)'s
      // entry of sides (sa, sb) sits at e + (2 sa + sb) h^2, e = a h + b.
      // Then each diagonal block, its new diagonal and zeros where its
      // pair acts, and its pair's rotation to the V block, by the threads
      // with the fewest blocks (the last: pair j on thread ng - 1 - j),
      // out of the loop above (their waits and stores to the other block
      // would keep the compiler from overlapping its iterations).
      if (pt < 0 && real) {
        const int h2 = h * h;
        int a = a0, b = b0;
        for (int e = tid; e < h2; e += ng) {
          if (a != b) {
            const V2 sa = st[a], sb = st[b];
            const int2 ra = rows[a], cb = cols[b];
            T x[4] = {A0[e], A0[e + h2], A0[e + 2 * h2], A0[e + 3 * h2]};
            wide_rotate(x, sa.x, sa.y, sb.x, sb.y);
            wide_store4(A1, e, ra, cb, x);
          }
          a += da;
          b += db;
          if (b >= h) {
            b -= h;
            ++a;
          }
        }
        const int j0 = ng - 1 - tid;
        if (j0 < h) {
          const unsigned full = peer(&ring.full[slot], 1);
          WideRec<T>* const dst = ring.rec + slot * h;
          const long long w0 = gw0 ? clock64() : 0;
          mbar_wait<false>(&ring.empty[slot], lap ^ 1u);  // the V block is
          if (gw0) ck[4] += clock64() - w0;              // done with it
          for (int j = j0; j < h; j += ng) {
            const V2 sj = st[j];
            T x[4];
            if (act[j]) {
              const V2 dj = dd[j];
              x[0] = dj.x;
              x[1] = T(0);
              x[2] = T(0);
              x[3] = dj.y;
            } else {
              wide_load4(A0, j, j, h, x);
            }
            wide_store4(A1, j * h + j, rows[j], cols[j], x);
            const int2 pj = wide_pair(j, r, m);
            const bool s0p = wide_slot(j, r, m) == pj.x;
            st_async_rec(peer(dst + j, 1), s0p ? -sj.x : sj.x,
                         s0p ? -sj.y : sj.y, pj.x, pj.y, full);
          }
          // The slot's next "empty" phase, armed by a thread that has seen
          // this one complete: the V block's warps free it after this use.
          if (j0 == 0) mbar_expect(&ring.empty[slot], 4u * vw);
        }
      }
      const long long c5 = kClock ? clock64() : 0;
      __syncthreads();
      if (real) {
        if (st0) {
          ck[1] += c2 - c1;
          ck[2] += c3 - c2;
          ck[3] += clock64() - c5;
        }
        if (g0) {
          ck[5] += c5 - c4;
          ck[6] += clock64() - c5;
        }
        ab ^= 1;
        if (++slot == slots) {
          slot = 0;
          lap ^= 1u;
        }
      }
      ++rounds;
      r = rn;
      if (r == 0) {  // a sweep starts (the slots are the indices again)
        if (sweep == kMaxSweeps) break;
        const long long c0 = st0 ? clock64() : 0;
        const T off = sqrt(wide_squares(X + (size_t)ab * m * m, m, true,
                                        par.red));
        if (st0) ck[7] += clock64() - c0;
        if (off <= tol) break;
        ++sweep;
      }
    }
    // The end mark: the diagonal (the eigenvalues) to the V block's next
    // slot; then the V block's last frees of the slots before it.
    if (pusher) {
      mbar_wait<false>(&ring.empty[slot], lap ^ 1u);
      const unsigned full = peer(&ring.full[slot], 1);
      WideRec<T>* const dst = ring.rec + slot * h;
      const T* const Af = X + (size_t)ab * m * m;
      for (int j = pt; j < h; j += np)
        st_async_rec(peer(dst + j, 1), Af[wide_home(2 * j, 2 * j, m)],
                     Af[wide_home(2 * j + 1, 2 * j + 1, m)], -1, -1, full);
    }
    if (pt == 0) {
      const int back = rounds < slots - 1 ? rounds : slots - 1;
      for (int b = 1; b <= back; ++b) {
        const int s = slot - b < 0 ? slot - b + slots : slot - b;
        mbar_wait<false>(&ring.empty[s], s < slot ? lap : lap ^ 1u);
      }
    }
    if (st0) {
      clk[0] = 10;
      clk[1] = ck[1];
      clk[2] = ck[2];
      clk[3] = ck[3];
      clk[7] = ck[7];
      clk[11] = sweep;
      clk[12] = rounds;
      clk[13] = kWideBody;
      clk[14] = clock64() - t_start;
      clk[15] = gtimer() - g_start;
      clk[10] = gtimer();  // the V block subtracts it from its end
    }
    if (g0) {
      clk[5] = ck[5];
      clk[6] = ck[6];
    }
    if (gw0) clk[4] = ck[4];
  } else {
    // V^T = I; then each round's rotations of V's columns p, q (rows p, q
    // of V^T) as the ring brings them: a slab of 32 columns of V^T to
    // wide_slab_warps warps, a lane a column, each warp taking every g-th
    // pair of the round; a slab's warps meet at a named barrier a round.
    for (size_t e = tid; e < (size_t)m * m; e += nt) {
      const int i = (int)(e / m), j = (int)(e - (size_t)i * m);
      X[i * ld + j] = i == j ? T(1) : T(0);
    }
    if (tid == 0)
      for (int b = 0; b < slots; ++b) mbar_expect(&ring.full[b], tx);
    __syncthreads();
    long long waits = 0, work_cycles = 0;
    int end_slot = 0;  // where the end mark came: every thread j < k has it
    const int warp = tid >> 5, gw = wide_slab_warps(m, nt);
    if (warp < vw) {
      // This warp's slabs (one where gw > 1) and its share of the pairs.
      const int slab0 = warp / gw, g = warp - slab0 * gw;
      const int slabs = (m + 31) / 32, step = nt / 32 / gw;
      int slot = 0;
      unsigned lap = 0;
      for (;;) {
        const long long c0 = stamp && tid == 0 ? clock64() : 0;
        mbar_wait<true>(&ring.full[slot], lap);
        const long long c1 = stamp && tid == 0 ? clock64() : 0;
        if (stamp && tid == 0) waits += c1 - c0;
        const WideRec<T>* const src = ring.rec + slot * h;
        if (src[0].p < 0) {
          end_slot = slot;
          break;
        }
        if (tid == 0) mbar_expect(&ring.full[slot], tx);  // its next use
        for (int sb = slab0; sb < slabs; sb += step) {
          const int c = sb * 32 + (tid & 31);  // this lane's column
          if (c < m)
            for (int i = g; i < h; i += gw) {
              const WideRec<T> rc = src[i];
              if (rc.s != T(0)) {
                const T s = rc.s, tau = rc.tau, ss = -s, tt = -tau;
                T* const vp = X + rc.p * ld + c;
                T* const vq = X + rc.q * ld + c;
                const T xv = *vp, yv = *vq;
                *vp = xv + ss * (yv - tt * xv);
                *vq = yv + s * (xv - tau * yv);
              }
            }
        }
        __syncwarp();
        if ((tid & 31) == 0)  // this warp is done with the slot
          st_async(peer(ring.sink, 0), 0u, peer(&ring.empty[slot], 0));
        // The slab's rows are whole before its next round.
        if (gw > 1) bar_sync(1 + slab0, 32 * gw);
        if (stamp && tid == 0) work_cycles += clock64() - c1;
        if (++slot == slots) {
          slot = 0;
          lap ^= 1u;
        }
      }
    }
    __syncthreads();
    // Thread j owns eigenpair j (column j of V, row j of V^T): the sign
    // convention, the rank among the diagonal the end mark brought, the
    // output.
    const WideRec<T>* const dg = ring.rec + end_slot * h;
    auto diag = [dg](int i) { return i & 1 ? dg[i >> 1].tau : dg[i >> 1].s; };
    for (int j = tid; j < k; j += nt) {
      const T* vj = X + j * ld;
      int imax = 0;
      T vmax = fabs(vj[0]);
      for (int i = 1; i < k; ++i) {
        const T x = fabs(vj[i]);
        if (x > vmax) {
          vmax = x;
          imax = i;
        }
      }
      const bool neg = vj[imax] < T(0);
      const T d = diag(j);
      int rank = 0;
      for (int i = 0; i < k; ++i)
        if (i != j && before(diag(i), i, d, j)) ++rank;
      evals[(size_t)mat * k + rank] = d;
      T* vb = Vout + (size_t)mat * k * k;
      for (int i = 0; i < k; ++i) vb[(size_t)i * k + rank] = neg ? -vj[i]
                                                                  : vj[i];
    }
    if (stamp && tid == 0) {
      clk[8] = waits;
      clk[9] = work_cycles;
    }
  }
  cluster_sync();
  if (kClock && !is_a && mat == 0 && tid == 0) clk[10] = gtimer() - clk[10];
}

template <typename T, bool kShared>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(kWideMaxThreads, 1)
    sym_eig_wide_kernel(const T* __restrict__ H, T* __restrict__ evals,
                        T* __restrict__ Vout, unsigned char* work, int k,
                        int m, int slots) {
  wide_body<T, kShared, false>(H, evals, Vout, work, k, m, slots, nullptr);
}

template <typename T, bool kShared>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(kWideMaxThreads, 1)
    sym_eig_wide_phases_kernel(const T* __restrict__ H,
                               T* __restrict__ evals, T* __restrict__ Vout,
                               unsigned char* work, int k, int m, int slots,
                               long long* clk) {
  wide_body<T, kShared, true>(H, evals, Vout, work, k, m, slots, clk);
}

// Opt a K4w kernel into kSmemLimit bytes of dynamic shared memory, once
// per instantiation at its first launch (a captured solve runs one step
// eagerly before it captures).
template <typename T, bool kShared, bool kClock>
cudaError_t wide_opt_in() {
  static const cudaError_t attr =
      kClock ? cudaFuncSetAttribute(
                   sym_eig_wide_phases_kernel<T, kShared>,
                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                   (int)kSmemLimit)
             : cudaFuncSetAttribute(
                   sym_eig_wide_kernel<T, kShared>,
                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                   (int)kSmemLimit);
  return attr;
}

template <typename T, bool kShared, bool kClock>
int launch_wide_form(const void* H, void* evals, void* V, void* work, int k,
                     int batch, int m, int slots, long long bytes,
                     cudaStream_t st, long long* clk) {
  const cudaError_t attr = wide_opt_in<T, kShared, kClock>();
  if (attr != cudaSuccess) return (int)attr;
  const int threads = wide_threads(m);
  if constexpr (kClock)
    sym_eig_wide_phases_kernel<T, kShared>
        <<<2 * batch, threads, (size_t)bytes, st>>>(
            (const T*)H, (T*)evals, (T*)V, (unsigned char*)work, k, m, slots,
            clk);
  else
    sym_eig_wide_kernel<T, kShared><<<2 * batch, threads, (size_t)bytes, st>>>(
        (const T*)H, (T*)evals, (T*)V, (unsigned char*)work, k, m, slots);
  return (int)cudaGetLastError();
}

template <typename T, bool kClock = false>
int launch_wide(const void* H, void* evals, void* V, void* work, int k,
                int batch, void* stream, long long* clk = nullptr) {
  if (k < 1 || batch < 0 || batch > 0x3fffffff)
    return (int)cudaErrorInvalidValue;
  if (batch == 0) return 0;
  const int m = k + (k & 1);
  cudaStream_t st = (cudaStream_t)stream;
  if (work == nullptr) {
    const int slots = wide_ring_slots<T>(m, true);
    if (slots < 1) return (int)cudaErrorInvalidValue;
    return launch_wide_form<T, true, kClock>(H, evals, V, nullptr, k, batch,
                                             m, slots, wide_smem_bytes<T>(m),
                                             st, clk);
  }
  if (reinterpret_cast<uintptr_t>(work) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  const int slots = wide_ring_slots<T>(m, false);
  if (slots < 1) return (int)cudaErrorInvalidValue;
  return launch_wide_form<T, false, kClock>(H, evals, V, work, k, batch, m,
                                            slots,
                                            wide_ring_bytes<T>(m, slots), st,
                                            clk);
}

// K4w's round alone: one block of `threads` threads; each round the
// parameter arithmetic of wide_round on every thread, its tau through
// shared memory to the partner thread, and the round's two block
// barriers.
template <typename T>
__global__ void __launch_bounds__(1024)
wide_round_probe_kernel(T* out, int rounds) {
  __shared__ T ex[1024];
  const int tid = threadIdx.x;
  const T app = T(1) + T(0.25) * (tid & 7), aqq = T(2) - T(0.125) * (tid & 3);
  T apq = T(0.5);
  for (int r = 0; r < rounds; ++r) {
    T d = aqq - app, a2 = apq + apq;
    T t = a2 / (d + copysign(hypot(d, a2), d));
    T c = T(1) / hypot(t, T(1));
    T s = t * c;
    T tau = s / (T(1) + c);
    ex[tid] = tau;
    __syncthreads();
    const T y = ex[tid ^ 1];
    __syncthreads();
    apq = y + T(0.5);
  }
  if (tid < 32) out[tid] = apq;
}

template <typename T>
int wide_probe(void* out, int rounds, int threads, void* stream) {
  if (rounds < 0 || threads < 32 || threads > 1024 || threads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  wide_round_probe_kernel<T><<<1, threads, 0, (cudaStream_t)stream>>>(
      (T*)out, rounds);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int sym_eig_f32(const void* H, void* evals, void* V, int k, int batch,
                void* stream) {
  return launch<float>(H, evals, V, k, batch, stream);
}

int sym_eig_f64(const void* H, void* evals, void* V, int k, int batch,
                void* stream) {
  return launch<double>(H, evals, V, k, batch, stream);
}

// K4w: H, evals, V as sym_eig_*; work NULL (A and V in shared memory,
// refused where sym_eig_wide_scratch_bytes_* passes 232,448) or a
// workspace of batch x sym_eig_wide_scratch_bytes_*(k) bytes.
int sym_eig_wide_f32(const void* H, void* evals, void* V, void* work, int k,
                     int batch, void* stream) {
  return launch_wide<float>(H, evals, V, work, k, batch, stream);
}

int sym_eig_wide_f64(const void* H, void* evals, void* V, void* work, int k,
                     int batch, void* stream) {
  return launch_wide<double>(H, evals, V, work, k, batch, stream);
}

// K4w with its phase stamps (see wide_body): arguments as sym_eig_wide_*,
// then clk, 16 long long on the card.
int sym_eig_wide_phases_f32(const void* H, void* evals, void* V, void* work,
                            int k, int batch, void* clk, void* stream) {
  return launch_wide<float, true>(H, evals, V, work, k, batch, stream,
                                  (long long*)clk);
}

int sym_eig_wide_phases_f64(const void* H, void* evals, void* V, void* work,
                            int k, int batch, void* clk, void* stream) {
  return launch_wide<double, true>(H, evals, V, work, k, batch, stream,
                                   (long long*)clk);
}

// The bytes of K4w's workspace for one matrix of order k, of dynamic shared
// memory a block of its shared-memory form takes, and its blocks' threads.
long long sym_eig_wide_scratch_bytes_f32(int k) {
  return wide_scratch_bytes<float>(k + (k & 1));
}

long long sym_eig_wide_scratch_bytes_f64(int k) {
  return wide_scratch_bytes<double>(k + (k & 1));
}

long long sym_eig_wide_smem_bytes_f32(int k) {
  return wide_smem_bytes<float>(k + (k & 1));
}

long long sym_eig_wide_smem_bytes_f64(int k) {
  return wide_smem_bytes<double>(k + (k & 1));
}

int sym_eig_wide_threads(int k) { return wide_threads(k + (k & 1)); }

// out: 32 values of the type; rounds: the chain's length.
int sym_eig_round_probe_f32(void* out, int rounds, void* stream) {
  return probe<float>(out, rounds, stream);
}

int sym_eig_round_probe_f64(void* out, int rounds, void* stream) {
  return probe<double>(out, rounds, stream);
}

// K4w's round at a block of `threads` threads (a multiple of 32, at most
// 1024); out: 32 values of the type.
int sym_eig_wide_round_probe_f32(void* out, int rounds, int threads,
                                 void* stream) {
  return wide_probe<float>(out, rounds, threads, stream);
}

int sym_eig_wide_round_probe_f64(void* out, int rounds, int threads,
                                 void* stream) {
  return wide_probe<double>(out, rounds, threads, stream);
}

}  // extern "C"
