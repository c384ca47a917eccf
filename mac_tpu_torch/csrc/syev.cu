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
// warp's registers. One thread block takes one matrix, with A and V^T
// row-major (leading dimension m + 1) in a scratch area: dynamic shared
// memory while the scratch (wide_scratch_bytes: A, V^T, the round's
// parameters, the reduction's partial sums) fits the 232,448 bytes a
// block may opt into (m up to 168 in float32, 118 in float64), else the
// caller's global workspace. The two storage forms run one body over one
// layout, so their outputs are bitwise equal. The same rounds in the same
// order as the warp body; each pair of a round has wide_lanes(m) threads
// of one warp (16 up to m = 128, fewer past it, so that the block stays
// within 1024 threads), and a round is
//   1. every thread of a pair computes (p, q) from slot_index at run time,
//      reads a_pp, a_qq and a_pq = A[p][q] (row p, column q, the operand
//      the warp body takes) and, where a_pq != 0, (t, c, s, tau) by the
//      expressions above as the warp body writes them: the same operands
//      in the same order on each, as the warp body's lanes p and q; its
//      first thread keeps them for phase 2; a warp barrier (the pair's
//      threads have read before any of them writes rows p and q);
//   2. the pair's threads update rows p, q of A and of V^T (V's columns
//      p, q), a stride of columns each, x + sigma s (y - sigma tau x) with
//      sigma -1 at p and +1 at q, skipped where s = 0; block barrier;
//   3. columns p, q of A the same way, a stride of rows each, then, where
//      the pair acts, the threads of rows p and q write the new diagonal
//      (a_pp - t a_pq, a_qq + t a_pq) and a_pq = a_qp = 0 after their own
//      column update; block barrier.
// Its stop test sums in this order: thread c sums column c's squares over
// the rows in index order (columns c, c + blockDim, ... one after the
// other), each warp adds its threads' sums by a butterfly, and every
// thread adds the warps' sums in warp order. For m <= 32 that is the warp
// body's order, so K4w forced onto a small matrix gives the warp body's
// outputs bit for bit. The ranking and the sign convention are the warp
// body's, a thread an eigenpair (a row of V^T). What bounds it is the
// warp body's chain plus the two block barriers a round;
// sym_eig_wide_round_probe_{f32,f64} times that round alone (the
// parameter arithmetic, an exchange through shared memory and the two
// barriers, at a given block size).

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

// ---- K4w: one thread block a matrix, any order ----

// Bytes of dynamic shared memory a block may opt into (H100, H200).
constexpr long long kSmemLimit = 232448;

// K4w's leading dimension of A and V^T at even order m: odd, so that a
// warp reading down a column of float32 entries meets no bank twice.
__host__ __device__ constexpr int wide_ld(int m) { return m + 1; }

// Bytes of K4w's per-matrix scratch at even order m, rounded up to 16: in
// elements of T, A and V^T (m x wide_ld(m) each, row-major), per pair s,
// tau and the new a_pp and a_qq (4 x m / 2), the reduction's per-warp sums
// (32); then per pair p, q and act (3 x m / 2 ints).
template <typename T>
__host__ __device__ constexpr long long wide_scratch_bytes(int m) {
  return ((2LL * m * wide_ld(m) + 2LL * m + 32) * (long long)sizeof(T)
          + 3LL * (m / 2) * (long long)sizeof(int) + 15) / 16 * 16;
}

// Threads a pair at even order m: the largest power of two up to 16 that
// keeps m / 2 pairs within 1024 threads (1 past m = 2048, where a thread
// takes several pairs in turn). Every setting gives the same bits; of 1
// to 32, 16 ran fastest on the H100 from m = 34 to 96.
__host__ __device__ constexpr int wide_lanes(int m) {
  int lanes = 16;
  while (lanes > 1 && (long long)(m / 2) * lanes > 1024) lanes >>= 1;
  return lanes;
}

// Threads of K4w's block at even order m: m / 2 pairs of wide_lanes(m)
// threads, a multiple of 32, at most 1024.
__host__ __device__ constexpr int wide_threads(int m) {
  const long long t = (long long)(m / 2) * wide_lanes(m);
  return t >= 1024 ? 1024 : (int)((t + 31) / 32 * 32);
}

template <typename T>
struct WideScratch {
  T *A, *VT, *s, *tau, *dp, *dq, *red;
  int *p, *q, *act;
  __device__ WideScratch(unsigned char* base, int m) {
    const int h = m / 2;
    const size_t mm = (size_t)m * wide_ld(m);
    A = reinterpret_cast<T*>(base);
    VT = A + mm;
    s = VT + mm;
    tau = s + h;
    dp = tau + h;
    dq = dp + h;
    red = dq + h;
    p = reinterpret_cast<int*>(red + 32);
    q = p + h;
    act = q + h;
  }
};

// The sum of every thread's v over the block, the same on every thread:
// each warp's by warp_sum, then the warps' sums in warp order.
template <typename T>
__device__ T block_sum(T v, T* red) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  T total = red[0];
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w) total += red[w];
  __syncthreads();  // red is written again by the next sum
  return total;
}

// The sum of squares of A's entries (off: its off-diagonal entries) in the
// order stated in the header.
template <typename T>
__device__ T wide_squares(const T* A, int m, bool off, T* red) {
  const int ld = wide_ld(m);
  T acc = T(0);
  for (int c = threadIdx.x; c < m; c += blockDim.x)
    for (int i = 0; i < m; ++i)
      if (!off || i != c) {
        const T a = A[(size_t)i * ld + c];
        acc += a * a;
      }
  return block_sum(acc, red);
}

// slot_index(slot, r, m) without the division, for run-time m and r
// (slot < m, r < m - 1); the warp body's slot_index folds at compile time.
__device__ __forceinline__ int wide_slot(int slot, int r, int m) {
  if (slot == 0) return 0;
  const int x = slot - 1 + r;
  return (x < m - 1 ? x : x - (m - 1)) + 1;
}

// Round r of a sweep over m (even) indices; see the header. Thread tid
// serves pair tid / lanes + k * (blockDim / lanes) (one pair when lanes >
// 1) as the lane tid % lanes of its `lanes` threads (a power of two up to
// 32).
template <typename T>
__device__ void wide_round(WideScratch<T>& w, int m, int lanes, int r) {
  const int h = m / 2, ld = wide_ld(m);
  const int per_pass = blockDim.x / lanes, lane = threadIdx.x & (lanes - 1);
  T* const A = w.A;
  T* const VT = w.VT;
  for (int base = 0; base < h; base += per_pass) {  // uniform trip count
    const int i = base + threadIdx.x / lanes;
    const bool mine = i < h;
    int p = 0, q = 0;
    T t = T(0), s = T(0), tau = T(0), app = T(0), aqq = T(0), apq = T(0);
    if (mine) {
      const int sa = wide_slot(i, r, m), sb = wide_slot(m - 1 - i, r, m);
      p = sa < sb ? sa : sb;
      q = sa < sb ? sb : sa;
      app = A[(size_t)p * ld + p];
      aqq = A[(size_t)q * ld + q];
      apq = A[(size_t)p * ld + q];
      if (apq != T(0)) {
        T d = aqq - app, a2 = apq + apq;
        t = a2 / (d + copysign(hypot(d, a2), d));
        T c = T(1) / hypot(t, T(1));
        s = t * c;
        tau = s / (T(1) + c);
      }
    }
    // The pair's lanes have read a_pp, a_qq and a_pq before any of them
    // updates rows p and q (one warp holds them; no other pair reads
    // those rows).
    if (lanes > 1) __syncwarp();
    if (mine) {
      if (lane == 0) {
        w.p[i] = p;
        w.q[i] = q;
        w.act[i] = apq != T(0);
        w.s[i] = s;
        w.tau[i] = tau;
        w.dp[i] = app - t * apq;
        w.dq[i] = aqq + t * apq;
      }
      if (s != T(0)) {
        const T ss = -s, tt = -tau;  // sigma = -1 at p
        T *ap = A + (size_t)p * ld, *aq = A + (size_t)q * ld;
        T *vp = VT + (size_t)p * ld, *vq = VT + (size_t)q * ld;
        for (int c = lane; c < m; c += lanes) {
          const T xa = ap[c], ya = aq[c], xv = vp[c], yv = vq[c];
          ap[c] = xa + ss * (ya - tt * xa);
          aq[c] = ya + s * (xa - tau * ya);
          vp[c] = xv + ss * (yv - tt * xv);
          vq[c] = yv + s * (xv - tau * yv);
        }
      }
    }
  }
  __syncthreads();
  for (int base = 0; base < h; base += per_pass) {
    const int i = base + threadIdx.x / lanes;
    if (i >= h) continue;
    const int p = w.p[i], q = w.q[i];
    const T s = w.s[i], tau = w.tau[i];
    if (s != T(0)) {
      const T ss = -s, tt = -tau;
      for (int row = lane; row < m; row += lanes) {
        T* const ar = A + (size_t)row * ld;
        const T x = ar[p], y = ar[q];
        ar[p] = x + ss * (y - tt * x);
        ar[q] = y + s * (x - tau * y);
      }
    }
    // The thread of row p and of row q: the new diagonal, a_pq = a_qp = 0,
    // after its own column update.
    if (w.act[i]) {
      if ((p & (lanes - 1)) == lane) {
        A[(size_t)p * ld + p] = w.dp[i];
        A[(size_t)p * ld + q] = T(0);
      }
      if ((q & (lanes - 1)) == lane) {
        A[(size_t)q * ld + p] = T(0);
        A[(size_t)q * ld + q] = w.dq[i];
      }
    }
  }
  __syncthreads();
}

template <typename T, bool kShared>
__global__ void __launch_bounds__(1024)
sym_eig_wide_kernel(const T* __restrict__ H, T* __restrict__ evals,
                    T* __restrict__ Vout, unsigned char* work, int k,
                    int m, int lanes) {
  extern __shared__ __align__(16) unsigned char wide_smem[];
  const int mat = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int ld = wide_ld(m);
  WideScratch<T> w(kShared ? wide_smem
                           : work + (size_t)mat * wide_scratch_bytes<T>(m),
                   m);
  const T* Hb = H + (size_t)mat * k * k;

  // A = H with a zero row and column padding an odd k; V^T = I.
  for (size_t e = tid; e < (size_t)m * m; e += nt) {
    const int i = (int)(e / m), j = (int)(e - (size_t)i * m);
    w.A[(size_t)i * ld + j] = (i < k && j < k) ? Hb[(size_t)i * k + j]
                                               : T(0);
    w.VT[(size_t)i * ld + j] = i == j ? T(1) : T(0);
  }
  __syncthreads();
  const T tol = Eps<T>::value() * sqrt(wide_squares(w.A, m, false, w.red));
  for (int sweep = 0; sweep < kMaxSweeps; ++sweep) {
    if (sqrt(wide_squares(w.A, m, true, w.red)) <= tol) break;  // uniform
    for (int r = 0; r < m - 1; ++r) wide_round(w, m, lanes, r);
  }

  // Thread j owns eigenpair j (column j of V, row j of V^T): the sign
  // convention, the rank, the output.
  for (int j = tid; j < k; j += nt) {
    const T* vj = w.VT + (size_t)j * ld;
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
    const T d = w.A[(size_t)j * ld + j];
    int rank = 0;
    for (int i = 0; i < k; ++i)
      if (i != j && before(w.A[(size_t)i * ld + i], i, d, j)) ++rank;
    evals[(size_t)mat * k + rank] = d;
    T* vb = Vout + (size_t)mat * k * k;
    for (int i = 0; i < k; ++i) vb[(size_t)i * k + rank] = neg ? -vj[i]
                                                                : vj[i];
  }
}

template <typename T>
int launch_wide(const void* H, void* evals, void* V, void* work, int k,
                int batch, void* stream) {
  if (k < 1 || batch < 0) return (int)cudaErrorInvalidValue;
  if (batch == 0) return 0;
  const int m = k + (k & 1);
  const long long bytes = wide_scratch_bytes<T>(m);
  const int lanes = wide_lanes(m), threads = wide_threads(m);
  cudaStream_t st = (cudaStream_t)stream;
  if (work == nullptr) {
    if (bytes > kSmemLimit) return (int)cudaErrorInvalidValue;
    // Once per instantiation, at its first launch (a captured solve runs
    // one step eagerly before it captures).
    static const cudaError_t attr = cudaFuncSetAttribute(
        sym_eig_wide_kernel<T, true>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemLimit);
    if (attr != cudaSuccess) return (int)attr;
    sym_eig_wide_kernel<T, true><<<batch, threads, (size_t)bytes, st>>>(
        (const T*)H, (T*)evals, (T*)V, nullptr, k, m, lanes);
  } else {
    if (reinterpret_cast<uintptr_t>(work) % 16 != 0)
      return (int)cudaErrorMisalignedAddress;
    sym_eig_wide_kernel<T, false><<<batch, threads, 0, st>>>(
        (const T*)H, (T*)evals, (T*)V, (unsigned char*)work, k, m, lanes);
  }
  return (int)cudaGetLastError();
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

// The bytes of K4w's scratch for one matrix of order k, and its block's
// threads.
long long sym_eig_wide_scratch_bytes_f32(int k) {
  return wide_scratch_bytes<float>(k + (k & 1));
}

long long sym_eig_wide_scratch_bytes_f64(int k) {
  return wide_scratch_bytes<double>(k + (k & 1));
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
