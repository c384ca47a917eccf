// K4: the eigenpairs of a batch of small symmetric matrices, by cyclic
// Jacobi rotations. sym_eig_{f32,f64}(H, evals, V, k, batch, stream):
// H (batch, k, k) contiguous, k <= 32; evals (batch, k) ascending, ties in
// index order; V (batch, k, k) with V[:, i, j] the i-th entry of the
// eigenvector of evals[:, j] (torch.linalg.eigh's layout). The arithmetic
// stays in H's type.
//
// Sign convention: each eigenvector column is scaled by -1 where needed so
// that its entry of largest magnitude (the first such row on ties) is
// positive.
//
// Replace: the JAX package runs the Rayleigh-Ritz eigensolve of its
// TRACEMIN as jnp.linalg.eigh inside the compiled solve (mac_tpu/ops/
// lobpcg.py:354 and :371 at the entry, :443 in every outer iteration), on
// the 4 x 4 and 12 x 12 matrices of a q = 4 block, under vmap for its
// lanes. It is not a Pallas kernel; for matrices this small XLA computes it
// on the TPU by Jacobi rotations too. torch.linalg.eigh on a CUDA tensor
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
// The design keeps everything between two parameter computations in
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
// One body serves every m. In float64 past m = 20 a lane's column of A and
// row of V (2 m doubles) outgrow its registers and ptxas spills; those
// sizes stay right and bitwise, only slower per round (no main path runs
// them: TRACEMIN's q = 4 gives m = 4 and 12).
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

// out: 32 values of the type; rounds: the chain's length.
int sym_eig_round_probe_f32(void* out, int rounds, void* stream) {
  return probe<float>(out, rounds, stream);
}

int sym_eig_round_probe_f64(void* out, int rounds, void* stream) {
  return probe<double>(out, rounds, stream);
}

}  // extern "C"
