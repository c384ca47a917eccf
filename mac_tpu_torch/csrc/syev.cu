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
// the 4 x 4 and 12 x 12 matrices of a q = 4 block. It is not a Pallas
// kernel; for matrices this small XLA computes it on the TPU by Jacobi
// rotations too. torch.linalg.eigh on a CUDA tensor (cuSOLVER's syevd)
// reads its error code back to the host, so a solve that called it could
// not be captured in a CUDA graph; this kernel reads nothing back.
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
// A rotation with a_pq = 0 is skipped. The stop test runs on the device
// before every sweep: the off-diagonal Frobenius norm at most eps(T) times
// ||H||_F, or MAX_SWEEPS sweeps done. Then the eigenvalues (the diagonal)
// are ranked (ascending, ties by index) and written with their vectors.
// The plain version, mac_tpu_torch.ops.kernels.syev.sym_eig_plain, runs
// the same rounds in the same order with the same stop rule.
//
// What bounds it on the H100: a chain of dependent rounds, as K3's chain
// of pivots bounds it, not bytes (a 12 x 12 float64 matrix is 1152 bytes,
// 0.3 ns at 3.35 TB/s) or operations (about 4 m^3 a sweep). Each round
// waits for the one before: a square root and two divisions for its
// parameters, then the row and the column updates, m / 2 dependent
// multiply-adds a thread each. 12 x 12 takes 11 rounds a sweep, and the
// data sets the sweeps (chip_smoke.py phase 3e prints them with the time
// a round; PERF.md keeps the measurements).
//
// The design keeps that chain short: one warp a matrix, so that every
// step between two phases of a round is a __syncwarp and not a block
// barrier; A and V live in shared memory with rows padded to 33 entries
// (a row and a column walk hit distinct banks in float32); lane j owns
// column j in the row update and row j in the column update, so a phase
// is m / 2 multiply-add pairs per lane with no atomics; the stop test is
// one warp reduction per sweep. No allocation, no host read: one launch,
// a block per matrix.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxK = 32;
constexpr int kPad = kMaxK + 1;
constexpr int kMaxSweeps = 30;
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
__device__ T warp_sum(T v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(kFullMask, v, off);
  return v;
}

// Index of slot `slot` in round r of a sweep over m (even) indices.
__device__ int slot_index(int slot, int r, int m) {
  return slot == 0 ? 0 : ((slot - 1 + r) % (m - 1)) + 1;
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

template <typename T>
__global__ void __launch_bounds__(32)
sym_eig_kernel(const T* __restrict__ H, T* __restrict__ evals,
               T* __restrict__ Vout, int k) {
  __shared__ T A[kMaxK][kPad];
  __shared__ T V[kMaxK][kPad];
  __shared__ T rot_s[kMaxK / 2];
  __shared__ T rot_tau[kMaxK / 2];
  __shared__ int rot_p[kMaxK / 2];
  __shared__ int rot_q[kMaxK / 2];

  const int lane = threadIdx.x;
  const int m = k + (k & 1);
  const int half = m / 2;
  const T* Hb = H + (size_t)blockIdx.x * k * k;

  // Load A (lane j holds column j), the identity into V; a zero row and
  // column pad an odd k.
  T norm2 = T(0);
  if (lane < m) {
    for (int i = 0; i < m; ++i) {
      T a = (i < k && lane < k) ? Hb[i * k + lane] : T(0);
      A[i][lane] = a;
      V[i][lane] = (i == lane) ? T(1) : T(0);
      norm2 += a * a;
    }
  }
  const T tol = Eps<T>::value() * sqrt(warp_sum(norm2));
  __syncwarp();

  for (int sweep = 0; sweep < kMaxSweeps; ++sweep) {
    T off2 = T(0);
    if (lane < m)
      for (int i = 0; i < m; ++i)
        if (i != lane) off2 += A[i][lane] * A[i][lane];
    if (sqrt(warp_sum(off2)) <= tol) break;  // the same on every lane

    for (int r = 0; r < m - 1; ++r) {
      // The round's rotations: lane i < m / 2 takes pair i.
      T t = T(0), app = T(0), aqq = T(0), apq = T(0);
      if (lane < half) {
        int a = slot_index(lane, r, m), b = slot_index(m - 1 - lane, r, m);
        int p = min(a, b), q = max(a, b);
        app = A[p][p];
        aqq = A[q][q];
        apq = A[p][q];
        T s = T(0), tau = T(0);
        if (apq != T(0)) {
          T d = aqq - app, a2 = apq + apq;
          t = a2 / (d + copysign(hypot(d, a2), d));
          T c = T(1) / hypot(t, T(1));
          s = t * c;
          tau = s / (T(1) + c);
        }
        rot_p[lane] = p;
        rot_q[lane] = q;
        rot_s[lane] = s;
        rot_tau[lane] = tau;
      }
      __syncwarp();
      // Rows p, q of A: lane j updates column j.
      if (lane < m) {
        for (int i = 0; i < half; ++i) {
          T s = rot_s[i], tau = rot_tau[i];
          if (s == T(0)) continue;
          int p = rot_p[i], q = rot_q[i];
          T x = A[p][lane], y = A[q][lane];
          A[p][lane] = x - s * (y + tau * x);
          A[q][lane] = y + s * (x - tau * y);
        }
      }
      __syncwarp();
      // Columns p, q of A and of V: lane j updates row j.
      if (lane < m) {
        for (int i = 0; i < half; ++i) {
          T s = rot_s[i], tau = rot_tau[i];
          if (s == T(0)) continue;
          int p = rot_p[i], q = rot_q[i];
          T x = A[lane][p], y = A[lane][q];
          A[lane][p] = x - s * (y + tau * x);
          A[lane][q] = y + s * (x - tau * y);
          x = V[lane][p];
          y = V[lane][q];
          V[lane][p] = x - s * (y + tau * x);
          V[lane][q] = y + s * (x - tau * y);
        }
      }
      __syncwarp();
      // Rutishauser's diagonal, and the annihilated pair exactly zero.
      if (lane < half && apq != T(0)) {
        int p = rot_p[lane], q = rot_q[lane];
        A[p][p] = app - t * apq;
        A[q][q] = aqq + t * apq;
        A[p][q] = T(0);
        A[q][p] = T(0);
      }
      __syncwarp();
    }
  }

  // The sign convention, then the ranks: lane j owns eigenpair j.
  if (lane < k) {
    int imax = 0;
    T vmax = fabs(V[0][lane]);
    for (int i = 1; i < k; ++i) {
      T v = fabs(V[i][lane]);
      if (v > vmax) {
        vmax = v;
        imax = i;
      }
    }
    if (V[imax][lane] < T(0))
      for (int i = 0; i < k; ++i) V[i][lane] = -V[i][lane];
  }
  __syncwarp();
  if (lane < k) {
    T d = A[lane][lane];
    int rank = 0;
    for (int i = 0; i < k; ++i)
      if (i != lane && before(A[i][i], i, d, lane)) ++rank;
    T* eb = evals + (size_t)blockIdx.x * k;
    T* vb = Vout + (size_t)blockIdx.x * k * k;
    eb[rank] = d;
    for (int i = 0; i < k; ++i) vb[i * k + rank] = V[i][lane];
  }
}

template <typename T>
int launch(const void* H, void* evals, void* V, int k, int batch,
           void* stream) {
  if (k < 1 || k > kMaxK || batch < 0) return (int)cudaErrorInvalidValue;
  if (batch == 0) return 0;
  sym_eig_kernel<T><<<batch, 32, 0, (cudaStream_t)stream>>>(
      (const T*)H, (T*)evals, (T*)V, k);
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

}  // extern "C"
