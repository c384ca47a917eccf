// The three-pass K4w (commit 9f43cf3: the parameters, then rows of A and
// V^T, then columns of A, two block barriers a round) with phase stamps,
// for kernel_ab.py's A/B: appended (by an #include of the older source) to
// that commit's mac_tpu_torch/csrc/syev.cu when that older syev.cu
// exports no sym_eig_wide_phases_*, so that the older design's split of a
// round stands beside the new one's. The body is that source's
// sym_eig_wide_kernel and wide_round, shared-memory form, with clock64()
// stamps of the first matrix's thread 0 (lane 0 of pair 0) into
// clk, laid out as the current syev.cu lays out its own (body 1 in
// clk[13]): [1] the parameters (up to the pair's warp barrier), [2] the
// row update of A and V^T, [3] the wait at the first block barrier, [4]
// the column update of A and the new diagonal, [5] the wait at the second,
// [6] the stop test; [11] sweeps, [12] rounds, [14] the kernel's cycles,
// [15] its %globaltimer nanoseconds. The unstamped kernels of the older
// source are compiled as they were.

namespace {

__device__ __forceinline__ long long three_pass_gtimer() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

template <typename T>
__device__ void three_pass_round_stamped(WideScratch<T>& w, int m, int lanes,
                                         int r,
                                   long long* ck) {
  const int h = m / 2, ld = wide_ld(m);
  const int per_pass = blockDim.x / lanes, lane = threadIdx.x & (lanes - 1);
  const bool st0 = ck != nullptr;
  T* const A = w.A;
  T* const VT = w.VT;
  const long long c0 = st0 ? clock64() : 0;
  long long c1 = 0;
  for (int base = 0; base < h; base += per_pass) {
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
    if (lanes > 1) __syncwarp();
    if (st0 && base == 0) c1 = clock64();
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
        const T ss = -s, tt = -tau;
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
  const long long c2 = st0 ? clock64() : 0;
  __syncthreads();
  const long long c3 = st0 ? clock64() : 0;
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
  const long long c4 = st0 ? clock64() : 0;
  __syncthreads();
  if (st0) {
    const long long c5 = clock64();
    ck[1] += c1 - c0;
    ck[2] += c2 - c1;
    ck[3] += c3 - c2;
    ck[4] += c4 - c3;
    ck[5] += c5 - c4;
  }
}

template <typename T>
__global__ void __launch_bounds__(1024)
    three_pass_wide_phases_kernel(const T* __restrict__ H,
                                  T* __restrict__ evals,
                            T* __restrict__ Vout, int k, int m, int lanes,
                            long long* clk) {
  extern __shared__ __align__(16) unsigned char wide_smem[];
  const int mat = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int ld = wide_ld(m);
  const bool st0 = mat == 0 && tid == 0;
  const long long t_start = clock64(), g_start = three_pass_gtimer();
  long long ck[7] = {0, 0, 0, 0, 0, 0, 0};
  WideScratch<T> w(wide_smem, m);
  const T* Hb = H + (size_t)mat * k * k;
  for (size_t e = tid; e < (size_t)m * m; e += nt) {
    const int i = (int)(e / m), j = (int)(e - (size_t)i * m);
    w.A[(size_t)i * ld + j] = (i < k && j < k) ? Hb[(size_t)i * k + j]
                                               : T(0);
    w.VT[(size_t)i * ld + j] = i == j ? T(1) : T(0);
  }
  __syncthreads();
  const T tol = Eps<T>::value() * sqrt(wide_squares(w.A, m, false, w.red));
  int sweep = 0;
  for (; sweep < kMaxSweeps; ++sweep) {
    const long long c0 = st0 ? clock64() : 0;
    const T off = sqrt(wide_squares(w.A, m, true, w.red));
    if (st0) ck[6] += clock64() - c0;
    if (off <= tol) break;
    for (int r = 0; r < m - 1; ++r)
      three_pass_round_stamped(w, m, lanes, r, st0 ? ck : nullptr);
  }
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
  if (st0) {
    clk[0] = 6;
    for (int p = 1; p <= 6; ++p) clk[p] = ck[p];
    clk[11] = sweep;
    clk[12] = (long long)sweep * (m - 1);
    clk[13] = 1;
    clk[14] = clock64() - t_start;
    clk[15] = three_pass_gtimer() - g_start;
  }
}

template <typename T>
int three_pass_phases(const void* H, void* evals, void* V, void* work, int k,
                int batch, void* stream, long long* clk) {
  if (k < 1 || batch < 0 || work != nullptr)  // the shared-memory form only
    return (int)cudaErrorInvalidValue;
  if (batch == 0) return 0;
  const int m = k + (k & 1);
  const long long bytes = wide_scratch_bytes<T>(m);
  if (bytes > kSmemLimit) return (int)cudaErrorInvalidValue;
  static const cudaError_t attr = cudaFuncSetAttribute(
      three_pass_wide_phases_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmemLimit);
  if (attr != cudaSuccess) return (int)attr;
  three_pass_wide_phases_kernel<T>
      <<<batch, wide_threads(m), (size_t)bytes, (cudaStream_t)stream>>>(
          (const T*)H, (T*)evals, (T*)V, k, m, wide_lanes(m), clk);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int sym_eig_wide_phases_f32(const void* H, void* evals, void* V, void* work,
                            int k, int batch, void* clk, void* stream) {
  return three_pass_phases<float>(H, evals, V, work, k, batch, stream,
                            (long long*)clk);
}

int sym_eig_wide_phases_f64(const void* H, void* evals, void* V, void* work,
                            int k, int batch, void* clk, void* stream) {
  return three_pass_phases<double>(H, evals, V, work, k, batch, stream,
                             (long long*)clk);
}

}  // extern "C"
