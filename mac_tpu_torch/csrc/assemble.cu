// Banded Laplacian assembly: the transposed upper block diagonals
//     ut[t][b][c][r] = L[128 b + r, 128 (b + t) + c],   t = 0..half
// of L(w), from the per-node slot tables that build_banded produces.
//
// Replaces both TPU kernels of mac_tpu/ops/pallas/assemble_kernel.py:
// _assemble_kernel (assemble_ut_fused, every slot dense) and
// _assemble_kernel_ov (assemble_ut_fused_ov, the first du_dense slots dense
// and the tail in per-block overflow tables). ov = 0 is the former.
//
// Node i = 128 b + r has up to du upper-neighbour slots; slot k holds the
// gathered weight -w of an edge (i, j > i) and its sheared column
// dcol = 128 + (j - i) + r. The entry lands at t = dcol / 128 - 1,
// c = dcol mod 128. Columns outside [128, 128 (half + 2)) are dropped:
// padding slots carry dcol = 0, exactly as the TPU kernel's iota compare
// never writes them. Overflow entry o of block b adds ow[o][b] at column
// ocol[o][b] of lane olane[o][b]; padding entries carry weight 0.
//
// One thread block per node block b, one thread per lane r. Element
// (c, r) of every tile is written by thread r alone, in slot order (dense
// slots, then the block's overflow entries in table order), so duplicate
// edges sum without atomics and in the same order as the reference's
// sheared accumulation: the result is bitwise equal to it.
//
// What bounds it on the H100: device-memory writes. It zeroes and writes
// (half + 1) * nb * 128 * 128 floats (city10000: 3 * 79 * 16384 * 4 B =
// 15.5 MB, coalesced across the 128 lanes), against ~40 KB of tables read.
// The slot adds are scattered single-float read-modify-writes, du of them
// per thread.

#include <cuda_runtime.h>

namespace {

constexpr int kBS = 128;

__global__ void __launch_bounds__(kBS)
assemble_ut_kernel(const int* __restrict__ dcol, const float* __restrict__ wu,
                   int du, const int* __restrict__ ocol,
                   const int* __restrict__ olane, const float* __restrict__ ow,
                   int ov, float* __restrict__ ut, int half, int nb) {
  const int b = blockIdx.x;
  const int r = threadIdx.x;
  const size_t n_pad = (size_t)nb * kBS;
  const size_t tile = (size_t)kBS * kBS;
  const size_t tstride = (size_t)nb * tile;
  float* base = ut + (size_t)b * tile + r;  // ut[0][b][0][r]

  for (int t = 0; t <= half; ++t)
    for (int c = 0; c < kBS; ++c) base[t * tstride + (size_t)c * kBS] = 0.0f;

  const int lo = kBS;
  const int hi = kBS * (half + 2);
  const size_t node = (size_t)b * kBS + r;
  for (int k = 0; k < du; ++k) {
    const int col = dcol[k * n_pad + node];
    if (col < lo || col >= hi) continue;
    const int t = col / kBS - 1;
    const int c = col % kBS;
    base[t * tstride + (size_t)c * kBS] += wu[k * n_pad + node];
  }
  for (int o = 0; o < ov; ++o) {
    const size_t e = (size_t)o * nb + b;
    if (olane[e] != r) continue;
    const int col = ocol[e];
    if (col < lo || col >= hi) continue;
    const int t = col / kBS - 1;
    const int c = col % kBS;
    base[t * tstride + (size_t)c * kBS] += ow[e];
  }
}

}  // namespace

// dcol: (du, nb*128) int32; wu: (du, nb*128) float32; ocol, olane: (ov, nb)
// int32; ow: (ov, nb) float32; ut: (half+1, nb, 128, 128) float32. All
// row-major and contiguous; the overflow pointers are unused when ov = 0.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int assemble_ut_f32(const int* dcol, const float* wu, int du,
                               const int* ocol, const int* olane,
                               const float* ow, int ov, float* ut, int half,
                               int nb, void* stream) {
  if (nb <= 0) return 0;
  assemble_ut_kernel<<<nb, kBS, 0, static_cast<cudaStream_t>(stream)>>>(
      dcol, wu, du, ocol, olane, ow, ov, ut, half, nb);
  return static_cast<int>(cudaGetLastError());
}
