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
// What bounds it on the H100: device-memory writes. ut is
// (half + 1) * nb * 128 * 128 floats (city10000: 3 * 79 tiles of 64 KB,
// 15.5 MB, 4.8 us at 3.35 TB/s) against ~0.2 MB of slot tables read.
//
// The design: one thread block per output tile (t, b), 237 blocks on
// city10000, so every SM has work. The block builds its 64 KB tile in
// dynamic shared memory: it zeroes the tile, then thread r adds the slots
// of lane r that land in tile t -- the dense slots first, then the block's
// overflow entries in table order. Element (c, r) has one owner who sums in
// slot order, as the reference's sheared accumulation does, so the result
// is bitwise equal to it without atomics; the shared index c * 128 + r is
// free of bank conflicts across a warp. ut[t][b] is one contiguous 64 KB
// run, so the tile leaves in one TMA bulk store (cp.async.bulk from shared
// to global memory): ut is written once, with no zero pass in device memory
// and no read-modify-write. Every table load of a block is issued before
// the tile is zeroed (eight dense slots a round in registers, the block's
// overflow entries staged in shared memory), so their latencies overlap.
// Measured (kernel_ab.py, NVIDIA H100 80GB HBM3 at 700 W): 0.0080 ms of
// device time at city10000, against 0.0084 ms for the same scatter as one
// index_add_ into a zeroed ut and 0.0099 ms for the first port of this
// kernel (one block per node block b, 79 blocks of 128 threads, ut zeroed
// and then updated in device memory); the bound is 0.0048 ms.
//
// Lanes (the budget sweep): wu (R, du, nb*128), ow (R, ov, nb) and ut
// (R, half+1, nb, 128, 128) gain a leading lane dimension; the slot tables
// dcol, ocol and olane are shared by every lane. The grid is (nb, half+1,
// R), one tile per block as before; R = 1 is the single assembly.
//
// Float64 (the banded operator of a float64 solve) is the same kernel with
// 8-byte elements: a 128 x 128 tile of 128 KB, one block per SM, and the
// same bulk store of the whole tile; bitwise equal to the plain version
// for the same reason.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBS = 128;
constexpr int kChunk = 8;  // dense slots whose loads are in flight together

// T is float (64 KB tiles) or double (128 KB tiles, above the default
// dynamic shared-memory limit, set at the first launch; one block per SM).
template <typename T>
__host__ __device__ constexpr int tile_bytes() {
  return kBS * kBS * static_cast<int>(sizeof(T));
}

template <typename T>
__global__ void __launch_bounds__(kBS)
assemble_ut_kernel(const int* __restrict__ dcol, const T* __restrict__ wu,
                   int du, const int* __restrict__ ocol,
                   const int* __restrict__ olane, const T* __restrict__ ow,
                   int ov, T* __restrict__ ut, int nb) {
  extern __shared__ __align__(128) unsigned char tile_raw[];
  T* tile = reinterpret_cast<T*>(tile_raw);  // tile[c * 128 + r]
  __shared__ int s_lane[kBS], s_col[kBS];    // one round of overflow
  __shared__ T s_w[kBS];
  const int b = blockIdx.x;
  const int t = blockIdx.y;
  const int r = threadIdx.x;
  // Columns of tile t: [128 (t + 1), 128 (t + 2)); col below is relative.
  const int lo = kBS * (t + 1);
  const size_t n_pad = (size_t)nb * kBS;
  const size_t node = (size_t)b * kBS + r;
  // Lane blockIdx.z: its slot weights and its ut.
  wu += (size_t)blockIdx.z * du * n_pad;
  ow += (size_t)blockIdx.z * ov * nb;
  ut += (size_t)blockIdx.z * gridDim.y * n_pad * kBS;

  // Loads first, so that their latency overlaps the zeroing: a round of
  // kChunk dense slots of lane r, and the block's first kBS overflow entries.
  int col[kChunk];
  T val[kChunk];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      const int k = k0 + u;
      col[u] = k < du ? dcol[k * n_pad + node] - lo : -1;
      val[u] = k < du ? wu[k * n_pad + node] : T(0);
    }
  };
  auto stage = [&](int o0) {
    if (o0 + r < ov) {
      const size_t e = (size_t)(o0 + r) * nb + b;
      s_lane[r] = olane[e];
      s_col[r] = ocol[e] - lo;
      s_w[r] = ow[e];
    }
  };
  fetch(0);
  stage(0);
  uint4* tile16 = reinterpret_cast<uint4*>(tile_raw);  // 16-byte zeroing
  for (int i = r; i < tile_bytes<T>() / 16; i += kBS)
    tile16[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();

  for (int k0 = 0; k0 < du; k0 += kChunk) {
    if (k0 > 0) fetch(k0);
#pragma unroll
    for (int u = 0; u < kChunk; ++u)
      if ((unsigned)col[u] < (unsigned)kBS) tile[col[u] * kBS + r] += val[u];
  }
  for (int o0 = 0; o0 < ov; o0 += kBS) {
    if (o0 > 0) {
      __syncthreads();  // the last round is read
      stage(o0);
      __syncthreads();
    }
    const int m = min(kBS, ov - o0);
    for (int o = 0; o < m; ++o)
      if (s_lane[o] == r && (unsigned)s_col[o] < (unsigned)kBS)
        tile[s_col[o] * kBS + r] += s_w[o];
  }

  // Make the generic-proxy writes to shared memory visible to the bulk
  // copy (async proxy), then one thread stores the whole tile.
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  if (r == 0) {
    T* dst = ut + ((size_t)t * nb + b) * kBS * kBS;
    const uint32_t src =
        static_cast<uint32_t>(__cvta_generic_to_shared(tile_raw));
    asm volatile(
        "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
        :: "l"(dst), "r"(src), "r"(tile_bytes<T>()) : "memory");
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    // The block's shared memory must outlive the copy's reads of it.
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

template <typename T>
int assemble_launch(const int* dcol, const T* wu, int du, const int* ocol,
                    const int* olane, const T* ow, int ov, T* ut, int half,
                    int nb, int lanes, void* stream) {
  if (nb <= 0 || half < 0 || lanes <= 0) return 0;
  if (reinterpret_cast<uintptr_t>(ut) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  static const cudaError_t attr = cudaFuncSetAttribute(
      assemble_ut_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      tile_bytes<T>());
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(nb, half + 1, lanes);
  assemble_ut_kernel<T><<<grid, kBS, tile_bytes<T>(),
                          static_cast<cudaStream_t>(stream)>>>(
      dcol, wu, du, ocol, olane, ow, ov, ut, nb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dcol: (du, nb*128) int32; wu: (lanes, du, nb*128) float32 (_f32) or
// float64 (_f64); ocol, olane: (ov, nb) int32; ow: (lanes, ov, nb) and ut:
// (lanes, half+1, nb, 128, 128) of wu's type, ut 16-byte aligned. All
// row-major and contiguous; the overflow pointers are unused when ov = 0.
// Launches on `stream` and returns the first CUDA error of the
// shared-memory attribute or the launch (0 on success).
extern "C" int assemble_ut_f32(const int* dcol, const float* wu, int du,
                               const int* ocol, const int* olane,
                               const float* ow, int ov, float* ut, int half,
                               int nb, int lanes, void* stream) {
  return assemble_launch(dcol, wu, du, ocol, olane, ow, ov, ut, half, nb,
                         lanes, stream);
}

extern "C" int assemble_ut_f64(const int* dcol, const double* wu, int du,
                               const int* ocol, const int* olane,
                               const double* ow, int ov, double* ut, int half,
                               int nb, int lanes, void* stream) {
  return assemble_launch(dcol, wu, du, ocol, olane, ow, ov, ut, half, nb,
                         lanes, stream);
}
