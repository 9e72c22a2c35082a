// Band cross of the global permutation null in bf16 / f32, one draw per
// launch:
//
//   cross[g] = sum_i z1_i[g] * lag_i[g],   lag_i[g] = sum_slots w * z[window + local_idx][g]
//
// with bf16 or f32 values and weights and float32 lag and accumulation.
// Replaces the Pallas kernel K4 of spatialcore_tpu/ops/banded.py:
// _band_halo_kernel_1t (:511) and its gene-tiled form _band_halo_kernel
// (:446), both behind _band_cross_pallas_halo (:667).
//
// What bounds it on the H100: bytes. The TPU kernel multiplies the dense
// band A[nb, B, 3B] (1.5 GB of bf16 at 1M cells, 0.8% nonzero at B=256, k=6)
// against the window on the matrix unit; here the compact band --
// local_idx int32 [Npad, k] and weights [Npad, k] -- gives k multiply-adds
// per value, and the traffic is the value slabs (three reads of each
// [B, G] slab, mostly from L2) plus the [nb, G] float partials.
//
// Design:
// - Grid (band block n, 32-gene tile). The block stages its window's three
//   B-row slabs [n*B, n*B + 3B) in shared memory (3*B*32 values: 48 KB of
//   bf16 or 96 KB of f32 at B=256); each of 8 warps walks every 8th row of
//   the block with one gene per lane, so a warp reads 32 consecutive values.
// - Products and sums are explicit __fmul_rn / __fadd_rn in slot order,
//   the order of the plain version's lag, so the lags agree bitwise with it.
// - Each block writes its own partial row [n, G]; the wrapper reduces the
//   partials in a fixed order. No atomics: results are bitwise reproducible
//   run to run.
//
// Later work (not here): tensor-core tiles, TMA staging, slab reuse across
// consecutive blocks, fusing the per-draw row gather.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 32;                        // genes per block (one per lane)
constexpr int kRowGroups = kThreads / kCols;     // warps, one row each in flight

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T zero_value();
template <>
__device__ __forceinline__ float zero_value<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero_value<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
band_cross_float_kernel(const int32_t* __restrict__ local_idx,
                        const T* __restrict__ w,
                        const T* __restrict__ zp,
                        float* __restrict__ partial,
                        int B, int k, int G, size_t slab_bytes) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* slab = reinterpret_cast<T*>(smem);                        // [3B][kCols]
  float* red = reinterpret_cast<float*>(smem + slab_bytes);    // [kRowGroups][kCols]

  const int n = blockIdx.x;
  const int g0 = blockIdx.y * kCols;
  const int tid = threadIdx.x;
  const int lane = tid % kCols;
  const int rg = tid / kCols;
  const size_t row0 = static_cast<size_t>(n) * B;

  for (int idx = tid; idx < 3 * B * kCols; idx += kThreads) {
    const int r = idx / kCols;
    const int g = g0 + idx % kCols;
    slab[idx] = g < G ? zp[(row0 + r) * G + g] : zero_value<T>();
  }
  __syncthreads();

  float acc = 0.f;
  if (g0 + lane < G) {
    for (int i = rg; i < B; i += kRowGroups) {
      const size_t r = row0 + i;
      float lag = 0.f;
      for (int s = 0; s < k; ++s) {
        const float wf = to_f32(w[r * k + s]);
        if (wf != 0.f) {
          lag = __fadd_rn(lag, __fmul_rn(wf, to_f32(slab[local_idx[r * k + s] * kCols + lane])));
        }
      }
      acc = __fadd_rn(acc, __fmul_rn(to_f32(slab[(B + i) * kCols + lane]), lag));
    }
  }
  red[rg * kCols + lane] = acc;
  __syncthreads();

  if (tid < kCols && g0 + tid < G) {
    float s = 0.f;
    for (int g = 0; g < kRowGroups; ++g) s = __fadd_rn(s, red[g * kCols + tid]);
    partial[static_cast<size_t>(n) * G + g0 + tid] = s;
  }
}

template <typename T>
cudaError_t launch(const int32_t* local_idx, const void* w, const void* zp,
                   float* partial, int nb, int B, int k, int G,
                   cudaStream_t stream) {
  const size_t slab_bytes = (static_cast<size_t>(3) * B * kCols * sizeof(T) + 15) / 16 * 16;
  const size_t smem = slab_bytes + sizeof(float) * kRowGroups * kCols;
  cudaError_t err = cudaFuncSetAttribute(
      band_cross_float_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(nb, (G + kCols - 1) / kCols);
  band_cross_float_kernel<T><<<grid, kThreads, smem, stream>>>(
      local_idx, static_cast<const T*>(w), static_cast<const T*>(zp), partial,
      B, k, G, slab_bytes);
  return cudaGetLastError();
}

}  // namespace

// partial: float [nb, G]. is_bf16 selects bf16 (else f32) weights and values.
extern "C" int sct_band_cross_float(const int32_t* local_idx, const void* w,
                                    const void* zp, float* partial, int nb,
                                    int B, int k, int G, int is_bf16,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(local_idx, w, zp, partial, nb, B, k, G, s)
              : launch<float>(local_idx, w, zp, partial, nb, B, k, G, s);
  return static_cast<int>(err);
}
