// Band cross of the global permutation null in the int8 / int4 system,
// one draw per launch:
//
//   cross_q[g] = sum_i sw_i * z1_i[g] * lag_i[g]
//   lag_i[g]   = sum_slots wq * z[window + local_idx][g]       (band)
//              + sum_{e in far run of row i} q_e * zf_e[g]       (far, optional)
//
// Replaces three Pallas kernels of spatialcore_tpu/ops/banded.py:
//   K1 _band_cross_win_kernel_i4 (:1122), nibble-packed codes, windowed far;
//   K2 _band_cross_win_kernel_i8 (:987), int8 codes, windowed far;
//   K3 _band_halo_kernel_i8 (:879), int8 codes, band only.
// One template covers all three: PACKED selects the nibble unpack, FAR the
// far-edge term.
//
// What bounds it on the H100: bytes. The band is 0.8% dense at B=256, k=6,
// so the TPU's dense int8 matmul against A8[nb, B, 3B] would spend ~128x
// the needed operations and read 768 MB of A8 per draw at 1M cells. This
// kernel takes the compact band instead -- local_idx int32 [Npad, k] and
// weight codes int8 [Npad, k] -- and does k integer multiply-adds per value,
// so the work per draw is ~k*N*G integer ops and the traffic is the value
// slabs (3 reads of each [B, cols] slab, most served by L2 because
// neighbouring blocks run together) plus the [nb, G] float partials.
//
// Design:
// - Grid (band block n, 64-byte column tile). The block stages the three
//   B-row slabs of its window [n*B, n*B + 3B) in shared memory (3*B*64
//   bytes: 48 KB at B=256) with 4-byte loads, then 16 row groups of 16
//   threads walk the block's rows; each thread owns one 4-byte word of
//   columns: 4 int8 genes, or 8 int4 genes (packed column j holds gene j in
//   the high nibble and gene j + cols in the low nibble, stored as code+8).
// - The lag is exact int32: |lag| <= k * 127 * 127.
// - Far edges: the compact far list is sorted by source row, so row r's
//   entries are [far_ptr[r], far_ptr[r+1]) and each adds q_e * zf_e straight
//   into the row's integer lag. No S-row windows, no one-hot operator: those
//   were BlockSpec artefacts of the TPU kernel.
// - Blocks run in no order; each writes its own partial row [n, G] and the
//   wrapper reduces the partials in a fixed order. The in-block reduction
//   over row groups is in a fixed order too, and the float multiply-adds are
//   explicit (__fmul_rn / __fadd_rn, no FMA contraction), so results are
//   bitwise reproducible run to run. No atomics.
//
// Later work (not here): wgmma/int8 MMA on the band, TMA staging, reusing
// slabs across consecutive blocks, fusing the per-draw row gather.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kColThreads = 16;                      // threads across a row
constexpr int kRowGroups = kThreads / kColThreads;   // rows in flight
constexpr int kTileBytes = kColThreads * 4;          // byte columns per block

template <bool PACKED>
__device__ __forceinline__ void unpack_word(int word, int* v) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int b = (word >> (8 * j)) & 0xFF;
    if (PACKED) {
      v[j] = ((b >> 4) & 15) - 8;       // gene c + j
      v[4 + j] = (b & 15) - 8;          // gene cols + c + j
    } else {
      v[j] = static_cast<int>(static_cast<int8_t>(b));
    }
  }
}

template <bool PACKED, bool FAR>
__global__ void __launch_bounds__(kThreads)
band_cross_int8_kernel(const int32_t* __restrict__ local_idx,
                       const int8_t* __restrict__ wq,
                       const float* __restrict__ sw,
                       const int8_t* __restrict__ zp,
                       const int32_t* __restrict__ far_ptr,
                       const int8_t* __restrict__ far_q,
                       const int8_t* __restrict__ zf,
                       float* __restrict__ partial,
                       int B, int k, int gcols) {
  constexpr int NV = PACKED ? 8 : 4;                 // genes per thread
  extern __shared__ __align__(16) unsigned char smem[];
  int* slab = reinterpret_cast<int*>(smem);          // [3B][kColThreads]
  float* red = reinterpret_cast<float*>(
      smem + static_cast<size_t>(3) * B * kTileBytes);  // [kRowGroups][16*NV]

  const int n = blockIdx.x;
  const int c0 = blockIdx.y * kTileBytes;
  const int tid = threadIdx.x;
  const int ct = tid % kColThreads;
  const int rg = tid / kColThreads;
  const int G = PACKED ? 2 * gcols : gcols;
  const size_t row0 = static_cast<size_t>(n) * B;

  // stage the window's three slabs (rows [n*B, n*B + 3B) of zp)
  for (int idx = tid; idx < 3 * B * kColThreads; idx += kThreads) {
    const int r = idx / kColThreads;
    const int col = c0 + 4 * (idx % kColThreads);
    int v = 0;
    if (col < gcols) {
      v = *reinterpret_cast<const int*>(zp + (row0 + r) * gcols + col);
    }
    slab[idx] = v;
  }
  __syncthreads();

  const int col = c0 + 4 * ct;
  float acc[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) acc[j] = 0.f;
  if (col < gcols) {
    int v[NV];
    for (int i = rg; i < B; i += kRowGroups) {
      const size_t r = row0 + i;
      int lag[NV];
#pragma unroll
      for (int j = 0; j < NV; ++j) lag[j] = 0;
      for (int s = 0; s < k; ++s) {
        const int w = wq[r * k + s];
        if (w != 0) {
          unpack_word<PACKED>(slab[local_idx[r * k + s] * kColThreads + ct], v);
#pragma unroll
          for (int j = 0; j < NV; ++j) lag[j] += w * v[j];
        }
      }
      if (FAR) {
        const int e1 = far_ptr[r + 1];
        for (int e = far_ptr[r]; e < e1; ++e) {
          const int q = far_q[e];
          unpack_word<PACKED>(
              *reinterpret_cast<const int*>(zf + static_cast<size_t>(e) * gcols + col), v);
#pragma unroll
          for (int j = 0; j < NV; ++j) lag[j] += q * v[j];
        }
      }
      unpack_word<PACKED>(slab[(B + i) * kColThreads + ct], v);   // own row
      const float s_row = sw[r];
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const float t = __fmul_rn(__fmul_rn(s_row, static_cast<float>(v[j])),
                                  static_cast<float>(lag[j]));
        acc[j] = __fadd_rn(acc[j], t);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < NV; ++j) red[rg * (kColThreads * NV) + ct * NV + j] = acc[j];
  __syncthreads();

  // fixed-order reduction over row groups; one partial per (block, gene)
  for (int t = tid; t < kColThreads * NV; t += kThreads) {
    float s = 0.f;
    for (int g = 0; g < kRowGroups; ++g) s = __fadd_rn(s, red[g * (kColThreads * NV) + t]);
    const int j = t % NV;
    const int c = c0 + 4 * (t / NV) + (j & 3);
    if (c < gcols) {
      const int gene = (PACKED && j >= 4) ? gcols + c : c;
      partial[static_cast<size_t>(n) * G + gene] = s;
    }
  }
}

template <bool PACKED, bool FAR>
cudaError_t launch(const int32_t* local_idx, const int8_t* wq, const float* sw,
                   const int8_t* zp, const int32_t* far_ptr, const int8_t* far_q,
                   const int8_t* zf, float* partial, int nb, int B, int k,
                   int gcols, cudaStream_t stream) {
  constexpr int NV = PACKED ? 8 : 4;
  const size_t smem = static_cast<size_t>(3) * B * kTileBytes
                      + sizeof(float) * kRowGroups * kColThreads * NV;
  cudaError_t err = cudaFuncSetAttribute(
      band_cross_int8_kernel<PACKED, FAR>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(nb, (gcols + kTileBytes - 1) / kTileBytes);
  band_cross_int8_kernel<PACKED, FAR><<<grid, kThreads, smem, stream>>>(
      local_idx, wq, sw, zp, far_ptr, far_q, zf, partial, B, k, gcols);
  return cudaGetLastError();
}

}  // namespace

// partial: float [nb, G] with G = gcols (int8) or 2*gcols (packed int4).
// far_ptr == nullptr runs the band-only form (K3).
extern "C" int sct_band_cross_int8(const int32_t* local_idx, const int8_t* wq,
                                   const float* sw, const int8_t* zp,
                                   const int32_t* far_ptr, const int8_t* far_q,
                                   const int8_t* zf, float* partial, int nb,
                                   int B, int k, int gcols, int packed,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (packed) {
    err = far_ptr ? launch<true, true>(local_idx, wq, sw, zp, far_ptr, far_q, zf,
                                       partial, nb, B, k, gcols, s)
                  : launch<true, false>(local_idx, wq, sw, zp, far_ptr, far_q, zf,
                                        partial, nb, B, k, gcols, s);
  } else {
    err = far_ptr ? launch<false, true>(local_idx, wq, sw, zp, far_ptr, far_q, zf,
                                        partial, nb, B, k, gcols, s)
                  : launch<false, false>(local_idx, wq, sw, zp, far_ptr, far_q, zf,
                                         partial, nb, B, k, gcols, s);
  }
  return static_cast<int>(err);
}
