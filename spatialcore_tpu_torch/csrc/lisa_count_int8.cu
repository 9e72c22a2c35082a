// Local Moran (LISA) permutation null in the int8 system: the fused draw
// step, and the observed statistic of the same operator.
//
//   lag_i[g] = sum_slots wq * z[window + local_idx][g]              (band)
//            + far_i[g]                                             (far)
//   val_i[g] = |z_i[g] * lag_i[g]|                                  (exact int32)
//   draw step:  cnt_i[g] += (val_i[g] >= obs_i[g])   (counter updated in place)
//   observed:   out_i[g]  = val_i[g]                 (identity placement)
//
// Replaces two Pallas kernels of spatialcore_tpu/ops/banded.py:
//   K7 _make_fused_win_kernel (:1389), stat="moran" tail -- the far lag
//      rebuilt from two S-row windows of the compact far list;
//   K8 _band_lag_count_kernel_i8 (:1291) -- a dense int32 far layer.
// and the XLA observed pass abs_ip of _banded_local_moran_p_i8 (:2369).
// The far term arrives in one of three forms (template FAR):
//   kFarRows  row pointers into the compact far list: far_ptr int32 [Npad+1],
//             far_q int8 [F] weight codes, zf int8 [F, G] gathered far values
//             (the function of K7; the list is sorted by source row, so row
//             r's entries are [far_ptr[r], far_ptr[r+1]) -- no S-row windows
//             and no one-hot operator, which were BlockSpec artefacts);
//   kFarDense a dense int32 far layer [Npad, G] (the function of K8);
//   kFarNone  no far edges.
//
// What bounds it on the H100: bytes. Per draw at 1M cells x 1,024 genes the
// function must read ~1.0 GB of gathered codes, 4.1 GB of int32 observed
// values, ~0.27 GB of far values and the int8 counters (1.0 GB), and write
// the counters back (1.0 GB): ~7.4 GB, ~2.2 ms at 3.35 TB/s. Its integer
// work is ~k+2 multiply-adds per value, far below what the card issues in
// that time.
//
// Design:
// - Grid (band block n, 64-gene column tile). The block stages the three
//   B-row slabs of its window [n*B, n*B + 3B) in shared memory (48 KB at
//   B=256) with 4-byte loads; 16 row groups of 16 threads then walk the
//   block's rows, each thread owning 4 consecutive genes of a row.
// - The streamed planes are read and written once, in 16-byte (int32 obs,
//   dense far), 4/8/16-byte (int8/int16/int32 counters) vector accesses,
//   consecutive threads on consecutive addresses.
// - Integer arithmetic only: |lag| <= k*127^2 and |z*lag| <= k*127^3 < 2^31
//   for k <= 1000 (the wrapper's caller checks k). No atomics, no floats:
//   every count is exact and bitwise reproducible.
// - The counter is updated in place (the TPU kernels aliased it with
//   input_output_aliases).
//
// Later work (not here): TMA staging, reusing slabs across consecutive
// blocks, fusing the per-draw row gather.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kColThreads = 16;                      // threads across a row
constexpr int kRowGroups = kThreads / kColThreads;   // rows in flight
constexpr int kTileCols = kColThreads * 4;           // genes per block

enum FarForm { kFarNone = 0, kFarRows = 1, kFarDense = 2 };

__device__ __forceinline__ void unpack4(int word, int* v) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    v[j] = static_cast<int>(static_cast<int8_t>((word >> (8 * j)) & 0xFF));
  }
}

__device__ __forceinline__ void load_cnt(const int8_t* p, int* c) {
  unpack4(*reinterpret_cast<const int*>(p), c);
}
__device__ __forceinline__ void store_cnt(int8_t* p, const int* c) {
  const unsigned w = (static_cast<unsigned>(c[0]) & 0xFFu)
                     | ((static_cast<unsigned>(c[1]) & 0xFFu) << 8)
                     | ((static_cast<unsigned>(c[2]) & 0xFFu) << 16)
                     | ((static_cast<unsigned>(c[3]) & 0xFFu) << 24);
  *reinterpret_cast<unsigned*>(p) = w;
}
__device__ __forceinline__ void load_cnt(const int16_t* p, int* c) {
  const short4 s = *reinterpret_cast<const short4*>(p);
  c[0] = s.x; c[1] = s.y; c[2] = s.z; c[3] = s.w;
}
__device__ __forceinline__ void store_cnt(int16_t* p, const int* c) {
  *reinterpret_cast<short4*>(p) = make_short4(
      static_cast<short>(c[0]), static_cast<short>(c[1]),
      static_cast<short>(c[2]), static_cast<short>(c[3]));
}
__device__ __forceinline__ void load_cnt(const int32_t* p, int* c) {
  const int4 s = *reinterpret_cast<const int4*>(p);
  c[0] = s.x; c[1] = s.y; c[2] = s.z; c[3] = s.w;
}
__device__ __forceinline__ void store_cnt(int32_t* p, const int* c) {
  *reinterpret_cast<int4*>(p) = make_int4(c[0], c[1], c[2], c[3]);
}

// COUNT: draw step (obs, cnt); else observed (out). CT: counter type.
template <int FAR, bool COUNT, typename CT>
__global__ void __launch_bounds__(kThreads)
lisa_kernel(const int32_t* __restrict__ local_idx,
            const int8_t* __restrict__ wq,
            const int8_t* __restrict__ zp,
            const int32_t* __restrict__ far_ptr,
            const int8_t* __restrict__ far_q,
            const int8_t* __restrict__ zf,
            const int32_t* __restrict__ far_dense,
            const int32_t* __restrict__ obs,
            CT* __restrict__ cnt,
            int32_t* __restrict__ out,
            int B, int k, int G) {
  extern __shared__ __align__(16) int slab[];        // [3B][kColThreads]
  const int n = blockIdx.x;
  const int c0 = blockIdx.y * kTileCols;
  const int tid = threadIdx.x;
  const int ct = tid % kColThreads;
  const int rg = tid / kColThreads;
  const size_t row0 = static_cast<size_t>(n) * B;

  // stage the window's three slabs (rows [n*B, n*B + 3B) of zp)
  for (int idx = tid; idx < 3 * B * kColThreads; idx += kThreads) {
    const int r = idx / kColThreads;
    const int col = c0 + 4 * (idx % kColThreads);
    int v = 0;
    if (col < G) {
      v = *reinterpret_cast<const int*>(zp + (row0 + r) * G + col);
    }
    slab[idx] = v;
  }
  __syncthreads();

  const int col = c0 + 4 * ct;
  if (col >= G) return;                              // no barrier below
  int v[4];
  for (int i = rg; i < B; i += kRowGroups) {
    const size_t r = row0 + i;
    int lag[4] = {0, 0, 0, 0};
    for (int s = 0; s < k; ++s) {
      const int w = wq[r * k + s];
      if (w != 0) {
        unpack4(slab[local_idx[r * k + s] * kColThreads + ct], v);
#pragma unroll
        for (int j = 0; j < 4; ++j) lag[j] += w * v[j];
      }
    }
    const size_t o = r * G + col;
    if (FAR == kFarRows) {
      const int e1 = far_ptr[r + 1];
      for (int e = far_ptr[r]; e < e1; ++e) {
        const int q = far_q[e];
        unpack4(*reinterpret_cast<const int*>(zf + static_cast<size_t>(e) * G + col), v);
#pragma unroll
        for (int j = 0; j < 4; ++j) lag[j] += q * v[j];
      }
    } else if (FAR == kFarDense) {
      const int4 f = *reinterpret_cast<const int4*>(far_dense + o);
      lag[0] += f.x; lag[1] += f.y; lag[2] += f.z; lag[3] += f.w;
    }
    unpack4(slab[(B + i) * kColThreads + ct], v);    // the row's own codes
    int val[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) val[j] = abs(v[j] * lag[j]);
    if (COUNT) {
      const int4 ob = *reinterpret_cast<const int4*>(obs + o);
      int c[4];
      load_cnt(cnt + o, c);
      c[0] += val[0] >= ob.x;
      c[1] += val[1] >= ob.y;
      c[2] += val[2] >= ob.z;
      c[3] += val[3] >= ob.w;
      store_cnt(cnt + o, c);
    } else {
      *reinterpret_cast<int4*>(out + o) = make_int4(val[0], val[1], val[2], val[3]);
    }
  }
}

template <int FAR, bool COUNT, typename CT>
cudaError_t launch(const int32_t* local_idx, const int8_t* wq, const int8_t* zp,
                   const int32_t* far_ptr, const int8_t* far_q, const int8_t* zf,
                   const int32_t* far_dense, const int32_t* obs, CT* cnt,
                   int32_t* out, int nb, int B, int k, int G,
                   cudaStream_t stream) {
  const size_t smem = sizeof(int) * static_cast<size_t>(3) * B * kColThreads;
  cudaError_t err = cudaFuncSetAttribute(
      lisa_kernel<FAR, COUNT, CT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(nb, (G + kTileCols - 1) / kTileCols);
  lisa_kernel<FAR, COUNT, CT><<<grid, kThreads, smem, stream>>>(
      local_idx, wq, zp, far_ptr, far_q, zf, far_dense, obs, cnt, out, B, k, G);
  return cudaGetLastError();
}

template <bool COUNT, typename CT>
cudaError_t by_far(int far_form, const int32_t* local_idx, const int8_t* wq,
                   const int8_t* zp, const int32_t* far_ptr, const int8_t* far_q,
                   const int8_t* zf, const int32_t* far_dense, const int32_t* obs,
                   CT* cnt, int32_t* out, int nb, int B, int k, int G,
                   cudaStream_t s) {
  switch (far_form) {
    case kFarNone:
      return launch<kFarNone, COUNT, CT>(local_idx, wq, zp, far_ptr, far_q, zf,
                                         far_dense, obs, cnt, out, nb, B, k, G, s);
    case kFarRows:
      return launch<kFarRows, COUNT, CT>(local_idx, wq, zp, far_ptr, far_q, zf,
                                         far_dense, obs, cnt, out, nb, B, k, G, s);
    case kFarDense:
      return launch<kFarDense, COUNT, CT>(local_idx, wq, zp, far_ptr, far_q, zf,
                                          far_dense, obs, cnt, out, nb, B, k, G, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Draw step: cnt [Npad, G] (cnt_bytes 1, 2 or 4: int8/int16/int32) +=
// (|z*lag| >= obs), in place. far_form: 0 none, 1 row pointers, 2 dense.
extern "C" int sct_lisa_count(const int32_t* local_idx, const int8_t* wq,
                              const int8_t* zp, const int32_t* far_ptr,
                              const int8_t* far_q, const int8_t* zf,
                              const int32_t* far_dense, const int32_t* obs,
                              void* cnt, int nb, int B, int k, int G,
                              int far_form, int cnt_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (cnt_bytes) {
    case 1:
      err = by_far<true, int8_t>(far_form, local_idx, wq, zp, far_ptr, far_q, zf,
                                 far_dense, obs, static_cast<int8_t*>(cnt),
                                 nullptr, nb, B, k, G, s);
      break;
    case 2:
      err = by_far<true, int16_t>(far_form, local_idx, wq, zp, far_ptr, far_q, zf,
                                  far_dense, obs, static_cast<int16_t*>(cnt),
                                  nullptr, nb, B, k, G, s);
      break;
    case 4:
      err = by_far<true, int32_t>(far_form, local_idx, wq, zp, far_ptr, far_q, zf,
                                  far_dense, obs, static_cast<int32_t*>(cnt),
                                  nullptr, nb, B, k, G, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// Observed: out int32 [Npad, G] = |z*lag| at the placement the caller
// gathered into zp (the identity placement for the observed statistic).
extern "C" int sct_lisa_observed(const int32_t* local_idx, const int8_t* wq,
                                 const int8_t* zp, const int32_t* far_ptr,
                                 const int8_t* far_q, const int8_t* zf,
                                 const int32_t* far_dense, int32_t* out, int nb,
                                 int B, int k, int G, int far_form, void* stream) {
  return static_cast<int>(by_far<false, int8_t>(
      far_form, local_idx, wq, zp, far_ptr, far_q, zf, far_dense, nullptr,
      nullptr, out, nb, B, k, G, static_cast<cudaStream_t>(stream)));
}
