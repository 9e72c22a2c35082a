// Local statistics' permutation nulls in the int8 system: the fused draw
// step, and the observed statistic of the same operator, for local Moran
// (LISA), local Geary and Getis-Ord Gi* / Gi.
//
//   lag_i[g]  = sum_slots wq * z[window + local_idx][g]             (band)
//             + far_i[g]                                            (far)
//   lag2_i[g] = the same sum over z^2                          (geary only)
//   draw step:  cnt_i[g] += extreme_i[g]     (counter updated in place)
//   observed:   out_i[g]  = the statistic    (identity placement)
//
// Per-statistic tail (template STAT), each replacing a tail of Pallas K7
// (spatialcore_tpu/ops/banded.py, _make_fused_win_kernel):
//   kMoran     |z*lag| >= obs                          (K7 :1494-1496, int32)
//   kGeary     z^2*W + lag2 - 2*z*lag <= obs           (K7 :1497-1510, int32;
//              W = the row's total weight code. The TPU split z^2 = 128a + b
//              into two int8 planes for its int8 MXU; here lag2 accumulates
//              z^2 directly in int32, which is the same integer: adds
//              commute. Bound: sum w (dz)^2 <= k*127*254^2 < 2^31, k <= 256)
//   kGetisStar A = lag + z against obs = A_obs         (K7 :1517-1534;
//              binary codes; one-sided exact integer tests, two-sided the
//              sign test f32(A - A_o) * (f32(A + A_o) - 2*c2) >= 0 with
//              c2 = (tot/m)*(W+1) formed here from a [G] and an [Npad]
//              vector instead of a streamed [Npad, G] f32 plane)
//   kGetisG    leave-one-out centering in f32          (K7 :1535-1557;
//              every f32 operation is an explicitly rounded intrinsic, so
//              nvcc's default FMA contraction cannot change a bit against
//              the plain version; an exact (lag, z) pair tie with the
//              observed (lag_o, me_o) counts as extreme)
// The observed entry returns |z*lag| (moran), the geary value, or the
// binary lag (getis; the wrapper forms A_o, cp_o from it), replacing the
// reference's XLA observed passes (abs_ip :2369, geary_q :2899, lag_me_q
// :3184). The moran far term also arrives densely (K8, _band_lag_count_
// kernel_i8 :1291); the far term comes in one of three forms (template FAR):
//   kFarRows  row pointers into the compact far list: far_ptr int32 [Npad+1],
//             far_q int8 [F] weight codes, zf int8 [F, G] gathered far values
//             (the function of K7; the list is sorted by source row, so row
//             r's entries are [far_ptr[r], far_ptr[r+1]) -- no S-row windows
//             and no one-hot operator, which were BlockSpec artefacts);
//   kFarDense a dense int32 far layer [Npad, G] (the function of K8, moran);
//   kFarNone  no far edges (moran; the other statistics take an empty list).
//
// What bounds it on the H100: bytes. Per draw at 1M cells x 1,024 genes the
// function must read ~1.0 GB of gathered codes, 4.1 GB of int32 (or f32)
// observed values, ~0.27 GB of far values and the int8 counters (1.0 GB),
// and write the counters back (1.0 GB): ~7.4 GB, ~2.2 ms at 3.35 TB/s.
// Gi adds its observed int32 lag and int8 own codes (5.1 GB, ~12.5 GB in
// all). The integer work is ~k+2 multiply-adds per value (2k+3 for geary),
// far below the card's integer rate over that time.
//
// Design:
// - Grid (band block n, 64-gene column tile). The block stages the three
//   B-row slabs of its window [n*B, n*B + 3B) in shared memory (48 KB at
//   B=256) with 4-byte loads; 16 row groups of 16 threads then walk the
//   block's rows, each thread owning 4 consecutive genes of a row.
// - The streamed planes are read and written once, in 16-byte (int32/f32
//   obs, Gi's observed lag, dense far), 4/8/16-byte (int8/int16/int32
//   counters, Gi's own codes) vector accesses, consecutive threads on
//   consecutive addresses.
// - Integer arithmetic wherever the reference's decision is integer: no
//   atomics, every count exact and bitwise reproducible.
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
enum Stat { kMoran = 0, kGeary = 1, kGetisStar = 2, kGetisG = 3 };
enum Alt { kTwoSided = 0, kGreater = 1, kLess = 2 };

// Per-statistic operands beyond the common ones (unused ones are null).
struct Tail {
  const int32_t* row_i;   // geary: total weight code W [Npad]
  const float* row_f;     // getis_star two-sided: W + 1; getis_g: W  [Npad]
  const float* col_a;     // getis_star two-sided: f32(tot/m); getis_g: tot [G]
  const float* col_b;     // getis_g: sq [G]
  const int32_t* lag_o;   // getis_g: observed binary lag [Npad, G]
  const int8_t* me_o;     // getis_g: observed own codes [Npad, G]
  float inv_m;            // getis_g: f32(1/m), the reference's x/m
  int alt;                // getis: Alt
};

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

// Gi's leave-one-out centered lag, in the plain version's order:
//   xbar = (tot - z) * inv_m;  s2 = max((sq - z*z) * inv_m - xbar^2, 0)
//   cp   = (lag - xbar * W) / sqrt(s2 > 0 ? s2 : 1)
__device__ __forceinline__ float gi_center(int z, int lag, float w, float tot,
                                           float sq, float inv_m) {
  const float zf = __int2float_rn(z);
  const float xbar = __fmul_rn(__fsub_rn(tot, zf), inv_m);
  float s2 = __fsub_rn(__fmul_rn(__fsub_rn(sq, __fmul_rn(zf, zf)), inv_m),
                       __fmul_rn(xbar, xbar));
  s2 = fmaxf(s2, 0.0f);
  const float s = __fsqrt_rn(s2 > 0.0f ? s2 : 1.0f);
  return __fdiv_rn(__fsub_rn(__int2float_rn(lag), __fmul_rn(xbar, w)), s);
}

__device__ __forceinline__ bool tail_test(float v, float o, int alt) {
  if (alt == kGreater) return v >= o;
  if (alt == kLess) return v <= o;
  return fabsf(v) >= fabsf(o);
}

// COUNT: draw step (obs, cnt); else observed (out). CT: counter type.
template <int STAT, int FAR, bool COUNT, typename CT>
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
            Tail t, int B, int k, int G) {
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
  float ca[4] = {0.f, 0.f, 0.f, 0.f};                // per-gene tail vectors
  float cb[4] = {0.f, 0.f, 0.f, 0.f};
  if (COUNT && (STAT == kGetisG || (STAT == kGetisStar && t.alt == kTwoSided))) {
    const float4 a = *reinterpret_cast<const float4*>(t.col_a + col);
    ca[0] = a.x; ca[1] = a.y; ca[2] = a.z; ca[3] = a.w;
    if (STAT == kGetisG) {
      const float4 b = *reinterpret_cast<const float4*>(t.col_b + col);
      cb[0] = b.x; cb[1] = b.y; cb[2] = b.z; cb[3] = b.w;
    }
  }
  int v[4];
  for (int i = rg; i < B; i += kRowGroups) {
    const size_t r = row0 + i;
    int lag[4] = {0, 0, 0, 0};
    int lag2[4] = {0, 0, 0, 0};                      // geary: lag of z^2
    for (int s = 0; s < k; ++s) {
      const int w = wq[r * k + s];
      if (w != 0) {
        unpack4(slab[local_idx[r * k + s] * kColThreads + ct], v);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          lag[j] += w * v[j];
          if (STAT == kGeary) lag2[j] += w * (v[j] * v[j]);
        }
      }
    }
    const size_t o = r * G + col;
    if (FAR == kFarRows) {
      const int e1 = far_ptr[r + 1];
      for (int e = far_ptr[r]; e < e1; ++e) {
        const int q = far_q[e];
        unpack4(*reinterpret_cast<const int*>(zf + static_cast<size_t>(e) * G + col), v);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          lag[j] += q * v[j];
          if (STAT == kGeary) lag2[j] += q * (v[j] * v[j]);
        }
      }
    } else if (FAR == kFarDense) {
      const int4 f = *reinterpret_cast<const int4*>(far_dense + o);
      lag[0] += f.x; lag[1] += f.y; lag[2] += f.z; lag[3] += f.w;
    }
    unpack4(slab[(B + i) * kColThreads + ct], v);    // the row's own codes
    int val[4];                                      // integer statistic
    const int w_row = STAT == kGeary ? t.row_i[r] : 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (STAT == kMoran) {
        val[j] = abs(v[j] * lag[j]);                 // <= k*127^3 < 2^31
      } else if (STAT == kGeary) {
        val[j] = v[j] * v[j] * w_row + lag2[j] - 2 * v[j] * lag[j];
      } else if (STAT == kGetisStar) {
        val[j] = lag[j] + v[j];                      // A = lag + own
      } else {
        val[j] = lag[j];
      }
    }
    if (!COUNT) {
      if (STAT == kGetisStar || STAT == kGetisG) {   // observed: binary lag
#pragma unroll
        for (int j = 0; j < 4; ++j) val[j] = lag[j];
      }
      *reinterpret_cast<int4*>(out + o) = make_int4(val[0], val[1], val[2], val[3]);
      continue;
    }
    const int4 ob4 = *reinterpret_cast<const int4*>(obs + o);
    const int ob[4] = {ob4.x, ob4.y, ob4.z, ob4.w};
    bool ext[4];
    if (STAT == kMoran) {
#pragma unroll
      for (int j = 0; j < 4; ++j) ext[j] = val[j] >= ob[j];
    } else if (STAT == kGeary) {
#pragma unroll
      for (int j = 0; j < 4; ++j) ext[j] = val[j] <= ob[j];
    } else if (STAT == kGetisStar) {
      if (t.alt == kGreater) {
#pragma unroll
        for (int j = 0; j < 4; ++j) ext[j] = val[j] >= ob[j];
      } else if (t.alt == kLess) {
#pragma unroll
        for (int j = 0; j < 4; ++j) ext[j] = val[j] <= ob[j];
      } else {
        const float wp1 = t.row_f[r];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float c2 = __fmul_rn(ca[j], wp1);
          const float x = __fsub_rn(__int2float_rn(val[j] + ob[j]),
                                    __fmul_rn(2.0f, c2));
          ext[j] = __fmul_rn(__int2float_rn(val[j] - ob[j]), x) >= 0.0f;
        }
      }
    } else {
      const float w = t.row_f[r];
      const int4 lo = *reinterpret_cast<const int4*>(t.lag_o + o);
      const int lag_o[4] = {lo.x, lo.y, lo.z, lo.w};
      int me_o[4];
      unpack4(*reinterpret_cast<const int*>(t.me_o + o), me_o);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float cp = gi_center(v[j], lag[j], w, ca[j], cb[j], t.inv_m);
        ext[j] = tail_test(cp, __int_as_float(ob[j]), t.alt)
                 || (lag[j] == lag_o[j] && v[j] == me_o[j]);
      }
    }
    int c[4];
    load_cnt(cnt + o, c);
#pragma unroll
    for (int j = 0; j < 4; ++j) c[j] += ext[j];
    store_cnt(cnt + o, c);
  }
}

template <int STAT, int FAR, bool COUNT, typename CT>
cudaError_t launch(const int32_t* local_idx, const int8_t* wq, const int8_t* zp,
                   const int32_t* far_ptr, const int8_t* far_q, const int8_t* zf,
                   const int32_t* far_dense, const int32_t* obs, CT* cnt,
                   int32_t* out, const Tail& t, int nb, int B, int k, int G,
                   cudaStream_t stream) {
  const size_t smem = sizeof(int) * static_cast<size_t>(3) * B * kColThreads;
  cudaError_t err = cudaFuncSetAttribute(
      lisa_kernel<STAT, FAR, COUNT, CT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(nb, (G + kTileCols - 1) / kTileCols);
  lisa_kernel<STAT, FAR, COUNT, CT><<<grid, kThreads, smem, stream>>>(
      local_idx, wq, zp, far_ptr, far_q, zf, far_dense, obs, cnt, out, t, B,
      k, G);
  return cudaGetLastError();
}

template <bool COUNT, typename CT>
cudaError_t moran_by_far(int far_form, const int32_t* local_idx,
                         const int8_t* wq, const int8_t* zp,
                         const int32_t* far_ptr, const int8_t* far_q,
                         const int8_t* zf, const int32_t* far_dense,
                         const int32_t* obs, CT* cnt, int32_t* out, int nb,
                         int B, int k, int G, cudaStream_t s) {
  const Tail t{};
  switch (far_form) {
    case kFarNone:
      return launch<kMoran, kFarNone, COUNT, CT>(local_idx, wq, zp, far_ptr,
          far_q, zf, far_dense, obs, cnt, out, t, nb, B, k, G, s);
    case kFarRows:
      return launch<kMoran, kFarRows, COUNT, CT>(local_idx, wq, zp, far_ptr,
          far_q, zf, far_dense, obs, cnt, out, t, nb, B, k, G, s);
    case kFarDense:
      return launch<kMoran, kFarDense, COUNT, CT>(local_idx, wq, zp, far_ptr,
          far_q, zf, far_dense, obs, cnt, out, t, nb, B, k, G, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// geary / getis_star / getis_g, always with row-pointer far edges (an
// empty list when the plan has none)
template <bool COUNT, typename CT>
cudaError_t by_stat(int stat, const int32_t* local_idx, const int8_t* wq,
                    const int8_t* zp, const int32_t* far_ptr,
                    const int8_t* far_q, const int8_t* zf, const int32_t* obs,
                    CT* cnt, int32_t* out, const Tail& t, int nb, int B, int k,
                    int G, cudaStream_t s) {
  switch (stat) {
    case kGeary:
      return launch<kGeary, kFarRows, COUNT, CT>(local_idx, wq, zp, far_ptr,
          far_q, zf, nullptr, obs, cnt, out, t, nb, B, k, G, s);
    case kGetisStar:
      return launch<kGetisStar, kFarRows, COUNT, CT>(local_idx, wq, zp,
          far_ptr, far_q, zf, nullptr, obs, cnt, out, t, nb, B, k, G, s);
    case kGetisG:
      return launch<kGetisG, kFarRows, COUNT, CT>(local_idx, wq, zp, far_ptr,
          far_q, zf, nullptr, obs, cnt, out, t, nb, B, k, G, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// LISA draw step: cnt [Npad, G] (cnt_bytes 1, 2 or 4: int8/int16/int32) +=
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
      err = moran_by_far<true, int8_t>(far_form, local_idx, wq, zp, far_ptr,
          far_q, zf, far_dense, obs, static_cast<int8_t*>(cnt), nullptr, nb, B,
          k, G, s);
      break;
    case 2:
      err = moran_by_far<true, int16_t>(far_form, local_idx, wq, zp, far_ptr,
          far_q, zf, far_dense, obs, static_cast<int16_t*>(cnt), nullptr, nb,
          B, k, G, s);
      break;
    case 4:
      err = moran_by_far<true, int32_t>(far_form, local_idx, wq, zp, far_ptr,
          far_q, zf, far_dense, obs, static_cast<int32_t*>(cnt), nullptr, nb,
          B, k, G, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// LISA observed: out int32 [Npad, G] = |z*lag| at the placement the caller
// gathered into zp (the identity placement for the observed statistic).
extern "C" int sct_lisa_observed(const int32_t* local_idx, const int8_t* wq,
                                 const int8_t* zp, const int32_t* far_ptr,
                                 const int8_t* far_q, const int8_t* zf,
                                 const int32_t* far_dense, int32_t* out, int nb,
                                 int B, int k, int G, int far_form, void* stream) {
  return static_cast<int>(moran_by_far<false, int8_t>(
      far_form, local_idx, wq, zp, far_ptr, far_q, zf, far_dense, nullptr,
      nullptr, out, nb, B, k, G, static_cast<cudaStream_t>(stream)));
}

// Draw step of local Geary (stat 1) or Getis-Ord Gi* (2) / Gi (3), in
// place; far edges as row pointers. obs is int32 [Npad, G] (f32 for Gi);
// the tail operands are as struct Tail documents; alt: 0 two-sided,
// 1 greater, 2 less.
extern "C" int sct_local_count(int stat, int alt, const int32_t* local_idx,
                               const int8_t* wq, const int8_t* zp,
                               const int32_t* far_ptr, const int8_t* far_q,
                               const int8_t* zf, const void* obs, void* cnt,
                               const int32_t* row_i, const float* row_f,
                               const float* col_a, const float* col_b,
                               const int32_t* lag_o, const int8_t* me_o,
                               float inv_m, int nb, int B, int k, int G,
                               int cnt_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Tail t{row_i, row_f, col_a, col_b, lag_o, me_o, inv_m, alt};
  const int32_t* ob = static_cast<const int32_t*>(obs);
  cudaError_t err;
  switch (cnt_bytes) {
    case 1:
      err = by_stat<true, int8_t>(stat, local_idx, wq, zp, far_ptr, far_q, zf,
          ob, static_cast<int8_t*>(cnt), nullptr, t, nb, B, k, G, s);
      break;
    case 2:
      err = by_stat<true, int16_t>(stat, local_idx, wq, zp, far_ptr, far_q, zf,
          ob, static_cast<int16_t*>(cnt), nullptr, t, nb, B, k, G, s);
      break;
    case 4:
      err = by_stat<true, int32_t>(stat, local_idx, wq, zp, far_ptr, far_q, zf,
          ob, static_cast<int32_t*>(cnt), nullptr, t, nb, B, k, G, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// Observed pass of local Geary (stat 1: the int32 geary value, row_i = W)
// or Getis-Ord (stat 2 or 3: the binary lag) at the placement in zp.
extern "C" int sct_local_observed(int stat, const int32_t* local_idx,
                                  const int8_t* wq, const int8_t* zp,
                                  const int32_t* far_ptr, const int8_t* far_q,
                                  const int8_t* zf, const int32_t* row_i,
                                  int32_t* out, int nb, int B, int k, int G,
                                  void* stream) {
  Tail t{};
  t.row_i = row_i;
  return static_cast<int>(by_stat<false, int8_t>(
      stat, local_idx, wq, zp, far_ptr, far_q, zf, nullptr, nullptr, out, t,
      nb, B, k, G, static_cast<cudaStream_t>(stream)));
}
