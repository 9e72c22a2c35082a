// Exact 2D k-nearest neighbours over all pairs, with a running top-k.
//
// Replaces the Pallas kernel K9 (spatialcore_tpu/ops/pallas_knn.py,
// _knn_kernel): for every query q of n points, the k candidates c != q (or
// any c with include_self) of smallest
//
//   d2 = (qx - cx)^2 + (qy - cy)^2      (each operation rounded once)
//
// sorted by (d2, candidate id). That is the reference's order: its pool is
// the previous best, then the candidate tile in id order, and each minimum
// takes the first lane among equals, so an equal distance keeps the lower
// id.
//
// Design:
// - One thread per query, 128 queries per block. Candidate tiles of 1,024
//   points (8 KB of float2) stream through shared memory in increasing id
//   order; every thread reads the same candidate at once (a broadcast).
// - Each thread keeps its k best sorted by (d2, id) and the k-th distance
//   in a register. A candidate enters only if d2 < k-th (strict): it
//   arrives after every candidate of lower id, so on an equal distance the
//   entry already held wins, as in the reference. It goes in after the
//   entries it does not beat, and the last entry drops out.
// - k is bounded by a template parameter KMAX (8, 16, 32, 64, 128, 256).
//   Up to 16 the list lives in registers (a fully unrolled insertion, no
//   dynamic index); above it in local memory (L1-cached), with a plain
//   insertion shift. The k = 50 of the reference vignette (51 with self)
//   takes KMAX = 64.
// - d2 is written with __fsub_rn / __fmul_rn / __fadd_rn, so nvcc contracts
//   nothing into an FMA and the distances are bitwise the plain version's.
//
// What bounds it on the H100: operations. The function needs 6 FP32
// operations per pair (2 sub, 2 mul, 1 add, 1 compare): 6*n^2, ~0.09 s at
// 1M points over 67 TFLOP/s; its bytes (8n in, 8nk out) are negligible.
// This first kernel is right and simple: one query per thread and no
// pruning of far tiles. Later work: spatial bucketing of the candidate
// stream, several queries per thread.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kQueries = 128;       // threads per block, one query each
constexpr int kTile = 1024;         // candidates per shared-memory tile

// Register list: every index is a compile-time constant after unrolling.
template <int KMAX>
__device__ __forceinline__ void insert_reg(float (&ld)[KMAX], int (&li)[KMAX],
                                           int k, float d, int id,
                                           float& kth) {
  bool moved = false;
  float cd = d;
  int ci = id;
#pragma unroll
  for (int p = 0; p < KMAX; ++p) {
    if (p < k) {
      if (moved || cd < ld[p]) {        // once in, every later entry shifts
        const float td = ld[p];
        const int ti = li[p];
        ld[p] = cd;
        li[p] = ci;
        cd = td;
        ci = ti;
        moved = true;
      }
      if (p == k - 1) kth = ld[p];
    }
  }
}

// Local-memory list: shift the entries it beats one place down.
__device__ __forceinline__ void insert_mem(float* ld, int* li, int k, float d,
                                           int id, float& kth) {
  int p = k - 1;
  while (p > 0 && ld[p - 1] > d) {
    ld[p] = ld[p - 1];
    li[p] = li[p - 1];
    --p;
  }
  ld[p] = d;
  li[p] = id;
  kth = ld[k - 1];
}

template <int KMAX>
__global__ void __launch_bounds__(kQueries)
knn_kernel(const float2* __restrict__ xy, int n, int k, int include_self,
           float* __restrict__ out_d, int32_t* __restrict__ out_i) {
  __shared__ float2 tile[kTile];
  const int q = blockIdx.x * kQueries + threadIdx.x;
  const bool live = q < n;
  const float2 me = live ? xy[q] : make_float2(0.f, 0.f);
  float ld[KMAX];
  int li[KMAX];
#pragma unroll
  for (int p = 0; p < KMAX; ++p) {
    ld[p] = INFINITY;
    li[p] = -1;
  }
  float kth = INFINITY;
  for (int t0 = 0; t0 < n; t0 += kTile) {
    const int count = min(kTile, n - t0);
    __syncthreads();                    // the previous tile is consumed
    for (int i = threadIdx.x; i < count; i += kQueries) tile[i] = xy[t0 + i];
    __syncthreads();
    if (!live) continue;
    for (int i = 0; i < count; ++i) {
      const float2 c = tile[i];
      const float dx = __fsub_rn(me.x, c.x);
      const float dy = __fsub_rn(me.y, c.y);
      const float d2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
      const int id = t0 + i;
      if (d2 < kth && (include_self || id != q)) {
        if constexpr (KMAX <= 16) {
          insert_reg<KMAX>(ld, li, k, d2, id, kth);
        } else {
          insert_mem(ld, li, k, d2, id, kth);
        }
      }
    }
  }
  if (!live) return;
  const size_t o = static_cast<size_t>(q) * k;
  if constexpr (KMAX <= 16) {
#pragma unroll
    for (int p = 0; p < KMAX; ++p) {
      if (p < k) {
        out_d[o + p] = ld[p];
        out_i[o + p] = li[p];
      }
    }
  } else {
    for (int p = 0; p < k; ++p) {
      out_d[o + p] = ld[p];
      out_i[o + p] = li[p];
    }
  }
}

template <int KMAX>
cudaError_t launch(const float* xy, int n, int k, int include_self,
                   float* out_d, int32_t* out_i, cudaStream_t stream) {
  const int blocks = (n + kQueries - 1) / kQueries;
  knn_kernel<KMAX><<<blocks, kQueries, 0, stream>>>(
      reinterpret_cast<const float2*>(xy), n, k, include_self, out_d, out_i);
  return cudaGetLastError();
}

}  // namespace

// xy f32 [n, 2] (8-byte aligned); out_d f32 [n, k] squared distances and
// out_i int32 [n, k] candidate ids, each row sorted by (d2, id).
// 1 <= k <= 256 and k < n (k <= n - 1 without self).
extern "C" int sct_knn(const float* xy, int n, int k, int include_self,
                       float* out_d, int32_t* out_i, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 1 || k < 1 || k >= n) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (k <= 8) {
    err = launch<8>(xy, n, k, include_self, out_d, out_i, s);
  } else if (k <= 16) {
    err = launch<16>(xy, n, k, include_self, out_d, out_i, s);
  } else if (k <= 32) {
    err = launch<32>(xy, n, k, include_self, out_d, out_i, s);
  } else if (k <= 64) {
    err = launch<64>(xy, n, k, include_self, out_d, out_i, s);
  } else if (k <= 128) {
    err = launch<128>(xy, n, k, include_self, out_d, out_i, s);
  } else if (k <= 256) {
    err = launch<256>(xy, n, k, include_self, out_d, out_i, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
