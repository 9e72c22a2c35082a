// The far-edge cross and Geary's degree term of the float global null
// (bf16 / f32 values, float32 sums), one launch a draw: for every gene g of
// the draw's gathered table Zp,
//
//   far[g] = sum_e w_e * z[src_e][g] * z[dst_e][g]     over the live far edges
//   sq[g]  = sum_i rc_i * z[B + i][g]^2                 rows [B, B + Npad), Geary only
//
// It replaces no Pallas kernel. The reference's _banded_stat
// (spatialcore_tpu/ops/banded.py) leaves both terms to XLA: an einsum over
// the far list and a matrix-vector product with (r + c). The port ran them
// as torch ops (kernels/global_terms.py, global_terms_plain): two far
// gathers into [F, G] float32 copies over the list's power-of-two capacity
// F, two products, a pairwise sum of log2(F) halving adds, and for Geary a
// float32 copy of the whole table, its square and a matrix-vector product:
// ~25 launches and several GB of temporaries a draw.
//
// What bounds it on the H100: bytes. The least it reads is each Zp row the
// terms touch, once: for Moran's I the rows of the far edges' sources and
// targets (at 1M kNN cells, k = 6: ~250k edges on ~400k rows x 512 bf16
// genes, ~0.4 GB, ~0.12 ms at 3.35 TB/s), for Geary's C every row (1M x
// 512 bf16, 1.07 GB, ~0.32 ms) plus the list (12 bytes an edge). Its work,
// three float32 operations an edge and gene, is far below the CUDA cores'
// rate.
//
// Design. One grid of two kinds of CTAs: the first far_ctas walk the far
// list, the other sq_ctas walk the table's own rows; each CTA takes an
// equal contiguous share of its list (split between the two kinds by the
// rows each reads), and each of its warps an equal contiguous share of
// that. The list is row-major, so a warp's consecutive edges often share a
// source row, which the second read then finds in L1 or L2.
// - A warp works on one row (or edge) at a time across a gene tile of 64
//   16-byte vectors (512 bf16 or 256 f32 genes): lane l holds vectors l and
//   l + 32, as float32 sums in registers, so a row segment is two
//   contiguous 512-byte reads. Where a row is not a whole number of 16-byte
//   vectors (odd G), lanes take single elements instead (64 genes a tile).
//   Wider tables take more tiles: the grid's second dimension.
// - A warp loads 4 edges' (rows') indices and vectors before it adds any,
//   so ~8 KB a warp is in flight; 16 warps an SM cover the latency of
//   random 1-KB rows.
// - Products round where the plain version rounds: the weight to the
//   table's dtype, then (w * z_src) * z_dst, each a rounded float32
//   multiply; the degree term adds rc * (z * z) by a fused multiply-add.
//   The sums run in another order than the plain version's pairwise one:
//   the check that holds the kernel is 1e-5 * sum|terms|.
// - No float atomics. Each CTA sums its warps in warp order into one
//   partial row [G]; the last CTA of a gene tile to finish (an integer
//   ticket, reset by that CTA for the next launch) sums the partial rows in
//   CTA order, in 8 interleaved chains joined in a fixed order, and writes
//   the two terms. A gene's sums never depend on G, the tile or the vector
//   width, so a launch is bitwise reproducible and a block of genes gives
//   the whole table's values.
// - A row with rc = 0 (padding, isolated cells) is not read: its term is 0
//   for every finite table.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVecs = 2;                  // vectors of a row a lane holds
constexpr int kTileVecs = 32 * kVecs;     // vectors of a gene tile
constexpr int kUnroll = 4;                // edges (rows) a warp loads at once
constexpr int kChains = 8;                // the final sum's interleaved chains

// A row's unit of load: 16 bytes (kN genes), or one element.
template <int kEsz, bool kVec16>
struct Vec;

template <>
struct Vec<2, true> {
  using Raw = uint4;
  static constexpr int kN = 8;
  static __device__ __forceinline__ void to_float(const Raw& r, float* f) {
    const unsigned int u[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(u[i] << 16);
      f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
    }
  }
};

template <>
struct Vec<4, true> {
  using Raw = uint4;
  static constexpr int kN = 4;
  static __device__ __forceinline__ void to_float(const Raw& r, float* f) {
    f[0] = __uint_as_float(r.x);
    f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z);
    f[3] = __uint_as_float(r.w);
  }
};

template <>
struct Vec<2, false> {
  using Raw = unsigned short;
  static constexpr int kN = 1;
  static __device__ __forceinline__ void to_float(const Raw& r, float* f) {
    f[0] = __uint_as_float(static_cast<unsigned int>(r) << 16);
  }
};

template <>
struct Vec<4, false> {
  using Raw = float;
  static constexpr int kN = 1;
  static __device__ __forceinline__ void to_float(const Raw& r, float* f) { f[0] = r; }
};

// The weight as the plain version multiplies it: rounded to the table's
// dtype (round to nearest even), then widened.
template <int kEsz>
__device__ __forceinline__ float table_weight(float w) {
  if constexpr (kEsz == 2) {
    return __bfloat162float(__float2bfloat16_rn(w));
  } else {
    return w;
  }
}

struct Args {
  const unsigned char* zp;  // the draw's table, row_bytes a row
  long long row_bytes;
  const int32_t* src;       // [n_far] Zp row of each live far edge's source
  const int32_t* dst;       // [n_far] ... and of its target
  const float* w;           // [n_far] its weight
  long long n_far;
  const float* rc;          // [n_rows] r_i + c_i of padded row i (Zp row row0 + i)
  long long n_rows;
  int row0;
  float* partial;           // [far_ctas + sq_ctas, G]
  float* out;               // [2, G]: far, then sq (written when sq_ctas > 0)
  unsigned int* sem;        // [gridDim.y] CTAs of a gene tile finished
  int G;
  int n_vec;                // units of load a row
  int far_ctas;
  int sq_ctas;
};

template <int kEsz, bool kVec16>
__global__ void __launch_bounds__(kThreads, 2) global_terms_kernel(const Args a) {
  using V = Vec<kEsz, kVec16>;
  using Raw = typename V::Raw;
  constexpr int kN = V::kN;
  __shared__ float red[kWarps][kTileVecs * kN];
  __shared__ unsigned int ticket;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int v0 = blockIdx.y * kTileVecs;
  bool live[kVecs];
#pragma unroll
  for (int j = 0; j < kVecs; ++j) live[j] = v0 + lane + 32 * j < a.n_vec;
  float acc[kVecs][kN];
#pragma unroll
  for (int j = 0; j < kVecs; ++j)
#pragma unroll
    for (int q = 0; q < kN; ++q) acc[j][q] = 0.f;

  auto load = [&](long long row, int j) -> Raw {
    const Raw* p = reinterpret_cast<const Raw*>(a.zp + row * a.row_bytes);
    return __ldg(p + v0 + lane + 32 * j);
  };

  const bool far = static_cast<int>(blockIdx.x) < a.far_ctas;
  const long long n = far ? a.n_far : a.n_rows;
  const long long ways = static_cast<long long>(far ? a.far_ctas : a.sq_ctas) * kWarps;
  const long long wi =
      static_cast<long long>(far ? blockIdx.x : blockIdx.x - a.far_ctas) * kWarps + warp;
  const long long e0 = n * wi / ways, e1 = n * (wi + 1) / ways;

  if (far) {
    for (long long e = e0; e < e1; e += kUnroll) {
      int s[kUnroll], d[kUnroll];
      float wt[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const bool ok = e + u < e1;
        s[u] = ok ? __ldg(a.src + e + u) : -1;
        d[u] = ok ? __ldg(a.dst + e + u) : 0;
        wt[u] = ok ? table_weight<kEsz>(__ldg(a.w + e + u)) : 0.f;
      }
      Raw rs[kUnroll][kVecs], rd[kUnroll][kVecs];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int j = 0; j < kVecs; ++j)
          if (s[u] >= 0 && live[j]) {
            rs[u][j] = load(s[u], j);
            rd[u][j] = load(d[u], j);
          }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int j = 0; j < kVecs; ++j)
          if (s[u] >= 0 && live[j]) {
            float fs[kN], fd[kN];
            V::to_float(rs[u][j], fs);
            V::to_float(rd[u][j], fd);
#pragma unroll
            for (int q = 0; q < kN; ++q)
              acc[j][q] += __fmul_rn(__fmul_rn(wt[u], fs[q]), fd[q]);
          }
    }
  } else {
    for (long long i = e0; i < e1; i += kUnroll) {
      float r[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) r[u] = i + u < e1 ? __ldg(a.rc + i + u) : 0.f;
      Raw z[kUnroll][kVecs];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int j = 0; j < kVecs; ++j)
          if (r[u] != 0.f && live[j]) z[u][j] = load(a.row0 + i + u, j);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int j = 0; j < kVecs; ++j)
          if (r[u] != 0.f && live[j]) {
            float f[kN];
            V::to_float(z[u][j], f);
#pragma unroll
            for (int q = 0; q < kN; ++q) acc[j][q] = fmaf(r[u], __fmul_rn(f[q], f[q]), acc[j][q]);
          }
    }
  }

  // the CTA's partial row: its warps summed in warp order
#pragma unroll
  for (int j = 0; j < kVecs; ++j)
    if (live[j])
#pragma unroll
      for (int q = 0; q < kN; ++q) red[warp][(lane + 32 * j) * kN + q] = acc[j][q];
  __syncthreads();
  const int g0 = v0 * kN;
  const int genes = min(kTileVecs * kN, a.G - g0);
  float* part = a.partial + static_cast<size_t>(blockIdx.x) * a.G + g0;
  for (int t = threadIdx.x; t < genes; t += kThreads) {
    float s = red[0][t];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s += red[w][t];
    part[t] = s;
  }

  // the last CTA of the tile sums the partial rows in CTA order
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) ticket = atomicAdd(a.sem + blockIdx.y, 1u);
  __syncthreads();
  if (ticket != gridDim.x - 1) return;
  __threadfence();
  auto rows_sum = [&](int c0, int c1, int g) {
    float c[kChains];
#pragma unroll
    for (int k = 0; k < kChains; ++k) c[k] = 0.f;
    int r = c0;
    for (; r + kChains <= c1; r += kChains)
#pragma unroll
      for (int k = 0; k < kChains; ++k)
        c[k] += __ldcg(a.partial + static_cast<size_t>(r + k) * a.G + g);
#pragma unroll
    for (int k = 0; k < kChains; ++k)
      if (r + k < c1) c[k] += __ldcg(a.partial + static_cast<size_t>(r + k) * a.G + g);
    return ((c[0] + c[1]) + (c[2] + c[3])) + ((c[4] + c[5]) + (c[6] + c[7]));
  };
  for (int t = threadIdx.x; t < genes; t += kThreads) {
    const int g = g0 + t;
    a.out[g] = rows_sum(0, a.far_ctas, g);
    if (a.sq_ctas > 0) a.out[a.G + g] = rows_sum(a.far_ctas, a.far_ctas + a.sq_ctas, g);
  }
  if (threadIdx.x == 0) a.sem[blockIdx.y] = 0u;
}

template <int kEsz, bool kVec16>
cudaError_t launch(const Args& a, cudaStream_t s) {
  const int n_tiles = (a.n_vec + kTileVecs - 1) / kTileVecs;
  global_terms_kernel<kEsz, kVec16>
      <<<dim3(a.far_ctas + a.sq_ctas, n_tiles), kThreads, 0, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

// zp: the draw's table [rows, G], bf16 (is_bf16) or f32, 16-byte aligned
// where vec16; src, dst, w: the live far list [n_far]; rc [n_rows], the
// degree weights of Zp rows row0 ..; partial float [far_ctas + sq_ctas, G];
// out float [2, G]; sem: one zeroed counter a gene tile, zero again after
// the launch. far_ctas + sq_ctas >= 1.
extern "C" int sct_global_terms(const void* zp, const int32_t* src, const int32_t* dst,
                                const float* w, long long n_far, const float* rc,
                                long long n_rows, int row0, float* partial, float* out,
                                unsigned int* sem, int G, int is_bf16, int vec16, int far_ctas,
                                int sq_ctas, void* stream) {
  Args a{};
  a.zp = static_cast<const unsigned char*>(zp);
  a.row_bytes = static_cast<long long>(G) * (is_bf16 ? 2 : 4);
  a.src = src;
  a.dst = dst;
  a.w = w;
  a.n_far = n_far;
  a.rc = rc;
  a.n_rows = n_rows;
  a.row0 = row0;
  a.partial = partial;
  a.out = out;
  a.sem = sem;
  a.G = G;
  a.n_vec = vec16 ? static_cast<int>(a.row_bytes / 16) : G;
  a.far_ctas = far_ctas;
  a.sq_ctas = sq_ctas;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (is_bf16)
    err = vec16 ? launch<2, true>(a, s) : launch<2, false>(a, s);
  else
    err = vec16 ? launch<4, true>(a, s) : launch<4, false>(a, s);
  return static_cast<int>(err);
}
