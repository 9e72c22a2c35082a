// Band cross of the global permutation null on the DENSE band, one draw per
// launch, in bf16 or f32:
//
//   cross[g] = sum_i z1_i[g] * lag_i[g],   lag = A[n] @ window(n)
//
// One main loop serves two kernels, each replacing one Pallas kernel of
// spatialcore_tpu/ops/banded.py:
//
// K5, sct_band_cross_dense (replaces _band_cross_kernel, :385, behind
//   _band_cross_pallas, :424). A[nb, B, 3B]; block n's window is the three
//   B-row slabs n, n+1, n+2 of the flat value table Zp [(nb+2)*B, G]: A's
//   column c multiplies Zp row n*B + c.
// K6, sct_band_cross_rot4 (replaces _band_halo_kernel_rot4, :557, behind
//   _band_cross_pallas_halo4, :635). A4[nb, B, 4B] from _build_band_rot4:
//   column block s multiplies the ring slot s, which holds slab
//   n + (s - n) mod 4 (kernels/band_cross.rot4_slabs); a slab past the
//   table reads as zeros. The block no window slab covers is zero in every
//   A4 that _build_band_rot4 makes.
// Own rows (z1) are slab n+1 in both.
//
// What bounds them on the H100. The band is 99% zero (0.8% nonzero at
// B=256, k=6): 11.7% of K5's 16x16 tiles of A hold a weight, 8.8% of K6's.
// Multiplying every tile is 1.57e12 (K5) / 2.10e12 (K6) operations at 1M
// cells x 1,024 bf16 genes, >= 1.59 / 2.12 ms on the tensor cores; the
// nonzero 16x16 tiles alone need ~0.2 ms. So once the zero tiles are
// skipped the bound is bytes: A and Zp read once, 1.07 / 1.22 ms there.
// f32 has no tensor-core route that keeps full precision (TF32's 10-bit
// mantissa breaks the 1e-5 * sum|terms| check), so it runs FFMA on the
// CUDA cores (67 TFLOP/s), where skipping is the whole lever.
//
// Design. A CTA owns one row tile of MT rows (16, 32 or 64) of one band
// block and walks every gene tile of Gt genes (512 bytes of a row: 256
// bf16, 128 f32); the grid is flat, one CTA per (block, row tile), so any
// nb fits.
// - The row tile of A, [MT, W*B], is copied into shared memory ONCE by
//   cp.async and serves every gene tile: A crosses L2 once, not once per
//   gene tile.
// - Skipping. Once the tile has landed, each thread takes one 16x16 tile
//   (16 rows of a warp's row group x one k16 step) and tests whether any
//   weight in it is nonzero; one warp then lists the k16 steps that some
//   row group needs, each with its row-group mask and the first Zp row of
//   its window slice (computed once, so the loop divides nothing). Only
//   those steps' window slices [16 rows, Gt] are copied, and a warp whose
//   16x16 tile is zero skips the step's MMA (bf16) or FMAs (f32). K6's
//   fourth column block is zero, so its slices are never copied and never
//   multiplied. `skip` = 0 lists every step and multiplies every tile (for
//   timing). A skipped tile contributes nothing, also where the window
//   holds an Inf or NaN that the plain version's 0 * Inf turns into NaN.
// - The list ends with the row tile's own rows (z1), one 16-row slice per
//   row group, which stream through the same ring: when one lands, the lag
//   of that row group is complete, and its warps multiply it by z1 from
//   shared memory. No z1 load waits on global memory in the epilogue.
// - Copies: S stages of two slices (S = 2..4) by 16-byte cp.async,
//   zero-filled past G or past the table (K6's slab nb+2): S-1 stages in
//   flight while one is multiplied, one barrier a stage. A slice is 16
//   consecutive rows of Zp, since B is a multiple of 16 and a k16 step
//   never straddles a slab. Rows that are not whole 16-byte chunks (G * esz
//   % 16 != 0) take element loads (the VEC = false instance).
// - bf16: mma.sync m16n8k16 (bf16 in, f32 accumulate) fed by ldmatrix
//   (A row-major, the window through .trans), 8 warps as (MT/16) row
//   groups x (8 / (MT/16)) column groups. It skips at 16 x 16, the tile of
//   one MMA's K step and one warp's rows; wgmma's 64-row tiles would skip
//   at 64 x 16 (twice the tiles kept), and the tensor cores' rate is not
//   what holds this kernel back (its time barely moves with the MMAs gone).
// - f32: FFMA, a lane holding 2 rows x 4 genes per 16 genes of its warp.
// - Sums: per gene tile, z1 * lag summed over the tile's rows in a fixed
//   order (a shuffle tree within a warp, then the row groups in order) into
//   the CTA's own partial row [n*T + t, G]; the wrapper sums the partials
//   in a fixed order. No atomics: bitwise reproducible run to run.
// - Ragged edges: genes past G load as zeros and are not stored; rows of
//   the row tile past B are zero (so skipped), and their own-row slice
//   reads as zeros.
//
// What it re-reads: each window slice once per row tile that needs it, per
// gene tile (from L2: the CTAs of neighbouring blocks run together, so Zp
// crosses HBM about once). K5 and K6 share the loop; K6's ring of slabs is
// only an address map here (slot s holds slab n + (s - n) mod 4), because
// a shared-memory ring of 4B rows would cap the gene tile at 64 bf16 and
// bring back A's re-reads. The launch shape (MT, S and the skip) comes
// from kernels/band_cross.dense_tiles, mirrored by dense_smem_bytes.

#include <cuda_bf16.h>

#include <type_traits>

#include "slab_ring.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;           // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSteps = 64;           // k16 steps of A's row: W*B/16 <= 4*256/16
constexpr int kMaxList = kMaxSteps + 4; // ... and up to 4 own-row slices
constexpr size_t kSmemMax = 232448;     // 227 KB a block may use on sm_90
constexpr unsigned kOwn = 0x8000;       // list entry: an own-row (z1) slice
constexpr int kGtBytes = 512;           // bytes of a row in a gene tile
constexpr int kPer = 2;                 // window slices a pipeline stage

template <typename T>
struct Cfg {
  static constexpr int esz = sizeof(T);
  static constexpr int Gt = kGtBytes / esz;       // genes per gene tile
  static constexpr int pad = 16 / esz;            // 16 bytes a row: no ldmatrix conflicts
  static constexpr int ldW = Gt + pad;
  static constexpr int VE = 16 / esz;             // elements of one 16-byte copy
  static constexpr int TPR = kGtBytes / 16;       // 16-byte copies a slice row
  static constexpr int CPT = 16 * TPR / kThreads; // ... a thread a slice
  static constexpr int SLICE = 16 * ldW;          // elements of a slice slot
};

__host__ __device__ constexpr size_t align16(size_t b) { return (b + 15) / 16 * 16; }

// Shared-memory layout, mirrored by band_cross.dense_smem_bytes: A's row
// tile [MT][W*B + pad]; the ring of S stages of kPer slices [16][ldW];
// the row groups' sums [MT/16][Gt] f32; the list's first Zp rows
// [kMaxList] int; the 16x16 tile flags [4][kMaxSteps]; the list
// [kMaxList] and its length.
template <typename T>
__host__ __device__ constexpr size_t smem_bytes(int MT, int KA, int S) {
  using C = Cfg<T>;
  return align16(static_cast<size_t>(MT) * (KA + C::pad) * sizeof(T)) +
         static_cast<size_t>(S) * kPer * C::SLICE * sizeof(T) +
         static_cast<size_t>(MT / 16) * C::Gt * 4 + 4 * kMaxList + 4 * kMaxSteps +
         2 * kMaxList + 16;
}

template <typename T>
__device__ __forceinline__ T zero_of();
template <>
__device__ __forceinline__ float zero_of<float>() { return 0.f; }
template <>
__device__ __forceinline__ bf16 zero_of<bf16>() { return __float2bfloat16(0.f); }

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// Per-warp arithmetic: lag[16 rows, CW genes] += A[16 rows, 16] @
// slice[16, CW genes] for one k16 step; and the epilogue, sum over the
// warp's 16 rows of z1 * lag with z1 read from an own-row slice.
// ---------------------------------------------------------------------------

// bf16: CW / 8 m16n8k16 accumulators. Fragment layout (PTX ISA): lane
// (g = lane/4, t = lane%4) holds rows g, g+8 and columns 2t, 2t+1.
template <int CW, int LDW>
struct WarpMma {
  static constexpr int NT = CW / 8;
  static_assert(NT % 2 == 0, "ldmatrix.x4.trans loads two n8 tiles");
  float acc[NT][4];

  __device__ void zero() {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
  }

  // a: this lane's ldmatrix row of A at the step's first column; w: this
  // lane's ldmatrix.trans row of the slice at the warp's first gene.
  __device__ void step(const bf16* a, const bf16* w) {
    unsigned a0, a1, a2, a3;
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(a0), "=r"(a1), "=r"(a2), "=r"(a3)
                 : "r"(smem_u32(a))
                 : "memory");
#pragma unroll
    for (int jj = 0; jj < NT / 2; ++jj) {
      unsigned b0, b1, b2, b3;
      asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                   : "=r"(b0), "=r"(b1), "=r"(b2), "=r"(b3)
                   : "r"(smem_u32(w + jj * 16))
                   : "memory");
      mma(acc[2 * jj], a0, a1, a2, a3, b0, b1);
      mma(acc[2 * jj + 1], a0, a1, a2, a3, b2, b3);
    }
  }

  __device__ static void mma(float* c, unsigned a0, unsigned a1, unsigned a2, unsigned a3,
                             unsigned b0, unsigned b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  }

  // z: the own-row slice at the warp's first gene (rows of the row group);
  // red[c] = sum over the 16 rows of z1 * lag for the warp's CW genes.
  __device__ void reduce(const bf16* z, float* red, int lane) const {
    const int g = lane / 4, t = lane % 4;
    float v[NT][2];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const unsigned lo = *reinterpret_cast<const unsigned*>(z + g * LDW + 8 * j + 2 * t);
      const unsigned hi = *reinterpret_cast<const unsigned*>(z + (g + 8) * LDW + 8 * j + 2 * t);
      v[j][0] = acc[j][0] * __uint_as_float(lo << 16) + acc[j][2] * __uint_as_float(hi << 16);
      v[j][1] = acc[j][1] * __uint_as_float(lo & 0xffff0000u) +
                acc[j][3] * __uint_as_float(hi & 0xffff0000u);
    }
#pragma unroll
    for (int m = 4; m < 32; m *= 2)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) v[j][h] += __shfl_xor_sync(0xffffffffu, v[j][h], m);
    if (g == 0)
#pragma unroll
      for (int j = 0; j < NT; ++j)
        *reinterpret_cast<float2*>(red + 8 * j + 2 * t) = make_float2(v[j][0], v[j][1]);
  }
};

// f32: lane (p = lane/4, q = lane%4) holds rows 2p, 2p+1 and, for each
// 16-gene group j of the warp, genes 16j + 4q .. 16j + 4q + 3.
template <int CW, int LDW>
struct WarpFma {
  static constexpr int NQ = CW / 16;
  static_assert(NQ >= 1, "a warp covers at least 16 genes");
  float acc[2][NQ][4];

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;
  }

  // a: this lane's first A row at the step's first column; w: this lane's
  // first gene in row 0 of the slice.
  __device__ void step(const float* a, int ldA, const float* w) {
#pragma unroll
    for (int kk = 0; kk < 16; kk += 4) {
      const float4 x0 = *reinterpret_cast<const float4*>(a + kk);
      const float4 x1 = *reinterpret_cast<const float4*>(a + ldA + kk);
      const float r0[4] = {x0.x, x0.y, x0.z, x0.w};
      const float r1[4] = {x1.x, x1.y, x1.z, x1.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
#pragma unroll
        for (int j = 0; j < NQ; ++j) {
          const float4 b = *reinterpret_cast<const float4*>(w + (kk + k) * LDW + 16 * j);
          acc[0][j][0] = fmaf(r0[k], b.x, acc[0][j][0]);
          acc[0][j][1] = fmaf(r0[k], b.y, acc[0][j][1]);
          acc[0][j][2] = fmaf(r0[k], b.z, acc[0][j][2]);
          acc[0][j][3] = fmaf(r0[k], b.w, acc[0][j][3]);
          acc[1][j][0] = fmaf(r1[k], b.x, acc[1][j][0]);
          acc[1][j][1] = fmaf(r1[k], b.y, acc[1][j][1]);
          acc[1][j][2] = fmaf(r1[k], b.z, acc[1][j][2]);
          acc[1][j][3] = fmaf(r1[k], b.w, acc[1][j][3]);
        }
      }
    }
  }

  // z: the own-row slice at the warp's first gene
  __device__ void reduce(const float* z, float* red, int lane) const {
    const int p = lane / 4, q = lane % 4;
    float v[NQ][4];
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      const float4 z0 = *reinterpret_cast<const float4*>(z + (2 * p) * LDW + 16 * j + 4 * q);
      const float4 z1 = *reinterpret_cast<const float4*>(z + (2 * p + 1) * LDW + 16 * j + 4 * q);
      v[j][0] = acc[0][j][0] * z0.x + acc[1][j][0] * z1.x;
      v[j][1] = acc[0][j][1] * z0.y + acc[1][j][1] * z1.y;
      v[j][2] = acc[0][j][2] * z0.z + acc[1][j][2] * z1.z;
      v[j][3] = acc[0][j][3] * z0.w + acc[1][j][3] * z1.w;
    }
#pragma unroll
    for (int m = 4; m < 32; m *= 2)
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) v[j][c] += __shfl_xor_sync(0xffffffffu, v[j][c], m);
    if (p == 0)
#pragma unroll
      for (int j = 0; j < NQ; ++j)
        *reinterpret_cast<float4*>(red + 16 * j + 4 * q) = make_float4(v[j][0], v[j][1], v[j][2], v[j][3]);
  }
};

// ---------------------------------------------------------------------------
// The kernel: W window slabs (3: K5, 4: K6), MT rows a CTA, S stages of kPer
// slices; VEC: Zp's rows are whole 16-byte chunks
// ---------------------------------------------------------------------------

template <typename T, int W, int MT, int S, bool VEC>
__global__ void __launch_bounds__(kThreads, 2)
band_cross_dense_kernel(const T* __restrict__ A, const T* __restrict__ zp,
                        float* __restrict__ partial, int nb, int B, int G, int skip) {
  using C = Cfg<T>;
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr int WR = MT / 16;                   // row groups of 16
  constexpr int WC = kWarps / WR;               // column groups
  constexpr int CW = C::Gt / WC;                // genes a warp
  using Warp = typename std::conditional<kBf16, WarpMma<CW, C::ldW>, WarpFma<CW, C::ldW>>::type;

  extern __shared__ __align__(128) unsigned char smem[];
  const int KA = W * B;
  const int ldA = KA + C::pad;
  const int KS = KA / 16;                       // k16 steps of a row
  T* sA = reinterpret_cast<T*>(smem);
  T* ring = reinterpret_cast<T*>(smem + align16(static_cast<size_t>(MT) * ldA * sizeof(T)));
  float* red = reinterpret_cast<float*>(ring + S * kPer * C::SLICE);
  int* zrow = reinterpret_cast<int*>(red + WR * C::Gt);    // an entry's first Zp row
  unsigned char* flag = reinterpret_cast<unsigned char*>(zrow + kMaxList);
  uint16_t* list = reinterpret_cast<uint16_t*>(flag + 4 * kMaxSteps);
  int* n_list = reinterpret_cast<int*>(list + kMaxList);

  const int T_ = (B + MT - 1) / MT;             // row tiles a block
  const int n = blockIdx.x / T_;
  const int r0 = (blockIdx.x - n * T_) * MT;    // first row of the tile in the block
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wr = warp % WR, wc = warp / WR;

  // A's row tile, once, a warp a row: rows past B are zeros
  {
    const T* A_blk = A + (static_cast<size_t>(n) * B + r0) * KA;
    for (int r = warp; r < MT; r += kWarps) {
      const bool in = r0 + r < B;
      for (int c = lane * C::VE; c < KA; c += 32 * C::VE)
        cp_async16(sA + r * ldA + c, in ? A_blk + static_cast<size_t>(r) * KA + c : A, in ? 16 : 0);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  }
  // flag each 16x16 tile (row group rg, step s) that holds a nonzero weight
  for (int i = threadIdx.x; i < WR * KS; i += kThreads) {
    const int rg = i / KS, s = i - rg * KS;
    uint4 any = make_uint4(0, 0, 0, 0);
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const uint4* p = reinterpret_cast<const uint4*>(sA + (16 * rg + r) * ldA + 16 * s);
#pragma unroll
      for (int h = 0; h < C::esz; ++h) {
        const uint4 x = p[h];
        any.x |= x.x; any.y |= x.y; any.z |= x.z; any.w |= x.w;
      }
    }
    flag[rg * kMaxSteps + s] = !skip || (any.x | any.y | any.z | any.w) != 0;
  }
  __syncthreads();
  // The list a gene tile walks: the steps some row group needs, in order,
  // each with its row-group mask and the Zp row its window slice starts at
  // (-1: K6's slab nb+2, zeros); then the WR own-row slices (z1 of row
  // group k, rows past B zeros), multiplied with the finished lag.
  if (warp == 0) {
    int count = 0;
    for (int base = 0; base < KS; base += 32) {
      const int s = base + lane;
      unsigned m = 0;
      if (s < KS)
#pragma unroll
        for (int rg = 0; rg < WR; ++rg) m |= static_cast<unsigned>(flag[rg * kMaxSteps + s]) << rg;
      const unsigned need = __ballot_sync(0xffffffffu, m != 0);
      if (m) {
        const int i = count + __popc(need & ((1u << lane) - 1));
        const int c0 = 16 * s, slot = c0 / B;
        const int slab = W == 4 ? n + ((slot - n) & 3) : n + slot;   // ring slot -> slab
        list[i] = static_cast<uint16_t>(s | m << 8);
        zrow[i] = slab <= nb + 1 ? slab * B + c0 - slot * B : -1;
      }
      count += __popc(need);
    }
    if (count > 0 && lane < WR) {
      list[count + lane] = static_cast<uint16_t>(kOwn | lane);
      zrow[count + lane] = r0 + 16 * lane < B ? (n + 1) * B + r0 + 16 * lane : -1;
    }
    if (lane == 0) *n_list = count > 0 ? count + WR : 0;
  }
  __syncthreads();
  const int nl = *n_list;
  float* out = partial + static_cast<size_t>(blockIdx.x) * G;
  if (nl == 0) {                                // an all-zero row tile
    for (int g = threadIdx.x; g < G; g += kThreads) out[g] = 0.f;
    return;
  }

  // This thread's 16-byte pieces of a slice: row cr[i], element cc[i]
  int cr[C::CPT], cc[C::CPT];
#pragma unroll
  for (int i = 0; i < C::CPT; ++i) {
    const int v = threadIdx.x + i * kThreads;
    cr[i] = v / C::TPR;
    cc[i] = (v % C::TPR) * C::VE;
  }
  // Stage (gene tile g0, list entries e0 .. e0 + kPer) into ring stage `st`
  auto issue = [&](int g0, int e0, int st) {
    T* dst = ring + st * (kPer * C::SLICE);
    const int left = G - g0;                    // genes of the tile inside G
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      if (e0 + j >= nl) break;
      const int row = zrow[e0 + j];
      if constexpr (VEC) {
        const T* src = zp + static_cast<size_t>(row < 0 ? 0 : row) * G + g0;
#pragma unroll
        for (int i = 0; i < C::CPT; ++i) {
          const bool in = row >= 0 && cc[i] < left;
          cp_async16(dst + j * C::SLICE + cr[i] * C::ldW + cc[i],
                     in ? src + cr[i] * G + cc[i] : zp, in ? 16 : 0);
        }
      } else {
        for (int v = threadIdx.x; v < 16 * C::Gt; v += kThreads) {
          const int r = v / C::Gt, c = v % C::Gt;
          dst[j * C::SLICE + r * C::ldW + c] = row >= 0 && c < left
              ? zp[static_cast<size_t>(row + r) * G + g0 + c] : zero_of<T>();
        }
      }
    }
  };

  // stages in order: gene tile by gene tile, kPer list entries each
  const int n_gt = (G + C::Gt - 1) / C::Gt;
  const int Q = n_gt * ((nl + kPer - 1) / kPer);
  constexpr int D = S - 1;                      // stages in flight
  int ig = 0, ie = 0;                           // next stage to issue: gene, entry
  auto issue_next = [&](int q) {
    if (q < Q) issue(ig, ie, q % S);
    cp_async_commit();
    ie += kPer;
    if (ie >= nl) { ie = 0; ig += C::Gt; }
  };
#pragma unroll 1
  for (int d = 0; d < D; ++d) issue_next(d);

  Warp acc;
  acc.zero();
  // this lane's operand addresses within A's tile and a slice slot
  const T* a_lane;
  int w_off;
  if constexpr (kBf16) {
    a_lane = sA + (16 * wr + lane % 16) * ldA + (lane / 16) * 8;
    w_off = ((lane % 8) + ((lane / 8) % 2) * 8) * C::ldW + (lane / 16) * 8 + wc * CW;
  } else {
    a_lane = sA + (16 * wr + 2 * (lane / 4)) * ldA;
    w_off = 4 * (lane % 4) + wc * CW;
  }
  float* red_w = red + wr * C::Gt + wc * CW;
  const unsigned my_group = 1u << (8 + wr);
  int g0 = 0, e0 = 0;                           // the stage being multiplied
#pragma unroll 1
  for (int q = 0; q < Q; ++q) {
    cp_async_wait<D - 1>();                     // stage q has landed
    __syncthreads();                            // ... for all; stage q-1's slots free
    issue_next(q + D);
    const T* stage = ring + (q % S) * (kPer * C::SLICE);
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      if (e0 + j >= nl) break;
      const unsigned e = list[e0 + j];
      if (e & kOwn) {                           // the lag is complete: z1 * lag
        if ((e & 3) == static_cast<unsigned>(wr)) {
          acc.reduce(stage + j * C::SLICE + wc * CW, red_w, lane);
          acc.zero();
        }
      } else if (e & my_group) {
        if constexpr (kBf16)
          acc.step(a_lane + 16 * (e & 0xff), stage + j * C::SLICE + w_off);
        else
          acc.step(a_lane + 16 * (e & 0xff), ldA, stage + j * C::SLICE + w_off);
      }
    }
    e0 += kPer;
    if (e0 >= nl) {                             // the gene tile's last stage
      __syncthreads();
      if (threadIdx.x < C::Gt && g0 + threadIdx.x < G) {
        float sum = 0.f;
#pragma unroll
        for (int rg = 0; rg < WR; ++rg) sum += red[rg * C::Gt + threadIdx.x];
        out[g0 + threadIdx.x] = sum;
      }
      e0 = 0;
      g0 += C::Gt;
    }
  }
  cp_async_wait<0>();
}

template <typename T, int W, int MT, int S>
cudaError_t launch(const void* A, const void* zp, float* partial, int nb, int B, int G, int skip,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(MT, W * B, S);
  if (smem > kSmemMax || W * B / 16 > kMaxSteps) return cudaErrorInvalidValue;
  const bool vec = (G % Cfg<T>::VE == 0) && (reinterpret_cast<uintptr_t>(zp) % 16 == 0);
  auto kernel = vec ? band_cross_dense_kernel<T, W, MT, S, true>
                    : band_cross_dense_kernel<T, W, MT, S, false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long n_cta = static_cast<long long>(nb) * ((B + MT - 1) / MT);
  if (n_cta > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  kernel<<<static_cast<unsigned>(n_cta), kThreads, smem, stream>>>(
      static_cast<const T*>(A), static_cast<const T*>(zp), partial, nb, B, G, skip);
  return cudaGetLastError();
}

// The launch shapes built (band_cross.DENSE_SHAPES): rows a CTA, stages
template <typename T, int W>
cudaError_t launch_shape(const void* A, const void* zp, float* partial, int nb, int B, int G,
                         int mt, int stages, int skip, cudaStream_t s) {
  if (mt == 32 && stages == 2) return launch<T, W, 32, 2>(A, zp, partial, nb, B, G, skip, s);
  if (mt == 32 && stages == 3) return launch<T, W, 32, 3>(A, zp, partial, nb, B, G, skip, s);
  if (mt == 32 && stages == 4) return launch<T, W, 32, 4>(A, zp, partial, nb, B, G, skip, s);
  if (mt == 16 && stages == 4) return launch<T, W, 16, 4>(A, zp, partial, nb, B, G, skip, s);
  if (mt == 64 && stages == 4) return launch<T, W, 64, 4>(A, zp, partial, nb, B, G, skip, s);
  return cudaErrorInvalidValue;
}

template <int W>
int dispatch(const void* A, const void* zp, float* partial, int nb, int B, int G, int is_bf16,
             int mt, int stages, int skip, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      is_bf16 ? launch_shape<bf16, W>(A, zp, partial, nb, B, G, mt, stages, skip, s)
              : launch_shape<float, W>(A, zp, partial, nb, B, G, mt, stages, skip, s));
}

}  // namespace

// partial: float [nb * ceil(B / mt), G], one row per (block, row tile).
// A [nb, B, 3B] and zp [(nb+2)*B, G], both bf16 (is_bf16) or both f32, A
// 16-byte aligned; B a multiple of 16, at most 256; (mt rows a CTA,
// stages) one of the shapes launch_shape builds; skip 0 multiplies every
// tile.
extern "C" int sct_band_cross_dense(const void* A, const void* zp, float* partial, int nb, int B,
                                    int G, int is_bf16, int mt, int stages, int skip,
                                    void* stream) {
  return dispatch<3>(A, zp, partial, nb, B, G, is_bf16, mt, stages, skip, stream);
}

// As sct_band_cross_dense with A4 [nb, B, 4B] in the rotation-baked layout.
extern "C" int sct_band_cross_rot4(const void* A4, const void* zp, float* partial, int nb, int B,
                                   int G, int is_bf16, int mt, int stages, int skip,
                                   void* stream) {
  return dispatch<4>(A4, zp, partial, nb, B, G, is_bf16, mt, stages, skip, stream);
}
