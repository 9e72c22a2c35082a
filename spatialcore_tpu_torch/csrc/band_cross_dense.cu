// Band cross of the global permutation null on the DENSE band, one draw per
// launch, in bf16 or f32:
//
//   cross[g] = sum_i z1_i[g] * lag_i[g],   lag = A[n] @ window(n)
//
// Two kernels, each replacing one Pallas kernel of
// spatialcore_tpu/ops/banded.py:
//
// K5, sct_band_cross_dense (replaces _band_cross_kernel, :385, behind
//   _band_cross_pallas, :415). A[nb, B, 3B]; block n's window is the three
//   B-row slabs [n*B, n*B + 3B) of the flat value table Zp [(nb+2)*B, G],
//   its own rows the centre slab. One flat grid of (band block, gene tile)
//   pairs, gene tile fastest, so the CTAs that share A[n] run together and
//   find it in L2 (band blocks on grid.y would cap nb at 65,535): each block
//   computes lag [B, Gt] = A[n] [B, 3B] @ window [3B, Gt], K-chunked, with
//   A's chunk and the window's chunk staged in shared memory; every slab is
//   read by three blocks, as the Pallas kernel's three shifted inputs read it.
//
// K6, sct_band_cross_rot4 (replaces _band_halo_kernel_rot4, :557, behind
//   _band_cross_pallas_halo4, :631). A4[nb, B, 4B] from _build_band_rot4:
//   slab s's weights sit at columns (s % 4)*B, and the block's fourth column
//   block is zero. A block walks kRun consecutive band blocks of one gene
//   tile over a 4-slot ring of [B, Gt] slabs in shared memory (slot s%4
//   holds slab s), filled by cp.async: one new slab per band block, so Zp
//   crosses HBM once and not three times. Per band block it computes ONE
//   [B, 4B] @ [4B, Gt] product over the whole ring, K-chunked (A4's row
//   tile is 512 KB of bf16 at B=256 and does not fit shared memory). The
//   slot the next slab is being copied into meets zero weights, so the
//   ring is zeroed before its first fill: a NaN of uninitialised memory
//   times 0 would poison the product (the Pallas kernel zeroes its window
//   for the same reason).
//
// What bounds them on the H100. These kernels multiply the whole dense band,
// 0.8% nonzero at B=256, k=6: 2*B*3B*G*nb (K5) and 2*B*4B*G*nb (K6)
// operations, 1.57e12 and 2.10e12 at 1M cells x 1,024 genes, >= 1.59 ms and
// >= 2.12 ms on the bf16 tensor cores (989 TFLOP/s); in f32 the same work
// runs on the CUDA cores (67 TFLOP/s), not in TF32, which would change the
// numbers against the plain version. The function itself needs far less:
// only the 16x16 tiles of A that hold a nonzero weight (K6's fourth column
// block holds none), so its bound is reading A and Zp once (bytes). The
// compact-band kernel of band_cross_float.cu (K4) does the same cross in
// 2*nnz*G operations without the dense band's bytes.
//
// Design (right and simple first):
// - bf16: WMMA 16x16x16 tiles (bf16 in, f32 accumulate) on the tensor
//   cores; f32: register-blocked FFMA, 8 outputs a thread.
// - Row tiles of kMt = 64 rows, gene tiles of Gt (64 bf16 / 32 f32), K
//   chunks of Kc (64 bf16 / 32 f32); 8 warps.
// - Each row tile's lag goes through shared memory, and the block reduces
//   z1 * lag over its rows in a fixed order into its own partial row
//   [n, G]; the wrapper sums the partials in a fixed order. No atomics:
//   results are bitwise reproducible run to run.
// - The ragged gene edge is masked in the kernel (zero columns in, no
//   store out); B is a multiple of 16 and at most 256.
//
// Later work (not here): wgmma and TMA, double-buffered A chunks, and
// skipping the all-zero 16-column sub-tiles of the 99%-zero band.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kMt = 64;     // rows of A per row tile
constexpr int kRun = 16;    // K6: band blocks per thread block

template <typename T>
struct Cfg;
template <>
struct Cfg<bf16> {
  static constexpr int Gt = 64;   // genes per block
  static constexpr int Kc = 64;   // K chunk
  static constexpr int ldA = Kc + 8;
  static constexpr int ldW = Gt + 8;
};
template <>
struct Cfg<float> {
  static constexpr int Gt = 32;
  static constexpr int Kc = 32;
  static constexpr int ldA = Kc + 4;
  static constexpr int ldW = Gt + 4;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T zero_value();
template <>
__device__ __forceinline__ float zero_value<float>() { return 0.f; }
template <>
__device__ __forceinline__ bf16 zero_value<bf16>() { return __float2bfloat16(0.f); }

__host__ __device__ constexpr size_t align128(size_t b) { return (b + 127) / 128 * 128; }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

// Stage rows [r0, r0 + kMt) x cols [k0, k0 + Kc) of one band block's
// A [B, KA] (row-major) into sA [kMt][ldA]; rows >= B and cols >= KA are
// zero. KA is a multiple of 16, so a 16-byte vector never straddles it.
template <typename T>
__device__ void stage_a(T* sA, const T* __restrict__ A_blk, int B, int KA, int r0, int k0) {
  using C = Cfg<T>;
  constexpr int VE = 16 / sizeof(T);
  constexpr int vpr = C::Kc / VE;
  for (int v = threadIdx.x; v < kMt * vpr; v += kThreads) {
    const int r = v / vpr;
    const int c = (v % vpr) * VE;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r0 + r < B && k0 + c < KA) {
      val = __ldg(reinterpret_cast<const uint4*>(A_blk + static_cast<size_t>(r0 + r) * KA + k0 + c));
    }
    *reinterpret_cast<uint4*>(sA + r * C::ldA + c) = val;
  }
}

// lag tile [kMt, Gt] = sA [kMt, Kc] @ sW [Kc, Gt] accumulated over K chunks.
// bf16: warps 4 (rows of 16) x 2 (cols of 32), two 16x16 accumulators each.
struct AccBf16 {
  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float> acc[2];
  __device__ void zero() {
    nvcuda::wmma::fill_fragment(acc[0], 0.f);
    nvcuda::wmma::fill_fragment(acc[1], 0.f);
  }
  __device__ void mma(const bf16* sA, const bf16* W, int ldW) {
    using namespace nvcuda;
    using C = Cfg<bf16>;
    const int warp = threadIdx.x / 32;
    const int wr = warp / 2, wc = warp % 2;
#pragma unroll
    for (int kk = 0; kk < C::Kc; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::load_matrix_sync(fa, sA + wr * 16 * C::ldA + kk, C::ldA);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fb, W + kk * ldW + wc * 32 + j * 16, ldW);
        wmma::mma_sync(acc[j], fa, fb, acc[j]);
      }
    }
  }
  __device__ void store(float* sLag, int ldL) {
    const int warp = threadIdx.x / 32;
    const int wr = warp / 2, wc = warp % 2;
    for (int j = 0; j < 2; ++j) {
      nvcuda::wmma::store_matrix_sync(sLag + wr * 16 * ldL + wc * 32 + j * 16, acc[j], ldL,
                                      nvcuda::wmma::mem_row_major);
    }
  }
};

// f32: thread (ty = t / 8, tx = t % 8) owns rows 2ty, 2ty+1 and cols
// 4tx .. 4tx+3 of the [64, 32] tile.
struct AccF32 {
  float acc[2][4];
  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }
  __device__ void mma(const float* sA, const float* W, int ldW) {
    using C = Cfg<float>;
    const int ty = threadIdx.x / 8, tx = threadIdx.x % 8;
#pragma unroll 8
    for (int kk = 0; kk < C::Kc; ++kk) {
      const float a0 = sA[(2 * ty) * C::ldA + kk];
      const float a1 = sA[(2 * ty + 1) * C::ldA + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float b = W[kk * ldW + 4 * tx + j];
        acc[0][j] = fmaf(a0, b, acc[0][j]);
        acc[1][j] = fmaf(a1, b, acc[1][j]);
      }
    }
  }
  __device__ void store(float* sLag, int ldL) {
    const int ty = threadIdx.x / 8, tx = threadIdx.x % 8;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sLag[(2 * ty + i) * ldL + 4 * tx + j] = acc[i][j];
  }
};

template <typename T>
struct Acc;
template <>
struct Acc<bf16> : AccBf16 {};
template <>
struct Acc<float> : AccF32 {};

template <typename T>
struct Smem {
  using C = Cfg<T>;
  static constexpr int ldL = C::Gt + 4;
  static constexpr int nRG = kThreads / C::Gt;   // row groups of the reduction
  static constexpr size_t a_bytes = align128(sizeof(T) * kMt * C::ldA);
  static constexpr size_t lag_bytes = align128(sizeof(float) * kMt * ldL);
  static constexpr size_t red_bytes = align128(sizeof(float) * kThreads);
  __host__ __device__ static size_t w_bytes(int rows) { return align128(sizeof(T) * static_cast<size_t>(rows) * C::ldW); }
};

// Adds sum over this row tile's rows of z1 * lag to `cross` (thread (rg, c)
// takes rows rg, rg + nRG, ... in order). z1(i) gives row i's value at
// column c of the tile.
template <typename T, typename Z1>
__device__ __forceinline__ float reduce_rows(const float* sLag, int B, int r0, float cross, Z1 z1) {
  using S = Smem<T>;
  const int c = threadIdx.x % Cfg<T>::Gt;
  const int rg = threadIdx.x / Cfg<T>::Gt;
  for (int i = rg; i < kMt && r0 + i < B; i += S::nRG) {
    cross = __fadd_rn(cross, __fmul_rn(z1(i, c), sLag[i * S::ldL + c]));
  }
  return cross;
}

// Row groups' sums into partial[n, g0 + c], in a fixed order.
template <typename T>
__device__ __forceinline__ void write_partial(float* red, float cross, float* __restrict__ partial,
                                              int n, int g0, int G) {
  using C = Cfg<T>;
  red[threadIdx.x] = cross;
  __syncthreads();
  if (threadIdx.x < C::Gt && g0 + threadIdx.x < G) {
    float s = 0.f;
    for (int rg = 0; rg < Smem<T>::nRG; ++rg) s = __fadd_rn(s, red[rg * C::Gt + threadIdx.x]);
    partial[static_cast<size_t>(n) * G + g0 + threadIdx.x] = s;
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// K5: dense band, three slabs read per block
// ---------------------------------------------------------------------------

// Four CTAs an SM (at most 64 registers a thread): the flat grid's index
// arithmetic otherwise lifts bf16 to 74 registers and three CTAs an SM.
template <typename T>
__global__ void __launch_bounds__(kThreads, 4)
band_cross_dense_kernel(const T* __restrict__ A, const T* __restrict__ zp,
                        float* __restrict__ partial, int B, int G, int vec_ok) {
  using C = Cfg<T>;
  using S = Smem<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sA = reinterpret_cast<T*>(smem);
  T* sW = reinterpret_cast<T*>(smem + S::a_bytes);
  float* sLag = reinterpret_cast<float*>(smem + S::a_bytes + S::w_bytes(C::Kc));
  float* red = reinterpret_cast<float*>(smem + S::a_bytes + S::w_bytes(C::Kc) + S::lag_bytes);

  const int n_gt = (G + C::Gt - 1) / C::Gt;
  const int n = blockIdx.x / n_gt;
  const int g0 = (blockIdx.x % n_gt) * C::Gt;
  const int KA = 3 * B;
  const T* A_blk = A + static_cast<size_t>(n) * B * KA;
  const size_t win0 = static_cast<size_t>(n) * B;      // first window row
  constexpr int VE = 16 / sizeof(T);
  float cross = 0.f;

  for (int r0 = 0; r0 < B; r0 += kMt) {
    Acc<T> acc;
    acc.zero();
    for (int k0 = 0; k0 < KA; k0 += C::Kc) {
      stage_a<T>(sA, A_blk, B, KA, r0, k0);
      // window rows [k0, k0 + Kc) x genes [g0, g0 + Gt)
      if (vec_ok) {
        constexpr int vpr = C::Gt / VE;
        for (int v = threadIdx.x; v < C::Kc * vpr; v += kThreads) {
          const int r = v / vpr;
          const int c = (v % vpr) * VE;
          uint4 val = make_uint4(0, 0, 0, 0);
          if (k0 + r < KA && g0 + c < G) {
            val = __ldg(reinterpret_cast<const uint4*>(zp + (win0 + k0 + r) * G + g0 + c));
          }
          *reinterpret_cast<uint4*>(sW + r * C::ldW + c) = val;
        }
      } else {
        for (int v = threadIdx.x; v < C::Kc * C::Gt; v += kThreads) {
          const int r = v / C::Gt;
          const int c = v % C::Gt;
          sW[r * C::ldW + c] = (k0 + r < KA && g0 + c < G) ? zp[(win0 + k0 + r) * G + g0 + c]
                                                            : zero_value<T>();
        }
      }
      __syncthreads();
      acc.mma(sA, sW, C::ldW);
      __syncthreads();
    }
    acc.store(sLag, S::ldL);
    __syncthreads();
    const size_t own0 = win0 + B + r0;                  // centre slab rows
    const bool col_ok = g0 + static_cast<int>(threadIdx.x % C::Gt) < G;
    cross = reduce_rows<T>(sLag, B, r0, cross, [&](int i, int c) {
      return col_ok ? to_f32(zp[(own0 + i) * G + g0 + c]) : 0.f;
    });
    __syncthreads();
  }
  write_partial<T>(red, cross, partial, n, g0, G);
}

// ---------------------------------------------------------------------------
// K6: rotation-baked A4 over a 4-slot ring, one slab loaded per band block
// ---------------------------------------------------------------------------

// Copy slab s (rows [s*B, s*B + B) of Zp, genes [g0, g0 + Gt)) into ring
// slot s % 4; asynchronous (cp.async, zero-filled past G) when rows are
// 16-byte aligned, else plain loads.
template <typename T>
__device__ void load_slab(T* ring, const T* __restrict__ zp, int s, int B, int G, int g0,
                          int vec_ok) {
  using C = Cfg<T>;
  constexpr int VE = 16 / sizeof(T);
  T* dst = ring + static_cast<size_t>(s % 4) * B * C::ldW;
  const size_t row0 = static_cast<size_t>(s) * B;
  if (vec_ok) {
    constexpr int vpr = C::Gt / VE;
    for (int v = threadIdx.x; v < B * vpr; v += kThreads) {
      const int r = v / vpr;
      const int c = (v % vpr) * VE;
      const bool in = g0 + c < G;
      cp_async16(dst + r * C::ldW + c, in ? zp + (row0 + r) * G + g0 + c : zp, in ? 16 : 0);
    }
  } else {
    for (int v = threadIdx.x; v < B * C::Gt; v += kThreads) {
      const int r = v / C::Gt;
      const int c = v % C::Gt;
      dst[r * C::ldW + c] = g0 + c < G ? zp[(row0 + r) * G + g0 + c] : zero_value<T>();
    }
  }
  cp_async_commit();
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
band_cross_rot4_kernel(const T* __restrict__ A4, const T* __restrict__ zp,
                       float* __restrict__ partial, int nb, int B, int G, int vec_ok) {
  using C = Cfg<T>;
  using S = Smem<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sA = reinterpret_cast<T*>(smem);
  T* ring = reinterpret_cast<T*>(smem + S::a_bytes);             // [4B][ldW]
  float* sLag = reinterpret_cast<float*>(smem + S::a_bytes + S::w_bytes(4 * B));
  float* red = reinterpret_cast<float*>(smem + S::a_bytes + S::w_bytes(4 * B) + S::lag_bytes);

  const int g0 = blockIdx.x * C::Gt;
  const int n0 = blockIdx.y * kRun;
  const int n1 = min(n0 + kRun, nb);
  const int KA = 4 * B;

  // zero the whole ring before its first fill (see the header)
  for (int v = threadIdx.x; v < 4 * B * C::ldW; v += kThreads) ring[v] = zero_value<T>();
  __syncthreads();
  load_slab<T>(ring, zp, n0, B, G, g0, vec_ok);
  load_slab<T>(ring, zp, n0 + 1, B, G, g0, vec_ok);
  load_slab<T>(ring, zp, n0 + 2, B, G, g0, vec_ok);

  for (int n = n0; n < n1; ++n) {
    cp_async_wait_all();          // slabs n, n+1, n+2 have landed
    __syncthreads();
    // prefetch slab n+3 into the slot slab n-1 held; it meets zero weights
    if (n + 3 <= nb + 1) load_slab<T>(ring, zp, n + 3, B, G, g0, vec_ok);
    const T* A_blk = A4 + static_cast<size_t>(n) * B * KA;
    const T* z1 = ring + static_cast<size_t>((n + 1) % 4) * B * C::ldW;
    float cross = 0.f;
    for (int r0 = 0; r0 < B; r0 += kMt) {
      Acc<T> acc;
      acc.zero();
      for (int k0 = 0; k0 < KA; k0 += C::Kc) {
        stage_a<T>(sA, A_blk, B, KA, r0, k0);
        __syncthreads();
        acc.mma(sA, ring + static_cast<size_t>(k0) * C::ldW, C::ldW);
        __syncthreads();
      }
      acc.store(sLag, S::ldL);
      __syncthreads();
      cross = reduce_rows<T>(sLag, B, r0, cross, [&](int i, int cc) {
        return to_f32(z1[(r0 + i) * C::ldW + cc]);
      });
      __syncthreads();
    }
    write_partial<T>(red, cross, partial, n, g0, G);
  }
  cp_async_wait_all();
}

template <typename T>
cudaError_t launch_dense(const void* A, const void* zp, float* partial, int nb, int B, int G,
                         cudaStream_t stream) {
  using C = Cfg<T>;
  using S = Smem<T>;
  const size_t smem = S::a_bytes + S::w_bytes(C::Kc) + S::lag_bytes + S::red_bytes;
  cudaError_t err = cudaFuncSetAttribute(band_cross_dense_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int vec_ok = (G % (16 / static_cast<int>(sizeof(T))) == 0) &&
                     (reinterpret_cast<uintptr_t>(zp) % 16 == 0);
  const long long n_cta = static_cast<long long>(nb) * ((G + C::Gt - 1) / C::Gt);
  if (n_cta > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const dim3 grid(static_cast<unsigned>(n_cta));
  band_cross_dense_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(A), static_cast<const T*>(zp), partial, B, G, vec_ok);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_rot4(const void* A4, const void* zp, float* partial, int nb, int B, int G,
                        cudaStream_t stream) {
  using C = Cfg<T>;
  using S = Smem<T>;
  const size_t smem = S::a_bytes + S::w_bytes(4 * B) + S::lag_bytes + S::red_bytes;
  cudaError_t err = cudaFuncSetAttribute(band_cross_rot4_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int vec_ok = (G % (16 / static_cast<int>(sizeof(T))) == 0) &&
                     (reinterpret_cast<uintptr_t>(zp) % 16 == 0);
  const dim3 grid((G + C::Gt - 1) / C::Gt, (nb + kRun - 1) / kRun);
  band_cross_rot4_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(A4), static_cast<const T*>(zp), partial, nb, B, G, vec_ok);
  return cudaGetLastError();
}

}  // namespace

// partial: float [nb, G]. A [nb, B, 3B] and zp [(nb+2)*B, G], both bf16
// (is_bf16) or both f32; B a multiple of 16, at most 256.
extern "C" int sct_band_cross_dense(const void* A, const void* zp, float* partial, int nb, int B,
                                    int G, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(is_bf16 ? launch_dense<bf16>(A, zp, partial, nb, B, G, s)
                                  : launch_dense<float>(A, zp, partial, nb, B, G, s));
}

// As sct_band_cross_dense with A4 [nb, B, 4B] in the rotation-baked layout.
extern "C" int sct_band_cross_rot4(const void* A4, const void* zp, float* partial, int nb, int B,
                                   int G, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(is_bf16 ? launch_rot4<bf16>(A4, zp, partial, nb, B, G, s)
                                  : launch_rot4<float>(A4, zp, partial, nb, B, G, s));
}
