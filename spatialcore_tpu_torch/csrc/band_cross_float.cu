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
// Operands: Zp [(nb+2)*B, G], the draw's gathered value table, whose
// B-row slab s is rows [s*B, s*B + B); block n's window is slabs n, n+1,
// n+2 and its own rows are slab n+1. The compact band: local_idx int32
// [Npad, k] (window-relative rows in [0, 3B)) and weights w [Npad, k].
//
// What bounds it on the H100: bytes. The function needs Zp read once and
// the band read once: at 1M cells x 1,024 genes in bf16 that is 2.05 GB +
// 38 MB over 3.35 TB/s = 0.6225 ms. Its work, 2*(nnz + Npad)*G flops
// (14.7 GFLOP there), is a tenth of that time on the CUDA cores. The TPU
// kernel multiplies a dense [B, 3B] band on the matrix unit instead; the
// compact band has no dense tile, so wgmma does not apply.
//
// Design. A CTA owns one gene tile of Gt genes (Gt*esz = 16..256 bytes)
// and walks a run of R consecutive band blocks, the grid's gene tile
// fastest so a run's tiles are resident together and share its band in L2.
// (Gt, R) and the band chunk come from kernels/band_cross.float_tiles.
// - The slab ring (slab_ring.cuh, shared with band_cross_int8.cu): 4 slots
//   of [B, Gt] values in shared memory, slab s in
//   slot s % 4 (the padded slab number, as in the Pallas ring). Slots n,
//   n+1, n+2 hold block n's window while slab n+3 is copied by cp.async
//   (16-byte .cg copies, zero-filled past G) into the slot slab n-1 left,
//   so each slab crosses HBM once per run: (R+2)/R reads of Zp, not 3.
//   Rows whose width or base is not 16-byte aligned (odd G) take plain
//   element loads into the ring instead, at the same point.
//   The Pallas kernel zeroes its ring because its dense band multiplies the
//   fourth slot by zero weights; here local_idx never addresses the fourth
//   slot, and every fill writes every byte the compute reads (genes past G
//   as zeros), so there is no separate zeroing pass.
// - Band operands: the block's local_idx and w rows are staged in shared
//   memory by 16-byte cp.async copies (the byte range keeps its alignment
//   phase; the last copy reads only up to the range's end) in the same
//   pipeline stage as the slab, double-buffered, in chunks of `chunk` rows
//   when a whole block's rows do not fit (k = 50 at B = 256 is 77 KB). The
//   inner loop reads only shared memory and registers.
// - Pipeline, one stage per band chunk: wait for the chunk's copies (and at
//   a block's first chunk the window's last slab), one __syncthreads, issue
//   the next chunk's band copies and (at a block's first chunk) slab n+3,
//   then compute. The slab copy overlaps the whole block's compute when the
//   block is one or two chunks.
// - Each thread owns 16 bytes of a row: 8 bf16 or 4 f32 neighbouring genes;
//   Gt*esz/16 threads cover a row, so a row segment is one contiguous read
//   and every shared-memory read of a window row is a 16-byte vector read.
//   A thread takes two of its rows at a time, two independent chains of
//   shared-memory reads and multiply-adds; the kNN band's k = 6 is an
//   instance of its own with the slot loop unrolled, other k a runtime
//   loop. 512 threads (16 warps, one CTA of ~146 KB per SM at B = 256).
// - Sums: the lag in slot order, each slot a fused multiply-add (one
//   instruction per multiply-add; the check that holds the kernel is a
//   tolerance of 1e-5 * sum|terms|, not bitwise lags). Each thread
//   accumulates z1 * lag over its rows of the run; the CTA reduces its
//   rows in a fixed order (a shuffle butterfly within a warp, then the
//   warps in order) into one partial row [run, G]; the wrapper sums the
//   partials in a fixed order. No atomics: bitwise reproducible run to run.
// - Ragged edges: genes past G load as zeros and are not stored; a run's
//   last block may be short; rows of a chunk are masked per thread, so B
//   need be a multiple of neither the row groups nor 16.
//
// What held the first version (one CTA per band block and 32 genes) back,
// and what answers it here: each slab was staged by three CTAs (the ring
// answers it); staging was scalar 2-byte loads with a divide each and no
// overlap with compute (16-byte cp.async, pipelined); the band was read
// from global memory on a serial chain per slot, 32 times at G = 1,024
// (staged in shared memory, read once per gene tile: 16 times at Gt = 64
// bf16, from L2 after the first); two instructions per multiply-add (FMA).
//
// What it re-reads: the band once per gene tile (the tile width is bounded
// by the 4-slot ring in 227 KB of shared memory); each run's two halo slabs
// are read again by the neighbouring run.
//
// Later work: the per-draw row gather Ztab[rows] (ops/banded.py) fused into
// the slab fill, and the Geary term's z1^2 row sums as a second output.

#include "slab_ring.cuh"

namespace {

constexpr int kThreads = 512;                   // mirrors band_cross._FLOAT_THREADS
constexpr int kWarps = kThreads / 32;
constexpr size_t kSmemMax = 232448;             // 227 KB a block may use on sm_90

// ---------------------------------------------------------------------------
// Arithmetic on 16 bytes of values
// ---------------------------------------------------------------------------

template <int ESZ>
__device__ __forceinline__ float raw_to_f32(typename RawOf<ESZ>::type x) {
  return __uint_as_float(ESZ == 2 ? static_cast<uint32_t>(x) << 16 : static_cast<uint32_t>(x));
}

// f[0 .. 16/ESZ) from 16 bytes; bf16 pairs are (low half, high half).
template <int ESZ>
__device__ __forceinline__ void unpack(const uint4 raw, float* f) {
  const uint32_t u[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (ESZ == 2) {
      f[2 * j] = __uint_as_float(u[j] << 16);
      f[2 * j + 1] = __uint_as_float(u[j] & 0xffff0000u);
    } else {
      f[j] = __uint_as_float(u[j]);
    }
  }
}

// Shared-memory layout, mirrored by band_cross.float_smem_bytes: the ring
// (which the final reduction reuses), then two band buffers, each the
// chunk's local_idx bytes then its weight bytes (slab_ring.cuh).
__host__ __device__ constexpr size_t float_ring_bytes(int B, int rb, int esz) {
  return ring_bytes(B, rb, static_cast<size_t>(kWarps) * (rb / esz) * 4);
}
__host__ __device__ constexpr size_t idx_buf_bytes(int chunk, int k) {
  return stage_buf_bytes(static_cast<size_t>(chunk) * k * 4);
}
__host__ __device__ constexpr size_t w_buf_bytes(int chunk, int k, int esz) {
  return stage_buf_bytes(static_cast<size_t>(chunk) * k * esz);
}

// acc += z1 * lag for NR rows of a block, row r's band entries at
// bi/bw + r*bstride and its own values at ring row own + r*ostride (before
// the wrap); window row j of the block is ring row (base + j) mod 4B.
template <int ESZ, int NR, int KC>
__device__ __forceinline__ void cross_rows(float* acc, const unsigned char* lane,
                                           const int32_t* bi,
                                           const typename RawOf<ESZ>::type* bw,
                                           int bstride, int k, int own, int ostride,
                                           int base, int four_b, int rb_shift) {
  constexpr int V = 16 / ESZ;
  float lag[NR][V];
#pragma unroll
  for (int r = 0; r < NR; ++r)
#pragma unroll
    for (int v = 0; v < V; ++v) lag[r][v] = 0.f;
  auto slot = [&](int t) {
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      int rr = base + bi[r * bstride + t];
      rr -= rr >= four_b ? four_b : 0;
      float z[V];
      unpack<ESZ>(*reinterpret_cast<const uint4*>(lane + (rr << rb_shift)), z);
      const float wf = raw_to_f32<ESZ>(bw[r * bstride + t]);
#pragma unroll
      for (int v = 0; v < V; ++v) lag[r][v] = fmaf(wf, z[v], lag[r][v]);
    }
  };
  if constexpr (KC > 0) {       // k known at compile time: all slots unrolled
#pragma unroll
    for (int t = 0; t < KC; ++t) slot(t);
  } else {
#pragma unroll 2
    for (int t = 0; t < k; ++t) slot(t);
  }
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    int orow = own + r * ostride;
    orow -= orow >= four_b ? four_b : 0;
    float z1[V];
    unpack<ESZ>(*reinterpret_cast<const uint4*>(lane + (orow << rb_shift)), z1);
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = fmaf(z1[v], lag[r][v], acc[v]);
  }
}

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------

template <int ESZ, int KC>
__global__ void __launch_bounds__(kThreads, 1)
band_cross_float_kernel(const int32_t* __restrict__ local_idx,
                        const unsigned char* __restrict__ w,
                        const unsigned char* __restrict__ zp,
                        float* __restrict__ partial, int nb, int B, int k, int G,
                        int rb_shift, int run, int chunk, int n_gt, bool vec) {
  using Raw = typename RawOf<ESZ>::type;
  constexpr int V = 16 / ESZ;                   // genes a thread owns
  extern __shared__ __align__(16) unsigned char smem[];
  const int rb = 1 << rb_shift;                 // bytes of a ring row
  const int Gt = rb / ESZ;
  unsigned char* ring = smem;
  unsigned char* band = smem + float_ring_bytes(B, rb, ESZ);
  const int idx_buf = static_cast<int>(idx_buf_bytes(chunk, k));
  const int buf = idx_buf + static_cast<int>(w_buf_bytes(chunk, k, ESZ));

  const int g0 = (blockIdx.x % n_gt) * Gt;
  const int run_i = blockIdx.x / n_gt;
  const int n0 = run_i * run;
  const int n1 = min(n0 + run, nb);
  const int nc = (B + chunk - 1) / chunk;       // band chunks per block
  const int stages = (n1 - n0) * nc;
  const int tpr_shift = rb_shift - 4;           // 16-byte lanes per row
  const int q = threadIdx.x & ((1 << tpr_shift) - 1);
  const int rg = threadIdx.x >> tpr_shift;      // row group
  const int n_rg = kThreads >> tpr_shift;
  const int four_b = 4 * B;
  const unsigned char* li = reinterpret_cast<const unsigned char*>(local_idx);

  // band chunk st's rows into buffer st & 1
  auto stage_band = [&](int st) {
    const int c = st % nc;
    const size_t r0 = static_cast<size_t>(n0 + st / nc) * B + c * chunk;
    const int rows = min(chunk, B - c * chunk);
    unsigned char* b = band + (st & 1) * buf;
    stage_bytes<kThreads>(b, li, r0 * k * 4, rows * k * 4);
    stage_bytes<kThreads>(b + idx_buf, w, r0 * k * ESZ, rows * k * ESZ);
  };

  fill_slot<kThreads, ESZ>(ring, zp, n0, B, G, g0, rb_shift, vec);
  fill_slot<kThreads, ESZ>(ring, zp, n0 + 1, B, G, g0, rb_shift, vec);
  fill_slot<kThreads, ESZ>(ring, zp, n0 + 2, B, G, g0, rb_shift, vec);
  cp_async_commit();
  stage_band(0);
  cp_async_commit();

  float acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = 0.f;

  for (int st = 0; st < stages; ++st) {
    const int n = n0 + st / nc;
    const int c = st % nc;
    // Groups committed one stage ago: [band st] and, after a block's first
    // chunk, [slab n+3]. A block's second chunk needs only the band; every
    // other stage needs everything (a first chunk: slab n+2 of its window).
    if (c == 1) cp_async_wait<1>(); else cp_async_wait<0>();
    __syncthreads();                            // also: stage st-1's reads are done
    if (st + 1 < stages) stage_band(st + 1);
    cp_async_commit();
    if (c == 0) {
      if (n + 1 < n1) fill_slot<kThreads, ESZ>(ring, zp, n + 3, B, G, g0, rb_shift, vec);
      cp_async_commit();
    }

    const size_t r0 = static_cast<size_t>(n) * B + c * chunk;
    const unsigned char* b = band + (st & 1) * buf;
    const int32_t* sidx = reinterpret_cast<const int32_t*>(b + ((r0 * k * 4) & 15));
    const Raw* sw = reinterpret_cast<const Raw*>(b + idx_buf + ((r0 * k * ESZ) & 15));
    const int base = (n & 3) * B;               // ring row of window row 0
    const int lo = c * chunk;
    const int hi = min(B, lo + chunk);
    const unsigned char* lane = ring + 16 * q;
    int i = lo + rg;
    for (; i + n_rg < hi; i += 2 * n_rg)        // two rows at a time: ILP
      cross_rows<ESZ, 2, KC>(acc, lane, sidx + (i - lo) * k, sw + (i - lo) * k, n_rg * k, k,
                         base + B + i, n_rg, base, four_b, rb_shift);
    if (i < hi)
      cross_rows<ESZ, 1, KC>(acc, lane, sidx + (i - lo) * k, sw + (i - lo) * k, 0, k,
                         base + B + i, 0, base, four_b, rb_shift);
  }

  // Fixed-order reduction over the run's rows: the lanes of a warp that
  // share genes (a butterfly, the same sum in every lane), then the warps.
  for (int off = 1 << tpr_shift; off < 32; off <<= 1) {
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] += __shfl_xor_sync(0xffffffffu, acc[v], off);
  }
  cp_async_wait<0>();
  __syncthreads();                              // the ring is free: reuse it
  float* red = reinterpret_cast<float*>(ring);  // [kWarps][Gt]
  const int warp = threadIdx.x / 32;
  if ((threadIdx.x & 31) < (1 << tpr_shift)) {
#pragma unroll
    for (int v = 0; v < V; ++v) red[warp * Gt + q * V + v] = acc[v];
  }
  __syncthreads();
  if (threadIdx.x < Gt && g0 + threadIdx.x < G) {
    float s = 0.f;
    for (int wi = 0; wi < kWarps; ++wi) s += red[wi * Gt + threadIdx.x];
    partial[static_cast<size_t>(run_i) * G + g0 + threadIdx.x] = s;
  }
}

template <int ESZ>
cudaError_t launch(const int32_t* local_idx, const void* w, const void* zp, float* partial,
                   int nb, int B, int k, int G, int gt, int run, int chunk,
                   cudaStream_t stream) {
  const int rb = gt * ESZ;
  int rb_shift = 4;
  while ((1 << rb_shift) < rb) ++rb_shift;
  if (rb != (1 << rb_shift) || rb < 16 || rb > 512 || run < 1 || chunk < 1 || chunk > B ||
      nb < 1 || k < 1 || G < 1)
    return cudaErrorInvalidValue;
  const size_t smem =
      float_ring_bytes(B, rb, ESZ) + 2 * (idx_buf_bytes(chunk, k) + w_buf_bytes(chunk, k, ESZ));
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  // the band's copies need 16-byte-aligned arrays (the wrapper sees to it)
  if (reinterpret_cast<uintptr_t>(local_idx) % 16 || reinterpret_cast<uintptr_t>(w) % 16)
    return cudaErrorMisalignedAddress;
  const bool vec = (static_cast<size_t>(G) * ESZ) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(zp) % 16 == 0;
  const long long n_gt = (G + gt - 1) / gt;
  const long long ctas = n_gt * ((nb + run - 1) / run);
  if (ctas > 0x7fffffffLL) return cudaErrorInvalidValue;
  // the common kNN band (k = 6) with its slot loop unrolled
  auto kernel = k == 6 ? band_cross_float_kernel<ESZ, 6> : band_cross_float_kernel<ESZ, 0>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(ctas), kThreads, smem, stream>>>(
      local_idx, static_cast<const unsigned char*>(w), static_cast<const unsigned char*>(zp),
      partial, nb, B, k, G, rb_shift, run, chunk, static_cast<int>(n_gt), vec);
  return cudaGetLastError();
}

}  // namespace

// partial: float [ceil(nb / run), G]. is_bf16 selects bf16 (else f32)
// weights and values; gt (genes per CTA), run (band blocks per CTA) and
// chunk (band rows per pipeline stage) come from band_cross.float_tiles.
extern "C" int sct_band_cross_float(const int32_t* local_idx, const void* w,
                                    const void* zp, float* partial, int nb,
                                    int B, int k, int G, int is_bf16, int gt,
                                    int run, int chunk, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch<2>(local_idx, w, zp, partial, nb, B, k, G, gt, run, chunk, s)
              : launch<4>(local_idx, w, zp, partial, nb, B, k, G, gt, run, chunk, s);
  return static_cast<int>(err);
}
