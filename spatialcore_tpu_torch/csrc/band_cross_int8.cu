// Band cross of the global permutation null in the int8 / int4 system,
// one draw per launch:
//
//   cross_q[g] = sum_i sw_i * z1_i[g] * lag_i[g]
//   lag_i[g]   = sum_slots wq * z[window + local_idx][g]       (band)
//              + sum_{e in far run of row i} q_e * zf_e[g]       (far, optional)
//
// with exact int32 lags over int8 codes, or int4 codes nibble-packed in the
// split-half layout (ops/banded._pack_codes: packed column j holds gene j in
// its high nibble and gene j + cols in its low nibble, each as code + 8).
// Replaces three Pallas kernels of spatialcore_tpu/ops/banded.py:
//   K1 _band_cross_win_kernel_i4 (:1122, pallas_call :1244), int4, windowed far;
//   K2 _band_cross_win_kernel_i8 (:987, pallas_call :1111), int8, windowed far;
//   K3 _band_halo_kernel_i8 (:879, pallas_call :934), int8, band only.
// One template covers all three: PACKED selects int4, FAR the far term.
//
// What bounds it on the H100: bytes. The function needs Zp read once, the
// live far values once and the compact band once: at 1M cells x 4,096 int4
// genes (2,048 packed columns) that is 2.05 GB + 0.51 GB + 34 MB over
// 3.35 TB/s = 0.777 ms (int8 x 1,024: 0.394 ms). The TPU kernels multiply a
// dense int8 band [B, 3B] on the matrix unit; the compact band is 0.8%
// dense at B=256, k=6 and has no dense tile, so int8 MMA does not apply.
// Its ~2*(k + far + 1)*N*G integer operations are what the old kernel was
// held by: they have to run on the CUDA cores in few instructions each.
//
// Design. The ring of band_cross_float.cu (slab_ring.cuh): a CTA of 512
// threads owns a column tile of rb bytes (16..256; 128 at B=256: 256 int4 or
// 128 int8 genes) and walks a run of R consecutive band blocks, the grid's
// column tile fastest. (rb, R), the band chunk and the far entries staged
// per chunk come from kernels/band_cross.int_tiles.
// - 4 ring slots of [B, rb] bytes, slab s in slot s % 4; slab n+3 is copied
//   by 16-byte cp.async (zero-filled past the row) while block n computes,
//   so Zp crosses HBM (R+2)/R times. Rows that are not whole 16-byte chunks
//   (cols % 16 != 0) take 4-byte loads into the ring at the same point.
// - The band chunk's local_idx, wq, sw and far row pointers are staged in
//   shared memory in the same pipeline stage (double-buffered, row chunks
//   when k is large), and its window rows turned into ring byte offsets
//   once per chunk. The inner loop reads shared memory and registers.
// - Each thread owns 16 bytes of a row (32 int4 or 16 int8 genes).
// - Integer dot products, four slots at a time: the 16-byte values of 4
//   slots are byte-transposed (8 PRMT per 4-byte word) so each byte
//   position's 4 slot codes sit in one word, and one IDP4A against the
//   row's 4 weight codes does 4 multiply-adds (int8: 16 a word and 4
//   slots). int4 masks the transposed word in place instead of unpacking:
//   & 0x0F0F0F0F gives the low nibbles u = code + 8, & 0xF0F0F0F0 the high
//   ones times 16, each one IDP4A with unsigned value bytes (dp4a.u32.s32),
//   so 8 genes x 4 slots cost 8 PRMT + 8 LOP3 + 8 IDP4A. The bias -8 * sum w
//   (x 16 for the high sums) is the accumulators' start, from one IDP4A of
//   the weight word against 0x01010101. A remainder of two slots (k = 6:
//   4 + 2) takes dp2a (2 PRMT + 4 dp2a a word, int4 also 4 LOP3), of three a
//   padded dp4a group. The weight words are read from the staged bytes by
//   a funnel shift (a row's codes start at r*k, not 4-aligned for k = 6).
//   Lags stay exact int32 (int4's high sums are 16 * lag, their row scale
//   sw / 16 exactly). Tensor-core int8 MMA does not apply: the compact band
//   has no dense tile.
// - Far edges by row pointers, as before: entries [far_ptr[r], far_ptr[r+1])
//   are read once each; a chunk's first far_cap entries are staged in
//   shared memory with the chunk (see 4 below), the rest read with 16-byte
//   loads (4-byte loads for ragged rows); each entry is 4 IDP4A a word with
//   its weight code in one byte (int4 takes the nibbles as signed values
//   there: no bias term).
// - Own-row epilogue: sw_i * float(z1 * lag), one IMAD, one I2F, one FFMA
//   per value (z1 * lag is exact in int32).
// - k = 6 (the kNN band) has an instance with its slot loop unrolled; int8
//   takes two rows a thread at a time, int4 (32 sums a row) one.
// - Sums: each thread accumulates over its rows of the run; the CTA
//   reduces its rows in a fixed order (a warp butterfly, then the warps in
//   order) into one partial row [run, G]; the wrapper sums the partials in
//   a fixed order. No atomics: bitwise reproducible run to run.
// - Ragged edges: columns past cols load as zero and are not stored (under
//   the bias a zero nibble is code -8: those sums are garbage); a run's
//   last block may be short; rows of a chunk are masked per thread.
//
// What held the first kernel (one CTA per band block and 64-byte column
// tile, one 4-byte word a thread) back, point by point, and the answer
// here (SASS from `python -m spatialcore_tpu_torch.kernels.sass`):
// 1. Integer issue. Per row and slot it loaded local_idx and wq from
//    global memory on a serial chain with a branch, unpacked every nibble
//    with a shift, a mask and a subtract, and did one IMAD per gene: 98
//    instructions per two slots of 8 int4 genes, 6.1 per gene-slot, and
//    ~77 per gene for a whole k = 6 row with its epilogue. Now the slot
//    arithmetic is 0.75 per gene-slot (4-slot dp4a group) and 0.875 (dp2a
//    pair), and a whole row 12.6 per gene band-only, 13.5 with far edges.
// 2. Each slab was staged by three CTAs with 4-byte loads and no overlap:
//    the ring reads it once per run, by 16-byte cp.async, pipelined.
// 3. The band was re-read per 64-byte column tile from global memory (32
//    times at int4 G = 4,096): now once per 128-byte tile (16 times), from
//    shared memory, staged by 16-byte copies, its window rows turned into
//    ring offsets once per chunk.
// 4. Far values were 4-byte global reads inside the row loop, their
//    latency exposed: now each chunk's first far entries (one a row) are
//    staged in shared memory by cp.async in the band's pipeline stage
//    (their range read from far_ptr a stage ahead), the rest read with
//    16-byte loads.
//
// What is left (measured on the card, PERF.md section 6): neither bytes
// nor the issue count alone binds; the own-row product (nibble extract and
// IMAD) is ~18% of the time, the conversion ~4%.
//
// Later work: the per-draw row gather Ztab[rows] (ops/banded.py) fused into
// the slab fill; the far gather Ztab[rowsf] read through the row indices.

#include "int_dot.cuh"

namespace {

constexpr int kThreads = 512;                   // mirrors band_cross._INT_THREADS
constexpr int kWarps = kThreads / 32;
constexpr size_t kSmemMax = 232448;             // 227 KB a block may use on sm_90

// Shared-memory layout, mirrored by band_cross.int_smem_bytes: the ring
// (which the final reduction, [kWarps][genes of the tile] f32, reuses),
// then two band buffers, each the chunk's local_idx, wq (8 spare bytes for
// the weight words' funnel reads), sw and far_ptr bytes, then two far
// buffers (their sizes and the integer dot products: int_dot.cuh).
__host__ __device__ constexpr size_t int_ring_bytes(int B, int rb, bool packed) {
  return ring_bytes(B, rb, static_cast<size_t>(kWarps) * rb * (packed ? 2 : 1) * 4);
}

// acc += sw * z1 * lag for NR rows of a block: row r's band entries at
// bi/bw + r*bstride (bi: ring byte offsets of the slots' window rows), its
// own row at ring row orow[r], its far entries (staged ones from fs)
// [e0[r], e1[r]). Slots go four at a time, the last two or one by dp2a
// (k = 6: one dp4a group and one dp2a pair).
template <bool PACKED, bool FAR, int NR, int KC>
__device__ __forceinline__ void cross_rows(float* acc, const unsigned char* lane,
                                           const int32_t* bi, const int8_t* bw, int bstride,
                                           int k, int rb_shift, const int* orow,
                                           const float* s_row,
                                           const int* e0, const int* e1,
                                           const int8_t* __restrict__ far_q,
                                           const FarRow<>& far, const FarStage& fs) {
  const int kk = KC > 0 ? KC : k;               // k known at compile time for KC
  const int k4 = kk & ~3;
  auto value = [&](int r, int t) {             // bi holds ring byte offsets
    return *reinterpret_cast<const uint4*>(lane + bi[r * bstride + t]);
  };
  Sums<PACKED> s[NR];
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    int bias = 0;
    if (PACKED) {                               // -8 * (the row's band weight codes)
      int wsum = 0;
      for (int t0 = 0; t0 < kk; t0 += 4)
        wsum = __dp4a(weight_word(bw + r * bstride, t0, min(4, kk - t0)), 0x01010101, wsum);
      bias = -8 * wsum;
    }
#pragma unroll
    for (int v = 0; v < 16; ++v) {
      s[r].lo[v] = bias;
      if (PACKED) s[r].hi[v] = 16 * bias;
    }
  }
  auto group4 = [&](int t0) {
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const uint4 v[4] = {value(r, t0), value(r, t0 + 1), value(r, t0 + 2), value(r, t0 + 3)};
      slots4<PACKED>(s[r], v, weight_word(bw + r * bstride, t0, 4));
    }
  };
  if constexpr (KC > 0) {
#pragma unroll
    for (int t0 = 0; t0 < k4; t0 += 4) group4(t0);
  } else {
    for (int t0 = 0; t0 < k4; t0 += 4) group4(t0);
  }
  const int rest = kk - k4;                     // 0..3 slots left
  if (rest == 3) {
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const uint4 v[4] = {value(r, k4), value(r, k4 + 1), value(r, k4 + 2), make_uint4(0, 0, 0, 0)};
      slots4<PACKED>(s[r], v, weight_word(bw + r * bstride, k4, 3));
    }
  } else if (rest > 0) {
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const uint4 v[2] = {value(r, k4), rest == 2 ? value(r, k4 + 1) : make_uint4(0, 0, 0, 0)};
      // the two codes as sign-extended 16-bit halves
      const int w2 = bytes_to_halves(weight_word(bw + r * bstride, k4, rest));
      slots2<PACKED>(s[r], v, w2);
    }
  }
  if (FAR) {                                    // staged entries, then the rest
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      for (int e = e0[r]; e < e1[r]; ++e) {
        const int x = e - fs.e0;
        if (x < fs.n)
          far1<PACKED>(s[r], *reinterpret_cast<const uint4*>(fs.vals + (x << rb_shift)),
                       fs.q[x]);
        else
          far1<PACKED>(s[r], far.load(e), far_q[e]);
      }
    }
  }
  // own row: sw * float(z1 * lag); int4's high sums carry 16 * lag, so their
  // row scale is sw / 16 (exact)
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    const uint4 o = *reinterpret_cast<const uint4*>(lane + (orow[r] << rb_shift));
    const float s16 = s_row[r] * 0.0625f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t x = word_of(o, j);
      // int4: nibble u ^ 8 is the 4-bit two's complement of u - 8, so a
      // shift up and an arithmetic shift down give the code
      const uint32_t xs = x ^ 0x88888888u;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int v = 4 * j + b;
        if (PACKED) {
          const int z_hi = static_cast<int>(xs << (24 - 8 * b)) >> 28;
          const int z_lo = static_cast<int>(xs << (28 - 8 * b)) >> 28;
          acc[v] = fmaf(s16, static_cast<float>(z_hi * s[r].hi[v]), acc[v]);
          acc[16 + v] = fmaf(s_row[r], static_cast<float>(z_lo * s[r].lo[v]), acc[16 + v]);
        } else {
          const int z1 = static_cast<int8_t>(x >> (8 * b));
          acc[v] = fmaf(s_row[r], static_cast<float>(z1 * s[r].lo[v]), acc[v]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------

template <bool PACKED, bool FAR, int KC>
__global__ void __launch_bounds__(kThreads, 1)
band_cross_int_kernel(const int32_t* __restrict__ local_idx,
                      const unsigned char* __restrict__ wq,
                      const unsigned char* __restrict__ sw,
                      const unsigned char* __restrict__ zp,
                      const unsigned char* __restrict__ far_ptr,
                      const int8_t* __restrict__ far_q,
                      const unsigned char* __restrict__ zf,
                      float* __restrict__ partial, int nb, int B, int k, int gcols,
                      int rb_shift, int run, int chunk, int far_cap, int n_ct, bool vec,
                      bool fvec) {
  constexpr int NV = PACKED ? 32 : 16;          // genes a thread owns
  extern __shared__ __align__(16) unsigned char smem[];
  const int rb = 1 << rb_shift;                 // packed columns of a ring row
  unsigned char* ring = smem;
  unsigned char* band = smem + int_ring_bytes(B, rb, PACKED);
  const int idx_b = static_cast<int>(idx_buf_bytes(chunk, k));
  const int wq_b = static_cast<int>(wq_buf_bytes(chunk, k));
  const int sw_b = static_cast<int>(row_buf_bytes(chunk));
  const int buf = static_cast<int>(band_buf_bytes(chunk, k));
  unsigned char* fbuf = band + 2 * buf;
  const int fbuf_b = static_cast<int>(far_buf_bytes(far_cap, rb));

  const int c0 = (blockIdx.x % n_ct) * rb;      // first packed column of the tile
  const int run_i = blockIdx.x / n_ct;
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
  const int G4 = gcols >> 2;                    // 4-byte words of a Zp row
  const FarRow<> far{zf + c0 + 16 * q, gcols, gcols - c0 - 16 * q, fvec};

  auto chunk_rows = [&](int st, size_t& r0, int& rows) {   // rows of chunk st
    const int c = st % nc;
    r0 = static_cast<size_t>(n0 + st / nc) * B + c * chunk;
    rows = min(chunk, B - c * chunk);
  };
  // band chunk st's rows into buffer st & 1
  auto stage_band = [&](int st) {
    size_t r0;
    int rows;
    chunk_rows(st, r0, rows);
    unsigned char* b = band + (st & 1) * buf;
    stage_bytes<kThreads>(b, li, r0 * k * 4, rows * k * 4);
    stage_bytes<kThreads>(b + idx_b, wq, r0 * k, rows * k);
    stage_bytes<kThreads>(b + idx_b + wq_b, sw, r0 * 4, rows * 4);
    if (FAR) stage_bytes<kThreads>(b + idx_b + wq_b + sw_b, far_ptr, r0 * 4, (rows + 1) * 4);
  };
  // far entries [p.x, p.y) of chunk st (the first far_cap of them) into far
  // buffer st & 1: values by 16-byte cp.async (4-byte loads for ragged
  // rows), weight codes by stage_bytes
  const int32_t* fptr = reinterpret_cast<const int32_t*>(far_ptr);
  auto far_range = [&](int st) {                // global loads: used a stage later
    size_t r0;
    int rows;
    chunk_rows(st, r0, rows);
    return make_int2(__ldg(fptr + r0), __ldg(fptr + r0 + rows));
  };
  auto stage_far = [&](int st, int2 p) {
    const int n = min(p.y - p.x, far_cap);
    unsigned char* f = fbuf + (st & 1) * fbuf_b;
    const int tpr = 1 << tpr_shift;
    for (int v = threadIdx.x; v < n << tpr_shift; v += kThreads) {
      const int x = v >> tpr_shift, l = v & (tpr - 1);
      const int col = c0 + 16 * l;
      const unsigned char* src = zf + static_cast<size_t>(p.x + x) * gcols + col;
      unsigned char* dst = f + (x << rb_shift) + 16 * l;
      if (fvec) {
        cp_async16(dst, col < gcols ? src : zf, col < gcols ? 16 : 0);
      } else {
#pragma unroll
        for (int w = 0; w < 4; ++w)
          reinterpret_cast<uint32_t*>(dst)[w] =
              col + 4 * w < gcols ? reinterpret_cast<const uint32_t*>(src)[w] : 0u;
      }
    }
    stage_bytes<kThreads>(f + far_cap * rb, reinterpret_cast<const unsigned char*>(far_q),
                          p.x, n);
  };

  fill_slot<kThreads, 4>(ring, zp, n0, B, G4, c0 >> 2, rb_shift, vec);
  fill_slot<kThreads, 4>(ring, zp, n0 + 1, B, G4, c0 >> 2, rb_shift, vec);
  fill_slot<kThreads, 4>(ring, zp, n0 + 2, B, G4, c0 >> 2, rb_shift, vec);
  cp_async_commit();
  stage_band(0);
  int2 pn = make_int2(0, 0);                    // far range of the next chunk
  if (FAR) {
    stage_far(0, far_range(0));
    if (stages > 1) pn = far_range(1);
  }
  cp_async_commit();

  float acc[NV];
#pragma unroll
  for (int v = 0; v < NV; ++v) acc[v] = 0.f;

  for (int st = 0; st < stages; ++st) {
    const int n = n0 + st / nc;
    const int c = st % nc;
    // Groups committed one stage ago: [band st] and, after a block's first
    // chunk, [slab n+3]. A block's second chunk needs only the band; every
    // other stage needs everything (a first chunk: slab n+2 of its window).
    if (c == 1) cp_async_wait<1>(); else cp_async_wait<0>();
    __syncthreads();                            // also: stage st-1's reads are done
    if (st + 1 < stages) {
      stage_band(st + 1);
      if (FAR) {
        stage_far(st + 1, pn);
        if (st + 2 < stages) pn = far_range(st + 2);
      }
    }
    cp_async_commit();
    if (c == 0) {
      if (n + 1 < n1) fill_slot<kThreads, 4>(ring, zp, n + 3, B, G4, c0 >> 2, rb_shift, vec);
      cp_async_commit();
    }

    const size_t r0 = static_cast<size_t>(n) * B + c * chunk;
    unsigned char* b = band + (st & 1) * buf;
    int32_t* sidx = reinterpret_cast<int32_t*>(b + ((r0 * k * 4) & 15));
    const int8_t* swq = reinterpret_cast<const int8_t*>(b + idx_b + ((r0 * k) & 15));
    const float* ssw = reinterpret_cast<const float*>(b + idx_b + wq_b + ((r0 * 4) & 15));
    const int32_t* sptr =
        reinterpret_cast<const int32_t*>(b + idx_b + wq_b + sw_b + ((r0 * 4) & 15));
    const int base = (n & 3) * B;               // ring row of window row 0
    const int lo = c * chunk;
    const int hi = min(B, lo + chunk);
    FarStage fs{};
    if (FAR) {
      const unsigned char* f = fbuf + (st & 1) * fbuf_b;
      fs.e0 = sptr[0];
      fs.n = min(sptr[hi - lo] - fs.e0, far_cap);
      fs.vals = f + 16 * q;
      fs.q = reinterpret_cast<const int8_t*>(f + far_cap * rb + (fs.e0 & 15));
    }
    // the chunk's window rows to ring byte offsets, once for all threads
    // of the row (window row j is ring row (base + j) mod 4B)
    for (int e = threadIdx.x; e < (hi - lo) * k; e += kThreads) {
      const int rr = base + sidx[e];
      sidx[e] = (rr >= four_b ? rr - four_b : rr) << rb_shift;
    }
    __syncthreads();
    const unsigned char* lane = ring + 16 * q;
    auto own = [&](int i) {                     // ring row of block row i
      const int o = base + B + i;
      return o >= four_b ? o - four_b : o;
    };
    // two rows at a time for int8 (ILP); int4's 32 sums a row leave room
    // for one
    constexpr int NR = PACKED ? 1 : 2;
    int i = lo + rg;
    if (NR == 2) {
      for (; i + n_rg < hi; i += 2 * n_rg) {
        const int j = i - lo;
        const int orow[2] = {own(i), own(i + n_rg)};
        const float s_row[2] = {ssw[j], ssw[j + n_rg]};
        const int e0[2] = {FAR ? sptr[j] : 0, FAR ? sptr[j + n_rg] : 0};
        const int e1[2] = {FAR ? sptr[j + 1] : 0, FAR ? sptr[j + n_rg + 1] : 0};
        cross_rows<PACKED, FAR, 2, KC>(acc, lane, sidx + j * k, swq + j * k, n_rg * k, k,
                                       rb_shift, orow, s_row, e0, e1, far_q, far, fs);
      }
    }
    for (; i < hi; i += n_rg) {
      const int j = i - lo;
      const int orow[1] = {own(i)};
      const float s_row[1] = {ssw[j]};
      const int e0[1] = {FAR ? sptr[j] : 0};
      const int e1[1] = {FAR ? sptr[j + 1] : 0};
      cross_rows<PACKED, FAR, 1, KC>(acc, lane, sidx + j * k, swq + j * k, 0, k, rb_shift,
                                     orow, s_row, e0, e1, far_q, far, fs);
    }
  }

  // Fixed-order reduction over the run's rows: the lanes of a warp that
  // share columns (a butterfly, the same sum in every lane), then the warps.
  for (int off = 1 << tpr_shift; off < 32; off <<= 1) {
#pragma unroll
    for (int v = 0; v < NV; ++v) acc[v] += __shfl_xor_sync(0xffffffffu, acc[v], off);
  }
  cp_async_wait<0>();
  __syncthreads();                              // the ring is free: reuse it
  const int tg = PACKED ? 2 * rb : rb;          // genes of the tile
  float* red = reinterpret_cast<float*>(ring);  // [kWarps][tg]
  const int warp = threadIdx.x / 32;
  if ((threadIdx.x & 31) < (1 << tpr_shift)) {
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      // the value's gene in the tile: int4's high nibbles are the first
      // half (genes c0 + ...), its low nibbles the second (gcols + c0 + ...)
      const int t = (v < 16 ? 0 : rb) + 16 * q + (v & 15);
      red[warp * tg + t] = acc[v];
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < tg; t += kThreads) {
    const int col = c0 + (PACKED && t >= rb ? t - rb : t);
    if (col < gcols) {
      float s = 0.f;
      for (int wi = 0; wi < kWarps; ++wi) s += red[wi * tg + t];
      const int G = PACKED ? 2 * gcols : gcols;
      const int gene = PACKED && t >= rb ? gcols + col : col;
      partial[static_cast<size_t>(run_i) * G + gene] = s;
    }
  }
}

template <bool PACKED, bool FAR>
cudaError_t launch(const int32_t* local_idx, const int8_t* wq, const float* sw,
                   const int8_t* zp, const int32_t* far_ptr, const int8_t* far_q,
                   const int8_t* zf, float* partial, int nb, int B, int k, int gcols,
                   int tile, int run, int chunk, int far_cap, cudaStream_t stream) {
  int rb_shift = 4;
  while ((1 << rb_shift) < tile) ++rb_shift;
  if (tile != (1 << rb_shift) || tile < 16 || tile > 256 || run < 1 || chunk < 1 ||
      chunk > B || far_cap < 0 || nb < 1 || k < 1 || gcols < 4 || gcols % 4)
    return cudaErrorInvalidValue;
  const size_t smem = int_ring_bytes(B, tile, PACKED) + 2 * band_buf_bytes(chunk, k) +
                      2 * far_buf_bytes(far_cap, tile);
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  // the band's copies need 16-byte-aligned arrays (the wrapper sees to it)
  for (const void* p : {static_cast<const void*>(local_idx), static_cast<const void*>(wq),
                        static_cast<const void*>(sw), static_cast<const void*>(far_ptr),
                        static_cast<const void*>(far_q)})
    if (reinterpret_cast<uintptr_t>(p) % 16) return cudaErrorMisalignedAddress;
  if (reinterpret_cast<uintptr_t>(zp) % 4 || reinterpret_cast<uintptr_t>(zf) % 4)
    return cudaErrorMisalignedAddress;
  const bool vec = gcols % 16 == 0 && reinterpret_cast<uintptr_t>(zp) % 16 == 0;
  const bool fvec = gcols % 16 == 0 && reinterpret_cast<uintptr_t>(zf) % 16 == 0;
  const long long n_ct = (gcols + tile - 1) / tile;
  const long long ctas = n_ct * ((nb + run - 1) / run);
  if (ctas > 0x7fffffffLL) return cudaErrorInvalidValue;
  // the common kNN band (k = 6) with its slot loop unrolled
  auto kernel = k == 6 ? band_cross_int_kernel<PACKED, FAR, 6>
                       : band_cross_int_kernel<PACKED, FAR, 0>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(ctas), kThreads, smem, stream>>>(
      local_idx, reinterpret_cast<const unsigned char*>(wq),
      reinterpret_cast<const unsigned char*>(sw), reinterpret_cast<const unsigned char*>(zp),
      reinterpret_cast<const unsigned char*>(far_ptr), far_q,
      reinterpret_cast<const unsigned char*>(zf), partial, nb, B, k, gcols, rb_shift, run,
      chunk, far_cap, static_cast<int>(n_ct), vec, fvec);
  return cudaGetLastError();
}

}  // namespace

// partial: float [ceil(nb / run), G] with G = gcols (int8) or 2*gcols
// (packed int4). far_ptr == nullptr runs the band-only form (K3). tile
// (packed columns per CTA), run (band blocks per CTA), chunk (band rows
// per pipeline stage) and far_cap (far entries of a chunk staged in shared
// memory) come from band_cross.int_tiles.
extern "C" int sct_band_cross_int8(const int32_t* local_idx, const int8_t* wq,
                                   const float* sw, const int8_t* zp,
                                   const int32_t* far_ptr, const int8_t* far_q,
                                   const int8_t* zf, float* partial, int nb,
                                   int B, int k, int gcols, int packed, int tile,
                                   int run, int chunk, int far_cap, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (packed) {
    err = far_ptr ? launch<true, true>(local_idx, wq, sw, zp, far_ptr, far_q, zf, partial,
                                       nb, B, k, gcols, tile, run, chunk, far_cap, s)
                  : launch<true, false>(local_idx, wq, sw, zp, far_ptr, far_q, zf, partial,
                                        nb, B, k, gcols, tile, run, chunk, far_cap, s);
  } else {
    err = far_ptr ? launch<false, true>(local_idx, wq, sw, zp, far_ptr, far_q, zf, partial,
                                        nb, B, k, gcols, tile, run, chunk, far_cap, s)
                  : launch<false, false>(local_idx, wq, sw, zp, far_ptr, far_q, zf, partial,
                                         nb, B, k, gcols, tile, run, chunk, far_cap, s);
  }
  return static_cast<int>(err);
}
