// Local statistics' permutation nulls in the int8 system: the fused draw
// step, and the observed statistic of the same operator, for local Moran
// (LISA), local Geary, Getis-Ord Gi* / Gi and local Lee's L.
//
//   lag_i[g]  = sum_slots wq * z[window + local_idx][g]             (band)
//             + far_i[g]                                            (far)
//   z[p][g]   = table[rows[p]][g]       (the draw's codes, read through
//               its rows: rows[p] is the table row at padded position p)
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
//   kLee       Lq = x*lag, |Lq| >= obs                 (K7 :1511-1516, int32;
//              x is the row's FIXED code of the pair's first gene, an int8
//              plane of its own -- Lee's null permutes y only, so the
//              slab's own row is not used. Second output: the per-block
//              f32 partial part[n][g] = sum_rows sw_row * f32(Lq) of the
//              global L, in one fixed order: row group q (rows q, q+16, ...)
//              sums its rows in row order with __fmul_rn / __fadd_rn, then
//              the 16 group sums are added in group order through shared
//              memory; no atomics, so the partial is bitwise the plain
//              version's and the same in every run)
// The observed entry returns |z*lag| (moran), the geary value, the binary
// lag (getis; the wrapper forms A_o, cp_o from it), or |Lq| and the
// partial (lee; without an output plane: the partial alone), replacing the
// reference's XLA observed passes (abs_ip :2369, geary_q :2899, lag_me_q
// :3184). The moran far term also arrives densely (K8, _band_lag_count_
// kernel_i8 :1291); the far term comes in one of three forms (template FAR):
//   kFarRows  row pointers into the compact far list: far_ptr int32 [Npad+1],
//             far_q int8 [F] weight codes, far_rows int64 [F] each entry's
//             table row (the draw's rows at the far targets), so far values
//             are read through the permutation too
//             (the function of K7; the list is sorted by source row, so row
//             r's entries are [far_ptr[r], far_ptr[r+1]) -- no S-row windows
//             and no one-hot operator, which were BlockSpec artefacts);
//   kFarDense a dense int32 far layer [Npad, G] (the function of K8, moran);
//   kFarNone  no far edges (moran; the other statistics take an empty list).
//
// What bounds it on the H100: bytes, and their latency. Per draw at 1M
// cells x 1,024 genes the function must read ~1.0 GB of codes (random rows
// of the table: 128-byte row segments at a 128-gene tile), 4.3 GB of
// int32 (or f32) observed values, ~0.27 GB of far values and the
// int8 counters (1.0 GB), and write the counters back (1.0 GB): ~7.5 GB,
// ~2.2 ms at 3.35 TB/s. Gi adds its observed int32 lag and int8 own codes,
// Lee 1.0 GB of fixed x codes, K8 4.3 GB of dense far layer. The integer
// work is ~k+2 multiply-adds per value (2k+3 for geary), well below the
// card's integer issue over that time once the slots go four to a dp4a.
//
// Design: one main loop for every (STAT, FAR, COUNT, counter type)
// instance the C entries dispatch; launch shape from
// kernels/lisa_count.lisa_tiles.
// - A CTA of 512 threads owns a column tile of rb genes (a power of two,
//   16..128) and walks a run of R consecutive band blocks on K4's 4-slot
//   slab ring (slab_ring.cuh): slab m+2 is copied by cp.async while block
//   m-1 computes, so the draw's codes cross HBM (R+2)/R times, 16 bytes a
//   copy (4 for a ragged G). Per draw nothing is gathered first: a slab's
//   ring row r comes straight from table row rows[s*B + r]
//   (fill_slot_rows), a far entry's values from table row far_rows[e].
//   The row indices are staged in shared memory by cp.async ahead of the
//   copies that read them, so neither a copy nor a register waits on one.
// - A block's rows go in chunks of up to four rows a thread. Each chunk's
//   band rows (local_idx, wq, the row vector, far row pointers) and its
//   first far entries are staged by cp.async S - 1 chunks ahead, one group
//   a chunk; window rows become ring offsets as the slots are read.
// - The streamed planes (obs, the counters, Gi's lag_o / me_o, Lee's zx,
//   K8's dense far layer) bypass shared memory: each thread reads its next
//   row's into registers (16-byte streaming loads) while it sums the
//   current one, so they stay in flight across the chunks' barriers.
//   Counters are written back in place, 4 genes a store.
// - A thread owns 16 genes of a row (8 in Gi's draw step, whose 10 bytes of
//   planes a gene would not fit the registers at 16). Lags go through
//   int_dot.cuh: byte transposes and dp4a four slots at a time, a last pair
//   by dp2a, far entries one dp4a a word; exact int32, so no count moves.
//   Geary's sum of w*z^2: where a slot group's nonzero weights are one code
//   w (the kNN band's rule), w times one dp4a of the masked transposed word
//   with itself, else an IMAD a code.
// - Lee's block partials keep their order: each chunk's f32 products
//   sw*f32(Lq) go to shared memory, and (row group q, gene) pairs add rows
//   q, q+16, ... in row order across the block's chunks; at the block's end
//   the 16 group sums are added in group order. No atomics.
// - Integer arithmetic wherever the reference's decision is integer; the
//   Gi / Gi* f32 operations are explicitly rounded intrinsics, per value.
//
// Why this shape (chip_smoke's launch-shape timings, PERF.md): a chunk's
// barrier waits for its slowest row, so the rows a thread sums between two
// barriers set the pace; staging the planes through shared memory a chunk
// ahead, at any depth, left them latency-bound behind those barriers, and
// reading them a row ahead into registers does not. The draw's row indices
// take the opposite road: every counting instance already uses the 128
// registers a thread may have, and holding the next copies' indices in
// registers (loaded an issue ahead) left the moran and lee draw steps at 1M
// cells 24% and 35% slower than on a gathered table; loading them as each
// copy is issued, 20% and 47% slower. Staged in shared memory they cost 3%
// and 6% (lee's buffers then fit two rows a thread at 64-gene tiles only).

#include "int_dot.cuh"

namespace {

constexpr int kThreads = 512;                   // mirrors lisa_count._THREADS
constexpr size_t kSmemMax = 232448;             // 227 KB a block may use on sm_90
constexpr int kLeeGroups = 16;                  // Lee's row groups (the partials' order)

enum FarForm { kFarNone = 0, kFarRows = 1, kFarDense = 2 };
enum Stat { kMoran = 0, kGeary = 1, kGetisStar = 2, kGetisG = 3, kLee = 4 };
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
  const int8_t* zx;       // lee: fixed x codes [Npad, G]
  const float* sw;        // lee: row weight scales sw_row [Npad]
  float* part;            // lee: per-block partials of the global L [nb, G]
};

// The common operands and the launch shape.
struct Args {
  const int32_t* local_idx;
  const int8_t* wq;
  const int8_t* table;    // value codes [T, G]
  const int64_t* rows;    // the draw's table row of each padded position [(nb+2)*B]
  const int32_t* far_ptr;
  const int8_t* far_q;
  const int64_t* far_rows;  // the table row of each far entry [F]
  const int32_t* far_dense;
  const int32_t* obs;
  void* cnt;
  int32_t* out;
  int nb, B, k, G;
  int rb_shift, run, chunk, far_cap, stages, n_ct;
  bool vec;               // byte planes and table rows in whole 16-byte copies
};

// Shared-memory layout, mirrored by lisa_count.lisa_smem_bytes: the ring
// [4B, rb], then per pipeline stage a band buffer and (row-pointer far) a
// far buffer, then Getis's two column vectors [rb] f32, Lee's products
// [chunk, rb] f32 and group sums [16, rb] f32.
struct Layout {
  size_t band, far, colv, prod, red, sidx, fidx, frng, total;
};
__host__ __device__ inline Layout layout(int B, int rb, int chunk, int k, int far_cap,
                                         int stages, bool rows_far, bool colv, bool lee) {
  Layout L{};
  size_t o = 4 * static_cast<size_t>(B) * rb;
  L.band = o;
  o += stages * band_buf_bytes(chunk, k);
  L.far = o;
  if (rows_far) o += stages * far_buf_bytes(far_cap, rb);
  o = round16(o);
  L.colv = o;
  if (colv) o += 2 * static_cast<size_t>(rb) * 4;
  L.prod = o;
  if (lee) o += static_cast<size_t>(chunk) * rb * 4;
  L.red = o;
  if (lee) o += static_cast<size_t>(kLeeGroups) * rb * 4;
  L.sidx = o;                                   // three slabs' row indices
  o += 3 * stage_buf_bytes(static_cast<size_t>(B) * 8);
  L.fidx = o;                                   // a stage's far rows, S of them
  if (rows_far) o += stages * stage_buf_bytes(static_cast<size_t>(far_cap) * 8);
  L.frng = o;                                   // 2S - 1 chunks' far ranges
  if (rows_far) o += round16((2 * static_cast<size_t>(stages) - 1) * 8);
  L.total = o;
  return L;
}

// Four counters of any type, loaded and stored.
__device__ __forceinline__ void load_cnt(const int8_t* p, int* c) {
  const int w = *reinterpret_cast<const int*>(p);
#pragma unroll
  for (int j = 0; j < 4; ++j) c[j] = static_cast<int8_t>(w >> (8 * j));
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

template <typename V>
__device__ __forceinline__ int code_of(const V& v, int g) {
  return static_cast<int8_t>(word_of(v, g >> 2) >> (8 * (g & 3)));
}

// The band lag of one row (s.lo: a thread's genes) and, for SQ (geary),
// the lag of the squared codes: slots four at a time by dp4a, the last two
// or one by dp2a (int_dot.cuh). bi: the slots' window rows, turned into
// ring rows here (window row j is ring row (base + j) mod 4B); bw: the
// weight codes. Geary's squares: where a group's nonzero weights are one
// code w (the kNN band's rule), w times one dp4a of the masked transposed
// word with itself; else an IMAD a code.
template <bool SQ, int KC, int NW>
__device__ __forceinline__ void band_lag(Sums<false, NW>& s, int* lag2, const unsigned char* lane,
                                         const int32_t* bi, const int8_t* bw, int k, int base,
                                         int four_b, int rb_shift) {
  using LT = typename Lane<NW>::type;
  const int kk = KC > 0 ? KC : k;
  const int k4 = kk & ~3;
  auto value = [&](int t) {
    int rr = base + bi[t];
    rr = rr >= four_b ? rr - four_b : rr;
    return *reinterpret_cast<const LT*>(lane + (rr << rb_shift));
  };
  // a group's weights ww: m = 0xFF where one is nonzero; true (with that
  // code in w0) when every nonzero one is the same code
  auto uniform = [](int ww, uint32_t& m, int& w0) {
    const uint32_t w = static_cast<uint32_t>(ww);
    m = __vcmpne4(w, 0u);
    if (m == 0) {
      w0 = 0;
      return true;
    }
    const uint32_t c = (w >> ((__ffs(m) - 1) & ~7)) & 0xFFu;
    w0 = static_cast<int8_t>(c);
    return (w & m) == (c * 0x01010101u & m);
  };
  // lag2 += the group's weighted squares, by IMAD
  auto squares = [&](const LT* v, int t0, int n) {
#pragma unroll
    for (int t = 0; t < n; ++t) {
      const int w = bw[t0 + t];
#pragma unroll
      for (int g = 0; g < 4 * NW; ++g) {
        const int z = code_of(v[t], g);
        lag2[g] += w * (z * z);
      }
    }
  };
  // four slots (n of them real), with geary's squares where their nonzero
  // weights are one code, else after them
  auto group = [&](const LT* v, int ww, int t0, int n) {
    uint32_t m = 0;
    int w0 = 0;
    if (SQ && uniform(ww, m, w0)) {
      slots4<false, NW, true>(s, v, ww, lag2, m, w0);
    } else {
      slots4<false, NW>(s, v, ww);
      if (SQ) squares(v, t0, n);
    }
  };
  auto group4 = [&](int t0) {
    const LT v[4] = {value(t0), value(t0 + 1), value(t0 + 2), value(t0 + 3)};
    group(v, weight_word(bw, t0, 4), t0, 4);
  };
  if constexpr (KC > 0) {
#pragma unroll
    for (int t0 = 0; t0 < k4; t0 += 4) group4(t0);
  } else {
    for (int t0 = 0; t0 < k4; t0 += 4) group4(t0);
  }
  const int rest = kk - k4;
  if (rest == 3) {
    const LT v[4] = {value(k4), value(k4 + 1), value(k4 + 2), LT{}};
    group(v, weight_word(bw, k4, 3), k4, 3);
  } else if (rest > 0) {
    const LT v[2] = {value(k4), rest == 2 ? value(k4 + 1) : LT{}};
    const int ww = weight_word(bw, k4, rest);
    uint32_t m = 0;
    int w0 = 0;
    if (SQ && uniform(ww, m, w0)) {
      slots2<false, NW, true>(s, v, bytes_to_halves(ww), lag2, m, w0);
    } else {
      slots2<false, NW>(s, v, bytes_to_halves(ww));
      if (SQ) squares(v, k4, rest);
    }
  }
}

// The streamed planes of one row at a thread's 4 * NW genes, read from
// global memory into registers one row ahead of their use (groups of 4
// genes past G read as zeros and are not stored): obs and the counters
// (draw steps), Gi's observed lag and own codes, K8's dense far layer,
// Lee's x codes.
template <int STAT, int FAR, bool COUNT, typename CT, int NW>
struct RowPlanes {
  struct P {
    static constexpr bool obs = COUNT, cnt = COUNT;
    static constexpr bool lag_o = COUNT && STAT == kGetisG, me_o = lag_o;
    static constexpr bool dense = FAR == kFarDense, zx = STAT == kLee;
  };
  int4 obs[P::obs ? NW : 1];
  int4 lag_o[P::lag_o ? NW : 1];
  int4 dense[P::dense ? NW : 1];
  int cnt[P::cnt ? 4 * NW : 1];
  uint32_t me_o[P::me_o ? NW : 1];
  uint32_t zx[P::zx ? NW : 1];

  __device__ __forceinline__ void load(const Args& a, const Tail& t, size_t r, int col) {
    const size_t o = r * a.G + col;
#pragma unroll
    for (int q = 0; q < NW; ++q) {
      const bool in = col + 4 * q < a.G;
      const size_t oq = o + 4 * q;
      if (P::obs) obs[q] = in ? __ldcs(reinterpret_cast<const int4*>(a.obs + oq)) : int4{};
      if (P::lag_o) lag_o[q] = in ? __ldcs(reinterpret_cast<const int4*>(t.lag_o + oq)) : int4{};
      if (P::dense)
        dense[q] = in ? __ldcs(reinterpret_cast<const int4*>(a.far_dense + oq)) : int4{};
      if (P::cnt) {
        if (in) load_cnt(static_cast<const CT*>(a.cnt) + oq, cnt + 4 * q);
        else cnt[4 * q] = cnt[4 * q + 1] = cnt[4 * q + 2] = cnt[4 * q + 3] = 0;
      }
      if (P::me_o) me_o[q] = in ? __ldcs(reinterpret_cast<const unsigned*>(t.me_o + oq)) : 0u;
      if (P::zx) zx[q] = in ? __ldcs(reinterpret_cast<const unsigned*>(t.zx + oq)) : 0u;
    }
  }
};

// ---------------------------------------------------------------------------
// The kernel: COUNT, a draw step (obs, cnt); else an observed pass (out;
// Lee's partial-only entry: neither). CT: the counter type.
// ---------------------------------------------------------------------------

template <int STAT, int FAR, bool COUNT, typename CT, int KC>
__global__ void __launch_bounds__(kThreads, 1)
lisa_kernel(const Args a, const Tail t) {
  constexpr bool kColv = COUNT && (STAT == kGetisStar || STAT == kGetisG);
  // the 4-byte words of a row a thread owns (lisa_count._genes): 4 (16
  // genes), or 2 in Gi's draw step, whose 10 bytes of planes a gene would
  // not fit the registers at 16
  constexpr int NW = COUNT && STAT == kGetisG ? 2 : 4;
  constexpr int NG = 4 * NW;                        // ... and genes
  using LT = typename Lane<NW>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  const int B = a.B, k = a.k, G = a.G, C = a.chunk, rb_shift = a.rb_shift;
  const int rb = 1 << rb_shift;
  const int S = a.stages;                           // pipeline stages
  const Layout L = layout(B, rb, C, k, a.far_cap, S, FAR == kFarRows, kColv, STAT == kLee);
  unsigned char* ring = smem;
  unsigned char* band = smem + L.band;
  unsigned char* fbuf = smem + L.far;
  float* colv = reinterpret_cast<float*>(smem + L.colv);
  float* prod = reinterpret_cast<float*>(smem + L.prod);
  float* red = reinterpret_cast<float*>(smem + L.red);
  const int idx_b = static_cast<int>(idx_buf_bytes(C, k));
  const int wq_b = static_cast<int>(wq_buf_bytes(C, k));
  const int row_b = static_cast<int>(row_buf_bytes(C));
  const int buf = static_cast<int>(band_buf_bytes(C, k));
  const int fbuf_b = static_cast<int>(far_buf_bytes(a.far_cap, rb));

  const int c0 = (blockIdx.x % a.n_ct) * rb;        // first gene of the tile
  const int n0 = (blockIdx.x / a.n_ct) * a.run;
  const int n1 = min(n0 + a.run, a.nb);
  const int nc = (B + C - 1) / C;                   // chunks per block
  const int steps = (n1 - n0) * nc;                 // chunks of the run
  const int tpr_shift = rb_shift - (NW == 4 ? 4 : 3);  // threads of a row (log2)
  const int lane_i = threadIdx.x & ((1 << tpr_shift) - 1);
  const int rg = threadIdx.x >> tpr_shift;
  const int n_rg = kThreads >> tpr_shift;
  const int col = c0 + NG * lane_i;             // this thread's first gene
  const int four_b = 4 * B;
  const void* rowv = STAT == kGeary ? static_cast<const void*>(t.row_i)
                     : STAT == kLee ? static_cast<const void*>(t.sw)
                     : STAT == kMoran ? nullptr : static_cast<const void*>(t.row_f);
  const unsigned char* li = reinterpret_cast<const unsigned char*>(a.local_idx);
  const unsigned char* wqb = reinterpret_cast<const unsigned char*>(a.wq);
  const unsigned char* tab = reinterpret_cast<const unsigned char*>(a.table);
  // far values past a chunk's staged ones: the entry's table row, read here
  const FarRow<NW> far{tab + col, G, G - col, a.vec};

  auto chunk_rows = [&](int st, size_t& r0, int& rows) {
    const int c = st % nc;
    r0 = static_cast<size_t>(n0 + st / nc) * B + c * C;
    rows = min(C, B - c * C);
  };
  // chunk st's band rows into buffer st % S
  auto stage = [&](int st) {
    size_t r0;
    int rows;
    chunk_rows(st, r0, rows);
    unsigned char* b = band + (st % S) * buf;
    stage_bytes<kThreads>(b, li, r0 * k * 4, rows * k * 4);
    stage_bytes<kThreads>(b + idx_b, wqb, r0 * k, rows * k);
    if (rowv != nullptr)
      stage_bytes<kThreads>(b + idx_b + wq_b, static_cast<const unsigned char*>(rowv), r0 * 4,
                            rows * 4);
    if (FAR == kFarRows)
      stage_bytes<kThreads>(b + idx_b + wq_b + row_b,
                            reinterpret_cast<const unsigned char*>(a.far_ptr), r0 * 4,
                            (rows + 1) * 4);
  };
  // The draw's row indices pass through shared memory, staged by cp.async
  // as the copies are, so no copy waits on an index and no register holds
  // one: slab s's B rows in slot s % 3, a ring step before its fill; chunk
  // st's far range (2 ints of far_ptr) in slot st % R, 2(S - 1) stages
  // before its values, and its first far_cap far rows in slot st % S, S - 1
  // stages before.
  unsigned char* sidx = smem + L.sidx;
  unsigned char* fidx = smem + L.fidx;
  int2* frng = reinterpret_cast<int2*>(smem + L.frng);
  const int sb = static_cast<int>(stage_buf_bytes(static_cast<size_t>(B) * 8));
  const int fb = static_cast<int>(stage_buf_bytes(static_cast<size_t>(a.far_cap) * 8));
  const int R = 2 * S - 1;
  auto slab_rows = [&](int s) {
    return reinterpret_cast<int64_t*>(sidx + (s % 3) * sb +
                                      ((static_cast<size_t>(s) * B * 8) & 15));
  };
  auto stage_slab_rows = [&](int s) {
    stage_bytes<kThreads>(sidx + (s % 3) * sb, reinterpret_cast<const unsigned char*>(a.rows),
                          static_cast<size_t>(s) * B * 8, B * 8);
  };
  auto far_range = [&](int st) {
    size_t r0;
    int rows;
    chunk_rows(st, r0, rows);
    return make_int2(__ldg(a.far_ptr + r0), __ldg(a.far_ptr + r0 + rows));
  };
  auto stage_range = [&](int st) {                  // threads 0 and 1
    if (threadIdx.x < 2) {
      size_t r0;
      int rows;
      chunk_rows(st, r0, rows);
      cp_async4(reinterpret_cast<int*>(frng + st % R) + threadIdx.x,
                a.far_ptr + r0 + (threadIdx.x ? rows : 0), 4);
    }
  };
  auto far_rows = [&](int st, int2 p) {
    return reinterpret_cast<int64_t*>(fidx + (st % S) * fb +
                                      ((static_cast<size_t>(p.x) * 8) & 15));
  };
  auto stage_far_rows = [&](int st) {
    const int2 p = frng[st % R];
    stage_bytes<kThreads>(fidx + (st % S) * fb,
                          reinterpret_cast<const unsigned char*>(a.far_rows),
                          static_cast<size_t>(p.x) * 8, min(p.y - p.x, a.far_cap) * 8);
  };
  // the first far_cap far entries of chunk st into far buffer st % S, each
  // from the table row its staged far row names
  auto stage_far = [&](int st) {
    const int2 p = frng[st % R];
    const int n = min(p.y - p.x, a.far_cap);
    const int64_t* src_rows = far_rows(st, p);
    unsigned char* f = fbuf + (st % S) * fbuf_b;
    const int q_shift = rb_shift - 4;               // 16-byte copies of a row
    for (int v = threadIdx.x; v < n << q_shift; v += kThreads) {
      const int x = v >> q_shift, l = v & ((1 << q_shift) - 1);
      const int g = c0 + 16 * l;
      const unsigned char* src = tab + static_cast<size_t>(src_rows[x]) * G + g;
      unsigned char* dst = f + (x << rb_shift) + 16 * l;
      if (a.vec) {
        cp_async16(dst, g < G ? src : tab, g < G ? 16 : 0);
      } else {
#pragma unroll
        for (int w = 0; w < 4; ++w)
          cp_async4(dst + 4 * w, g + 4 * w < G ? src + 4 * w : tab, g + 4 * w < G ? 4 : 0);
      }
    }
    stage_bytes<kThreads>(f + a.far_cap * rb, reinterpret_cast<const unsigned char*>(a.far_q),
                          p.x, n);
  };

  if (kColv) {                                      // the tile's column vectors
    for (int g = threadIdx.x; g < rb; g += kThreads) {
      const bool in = c0 + g < G;
      colv[g] = in && t.col_a != nullptr ? t.col_a[c0 + g] : 0.f;
      colv[rb + g] = in && t.col_b != nullptr ? t.col_b[c0 + g] : 0.f;
    }
  }
  // Pipeline: stage st's copies (band, far entries and, at a block's first
  // chunk, its window's last slab) go out S - 1 stages ahead, one cp.async
  // group a stage, with the row indices of later copies. Slab m + 2 (block
  // m's last) lands in the slot slab m - 2 held; with S - 1 <= chunks a
  // block, block m - 2 is done when it is issued, and so is every index
  // staged for it. The streamed planes bypass shared memory: each thread
  // reads its next row's while it sums the current one.
  const int ahead = S - 1;
  auto issue = [&](int st) {
    if (st < steps) {
      stage(st);
      if (FAR == kFarRows) {
        stage_far(st);
        if (st + ahead < steps) stage_far_rows(st + ahead);
        if (st + 2 * ahead < steps) stage_range(st + 2 * ahead);
      }
      const int m = n0 + st / nc;
      if (st % nc == 0) {
        if (m > n0)
          fill_slot_rows<kThreads>(ring, tab, slab_rows(m + 2), m + 2, B, G, c0, rb_shift,
                                   a.vec);
        if (m + 3 <= n1 + 1) stage_slab_rows(m + 3);
      }
    }
    cp_async_commit();
  };
  // the first three slabs' rows, the first 2(S - 1) far ranges and the
  // first S - 1 chunks' far rows, read directly
  if (threadIdx.x < B) {
    int64_t r[3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
      r[i] = __ldg(a.rows + static_cast<size_t>(n0 + i) * B + threadIdx.x);
#pragma unroll
    for (int i = 0; i < 3; ++i) slab_rows(n0 + i)[threadIdx.x] = r[i];
  }
  if (FAR == kFarRows)
    for (int j = threadIdx.x; j < min(2 * ahead, steps); j += kThreads) frng[j % R] = far_range(j);
  __syncthreads();
  if (FAR == kFarRows) {
    for (int j = 0; j < min(ahead, steps); ++j) {
      const int2 p = frng[j % R];
      int64_t* fr = far_rows(j, p);
      for (int x = threadIdx.x; x < min(p.y - p.x, a.far_cap); x += kThreads)
        fr[x] = __ldg(a.far_rows + p.x + x);
    }
  }
  fill_slot_rows<kThreads>(ring, tab, slab_rows(n0), n0, B, G, c0, rb_shift, a.vec);
  fill_slot_rows<kThreads>(ring, tab, slab_rows(n0 + 1), n0 + 1, B, G, c0, rb_shift, a.vec);
  fill_slot_rows<kThreads>(ring, tab, slab_rows(n0 + 2), n0 + 2, B, G, c0, rb_shift, a.vec);
  // a barrier before each issue, as in the loop: issue(st) restages index
  // slots that issue(st - 1) read (issue(0): slab n0's)
  for (int st = 0; st < ahead; ++st) {
    __syncthreads();
    issue(st);
  }

  // this thread's first row at or after stage st (false: none)
  auto first_row = [&](int st, size_t& r) {
    for (; st < steps; ++st) {
      size_t r0;
      int rows;
      chunk_rows(st, r0, rows);
      if (rg < rows) {
        r = r0 + rg;
        return true;
      }
    }
    return false;
  };
  RowPlanes<STAT, FAR, COUNT, CT, NW> cur, nxt;
  {
    size_t r;
    if (first_row(0, r)) cur.load(a, t, r, col);
  }

  constexpr int kPairs = (kLeeGroups * 128 + kThreads - 1) / kThreads;  // Lee: (group, gene)
  float acc[kPairs] = {};                                                // pairs a thread
  const unsigned char* lane = ring + NG * lane_i;

  for (int st = 0; st < steps; ++st) {
    const int n = n0 + st / nc;
    const int c = st % nc;
    // stage st's group is done when at most ahead - 1 later ones are in flight
    if (ahead == 1) cp_async_wait<0>();
    else if (ahead == 2) cp_async_wait<1>();
    else cp_async_wait<2>();
    __syncthreads();                                // also: stage st-1's reads are done
    issue(st + ahead);

    const size_t r0 = static_cast<size_t>(n) * B + c * C;
    const unsigned char* b = band + (st % S) * buf;
    const int32_t* sidx = reinterpret_cast<const int32_t*>(b + ((r0 * k * 4) & 15));
    const int8_t* swq = reinterpret_cast<const int8_t*>(b + idx_b + ((r0 * k) & 15));
    const unsigned char* srow = b + idx_b + wq_b + ((r0 * 4) & 15);
    const int32_t* sptr =
        reinterpret_cast<const int32_t*>(b + idx_b + wq_b + row_b + ((r0 * 4) & 15));
    const int base = (n & 3) * B;                   // ring row of window row 0
    const int lo = c * C;
    const int hi = min(B, lo + C);
    FarStage fs{};
    if (FAR == kFarRows) {
      const unsigned char* f = fbuf + (st % S) * fbuf_b;
      fs.e0 = sptr[0];
      fs.n = min(sptr[hi - lo] - fs.e0, a.far_cap);
      fs.vals = f + NG * lane_i;
      fs.q = reinterpret_cast<const int8_t*>(f + a.far_cap * rb + (fs.e0 & 15));
    }

    for (int i = lo + rg; i < hi; i += n_rg) {
      const int j = i - lo;                         // row of the chunk
      const size_t r = r0 + j;
      {                                             // the next row's planes, in flight
        size_t rn;
        if (i + n_rg < hi) nxt.load(a, t, r + n_rg, col);
        else if (first_row(st + 1, rn)) nxt.load(a, t, rn, col);
      }
      Sums<false, NW> s;
      int lag2[STAT == kGeary ? NG : 1];
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        s.lo[g] = 0;
        if constexpr (STAT == kGeary) lag2[g] = 0;
      }
      band_lag<STAT == kGeary, KC, NW>(s, lag2, lane, sidx + j * k, swq + j * k, k, base, four_b,
                                   rb_shift);
      if (FAR == kFarRows) {                        // staged entries, then the rest
        const int e1 = sptr[j + 1];
        for (int e = sptr[j]; e < e1; ++e) {
          const int x = e - fs.e0;
          const bool staged = x < fs.n;
          const LT v = staged ? *reinterpret_cast<const LT*>(fs.vals + (x << rb_shift))
                                 : far.load(static_cast<int>(__ldg(a.far_rows + e)));
          const int q = staged ? fs.q[x] : a.far_q[e];
          far1<false>(s, v, q);
          if constexpr (STAT == kGeary) {
#pragma unroll
            for (int g = 0; g < NG; ++g) {
              const int z = code_of(v, g);
              lag2[g] += q * (z * z);
            }
          }
        }
      } else if (FAR == kFarDense) {
#pragma unroll
        for (int q = 0; q < NW; ++q) {
          const int4 f = cur.dense[q];
          s.lo[4 * q] += f.x; s.lo[4 * q + 1] += f.y;
          s.lo[4 * q + 2] += f.z; s.lo[4 * q + 3] += f.w;
        }
      }
      int own = base + B + i;                       // the row's own codes
      own = own >= four_b ? own - four_b : own;
      const LT zo = *reinterpret_cast<const LT*>(lane + (own << rb_shift));
      int val[NG];
      const int w_row = STAT == kGeary ? reinterpret_cast<const int32_t*>(srow)[j] : 0;
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const int z = code_of(zo, g);
        const int lag = s.lo[g];
        if (STAT == kMoran) val[g] = abs(z * lag);               // <= k*127^3 < 2^31
        else if (STAT == kGeary) val[g] = z * z * w_row + lag2[g] - 2 * z * lag;
        else if (STAT == kGetisStar && COUNT) val[g] = lag + z;  // A = lag + own
        else val[g] = lag;                                       // Getis observed: lag
      }
      if (STAT == kLee) {
        const float sw = reinterpret_cast<const float*>(srow)[j];
        float4* pr = reinterpret_cast<float4*>(prod + (j << rb_shift) + NG * lane_i);
#pragma unroll
        for (int q = 0; q < NW; ++q) {
          float f[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int g = 4 * q + e;
            const int x = static_cast<int8_t>(cur.zx[q] >> (8 * e));
            const int lq = x * s.lo[g];                          // <= k*127^3 < 2^31
            val[g] = abs(lq);
            f[e] = __fmul_rn(sw, __int2float_rn(lq));
          }
          pr[q] = make_float4(f[0], f[1], f[2], f[3]);
        }
      }
      if (!COUNT) {
        if (a.out != nullptr) {                     // lee: the partial-only entry
#pragma unroll
          for (int q = 0; q < NW; ++q)
            if (col + 4 * q < G)
              __stcs(reinterpret_cast<int4*>(a.out + r * G + col + 4 * q),
                     make_int4(val[4 * q], val[4 * q + 1], val[4 * q + 2], val[4 * q + 3]));
        }
        cur = nxt;
        continue;
      }
      CT* gc = static_cast<CT*>(a.cnt) + r * G + col;
      const float wr = (STAT == kGetisG || STAT == kGetisStar) && rowv != nullptr
                           ? reinterpret_cast<const float*>(srow)[j] : 0.f;
#pragma unroll
      for (int q = 0; q < NW; ++q) {
        const int4 o4 = cur.obs[q];
        const int ob[4] = {o4.x, o4.y, o4.z, o4.w};
        int lo4[4] = {0, 0, 0, 0};
        if (STAT == kGetisG) {
          const int4 l4 = cur.lag_o[q];
          lo4[0] = l4.x; lo4[1] = l4.y; lo4[2] = l4.z; lo4[3] = l4.w;
        }
        int cn[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int g = 4 * q + e;
          bool ext;
          if (STAT == kMoran || STAT == kLee) {
            ext = val[g] >= ob[e];
          } else if (STAT == kGeary) {
            ext = val[g] <= ob[e];
          } else if (STAT == kGetisStar) {
            if (t.alt == kGreater) {
              ext = val[g] >= ob[e];
            } else if (t.alt == kLess) {
              ext = val[g] <= ob[e];
            } else {
              const float c2 = __fmul_rn(colv[NG * lane_i + g], wr);
              const float x = __fsub_rn(__int2float_rn(val[g] + ob[e]), __fmul_rn(2.0f, c2));
              ext = __fmul_rn(__int2float_rn(val[g] - ob[e]), x) >= 0.0f;
            }
          } else {
            const int me_o = static_cast<int8_t>(cur.me_o[q] >> (8 * e));
            const int z = code_of(zo, g);
            const float cp = gi_center(z, val[g], wr, colv[NG * lane_i + g],
                                       colv[rb + NG * lane_i + g], t.inv_m);
            ext = tail_test(cp, __int_as_float(ob[e]), t.alt)
                  || (val[g] == lo4[e] && z == me_o);
          }
          cn[e] = cur.cnt[g] + ext;
        }
        if (col + 4 * q < G) store_cnt(gc + 4 * q, cn);
      }
      cur = nxt;
    }

    if constexpr (STAT == kLee) {
      // (row group q, gene) pairs add the chunk's rows q, q+16, ... in row
      // order; at the block's end the 16 group sums are added in group order
      __syncthreads();
#pragma unroll
      for (int x = 0; x < kPairs; ++x) {
        const int pq = threadIdx.x + x * kThreads;
        if (pq < kLeeGroups * rb) {
          const int q = pq >> rb_shift, g = pq & (rb - 1);
          for (int ii = lo + ((q - lo) & (kLeeGroups - 1)); ii < hi; ii += kLeeGroups)
            acc[x] = __fadd_rn(acc[x], prod[((ii - lo) << rb_shift) + g]);
        }
      }
      if (c == nc - 1) {
#pragma unroll
        for (int x = 0; x < kPairs; ++x) {
          const int pq = threadIdx.x + x * kThreads;
          if (pq < kLeeGroups * rb) red[pq] = acc[x];
          acc[x] = 0.f;
        }
        __syncthreads();
        for (int g = threadIdx.x; g < rb; g += kThreads) {
          if (c0 + g < G) {
            float sum = 0.f;
#pragma unroll
            for (int q = 0; q < kLeeGroups; ++q) sum = __fadd_rn(sum, red[(q << rb_shift) + g]);
            t.part[static_cast<size_t>(n) * G + c0 + g] = sum;
          }
        }
      }
    }
  }
  cp_async_wait<0>();
}

// The launch shape: tile genes per CTA (a power of two, 16..128), run
// blocks per CTA, chunk rows per stage, far_cap far entries staged a
// chunk, stages in the pipeline (2..4, at most one more than the chunks of
// a block).
struct Shape {
  int tile, run, chunk, far_cap, stages;
};

bool aligned(const void* p, int n) { return reinterpret_cast<uintptr_t>(p) % n == 0; }

template <int STAT, int FAR, bool COUNT, typename CT>
cudaError_t launch(Args a, const Tail& t, const Shape& sh, cudaStream_t stream) {
  int rb_shift = 4;
  while ((1 << rb_shift) < sh.tile) ++rb_shift;
  if (sh.tile != (1 << rb_shift) || sh.tile > 128 || sh.run < 1 || sh.chunk < 1 ||
      sh.chunk > a.B || sh.far_cap < 0 || a.nb < 1 || a.B < 1 || a.B > kThreads ||
      a.k < 1 || a.G < 4 ||
      a.G % 4 || sh.stages < 2 || sh.stages > 4 ||
      sh.stages - 1 > (a.B + sh.chunk - 1) / sh.chunk)
    return cudaErrorInvalidValue;
  const bool colv = COUNT && (STAT == kGetisStar || STAT == kGetisG);
  const size_t smem = layout(a.B, sh.tile, sh.chunk, a.k, sh.far_cap, sh.stages,
                             FAR == kFarRows, colv, STAT == kLee).total;
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  const void* rowv = STAT == kGeary ? static_cast<const void*>(t.row_i)
                     : STAT == kLee ? static_cast<const void*>(t.sw)
                     : STAT == kMoran ? nullptr : static_cast<const void*>(t.row_f);
  // the band's and the row indices' copies need 16-byte-aligned arrays,
  // the int32 / f32 planes 16-byte rows (the wrappers see to both)
  for (const void* p : {static_cast<const void*>(a.local_idx), static_cast<const void*>(a.wq),
                        rowv, static_cast<const void*>(a.far_ptr),
                        static_cast<const void*>(a.far_q), static_cast<const void*>(a.obs),
                        static_cast<const void*>(t.lag_o), static_cast<const void*>(a.far_dense),
                        static_cast<const void*>(a.rows), static_cast<const void*>(a.far_rows)})
    if (!aligned(p, 16)) return cudaErrorMisalignedAddress;
  if (!aligned(a.table, 4) || !aligned(a.cnt, 4 * sizeof(CT)) || !aligned(t.me_o, 4) ||
      !aligned(t.zx, 4))
    return cudaErrorMisalignedAddress;
  a.vec = a.G % 16 == 0 && aligned(a.table, 16) && aligned(a.cnt, 16) &&
          aligned(t.me_o, 16) && aligned(t.zx, 16);
  a.rb_shift = rb_shift;
  a.run = sh.run;
  a.chunk = sh.chunk;
  a.far_cap = sh.far_cap;
  a.stages = sh.stages;
  const long long n_ct = (a.G + sh.tile - 1) / sh.tile;
  const long long ctas = n_ct * ((a.nb + sh.run - 1) / sh.run);
  if (ctas > 0x7fffffffLL) return cudaErrorInvalidValue;
  a.n_ct = static_cast<int>(n_ct);
  // the draw steps of the common kNN band (k = 6) with the slot loop unrolled
  auto kernel = COUNT && a.k == 6 ? lisa_kernel<STAT, FAR, COUNT, CT, COUNT ? 6 : 0>
                                  : lisa_kernel<STAT, FAR, COUNT, CT, 0>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(ctas), kThreads, smem, stream>>>(a, t);
  return cudaGetLastError();
}

template <bool COUNT, typename CT>
cudaError_t moran_by_far(int far_form, const Args& a, const Shape& sh, cudaStream_t s) {
  const Tail t{};
  switch (far_form) {
    case kFarNone: return launch<kMoran, kFarNone, COUNT, CT>(a, t, sh, s);
    case kFarRows: return launch<kMoran, kFarRows, COUNT, CT>(a, t, sh, s);
    case kFarDense: return launch<kMoran, kFarDense, COUNT, CT>(a, t, sh, s);
    default: return cudaErrorInvalidValue;
  }
}

// geary / getis_star / getis_g, always with row-pointer far edges (an
// empty list when the plan has none)
template <bool COUNT, typename CT>
cudaError_t by_stat(int stat, const Args& a, const Tail& t, const Shape& sh, cudaStream_t s) {
  switch (stat) {
    case kGeary: return launch<kGeary, kFarRows, COUNT, CT>(a, t, sh, s);
    case kGetisStar: return launch<kGetisStar, kFarRows, COUNT, CT>(a, t, sh, s);
    case kGetisG: return launch<kGetisG, kFarRows, COUNT, CT>(a, t, sh, s);
    default: return cudaErrorInvalidValue;
  }
}

// Dispatch on the counter's bytes (1, 2 or 4: int8 / int16 / int32).
template <typename F>
cudaError_t by_counter(int cnt_bytes, F f) {
  switch (cnt_bytes) {
    case 1: return f(int8_t{});
    case 2: return f(int16_t{});
    case 4: return f(int32_t{});
    default: return cudaErrorInvalidValue;
  }
}

Args common(const int32_t* local_idx, const int8_t* wq, const int8_t* table,
            const int64_t* rows, const int32_t* far_ptr, const int8_t* far_q,
            const int64_t* far_rows, int nb, int B, int k, int G) {
  Args a{};
  a.local_idx = local_idx;
  a.wq = wq;
  a.table = table;
  a.rows = rows;
  a.far_ptr = far_ptr;
  a.far_q = far_q;
  a.far_rows = far_rows;
  a.nb = nb;
  a.B = B;
  a.k = k;
  a.G = G;
  return a;
}

}  // namespace

// Every entry takes the launch shape (tile, run, chunk, far_cap, stages)
// from lisa_count.lisa_tiles.

// LISA draw step: cnt [Npad, G] (cnt_bytes 1, 2 or 4: int8/int16/int32) +=
// (|z*lag| >= obs), in place. far_form: 0 none, 1 row pointers, 2 dense.
extern "C" int sct_lisa_count(const int32_t* local_idx, const int8_t* wq,
                              const int8_t* table, const int64_t* rows,
                              const int32_t* far_ptr, const int8_t* far_q,
                              const int64_t* far_rows,
                              const int32_t* far_dense, const int32_t* obs,
                              void* cnt, int nb, int B, int k, int G,
                              int far_form, int cnt_bytes, int tile, int run,
                              int chunk, int far_cap, int stages, void* stream) {
  Args a = common(local_idx, wq, table, rows, far_ptr, far_q, far_rows, nb, B, k, G);
  a.far_dense = far_dense;
  a.obs = obs;
  a.cnt = cnt;
  const Shape sh{tile, run, chunk, far_cap, stages};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(by_counter(cnt_bytes, [&](auto c) {
    return moran_by_far<true, decltype(c)>(far_form, a, sh, s);
  }));
}

// LISA observed: out int32 [Npad, G] = |z*lag| at the placement the caller
// given by rows (the identity placement for the observed statistic).
extern "C" int sct_lisa_observed(const int32_t* local_idx, const int8_t* wq,
                                 const int8_t* table, const int64_t* rows,
                                 const int32_t* far_ptr, const int8_t* far_q,
                                 const int64_t* far_rows,
                                 const int32_t* far_dense, int32_t* out, int nb,
                                 int B, int k, int G, int far_form, int tile,
                                 int run, int chunk, int far_cap, int stages,
                                 void* stream) {
  Args a = common(local_idx, wq, table, rows, far_ptr, far_q, far_rows, nb, B, k, G);
  a.far_dense = far_dense;
  a.out = out;
  return static_cast<int>(moran_by_far<false, int8_t>(
      far_form, a, Shape{tile, run, chunk, far_cap, stages}, static_cast<cudaStream_t>(stream)));
}

// Draw step of local Geary (stat 1) or Getis-Ord Gi* (2) / Gi (3), in
// place; far edges as row pointers. obs is int32 [Npad, G] (f32 for Gi);
// the tail operands are as struct Tail documents; alt: 0 two-sided,
// 1 greater, 2 less.
extern "C" int sct_local_count(int stat, int alt, const int32_t* local_idx,
                               const int8_t* wq, const int8_t* table,
                               const int64_t* rows, const int32_t* far_ptr,
                               const int8_t* far_q, const int64_t* far_rows,
                               const void* obs, void* cnt,
                               const int32_t* row_i, const float* row_f,
                               const float* col_a, const float* col_b,
                               const int32_t* lag_o, const int8_t* me_o,
                               float inv_m, int nb, int B, int k, int G,
                               int cnt_bytes, int tile, int run, int chunk,
                               int far_cap, int stages, void* stream) {
  Args a = common(local_idx, wq, table, rows, far_ptr, far_q, far_rows, nb, B, k, G);
  a.obs = static_cast<const int32_t*>(obs);
  a.cnt = cnt;
  const Tail t{row_i, row_f, col_a, col_b, lag_o, me_o, inv_m, alt};
  const Shape sh{tile, run, chunk, far_cap, stages};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(by_counter(cnt_bytes, [&](auto c) {
    return by_stat<true, decltype(c)>(stat, a, t, sh, s);
  }));
}

// Observed pass of local Geary (stat 1: the int32 geary value, row_i = W)
// or Getis-Ord (stat 2 or 3: the binary lag) at the placement in rows.
extern "C" int sct_local_observed(int stat, const int32_t* local_idx,
                                  const int8_t* wq, const int8_t* table,
                                  const int64_t* rows, const int32_t* far_ptr,
                                  const int8_t* far_q, const int64_t* far_rows,
                                  const int32_t* row_i,
                                  int32_t* out, int nb, int B, int k, int G,
                                  int tile, int run, int chunk, int far_cap,
                                  int stages, void* stream) {
  Args a = common(local_idx, wq, table, rows, far_ptr, far_q, far_rows, nb, B, k, G);
  a.out = out;
  Tail t{};
  t.row_i = row_i;
  return static_cast<int>(by_stat<false, int8_t>(
      stat, a, t, Shape{tile, run, chunk, far_cap, stages}, static_cast<cudaStream_t>(stream)));
}

// Local Lee's L (stat 4 of the template), far edges as row pointers. mode 0:
// draw step, cnt [Npad, G] (cnt_bytes 1, 2 or 4) += (|x*lag| >= obs), in
// place; mode 1: observed, out int32 [Npad, G] = |x*lag|; mode 2: neither
// (the global-only null). Every mode writes part f32 [nb, G], the per-block
// partials of the global L. zx int8 [Npad, G]: fixed x codes; sw f32 [Npad].
extern "C" int sct_lee(int mode, const int32_t* local_idx, const int8_t* wq,
                       const int8_t* table, const int64_t* rows,
                       const int32_t* far_ptr, const int8_t* far_q,
                       const int64_t* far_rows, const int8_t* zx,
                       const float* sw, const int32_t* obs, void* cnt,
                       int32_t* out, float* part, int nb, int B, int k, int G,
                       int cnt_bytes, int tile, int run, int chunk, int far_cap,
                       int stages, void* stream) {
  Args a = common(local_idx, wq, table, rows, far_ptr, far_q, far_rows, nb, B, k, G);
  Tail t{};
  t.zx = zx;
  t.sw = sw;
  t.part = part;
  const Shape sh{tile, run, chunk, far_cap, stages};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == 0) {
    a.obs = obs;
    a.cnt = cnt;
    return static_cast<int>(by_counter(cnt_bytes, [&](auto c) {
      return launch<kLee, kFarRows, true, decltype(c)>(a, t, sh, s);
    }));
  }
  if (mode != 1 && mode != 2) return static_cast<int>(cudaErrorInvalidValue);
  a.out = mode == 1 ? out : nullptr;
  return static_cast<int>(launch<kLee, kFarRows, false, int8_t>(a, t, sh, s));
}
