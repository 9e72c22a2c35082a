// The float local Moran null's draw step (bf16 / f32 values, float32 lag),
// one launch a draw: for every padded row r and gene g of the draw's
// gathered table Zp,
//
//   lag  = ((w_0*z_0 + w_1*z_1) + ...) + w_{k-1}*z_{k-1}   band slots, slot order
//          + y_0*f_0 + y_1*f_1 + ...                       far edges, list order
//   cnt[r][g] += |z_own * lag| >= obs[r][g]                counter updated in place
//
// It replaces no Pallas kernel. The reference's _banded_local_moran_p
// (spatialcore_tpu/ops/banded.py:2487) is XLA ops: a band matmul and a
// far-edge segment sum per draw. The port ran it as torch ops
// (kernels/lisa_float.py, moran_count_plain): per row span, 50 band slots
// and R far slots, each a gather, a product and an add over a [rows, G]
// float32 temp in device memory, ~370 launches a draw. This kernel keeps
// the lag in registers.
//
// What must stay bitwise. On discrete counts |z*lag| >= obs ties exactly
// and often, and float32 rounding decides a tie, so the counts are equal
// to the plain version's only if every row rounds at the same places:
// - each product is rounded to float32, then added to the lag in slot
//   order 0..k-1 (the first product is the lag's start, not 0 + w_0*z_0),
//   then the far edges in their order in the far list, which is the order
//   of the plain version's far slots. __fmul_rn / __fadd_rn round each
//   step once, so nvcc cannot contract a product and an add into an FMA;
// - Ip = z_own * lag is one rounded product and fabsf(Ip) >= obs the
//   plain version's comparison.
// The plain version adds R far slots to every row, the empty ones as
// Zp[0] * 0 = +-0; this kernel reads the row-pointer form and skips them.
// x + (+-0) is x for every x but -0 (which gives +-0), and the sign of a
// zero lag never changes |z * lag|, so the counts are equal for every
// finite table. (A non-finite value in Zp's row 0 would turn the plain
// version's empty slots into NaN; standardized values are finite.) bf16
// values and band weights widen to float32 before each product, as the
// plain version casts them; the far weights are float32 in both.
//
// What bounds it on the H100. Bytes, a draw at n rows x G genes, k slots:
// the gathered table read once (n*G*t, t = 2 or 4 bytes), the observed
// |I| read (4 n G), the counters read and written (2 c n G, c = 2 or 4
// bytes), the band's index and weight read once (n*k*(4 + t)): at the
// CosMx vignette's 366,938 cells x 100 genes, k = 50, float32 and int16
// counters, 587 MB, 0.175 ms at 3.35 TB/s. The far values come on top
// (~2M far edges there, a random 128-byte row segment each a gene tile,
// ~840 MB, mostly from device memory; most rows have none, a few dozens).
// Shared memory carries the band reads: n*k*G*t bytes, 7.3 GB a draw
// there, ~0.25 ms at the SMs' 128 bytes a clock.
// The arithmetic, 2*n*k*G float32 operations (3.7 GFLOP), is ~0.06 ms
// on the CUDA cores; tensor cores would round to TF32, a lower
// precision than the null states.
//
// Design: K4's slab ring (slab_ring.cuh, band_cross_float.cu), with the
// lag kept per row instead of summed into a cross product.
// - A CTA owns one gene tile of Gt genes (Gt*t = 16..512 bytes, 128 at
//   B = 256: 32 float32 genes, a 128-byte row segment) and walks a run of
//   consecutive band blocks. The ring holds 4 slabs of [B, Gt] values;
//   block n's window is slabs n, n+1, n+2, and slab n+3 is copied by
//   cp.async into the slot slab n-1 left while block n computes, so each
//   slab crosses device memory (run+2)/run times a draw and the k band
//   reads of a row come from shared memory.
// - The block's local_idx (int16: window rows < 3B <= 1536) and weight
//   rows are staged in shared memory a chunk of rows at a time (a row a
//   thread), double-buffered in the same pipeline as the slabs; a row's
//   band operands are read once per gene tile, two slots' indices and
//   weights a read where k is even.
// - A thread owns 16 bytes of a row (4 float32 or 8 bf16 genes): Gt*t/16
//   threads cover a row, so every shared-memory read of a window row is
//   one 16-byte vector read and a row segment is one contiguous read.
// - The genes past the whole tiles go to one last tile of the narrowest
//   ring row that holds them (100 float32 genes: three tiles of 32, then
//   one of 4 with a 16-byte ring row, a thread a row), so a ragged G pays
//   a fraction of a tile's band reads for its last genes, not a whole
//   tile's. Threads whose genes all lie past G do no row work.
// - The observed |I| and the counters are read into registers before the
//   row's band loop (4 genes a load where G % 4 == 0), so their latency
//   hides behind it; the counters are written back in place, 4 a store.
// - Far edges as row pointers into the far list (the plan's order). A
//   chunk's barrier waits for its row with the most far edges, and read
//   one after another from device memory those cost more than the band
//   loop; so a chunk's first far_cap entries (rows and weights staged
//   with its band rows a stage ahead) have their value segments copied
//   into shared memory by cp.async at the chunk's start, landing while
//   the band loop runs; the adds then read shared memory. Entries past
//   far_cap (a seventh of them on a kNN plan at k = 50: B = 256 leaves
//   room for 436 float32 entries a 64-row chunk, which holds 333 on
//   average) are read from L2, four ahead of their adds.
// - Nothing is allocated here; the wrapper owns every buffer.

#include "slab_ring.cuh"

namespace {

constexpr int kThreads = 512;                   // mirrors lisa_float._THREADS
constexpr int kBatch = 4;                       // far entries a row loaded ahead of their adds
constexpr size_t kSmemMax = 232448;             // 227 KB a block may use on sm_90

// ---------------------------------------------------------------------------
// Values
// ---------------------------------------------------------------------------

template <int ESZ>
__device__ __forceinline__ float widen(typename RawOf<ESZ>::type x) {
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

// The 16 bytes of genes [g, g + 16/ESZ) of Zp's row `row`, through L2
// (zeros past G). v16: rows are whole 16-byte chunks (G*ESZ % 16 == 0, Zp
// 16-byte aligned); else element loads.
template <int ESZ>
__device__ __forceinline__ uint4 load_raw(const unsigned char* zp, int row, int g, int G,
                                          bool v16) {
  using Raw = typename RawOf<ESZ>::type;
  constexpr int V = 16 / ESZ;
  const size_t off = (static_cast<size_t>(row) * G + g) * ESZ;
  if (v16) return __ldg(reinterpret_cast<const uint4*>(zp + off));
  const Raw* p = reinterpret_cast<const Raw*>(zp + off);
  uint32_t u[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const uint32_t x = g + v < G ? static_cast<uint32_t>(__ldg(p + v)) : 0u;
    u[v * ESZ / 4] |= x << (8 * ((v * ESZ) & 3));
  }
  return make_uint4(u[0], u[1], u[2], u[3]);
}

// Four counters, loaded and stored.
__device__ __forceinline__ void load_cnt4(const int16_t* p, int* c) {
  const short4 s = *reinterpret_cast<const short4*>(p);
  c[0] = s.x; c[1] = s.y; c[2] = s.z; c[3] = s.w;
}
__device__ __forceinline__ void store_cnt4(int16_t* p, const int* c) {
  *reinterpret_cast<short4*>(p) = make_short4(static_cast<short>(c[0]), static_cast<short>(c[1]),
                                              static_cast<short>(c[2]), static_cast<short>(c[3]));
}
__device__ __forceinline__ void load_cnt4(const int32_t* p, int* c) {
  const int4 s = *reinterpret_cast<const int4*>(p);
  c[0] = s.x; c[1] = s.y; c[2] = s.z; c[3] = s.w;
}
__device__ __forceinline__ void store_cnt4(int32_t* p, const int* c) {
  *reinterpret_cast<int4*>(p) = make_int4(c[0], c[1], c[2], c[3]);
}

// ---------------------------------------------------------------------------
// Operands and shared memory
// ---------------------------------------------------------------------------

// A gene tile's launch shape: ring rows of 1 << rb_shift bytes, band rows
// staged `chunk` at a time (at most a row a thread), and the far values of
// up to far_cap entries of a chunk staged in shared memory.
struct TileShape {
  int rb_shift, chunk, far_cap;
};

struct Args {
  const int16_t* local_idx;  // [Npad, k] window rows in [0, 3B)
  const unsigned char* w;    // [Npad, k] band weights, f32 or bf16
  const unsigned char* zp;   // [(nb+2)*B, G] the draw's gathered table
  const int32_t* far_ptr;    // [Npad+1] row pointers into the far list
  const int32_t* far_dst;    // [F] Zp row of each far edge's value
  const float* far_w;        // [F] far weights
  const float* obs;          // [Npad, G] observed |I| (padded rows +inf)
  void* cnt;                 // [Npad, G] int16 or int32 counters
  int nb, B, k, G;
  TileShape full, tail;      // the full tiles' shape and the last tile's
  int run, n_full, n_gt;     // blocks a CTA; full tiles; tiles (n_full + 1 with a tail)
  bool v16;                  // Zp rows in whole 16-byte chunks
  bool vec4;                 // obs and counters 4 genes a load
};

// Shared-memory layout, mirrored by lisa_float.lisa_float_smem_bytes: the
// ring [4B, rb]; two stage buffers, each a chunk's local_idx bytes, its
// weight bytes and its first far_cap far entries' rows and weights (each
// with the alignment phase stage_bytes keeps); the far values [far_cap, rb].
struct Layout {
  size_t w, fdst, fw, buf, band, fval, total;
};
__host__ __device__ inline Layout layout(int B, int rb, int chunk, int k, int far_cap, int esz) {
  Layout L{};
  L.w = stage_buf_bytes(static_cast<size_t>(chunk) * k * 2);
  L.fdst = L.w + stage_buf_bytes(static_cast<size_t>(chunk) * k * esz);
  L.fw = L.fdst + stage_buf_bytes(static_cast<size_t>(far_cap) * 4);
  L.buf = L.fw + stage_buf_bytes(static_cast<size_t>(far_cap) * 4);
  L.band = 4 * static_cast<size_t>(B) * rb;
  L.fval = L.band + 2 * L.buf;
  L.total = L.fval + static_cast<size_t>(far_cap) * rb;
  return L;
}

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------

template <int ESZ, typename CT>
__global__ void __launch_bounds__(kThreads, 1) lisa_float_kernel(const Args a) {
  using Raw = typename RawOf<ESZ>::type;
  constexpr int V = 16 / ESZ;                   // genes a thread owns
  extern __shared__ __align__(16) unsigned char smem[];
  const int B = a.B, k = a.k, G = a.G;
  const int tile_i = blockIdx.x % a.n_gt;
  const TileShape sh = tile_i < a.n_full ? a.full : a.tail;
  const int rb_shift = sh.rb_shift, chunk = sh.chunk;
  const int cap = a.v16 ? sh.far_cap : 0;       // far entries staged a chunk
  const Layout L = layout(B, 1 << rb_shift, chunk, k, sh.far_cap, ESZ);
  unsigned char* ring = smem;
  unsigned char* band = smem + L.band;
  unsigned char* fval = smem + L.fval;

  const int g0 = tile_i * ((1 << a.full.rb_shift) / ESZ);
  const int n0 = (blockIdx.x / a.n_gt) * a.run;
  const int n1 = min(n0 + a.run, a.nb);
  const int nc = (B + chunk - 1) / chunk;       // band chunks per block
  const int stages = (n1 - n0) * nc;
  const int tpr_shift = rb_shift - 4;           // 16-byte lanes per row (log2)
  const int q = threadIdx.x & ((1 << tpr_shift) - 1);
  const int rg = threadIdx.x >> tpr_shift;      // row group: a row of each chunk
  const int four_b = 4 * B;
  const int g = g0 + q * V;                     // this thread's first gene
  const bool active = g < G;
  const unsigned char* lane = ring + 16 * q;
  CT* cnt = static_cast<CT*>(a.cnt);

  auto chunk_rows = [&](int st, size_t& r0, int& rows) {
    const int c = st % nc;
    r0 = static_cast<size_t>(n0 + st / nc) * B + c * chunk;
    rows = min(chunk, B - c * chunk);
  };
  // chunk st's far entries [x, y), read a stage before they are staged
  auto far_range = [&](int st) {
    size_t r0;
    int rows;
    chunk_rows(st, r0, rows);
    return make_int2(__ldg(a.far_ptr + r0), __ldg(a.far_ptr + r0 + rows));
  };
  // chunk st's band rows and its first far entries' rows and weights into
  // stage buffer st & 1
  auto stage = [&](int st, int2 fr) {
    size_t r0;
    int rows;
    chunk_rows(st, r0, rows);
    unsigned char* b = band + (st & 1) * L.buf;
    stage_bytes<kThreads>(b, reinterpret_cast<const unsigned char*>(a.local_idx), r0 * k * 2,
                          rows * k * 2);
    stage_bytes<kThreads>(b + L.w, a.w, r0 * k * ESZ, rows * k * ESZ);
    const int nf = min(fr.y - fr.x, cap);
    if (nf > 0) {
      stage_bytes<kThreads>(b + L.fdst, reinterpret_cast<const unsigned char*>(a.far_dst),
                            static_cast<size_t>(fr.x) * 4, nf * 4);
      stage_bytes<kThreads>(b + L.fw, reinterpret_cast<const unsigned char*>(a.far_w),
                            static_cast<size_t>(fr.x) * 4, nf * 4);
    }
  };
  // the staged far entries' values of chunk st, 16 bytes a lane, into fval
  auto fetch_far = [&](int st, int2 fr) {
    const int nf = min(fr.y - fr.x, cap);
    const int32_t* sd = reinterpret_cast<const int32_t*>(band + (st & 1) * L.buf + L.fdst +
                                                         ((fr.x * 4) & 15));
    for (int v = threadIdx.x; v < nf << tpr_shift; v += kThreads) {
      const int x = v >> tpr_shift, l = v & ((1 << tpr_shift) - 1);
      const int gg = g0 + l * V;
      const bool in = gg < G;
      cp_async16(fval + (x << rb_shift) + 16 * l,
                 in ? a.zp + (static_cast<size_t>(sd[x]) * G + gg) * ESZ : a.zp, in ? 16 : 0);
    }
  };

  fill_slot<kThreads, ESZ>(ring, a.zp, n0, B, G, g0, rb_shift, a.v16);
  fill_slot<kThreads, ESZ>(ring, a.zp, n0 + 1, B, G, g0, rb_shift, a.v16);
  fill_slot<kThreads, ESZ>(ring, a.zp, n0 + 2, B, G, g0, rb_shift, a.v16);
  int2 fr_cur = far_range(0);
  stage(0, fr_cur);
  cp_async_commit();
  int2 fr_next = stages > 1 ? far_range(1) : make_int2(0, 0);

  // Pipeline, a stage a chunk: at its start every copy issued before has
  // landed (band rows, far rows and weights of this chunk; a first chunk's
  // window slab n+2). Then the next chunk's band and far list and (a first
  // chunk) slab n+3 are issued, and this chunk's staged far values; the
  // band loop runs while they land; a second wait and barrier, and each
  // row adds its far values, the staged ones from shared memory.
  for (int st = 0; st < stages; ++st) {
    const int n = n0 + st / nc;
    const int c = st % nc;
    cp_async_wait<0>();
    __syncthreads();                            // also: stage st-1's reads are done
    if (st + 1 < stages) stage(st + 1, fr_next);
    if (c == 0 && n + 1 < n1) fill_slot<kThreads, ESZ>(ring, a.zp, n + 3, B, G, g0, rb_shift,
                                                       a.v16);
    fetch_far(st, fr_cur);
    cp_async_commit();
    const int2 fr = fr_cur;
    fr_cur = fr_next;
    fr_next = st + 2 < stages ? far_range(st + 2) : make_int2(0, 0);

    size_t r0;
    int rows;
    chunk_rows(st, r0, rows);
    const bool mine = active && rg < rows;      // this thread's row of the chunk
    const unsigned char* b = band + (st & 1) * L.buf;
    const int base = (n & 3) * B;               // ring row of window row 0
    const int i = c * chunk + rg;               // the row within its block
    const size_t r = r0 + rg;
    const size_t o = r * G + g;
    float ob[V], lag[V];
    int cn[V], e0 = 0, e1 = 0;
    if (mine) {
      // the row's planes and far range, in flight across the band loop
#pragma unroll
      for (int h = 0; h < V; h += 4) {
        if (a.vec4 && g + h < G) {
          const float4 f = __ldcs(reinterpret_cast<const float4*>(a.obs + o + h));
          ob[h] = f.x; ob[h + 1] = f.y; ob[h + 2] = f.z; ob[h + 3] = f.w;
          load_cnt4(cnt + o + h, cn + h);
        } else {
#pragma unroll
          for (int y = h; y < h + 4; ++y) {
            const bool in = g + y < G;
            ob[y] = in ? __ldcs(a.obs + o + y) : 0.f;
            cn[y] = in ? static_cast<int>(cnt[o + y]) : 0;
          }
        }
      }
      e0 = __ldg(a.far_ptr + r);
      e1 = __ldg(a.far_ptr + r + 1);

      // band slots in slot order, each product rounded, then added
      const int16_t* bi = reinterpret_cast<const int16_t*>(b + ((r0 * k * 2) & 15)) + rg * k;
      const Raw* bw = reinterpret_cast<const Raw*>(b + L.w + ((r0 * k * ESZ) & 15)) + rg * k;
      auto window = [&](int idx, float* z) {
        int rr = base + idx;
        rr -= rr >= four_b ? four_b : 0;
        unpack<ESZ>(*reinterpret_cast<const uint4*>(lane + (rr << rb_shift)), z);
      };
      auto add = [&](float wf, const float* z) {
#pragma unroll
        for (int v = 0; v < V; ++v) lag[v] = __fadd_rn(lag[v], __fmul_rn(wf, z[v]));
      };
      if ((k & 1) == 0) {
        // slots two at a time: one 4-byte read of the pair's indices and
        // one of 2*ESZ bytes of its weights (a row's operands start at an
        // even slot, so both are aligned)
        auto pair = [&](int t, float* z0, float* z1, float& w0, float& w1) {
          const uint32_t ip = *reinterpret_cast<const uint32_t*>(bi + t);
          if constexpr (ESZ == 4) {
            const float2 wp = *reinterpret_cast<const float2*>(bw + t);
            w0 = wp.x;
            w1 = wp.y;
          } else {
            const uint32_t wp = *reinterpret_cast<const uint32_t*>(bw + t);
            w0 = __uint_as_float(wp << 16);
            w1 = __uint_as_float(wp & 0xffff0000u);
          }
          window(static_cast<int16_t>(ip & 0xffffu), z0);
          window(static_cast<int16_t>(ip >> 16), z1);
        };
        float z0[V], z1[V], w0, w1;
        pair(0, z0, z1, w0, w1);
#pragma unroll
        for (int v = 0; v < V; ++v) lag[v] = __fmul_rn(w0, z0[v]);
        add(w1, z1);
#pragma unroll 2
        for (int t = 2; t < k; t += 2) {
          pair(t, z0, z1, w0, w1);
          add(w0, z0);
          add(w1, z1);
        }
      } else {
        float z[V];
        window(bi[0], z);
        const float wf = widen<ESZ>(bw[0]);
#pragma unroll
        for (int v = 0; v < V; ++v) lag[v] = __fmul_rn(wf, z[v]);
#pragma unroll 4
        for (int t = 1; t < k; ++t) {
          window(bi[t], z);
          add(widen<ESZ>(bw[t]), z);
        }
      }
    }

    cp_async_wait<0>();
    __syncthreads();                            // every lane's far values have landed
    if (!mine) continue;

    // far edges in list order: the staged ones from shared memory, the
    // rest kBatch loads ahead of their adds
    auto add_raw = [&](const uint4 raw, float f) {
      float y[V];
      unpack<ESZ>(raw, y);
#pragma unroll
      for (int v = 0; v < V; ++v) lag[v] = __fadd_rn(lag[v], __fmul_rn(y[v], f));
    };
    const int es = min(e1, fr.x + min(fr.y - fr.x, cap));
    const float* sfw = reinterpret_cast<const float*>(b + L.fw + ((fr.x * 4) & 15));
    const unsigned char* sval = fval + 16 * q;
    for (int e = e0; e < es; ++e)
      add_raw(*reinterpret_cast<const uint4*>(sval + ((e - fr.x) << rb_shift)), sfw[e - fr.x]);
    for (int e = max(e0, es); e < e1; e += kBatch) {
      uint4 raw[kBatch];
      float f[kBatch];
#pragma unroll
      for (int y = 0; y < kBatch; ++y) {
        const bool in = e + y < e1;
        f[y] = in ? __ldg(a.far_w + e + y) : 0.f;
        raw[y] = in ? load_raw<ESZ>(a.zp, __ldg(a.far_dst + e + y), g, G, a.v16) : uint4{};
      }
#pragma unroll
      for (int y = 0; y < kBatch; ++y)
        if (e + y < e1) add_raw(raw[y], f[y]);
    }

    // |z_own * lag| >= obs, the counters in place
    int orow = base + B + i;
    orow -= orow >= four_b ? four_b : 0;
    float zo[V];
    unpack<ESZ>(*reinterpret_cast<const uint4*>(lane + (orow << rb_shift)), zo);
#pragma unroll
    for (int v = 0; v < V; ++v) cn[v] += fabsf(__fmul_rn(zo[v], lag[v])) >= ob[v];
#pragma unroll
    for (int h = 0; h < V; h += 4) {
      if (a.vec4 && g + h < G) {
        store_cnt4(cnt + o + h, cn + h);
      } else {
#pragma unroll
        for (int y = h; y < h + 4; ++y)
          if (g + y < G) cnt[o + y] = static_cast<CT>(cn[y]);
      }
    }
  }
  cp_async_wait<0>();
}

// rb (bytes of a ring row) to its log2, or -1 if not a power of two in
// [16, 512].
int shift_of(int rb) {
  int s = 4;
  while ((1 << s) < rb) ++s;
  return rb == (1 << s) && rb <= 512 ? s : -1;
}

template <int ESZ, typename CT>
cudaError_t launch(Args a, int tile, int chunk, int far_cap, int tail, int tail_chunk,
                   int tail_far_cap, int run, cudaStream_t stream) {
  const int full_shift = shift_of(tile * ESZ), tail_shift = shift_of(tail * ESZ);
  if (tile < 1 || tail < 1 || tail > tile || full_shift < 0 || tail_shift < 0 || run < 1 ||
      chunk < 1 || chunk > a.B || chunk > kThreads * 16 / (tile * ESZ) || tail_chunk < 1 ||
      tail_chunk > a.B || tail_chunk > kThreads * 16 / (tail * ESZ) || far_cap < 0 ||
      tail_far_cap < 0 || a.nb < 1 || a.B < 1 || a.k < 1 || a.G < 1)
    return cudaErrorInvalidValue;
  const size_t smem = max(layout(a.B, tile * ESZ, chunk, a.k, far_cap, ESZ).total,
                          layout(a.B, tail * ESZ, tail_chunk, a.k, tail_far_cap, ESZ).total);
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  auto aligned = [](const void* p, int n) { return reinterpret_cast<uintptr_t>(p) % n == 0; };
  // the staged copies need 16-byte-aligned arrays (the wrapper sees to it)
  if (!aligned(a.local_idx, 16) || !aligned(a.w, 16) || !aligned(a.zp, ESZ) ||
      !aligned(a.far_ptr, 4) || !aligned(a.far_dst, 16) || !aligned(a.far_w, 16) ||
      !aligned(a.obs, 4) || !aligned(a.cnt, sizeof(CT)))
    return cudaErrorMisalignedAddress;
  a.v16 = (static_cast<size_t>(a.G) * ESZ) % 16 == 0 && aligned(a.zp, 16);
  a.vec4 = a.G % 4 == 0 && aligned(a.obs, 16) && aligned(a.cnt, 4 * sizeof(CT));
  a.full = TileShape{full_shift, chunk, far_cap};
  a.tail = TileShape{tail_shift, tail_chunk, tail_far_cap};
  a.run = run;
  // whole tiles of `tile` genes, then one of `tail` genes for the rest
  // (none when the whole tiles cover G)
  a.n_full = a.G / tile;
  const int rest = a.G - a.n_full * tile;
  if (rest > tail) return cudaErrorInvalidValue;
  a.n_gt = a.n_full + (rest > 0);
  const long long ctas = static_cast<long long>(a.n_gt) * ((a.nb + run - 1) / run);
  if (ctas > 0x7fffffffLL) return cudaErrorInvalidValue;
  auto kernel = lisa_float_kernel<ESZ, CT>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(ctas), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int ESZ>
cudaError_t by_counter(int cnt_bytes, const Args& a, int tile, int chunk, int far_cap, int tail,
                       int tail_chunk, int tail_far_cap, int run, cudaStream_t s) {
  switch (cnt_bytes) {
    case 2:
      return launch<ESZ, int16_t>(a, tile, chunk, far_cap, tail, tail_chunk, tail_far_cap, run, s);
    case 4:
      return launch<ESZ, int32_t>(a, tile, chunk, far_cap, tail, tail_chunk, tail_far_cap, run, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Local Moran draw step in bf16 (is_bf16) or f32: cnt [Npad, G] (cnt_bytes
// 2 or 4: int16 / int32) += (|z*lag| >= obs), in place. The launch shape
// comes from lisa_float.lisa_float_tiles: tile genes a CTA over the whole
// tiles (chunk band rows a stage, far_cap far entries staged a chunk),
// then one tile of `tail` genes (tail_chunk, tail_far_cap) for the genes
// left, and run band blocks a CTA.
extern "C" int sct_lisa_float(const int16_t* local_idx, const void* w, const void* zp,
                              const int32_t* far_ptr, const int32_t* far_dst,
                              const float* far_w, const float* obs, void* cnt, int nb, int B,
                              int k, int G, int is_bf16, int cnt_bytes, int tile, int chunk,
                              int far_cap, int tail, int tail_chunk, int tail_far_cap, int run,
                              void* stream) {
  Args a{};
  a.local_idx = local_idx;
  a.w = static_cast<const unsigned char*>(w);
  a.zp = static_cast<const unsigned char*>(zp);
  a.far_ptr = far_ptr;
  a.far_dst = far_dst;
  a.far_w = far_w;
  a.obs = obs;
  a.cnt = cnt;
  a.nb = nb;
  a.B = B;
  a.k = k;
  a.G = G;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      is_bf16 ? by_counter<2>(cnt_bytes, a, tile, chunk, far_cap, tail, tail_chunk, tail_far_cap,
                              run, s)
              : by_counter<4>(cnt_bytes, a, tile, chunk, far_cap, tail, tail_chunk, tail_far_cap,
                              run, s));
}
