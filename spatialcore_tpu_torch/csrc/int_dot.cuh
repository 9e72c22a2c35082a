// Integer band-lag arithmetic shared by the int8 / int4 band cross
// (band_cross_int8.cu, K1-K3) and the local statistics' draw step
// (lisa_count_int8.cu, K7/K8): the staged band's buffer sizes, and dot
// products of int8 (or nibble-packed int4) codes over the band's slots,
// four slots a dp4a after a byte transpose, two a dp2a, far entries one at a
// time. A thread owns NW 4-byte words of a value row: 16 bytes (16 int8 or
// 32 int4 genes) or 8.

#pragma once

#include "slab_ring.cuh"

namespace {

// The band chunk's staged buffers: local_idx, wq (8 spare bytes for the
// weight words' funnel reads), a row vector and far row pointers.
__host__ __device__ constexpr size_t idx_buf_bytes(int chunk, int k) {
  return stage_buf_bytes(static_cast<size_t>(chunk) * k * 4);
}
__host__ __device__ constexpr size_t wq_buf_bytes(int chunk, int k) {
  return stage_buf_bytes(static_cast<size_t>(chunk) * k + 8);
}
__host__ __device__ constexpr size_t row_buf_bytes(int chunk) {
  return stage_buf_bytes(static_cast<size_t>(chunk) * 4);
}
__host__ __device__ constexpr size_t band_buf_bytes(int chunk, int k) {
  return idx_buf_bytes(chunk, k) + wq_buf_bytes(chunk, k) + row_buf_bytes(chunk) +
         row_buf_bytes(chunk + 1);
}
// A far buffer: the first far_cap far entries of a band chunk, [far_cap, rb]
// values, then their weight codes.
__host__ __device__ constexpr size_t far_buf_bytes(int far_cap, int rb) {
  return static_cast<size_t>(far_cap) * rb + stage_buf_bytes(far_cap);
}

__device__ __forceinline__ uint32_t word_of(const uint4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}
__device__ __forceinline__ uint32_t word_of(const uint2& v, int j) { return j == 0 ? v.x : v.y; }

// A thread's bytes of a value row as NW 4-byte words: 16 bytes (uint4) or 8
// (uint2).
template <int NW>
struct Lane;
template <>
struct Lane<4> { using type = uint4; };
template <>
struct Lane<2> { using type = uint2; };

// A thread's NW words of far values (entry e's row of Zf at its columns),
// zeros past the row.
template <int NW = 4>
struct FarRow {
  using V = typename Lane<NW>::type;
  const unsigned char* zf;                      // zf + this thread's first column
  int gcols;
  int cols_left;                                // columns of the row from here on
  bool vec;

  __device__ __forceinline__ V load(int e) const {
    const unsigned char* p = zf + static_cast<size_t>(e) * gcols;
    if (vec && cols_left > 0) return *reinterpret_cast<const V*>(p);
    uint32_t w[NW];
#pragma unroll
    for (int j = 0; j < NW; ++j)
      w[j] = !vec && 4 * j < cols_left ? reinterpret_cast<const uint32_t*>(p)[j] : 0u;
    V v;
    if constexpr (NW == 4) v = make_uint4(w[0], w[1], w[2], w[3]);
    else v = make_uint2(w[0], w[1]);
    return v;
  }
};

// ---------------------------------------------------------------------------
// Integer dot products: 4 slots (dp4a) or 2 slots (dp2a) at a time
// ---------------------------------------------------------------------------

// dp4a / dp2a with unsigned value bytes `a` (int4 nibbles) and signed
// weight bytes or 16-bit halves; the int8 forms take signed values.
__device__ __forceinline__ int dp4a_us(uint32_t a, int w, int c) {
  int d;
  asm("dp4a.u32.s32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(w), "r"(c));
  return d;
}
template <bool HI, bool UNSIGNED>
__device__ __forceinline__ int dp2a(int w2, uint32_t b, int c) {
  int d;
  if (HI && UNSIGNED)
    asm("dp2a.hi.s32.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(w2), "r"(b), "r"(c));
  else if (HI)
    asm("dp2a.hi.s32.s32 %0, %1, %2, %3;" : "=r"(d) : "r"(w2), "r"(b), "r"(c));
  else if (UNSIGNED)
    asm("dp2a.lo.s32.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(w2), "r"(b), "r"(c));
  else
    asm("dp2a.lo.s32.s32 %0, %1, %2, %3;" : "=r"(d) : "r"(w2), "r"(b), "r"(c));
  return d;
}

// The sums of a thread's 16 bytes of a row: int8, lo[4j + b] for byte b of
// word j; int4, lo[4j + b] = sum w*u of the low nibble (gene cols + col)
// and hi[4j + b] = 16 * sum w*u of the high nibble (gene col), u = code + 8
// (the bias is taken out by the accumulators' start, -8 * sum w). NW: the
// thread's words of a row (4: 16 bytes; 2: 8).
template <bool PACKED, int NW = 4>
struct Sums {
  int lo[4 * NW];
  int hi[PACKED ? 4 * NW : 1];
};

// Four slots: byte-transpose the slots' words so each byte position's four
// slot codes sit in one word, then one dp4a per word (int4: one per
// nibble, masked in place). ww: the four weight codes. Slots past the
// row's last are zero words with zero weights. SQ (int8): also sq[v] +=
// w0 * the sum of the squared codes of the slots whose byte of m is 0xFF.
template <bool PACKED, int NW, bool SQ = false>
__device__ __forceinline__ void slots4(Sums<PACKED, NW>& s, const typename Lane<NW>::type* v,
                                       int ww, int* sq = nullptr, uint32_t m = 0, int w0 = 0) {
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    const uint32_t a0 = word_of(v[0], j), a1 = word_of(v[1], j);
    const uint32_t a2 = word_of(v[2], j), a3 = word_of(v[3], j);
    const uint32_t t0 = __byte_perm(a0, a1, 0x5140), t1 = __byte_perm(a0, a1, 0x7362);
    const uint32_t t2 = __byte_perm(a2, a3, 0x5140), t3 = __byte_perm(a2, a3, 0x7362);
    const uint32_t T[4] = {__byte_perm(t0, t2, 0x5410), __byte_perm(t0, t2, 0x7632),
                           __byte_perm(t1, t3, 0x5410), __byte_perm(t1, t3, 0x7632)};
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      if (PACKED) {
        s.lo[4 * j + b] = dp4a_us(T[b] & 0x0F0F0F0Fu, ww, s.lo[4 * j + b]);
        s.hi[4 * j + b] = dp4a_us(T[b] & 0xF0F0F0F0u, ww, s.hi[4 * j + b]);
      } else {
        s.lo[4 * j + b] = __dp4a(static_cast<int>(T[b]), ww, s.lo[4 * j + b]);
        if (SQ)
          sq[4 * j + b] += w0 * __dp4a(static_cast<int>(T[b] & m), static_cast<int>(T[b]), 0);
      }
    }
  }
}

// Two slots: interleave the two words' bytes (t0 holds bytes 0 and 1 of
// both, t1 bytes 2 and 3) and take dp2a's low and high halves. w2: the two
// weight codes as 16-bit halves. SQ (int8): as slots4, m's bytes 0 and 1
// for the two slots.
template <bool PACKED, int NW, bool SQ = false>
__device__ __forceinline__ void slots2(Sums<PACKED, NW>& s, const typename Lane<NW>::type* v,
                                       int w2, int* sq = nullptr, uint32_t m = 0, int w0 = 0) {
  const uint32_t m_lo = m & 0xFFFFu, m_hi = (m & 0xFFFFu) << 16;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    const uint32_t a0 = word_of(v[0], j), a1 = word_of(v[1], j);
    const uint32_t t[2] = {__byte_perm(a0, a1, 0x5140), __byte_perm(a0, a1, 0x7362)};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int b = 2 * h;
      if (PACKED) {
        const uint32_t l = t[h] & 0x0F0F0F0Fu, u = t[h] & 0xF0F0F0F0u;
        s.lo[4 * j + b] = dp2a<false, true>(w2, l, s.lo[4 * j + b]);
        s.lo[4 * j + b + 1] = dp2a<true, true>(w2, l, s.lo[4 * j + b + 1]);
        s.hi[4 * j + b] = dp2a<false, true>(w2, u, s.hi[4 * j + b]);
        s.hi[4 * j + b + 1] = dp2a<true, true>(w2, u, s.hi[4 * j + b + 1]);
      } else {
        s.lo[4 * j + b] = dp2a<false, false>(w2, t[h], s.lo[4 * j + b]);
        s.lo[4 * j + b + 1] = dp2a<true, false>(w2, t[h], s.lo[4 * j + b + 1]);
        if (SQ) {
          sq[4 * j + b] += w0 * __dp4a(static_cast<int>(t[h] & m_lo), static_cast<int>(t[h]), 0);
          sq[4 * j + b + 1] +=
              w0 * __dp4a(static_cast<int>(t[h] & m_hi), static_cast<int>(t[h]), 0);
        }
      }
    }
  }
}

// One far entry, weight code q. int4 takes the nibbles as signed values
// here (low: u - 8; high: 16 * (u - 8)), so it needs no bias term.
template <bool PACKED, int NW>
__device__ __forceinline__ void far1(Sums<PACKED, NW>& s, const typename Lane<NW>::type& v,
                                     int q) {
  const int qb = q & 0xff;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    const uint32_t x = word_of(v, j);
    const uint32_t l =
        PACKED ? (((x & 0x0F0F0F0Fu) | 0x80808080u) - 0x08080808u) ^ 0x80808080u : x;
    const uint32_t u = (x & 0xF0F0F0F0u) ^ 0x80808080u;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      s.lo[4 * j + b] = __dp4a(static_cast<int>(l), qb << (8 * b), s.lo[4 * j + b]);
      if (PACKED) s.hi[4 * j + b] = __dp4a(static_cast<int>(u), qb << (8 * b), s.hi[4 * j + b]);
    }
  }
}

// The low two bytes of w as sign-extended 16-bit halves (prmt's sign
// replication; __byte_perm ignores the selector's sign bit).
__device__ __forceinline__ int bytes_to_halves(int w) {
  int d;
  asm("prmt.b32 %0, %1, 0, 0x9180;" : "=r"(d) : "r"(w));
  return d;
}

// Weight codes bw[t0 .. t0 + 4) of a staged row as one word, bytes at or
// past `valid` zero (bw need not be 4-aligned; the buffer has spare bytes).
__device__ __forceinline__ int weight_word(const int8_t* bw, int t0, int valid) {
  const int8_t* at = bw + t0;
  const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(at) & 3);
  const uint32_t* p = reinterpret_cast<const uint32_t*>(at - mis);   // stays in shared
  const uint32_t w = __funnelshift_r(p[0], p[1], static_cast<unsigned>(mis) * 8);
  return static_cast<int>(valid >= 4 ? w : w & ((1u << (8 * valid)) - 1u));
}

// The band chunk's first far entries in shared memory: entries
// [e0, e0 + n), entry e0 + x's values at vals + x * rb (this thread's 16
// bytes), its weight code at q[x].
struct FarStage {
  const unsigned char* vals;
  const int8_t* q;
  int e0;
  int n;
};

}  // namespace
