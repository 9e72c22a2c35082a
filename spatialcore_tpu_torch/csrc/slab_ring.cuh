// The slab ring shared by the compact-band cross kernels
// (band_cross_float.cu, K4; band_cross_int8.cu, K1-K3); the dense-band
// kernels (band_cross_dense.cu, K5/K6) use its cp.async helpers.
//
// A CTA owns one column tile of the draw's gathered value table Zp
// [(nb+2)*B, row bytes] and walks a run of consecutive band blocks. Block
// n's window is slabs n, n+1, n+2 (slab s = rows [s*B, s*B + B)); the ring
// holds 4 slabs of [B, rb] bytes in shared memory, slab s in slot s % 4,
// so slab n+3 is copied by cp.async into the slot slab n-1 left while
// block n computes, and each slab crosses HBM once per run. The block's
// band rows are staged beside it in the same pipeline stage by
// stage_bytes. Everything here is device code for sm_90a with a plain C
// launch interface; the kernels fix the CTA size (THREADS) at compile time.
//
// The local draw step (lisa_count_int8.cu, K7/K8) fills the same ring
// through the permutation instead (fill_slot_rows): ring row r of slab s
// is the value table's row rows[s*B + r], so the draw's permuted table is
// never written to device memory. The slab's row indices are staged in
// shared memory a ring step earlier, so no copy waits on an index.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Bytes [off, off + len) of the 16-byte-aligned array `base` into shared
// memory, byte `off` landing at dst + (off & 15): 16-byte copies from the
// aligned chunk below `off`, the last one reading only up to off + len.
template <int THREADS>
__device__ __forceinline__ void stage_bytes(unsigned char* dst, const unsigned char* base,
                                            size_t off, int len) {
  const size_t a0 = off & ~static_cast<size_t>(15);
  const size_t end = off + len;
  const int n = static_cast<int>((end - a0 + 15) / 16);
  for (int j = threadIdx.x; j < n; j += THREADS) {
    const size_t a = a0 + 16 * static_cast<size_t>(j);
    cp_async16(dst + 16 * j, base + a, static_cast<int>(end - a < 16 ? end - a : 16));
  }
}

// Raw storage of one element: copied as bits (zero is 0).
template <int ESZ>
struct RawOf;
template <>
struct RawOf<2> { using type = uint16_t; };
template <>
struct RawOf<4> { using type = uint32_t; };

// Slab s (rows [s*B, s*B + B) of Zp, elements [g0, g0 + rb/ESZ) of rows of
// G elements of ESZ bytes) into ring slot s % 4, ring rows of
// rb = 1 << rb_shift bytes; elements past G are zeros. `vec`: rows are
// whole 16-byte chunks (G*ESZ % 16 == 0, Zp 16-byte aligned).
template <int THREADS, int ESZ>
__device__ __forceinline__ void fill_slot(unsigned char* ring, const unsigned char* zp,
                                          int s, int B, int G, int g0, int rb_shift,
                                          bool vec) {
  using Raw = typename RawOf<ESZ>::type;
  unsigned char* dst = ring + (static_cast<size_t>(s & 3) * B << rb_shift);
  const size_t row0 = static_cast<size_t>(s) * B;
  if (vec) {                                    // 16-byte copies
    const int tpr_shift = rb_shift - 4;
    constexpr int V = 16 / ESZ;
    for (int v = threadIdx.x; v < B << tpr_shift; v += THREADS) {
      const int r = v >> tpr_shift;
      const int q = v & ((1 << tpr_shift) - 1);
      const int g = g0 + q * V;
      const bool in = g < G;
      cp_async16(dst + (r << rb_shift) + 16 * q,
                 in ? zp + ((row0 + r) * G + g) * ESZ : zp, in ? 16 : 0);
    }
  } else {                                      // element loads
    const int gt_shift = rb_shift - (ESZ == 2 ? 1 : 2);
    const Raw* src = reinterpret_cast<const Raw*>(zp);
    for (int v = threadIdx.x; v < B << gt_shift; v += THREADS) {
      const int r = v >> gt_shift;
      const int c = v & ((1 << gt_shift) - 1);
      reinterpret_cast<Raw*>(dst + (r << rb_shift))[c] =
          g0 + c < G ? src[(row0 + r) * G + g0 + c] : Raw(0);
    }
  }
}

// A 4-byte cp.async (zero-filled past src_bytes).
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}

// Slab s read through the permutation into ring slot s % 4: ring row r is
// bytes [g0, g0 + rb) of the table's row idx[r] (rows of G bytes; bytes
// past G are zeros), rb = 1 << rb_shift. `idx` holds the slab's B row
// indices (rows[s*B .. s*B + B), staged in shared memory a ring step
// ahead), so each copy reads its source row from shared memory and the
// copies move whole row segments as fill_slot's do. Rows repeat freely (a
// padded slab clamps to the first and last cell). `vec`: 16-byte copies
// (G % 16 == 0, table 16-byte aligned), else 4-byte ones (G % 4 == 0).
template <int THREADS>
__device__ __forceinline__ void fill_slot_rows(unsigned char* ring, const unsigned char* table,
                                               const int64_t* idx, int s, int B, int G,
                                               int g0, int rb_shift, bool vec) {
  unsigned char* dst = ring + (static_cast<size_t>(s & 3) * B << rb_shift);
  const int p_shift = rb_shift - (vec ? 4 : 2);   // copies a row (log2)
  for (int v = threadIdx.x; v < B << p_shift; v += THREADS) {
    const int r = v >> p_shift, q = v & ((1 << p_shift) - 1);
    const unsigned char* from = table + static_cast<size_t>(idx[r]) * G;
    if (vec) {
      const int g = g0 + 16 * q;
      cp_async16(dst + (r << rb_shift) + 16 * q, g < G ? from + g : table, g < G ? 16 : 0);
    } else {
      const int g = g0 + 4 * q;
      cp_async4(dst + (r << rb_shift) + 4 * q, g < G ? from + g : table, g < G ? 4 : 0);
    }
  }
}

__host__ __device__ constexpr size_t round16(size_t b) { return (b + 15) / 16 * 16; }

// The ring's bytes: 4 slots of [B, rb], or the `red` bytes of the kernel's
// final reduction, which reuses the ring, if those are more.
__host__ __device__ constexpr size_t ring_bytes(int B, int rb, size_t red) {
  return 4 * static_cast<size_t>(B) * rb > red ? 4 * static_cast<size_t>(B) * rb : red;
}

// A stage_bytes buffer for `bytes` bytes: 15 spare bytes for the copies'
// alignment phase, rounded to 16.
__host__ __device__ constexpr size_t stage_buf_bytes(size_t bytes) { return round16(bytes + 15); }

}  // namespace
