// Exact 2D k-nearest neighbours over all pairs, ranked by (d2, id) keys.
//
// Replaces the Pallas kernel K9 (spatialcore_tpu/ops/pallas_knn.py,
// _knn_kernel): for every query q of n float32 points, the k candidates
// c != q (or any c with include_self) of smallest
//
//   d2 = (qx - cx)^2 + (qy - cy)^2      (each operation rounded once)
//
// sorted by (d2, candidate id), so an equal distance keeps the lower id. A
// candidate whose d2 is +Inf (or NaN) never enters: a row with fewer than k
// finite candidates ends in id -1, d2 +Inf, as the plain version's does.
//
// What bounds it on the H100. The stated bound is that of an all-pairs
// scan: 6 FP32 operations a pair over 67 TFLOP/s. Ranking every pair by
// its exact d2 takes 2 FSUB, 2 FMUL, 1 FADD and a compare, none of which
// may fuse into an FMA (d2 must stay bitwise the plain version's:
// __fsub_rn / __fmul_rn / __fadd_rn); the pipe runs one such instruction a
// lane a clock (33.5 T/s), so that design's floor is 5n^2-6n^2 / 33.5e12,
// twice the stated bound. This kernel is not held to either: its filter
// (below) takes about 3.5 instructions a pair, and with the points in
// Morton order most candidate tiles hold no point that can enter, so
// skipping a tile whose bounding box lies beyond the CTA's widest
// threshold would cut the pairs far below n^2 (not done yet). The bytes
// (8n in, 8nk out) are negligible; the coordinates sit in L2.
//
// Design:
// - Keys. A candidate is ranked by (d2 bits << 32) | id, which for
//   d2 >= +0 orders exactly as (d2, id): the answer does not depend on the
//   order in which candidates are seen, so lanes take different candidates
//   and the points may be visited in any order. The empty key kEmpty (+Inf
//   bits, id 0) is above every key that can enter. A list of KMAX keys holds its k real ones after KMAX - k
//   dummy keys 0, so the k-th is always the last, at a fixed register.
// - A cheaper filter. The common path does not compute d2: it estimates
//   d2 - |q|^2 as fma(-2qx, cx, fma(-2qy, cy, |c|^2)), 2 FFMA a pair plus a
//   min tree and one compare a query, against a threshold widened by a
//   margin that bounds every rounding error (`threshold`). The filter never
//   drops a candidate whose exact d2 could enter; the insertion code
//   computes that exact d2. About 3.5 instructions a pair, under the floor
//   above, which is the floor of ranking every pair by its exact d2, not
//   of this kernel. Where the coordinates leave the margin's range (|x|
//   outside [2^-50, 2^60]) the filter is the exact d2 itself. The margin
//   scales with R, the largest |coordinate|, not with the spacing of the
//   points: at 1M centred uniform cells it equals about the 6th
//   neighbour's d2, so the filter passes about twice the candidates it
//   needs; at larger n, or on points far from the origin, it grows past the
//   k-th d2 and more candidates reach the insertion code. The answer stays
//   exact, only slower; a margin from the bounding box's extent around its
//   centre would keep it tight.
// - Locality. The wrapper orders the points along a Morton curve (its
//   codes in torch ops, then a sort) and passes their ids (`order`): a
//   CTA's queries are then neighbours, and it scans their own tile first,
//   from their own round outward, so its lists hold near neighbours after one
//   tile and the filter passes almost nothing after that. In id order a
//   query takes about k ln(n/k) insertions over the scan (k=50 at 66,536
//   points: ~360), and the kernel ran 1.3-2.3x slower on the H100.
//   The first round's threshold is seeded from its lanes' smallest values
//   (WarpQueries::seed), where every candidate would otherwise enter.
// - The common path is straight-line code: a round of candidates x
//   queries ORs "passes the filter" into one predicate; only when a lane of
//   the warp has one set (__any_sync) does the round enter the insertion
//   code, which votes again a query before it looks at candidates.
// - A warp owns QW queries (8, 4 at k > 64); its lanes take consecutive
//   candidates (two conflict-free 16-byte loads a lane, a round of 128). A query's best
//   KMAX = 32W keys are spread over the warp, lane L holding positions
//   [L*W, L*W + W), sorted. A candidate that passes is inserted by the whole
//   warp at once (key broadcast by __shfl_sync, every position shifted by
//   compare and select, the position before a lane's first from
//   __shfl_up_sync): no local memory and no divergence. (A thread that
//   owns its queries, with register lists and broadcast candidates, ran
//   1.1-1.4x slower at every shape measured: its lanes insert one at a
//   time.)
// - A CTA scans every candidate; the grid is the query tiles. (Splitting
//   the candidates into slices merged by key ran 1.8-2.8x slower on the
//   H100 at every shape measured, also where the query tiles alone leave
//   SMs idle: a slice away from a CTA's queries repeats the warm-up of its
//   lists without the Morton order's help.)
// - Candidates stream through a ring of `stages` tiles of `tile` points in
//   shared memory, filled by 16-byte cp.async (slab_ring.cuh) while the
//   tile before is ranked. The last tile's points past n are NaN: their
//   filter value and d2 are NaN and pass nothing.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include "slab_ring.cuh"

namespace {

constexpr uint64_t kEmpty = 0x7F80000000000000ull;  // +Inf bits, id 0
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxThreads = 256;
constexpr size_t kSmemLimit = 232448;

__device__ __forceinline__ float dist2(float qx, float qy, float cx, float cy) {
  const float dx = __fsub_rn(qx, cx);
  const float dy = __fsub_rn(qy, cy);
  return __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
}

__device__ __forceinline__ uint64_t make_key(float d2, int id) {
  return (static_cast<uint64_t>(__float_as_uint(d2)) << 32) | static_cast<uint32_t>(id);
}

// The filter of a list whose k-th key is `kth`: a candidate passes if its
// d2 <= this. FLT_MAX while the list is not full, so +Inf never passes.
__device__ __forceinline__ float filter_of(uint64_t kth) {
  return fminf(__uint_as_float(static_cast<uint32_t>(kth >> 32)), FLT_MAX);
}

__device__ __forceinline__ void store_key(uint64_t key, float* d, int32_t* i) {
  const uint32_t hi = static_cast<uint32_t>(key >> 32);
  const bool none = hi >= 0x7F800000u;
  *d = none ? INFINITY : __uint_as_float(hi);
  *i = none ? -1 : static_cast<int32_t>(static_cast<uint32_t>(key));
}

__device__ __forceinline__ float nan_f() { return __int_as_float(0x7fffffff); }

// The t-th of n places visited outward from `first`: first, first+1,
// first-1, first+2, ... (mod n), each once.
__device__ __forceinline__ int outward(int t, int first, int n) {
  const int half = (t + 1) >> 1;
  const int p = first + ((t & 1) ? half : -half);
  return p < 0 ? p + n : (p >= n ? p - n : p);
}

// The candidate ring over the n points: its tiles of `tile` points,
// visited outward from `first` (the tile of the CTA's own queries: in the
// wrapper's spatial order their neighbours, so the filter tightens at
// once), the t-th in slot t % stages as float4 pairs; points past n read
// as NaN. Within the first tile the kernel also starts at the round that
// holds the CTA's middle query `mid`.
struct TileRing {
  float4* ring;
  const float2* xy;
  int n, tile, stages, nt, first, mid;

  __device__ __forceinline__ int base(int t) const { return outward(t, first, nt) * tile; }

  // Of the first tile's `rounds` rounds of 128 points, the one holding the
  // CTA's middle query.
  __device__ __forceinline__ int first_round(int rounds) const {
    return min(rounds - 1, max(0, (mid - base(0)) / 128));
  }
  __device__ __forceinline__ int count(int t) const { return min(tile, n - base(t)); }

  __device__ __forceinline__ void fill(int t) const {
    float4* dst = ring + (t % stages) * (tile / 2);
    const int b = base(t);
    const int cnt = count(t);
    for (int j = threadIdx.x; j < tile / 2; j += blockDim.x) {
      const int c = 2 * j;
      if (c + 1 < cnt) {
        cp_async16(dst + j, xy + b + c, 16);
      } else {
        float4 v = make_float4(nan_f(), nan_f(), nan_f(), nan_f());
        if (c < cnt) {
          const float2 p = xy[b + c];
          v.x = p.x;
          v.y = p.y;
        }
        dst[j] = v;
      }
    }
  }

  __device__ __forceinline__ void prologue() const {
    for (int s = 0; s < stages - 1; ++s) {
      if (s < nt) fill(s);
      cp_async_commit();
    }
  }

  // Tile t, landed and visible to the CTA; starts the copy of t+stages-1
  // into the slot tile t-1 left.
  __device__ __forceinline__ const float4* acquire(int t) const {
    if (stages == 2) {
      cp_async_wait<0>();
    } else if (stages == 3) {
      cp_async_wait<1>();
    } else {
      cp_async_wait<2>();
    }
    __syncthreads();
    if (t + stages - 1 < nt) fill(t + stages - 1);
    cp_async_commit();
    return ring + (t % stages) * (tile / 2);
  }
};

// The ring of this CTA, first visiting the tile that holds the middle of
// its queries [q0, q0 + per_cta).
__device__ __forceinline__ TileRing make_ring(float4* ring, const float2* xy, int n, int tile,
                                              int stages, int q0, int per_cta) {
  const int nt = (n + tile - 1) / tile;
  const int mid = min(q0 + per_cta / 2, n - 1);
  return TileRing{ring, xy, n, tile, stages, nt, mid / tile, mid};
}

// A list of KMAX keys holds k real ones after KMAX - k dummies: key 0,
// which no candidate's key is below, so no insertion displaces them. The
// k-th real key is then always the last, at a fixed register.
__device__ __forceinline__ uint64_t initial_key(int pos, int kmax, int k) {
  return pos < kmax - k ? 0ull : kEmpty;
}

__device__ __forceinline__ float min4(float a, float b, float c, float d) {
  return fminf(fminf(a, b), fminf(c, d));    // fminf drops a NaN operand
}

// The filter. With EXPAND a query is held as (u, v) = (-2qx, -2qy) and a
// candidate passes if e = fma(u, cx, fma(v, cy, cc)) <= thr, cc = |c|^2:
// e estimates d2 - |q|^2 in 2 FFMA a pair. With every coordinate within R
// of 0 its rounding error and that of d2 itself stay below 68 eps R^2
// (eps = 2^-24), so thr = (kd + marg) - |q|^2 with marg = 2^-17 R^2 never
// drops a candidate whose exact d2 <= kd; the insertion code computes that
// exact d2. Without EXPAND (R outside [2^-50, 2^60], where that bound
// fails) a query is (qx, qy), e = d2 and thr = kd.
__device__ __forceinline__ bool expandable(float r) { return r > 0x1p-50f && r < 0x1p60f; }
__device__ __forceinline__ float margin_of(float r) { return 0x1p-17f * __fmul_rn(r, r); }

template <bool EXPAND>
__device__ __forceinline__ float query_coord(float x) { return EXPAND ? -2.f * x : x; }
template <bool EXPAND>
__device__ __forceinline__ float coord_of(float u) { return EXPAND ? -0.5f * u : u; }

template <bool EXPAND>
__device__ __forceinline__ float cand_norm(float cx, float cy) {
  return EXPAND ? __fmaf_rn(cx, cx, __fmul_rn(cy, cy)) : 0.f;
}

template <bool EXPAND>
__device__ __forceinline__ float filter_value(float u, float v, float cx, float cy, float cc) {
  return EXPAND ? __fmaf_rn(u, cx, __fmaf_rn(v, cy, cc)) : dist2(u, v, cx, cy);
}

// The threshold of a query at (qx, qy) whose list's filter is kd.
template <bool EXPAND>
__device__ __forceinline__ float threshold(float kd, float qx, float qy, float marg) {
  if (!EXPAND) return kd;
  if (kd == FLT_MAX) return INFINITY;         // the list is not full
  return __fsub_rn(__fadd_rn(kd, marg), __fadd_rn(__fmul_rn(qx, qx), __fmul_rn(qy, qy)));
}

// Insert the warp-uniform key x into a warp's sorted list (lane L holds
// positions [L*W, L*W + W)); the last position drops out.
template <int W>
__device__ __forceinline__ void warp_insert(uint64_t (&l)[W], uint64_t x, int lane) {
  const uint64_t prev = __shfl_up_sync(kFull, l[W - 1], 1);
  const bool ltp = lane > 0 && x < prev;
#pragma unroll
  for (int r = W - 1; r >= 0; --r) {
    const bool lt = x < l[r];
    const bool ltl = r > 0 ? x < l[r > 0 ? r - 1 : 0] : ltp;
    const uint64_t left = r > 0 ? l[r > 0 ? r - 1 : 0] : prev;
    if (lt) l[r] = ltl ? left : x;
  }
}

// The QW queries of a warp, each with its best 32W keys spread
// over the lanes (the k-th real key last, on lane 31).
template <int W, int QW, bool EXPAND>
struct WarpQueries {
  static constexpr int KMAX = 32 * W;
  float qu[QW], qv[QW], kd[QW], thr[QW];
  uint64_t lst[QW][W];
  const int32_t* order;
  int lane, q0, include_self;
  float marg;

  __device__ __forceinline__ void init(const float2* __restrict__ xy, int n, int k) {
#pragma unroll
    for (int j = 0; j < QW; ++j) {
      const int q = q0 + j;
      const float2 p = q < n ? xy[q] : make_float2(nan_f(), nan_f());
      qu[j] = query_coord<EXPAND>(p.x);
      qv[j] = query_coord<EXPAND>(p.y);
      kd[j] = FLT_MAX;
      thr[j] = threshold<EXPAND>(FLT_MAX, p.x, p.y, marg);
#pragma unroll
      for (int r = 0; r < W; ++r) lst[j][r] = initial_key(lane * W + r, KMAX, k);
    }
  }

  // Before the first round (rd of tile tl), where every candidate would
  // pass: seed each query's threshold with the kk-th smallest of the 32
  // lanes' smallest filter values (kk = k, or k + 1 without self, which
  // may be one of them; kk <= 32). Those kk values belong to distinct
  // candidates, so the k-th exact d2 of the query is at most tau + |q|^2
  // + 45 eps R^2, and every candidate that can enter has a filter value
  // <= tau + 90 eps R^2 < tau + marg (the bounds of `threshold`); without
  // EXPAND, tau itself.
  __device__ __forceinline__ void seed(const float4* tl, int rd, int kk) {
    const float4 a = tl[64 * rd + lane];
    const float4 b = tl[64 * rd + 32 + lane];
    const float cx[4] = {a.x, a.z, b.x, b.z};
    const float cy[4] = {a.y, a.w, b.y, b.w};
    float cc[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) cc[u] = cand_norm<EXPAND>(cx[u], cy[u]);
#pragma unroll
    for (int j = 0; j < QW; ++j) {
      float e[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) e[u] = filter_value<EXPAND>(qu[j], qv[j], cx[u], cy[u], cc[u]);
      float v = fminf(min4(e[0], e[1], e[2], e[3]), INFINITY);  // NaN (padding): +Inf
#pragma unroll
      for (int size = 2; size <= 32; size <<= 1) {  // bitonic sort over the lanes
#pragma unroll
        for (int stride = size >> 1; stride > 0; stride >>= 1) {
          const float o = __shfl_xor_sync(kFull, v, stride);
          const bool low = ((lane & stride) == 0) == ((lane & size) == 0);
          v = low ? fminf(v, o) : fmaxf(v, o);
        }
      }
      const float tau = __shfl_sync(kFull, v, kk - 1);
      if (tau < INFINITY) thr[j] = EXPAND ? __fadd_rn(tau, marg) : tau;
    }
  }

  // Round rd of the tile tl (points base + 128*rd + [0, 128)): each lane
  // takes 4 of them.
  __device__ __forceinline__ void rank(const float4* tl, int rd, int base) {
    const float4 a = tl[64 * rd + lane];
    const float4 b = tl[64 * rd + 32 + lane];
    const float cx[4] = {a.x, a.z, b.x, b.z};
    const float cy[4] = {a.y, a.w, b.y, b.w};
    float cc[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) cc[u] = cand_norm<EXPAND>(cx[u], cy[u]);
    float e[QW][4], m[QW];
    bool hit = false;
#pragma unroll
    for (int j = 0; j < QW; ++j) {
#pragma unroll
      for (int u = 0; u < 4; ++u) e[j][u] = filter_value<EXPAND>(qu[j], qv[j], cx[u], cy[u], cc[u]);
      m[j] = min4(e[j][0], e[j][1], e[j][2], e[j][3]);
      hit |= m[j] <= thr[j];
    }
    if (!__any_sync(kFull, hit)) return;
    const int id0 = base + 128 * rd + 2 * lane;
    const int ids[4] = {id0, id0 + 1, id0 + 64, id0 + 65};
#pragma unroll
    for (int j = 0; j < QW; ++j) {
      if (!__any_sync(kFull, m[j] <= thr[j])) continue;
      const float qx = coord_of<EXPAND>(qu[j]);
      const float qy = coord_of<EXPAND>(qv[j]);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float d = EXPAND ? dist2(qx, qy, cx[u], cy[u]) : e[j][u];
        const bool pass = d <= kd[j] && (include_self || ids[u] != q0 + j);
        unsigned bits = __ballot_sync(kFull, pass);
        if (bits) {
          const uint64_t key = make_key(d, pass ? __ldg(order + ids[u]) : 0);
          do {
            const int src = __ffs(bits) - 1;
            bits &= bits - 1;
            warp_insert<W>(lst[j], __shfl_sync(kFull, key, src), lane);
          } while (bits);
        }
      }
      kd[j] = filter_of(__shfl_sync(kFull, lst[j][W - 1], 31));
      thr[j] = threshold<EXPAND>(kd[j], qx, qy, marg);
    }
  }

  __device__ __forceinline__ void store(int n, int k, float* __restrict__ out_d,
                                        int32_t* __restrict__ out_i) const {
#pragma unroll
    for (int j = 0; j < QW; ++j) {
      const int q = q0 + j;
      if (q >= n) continue;
      const int row = __ldg(order + q);        // the query's own id
      const size_t o = static_cast<size_t>(row) * k;
#pragma unroll
      for (int r = 0; r < W; ++r) {
        const int p = lane * W + r;
        if (p >= KMAX - k) {
          const int r_out = p - (KMAX - k);     // the real key's rank
          store_key(lst[j][r], out_d + o + r_out, out_i + o + r_out);
        }
      }
    }
  }
};

// Warp w of the grid owns queries [w*QW, w*QW + QW); its lanes take
// consecutive candidates, and each query's best 32W keys are spread over
// the lanes (the k-th real key last, on lane 31).
template <int W, int QW, bool EXPAND>
__device__ __forceinline__ void warp_body(const float2* __restrict__ xy,
                                          const int32_t* __restrict__ order, int n, int k,
                                          int include_self, const TileRing& ring, float marg,
                                          float* __restrict__ out_d, int32_t* __restrict__ out_i) {
  WarpQueries<W, QW, EXPAND> w;
  w.order = order;
  w.lane = threadIdx.x & 31;
  w.q0 = (blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5)) * QW;
  w.include_self = include_self;
  w.marg = marg;
  w.init(xy, n, k);
  ring.prologue();
  for (int t = 0; t < ring.nt; ++t) {
    const float4* tl = ring.acquire(t);
    const int base = ring.base(t);
    const int rounds = (ring.count(t) + 127) / 128;
    if (t == 0) {                              // outward from the CTA's queries
      const int rd0 = ring.first_round(rounds);
      if constexpr (W == 1) {                  // k <= 32: the lanes' minima suffice
        const int kk = k + (include_self ? 0 : 1);
        if (kk <= 32) w.seed(tl, rd0, kk);
      }
      for (int ri = 0; ri < rounds; ++ri) w.rank(tl, outward(ri, rd0, rounds), base);
    } else {
      for (int rd = 0; rd < rounds; ++rd) w.rank(tl, rd, base);
    }
  }
  w.store(n, k, out_d, out_i);
}

template <int W, int QW>
__global__ void __launch_bounds__(kMaxThreads, 2)
knn_warp(const float2* __restrict__ xy, const int32_t* __restrict__ order,
         const float* __restrict__ rmax, int n, int k, int include_self, int tile, int stages,
         float* __restrict__ out_d, int32_t* __restrict__ out_i) {
  extern __shared__ float4 ring_mem[];
  const int per_cta = (blockDim.x >> 5) * QW;
  const TileRing ring = make_ring(ring_mem, xy, n, tile, stages, blockIdx.x * per_cta, per_cta);
  const float r = *rmax;
  if (expandable(r)) {
    warp_body<W, QW, true>(xy, order, n, k, include_self, ring, margin_of(r), out_d, out_i);
  } else {
    warp_body<W, QW, false>(xy, order, n, k, include_self, ring, 0.f, out_d, out_i);
  }
}

using KernelFn = void (*)(const float2*, const int32_t*, const float*, int, int, int, int, int,
                          float*, int32_t*);

// The instance for k: W = KMAX / 32 keys a lane, QW queries a warp (8, 4
// at W >= 4, where 8 lists would not fit 128 registers a thread; kernels/
// knn.py, queries_a_warp).
KernelFn warp_kernel(int k, int* queries) {
  const int w = k <= 32 ? 1 : k <= 64 ? 2 : k <= 128 ? 4 : 8;
  *queries = w <= 2 ? 8 : 4;
  switch (w) {
    case 1: return knn_warp<1, 8>;
    case 2: return knn_warp<2, 8>;
    case 4: return knn_warp<4, 4>;
    default: return knn_warp<8, 4>;
  }
}

}  // namespace

// xy f32 [n, 2] (16-byte aligned): the points in any order (the wrapper's
// is spatial), order int32 [n]: the id of each, a permutation of [0, n);
// rmax f32 [1] on the device, the largest |coordinate| (the filter's
// margin). out_d f32 [n, k] squared distances and out_i int32 [n, k]
// candidate ids by id, each row sorted by (d2, id). 1 <= k <= 256 and
// k < n. Launch shape (kernels/knn.py, KnnTiles): `threads` a CTA (a
// multiple of 32, <= 256), candidate tiles of `tile` points (a multiple of
// 128) in a ring of `stages` (2-4).
extern "C" int sct_knn(const float* xy, const int32_t* order, const float* rmax, int n, int k,
                       int include_self, int threads, int tile, int stages, float* out_d,
                       int32_t* out_i, void* stream) {
  if (n < 2 || k < 1 || k >= n || k > 256 || threads < 32 || threads > kMaxThreads ||
      threads % 32 || tile < 128 || tile % 128 || stages < 2 || stages > 4 ||
      static_cast<size_t>(stages) * tile * sizeof(float2) > kSmemLimit ||
      reinterpret_cast<uintptr_t>(xy) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int queries = 0;
  const KernelFn fn = warp_kernel(k, &queries);
  const size_t smem = static_cast<size_t>(stages) * tile * sizeof(float2);
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int per_cta = threads / 32 * queries;
  const float2* pts = reinterpret_cast<const float2*>(xy);
  void* args[] = {&pts, &order, &rmax, &n, &k, &include_self, &tile, &stages, &out_d, &out_i};
  return static_cast<int>(cudaLaunchKernel(reinterpret_cast<const void*>(fn),
                                           dim3((n + per_cta - 1) / per_cta), dim3(threads),
                                           args, smem, static_cast<cudaStream_t>(stream)));
}
