// The keyed Feistel permutation's cycle walk, one thread a value.
//
// Replaces no Pallas kernel. The JAX package evaluates the Feistel stream
// (spatialcore_tpu/core/rng.py, feistel_apply) as a jax.lax.while_loop of
// elementwise uint32 ops that XLA compiles into one loop on the device; the
// port's plain version (kernels/feistel.py, feistel_walk_plain) runs each
// pass as ~175 eager torch int64 launches over every value and reads one
// "any value still out of range" flag back a pass, so a draw's rows cost
// 5-32 host round trips. This kernel walks each value's cycle in registers
// until it lands in [0, n): one launch, nothing read back.
//
// Each value y in [0, n) goes through the balanced 8-round bijection on
// [0, 4^bits) until the result is < n (cycle walking). Both the plain loop
// and the reference's while_loop apply the bijection to an out-of-range
// value and leave an in-range one as it is, so a value's result depends on
// its own orbit alone and a per-thread loop gives every row bitwise. The
// multiplications wrap mod 2^32, as jnp.uint32's do.
//
// What bounds it on the H100. Bytes: 8 in and 8 out a value (int64
// indices and rows, as the callers hold them), 16 MB at 1M values, ~5 us
// at 3.35 TB/s. Operations: a bijection is ~70 integer instructions and a
// warp runs as many as its longest walk; at n = 4^10 / 2.86 (366,938
// cells) that is ~10 bijections a warp, ~25 us at one warp instruction a
// scheduler a clock. Values already in range never enter the loop again,
// so divergence costs the longest walk in the warp, not in the array.
//
// The longest walk of a call is the port's count rng.feistel_passes (the
// passes the plain loop makes). The kernel keeps it on the device: a warp
// and block max, an atomicMax into the call's longest walk, and the last
// block to finish adds it into a running total and clears it for the next
// call (launches on one stream run in order, so one set of words serves
// every call). The host reads the total only when the counters are read.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kRounds = 8;
constexpr int kThreads = 256;
constexpr int kMaxBlocks = 16384;

struct RoundKeys {
  uint32_t k[kRounds];
};

__device__ __forceinline__ uint32_t bijection(uint32_t x, const RoundKeys& keys, int bits,
                                              uint32_t mask) {
  uint32_t left = x >> bits;
  uint32_t right = x & mask;
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    uint32_t h = (right ^ keys.k[r]) * 0x9E3779B1u;
    h ^= h >> 15;
    h *= 0x85EBCA77u;
    h ^= h >> 13;
    const uint32_t next = (left ^ h) & mask;
    left = right;
    right = next;
  }
  return (left << bits) | right;
}

// state: the running total of longest walks, the call's longest walk, and
// the call's blocks finished
__global__ void __launch_bounds__(kThreads)
    feistel_walk_kernel(const int64_t* __restrict__ idx, int64_t* __restrict__ out,
                        int64_t count, RoundKeys keys, int bits, uint32_t n,
                        unsigned long long* __restrict__ state) {
  const uint32_t mask = (1u << bits) - 1u;
  uint32_t longest = 1;  // every value takes at least one pass
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i < count;
       i += stride) {
    uint32_t y = static_cast<uint32_t>(idx[i]);
    uint32_t walk = 0;
    do {
      y = bijection(y, keys, bits, mask);
      ++walk;
    } while (y >= n);
    out[i] = static_cast<int64_t>(y);
    longest = max(longest, walk);
  }

  __shared__ uint32_t warp_longest[kThreads / 32];
  longest = __reduce_max_sync(0xffffffffu, longest);
  if ((threadIdx.x & 31) == 0) warp_longest[threadIdx.x >> 5] = longest;
  __syncthreads();
  if (threadIdx.x != 0) return;
  for (int w = 1; w < kThreads / 32; ++w) longest = max(longest, warp_longest[w]);
  atomicMax(state + 1, static_cast<unsigned long long>(longest));
  __threadfence();
  if (atomicAdd(state + 2, 1ull) == gridDim.x - 1) {  // the last block
    atomicAdd(state, atomicExch(state + 1, 0ull));
    atomicExch(state + 2, 0ull);
  }
}

}  // namespace

extern "C" int sct_feistel_walk(const int64_t* idx, int64_t* out, long long count,
                                unsigned int k0, unsigned int k1, unsigned int k2,
                                unsigned int k3, unsigned int k4, unsigned int k5,
                                unsigned int k6, unsigned int k7, int bits, unsigned int n,
                                unsigned long long* state, void* stream) {
  if (count < 0 || bits < 1 || bits > 16 || n < 2 ||
      static_cast<unsigned long long>(n) > (1ull << (2 * bits)) || state == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const RoundKeys keys = {{k0, k1, k2, k3, k4, k5, k6, k7}};
  const long long want = (count + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < 1 ? 1 : (want > kMaxBlocks ? kMaxBlocks : want));
  feistel_walk_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      idx, out, static_cast<int64_t>(count), keys, bits, n, state);
  return static_cast<int>(cudaGetLastError());
}
