// Counter-based random bits for the port's kernels: Philox4x32-10 (Salmon,
// Moraes, Dror and Shaw, "Parallel random numbers: as easy as 1, 2, 3",
// SC 2011), the generator cuRAND and PyTorch's CUDA generator also use.
//
// The TPU kernels this port replaces (ops/pallas/dropout.py,
// ops/pallas/pooling.py) draw from the TPU core's hardware PRNG
// (pltpu.prng_random_bits), whose bits nothing on a GPU can reproduce.  In
// their place the kernels here draw from this generator, keyed by a 64-bit
// seed and counted by the flat element index: element i takes word i % 4 of
// the Philox block for counter (i / 4, 0), key (seed low, seed high).  So
// the bits of an element depend on (seed, i) only, never on the launch
// geometry, and kernels/counter_rng.py computes the same bits in torch int64
// ops for the plain versions and the CPU tests.

#pragma once

#include <cstdint>

namespace znicz_rng {

constexpr uint32_t kM0 = 0xD2511F53u;  // Philox4x32 multipliers
constexpr uint32_t kM1 = 0xCD9E8D57u;
constexpr uint32_t kW0 = 0x9E3779B9u;  // key bumps (golden ratio, sqrt 3)
constexpr uint32_t kW1 = 0xBB67AE85u;

// The four 32-bit words of Philox4x32-10 at counter (c0, c1, 0, 0).
__device__ __forceinline__ uint4 philox4x32_10(uint32_t c0, uint32_t c1,
                                               uint64_t seed) {
  uint32_t k0 = static_cast<uint32_t>(seed);
  uint32_t k1 = static_cast<uint32_t>(seed >> 32);
  uint4 c = make_uint4(c0, c1, 0u, 0u);
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += kW0;
      k1 += kW1;
    }
    const uint32_t hi0 = __umulhi(kM0, c.x), lo0 = kM0 * c.x;
    const uint32_t hi1 = __umulhi(kM1, c.z), lo1 = kM1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

// The Philox block of the group of four elements that starts at 4 * group.
__device__ __forceinline__ uint4 group_bits(unsigned long long group,
                                            uint64_t seed) {
  return philox4x32_10(static_cast<uint32_t>(group),
                       static_cast<uint32_t>(group >> 32), seed);
}

__device__ __forceinline__ uint32_t word(const uint4& b, int j) {
  return j == 0 ? b.x : j == 1 ? b.y : j == 2 ? b.z : b.w;
}

// The bits of element i alone (a kernel that handles four consecutive
// elements per thread calls group_bits once instead).
__device__ __forceinline__ uint32_t element_bits(unsigned long long i,
                                                 uint64_t seed) {
  return word(group_bits(i >> 2, seed), static_cast<int>(i & 3));
}

// A uniform in [0, 1) from the top 24 bits, exactly as the TPU kernels
// make it (ops/pallas/pooling.py :: _uniform).
__device__ __forceinline__ float uniform24(uint32_t bits) {
  return static_cast<float>(bits >> 8) * 5.9604644775390625e-08f;  // 2^-24
}

}  // namespace znicz_rng
