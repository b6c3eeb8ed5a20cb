// Counter-based random numbers shared by the kernels.
//
// Philox-4x32-10 (Salmon et al., SC'11): four 32-bit words per call, a pure
// function of a 128-bit counter and a 64-bit key.  The kernels key it with the
// launch seed and count with the logical coordinates of a draw (chain, sweep,
// color, site, draw index), so the stream does not depend on the launch
// geometry, in the spirit of the JAX package's fold-in discipline.
#pragma once
#include <cstdint>

namespace sv {

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
    const uint32_t M0 = 0xD2511F53u, M1 = 0xCD9E8D57u;
    const uint32_t W0 = 0x9E3779B9u, W1 = 0xBB67AE85u;
#pragma unroll
    for (int i = 0; i < 10; ++i) {
        const uint32_t hi0 = __umulhi(M0, c.x), lo0 = M0 * c.x;
        const uint32_t hi1 = __umulhi(M1, c.z), lo1 = M1 * c.z;
        c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
        k.x += W0;
        k.y += W1;
    }
    return c;
}

// Uniform [0, 1) from the top 24 bits of a word (the TPU kernels' conversion).
__device__ __forceinline__ float u24(uint32_t w) {
    return (float)(w >> 8) * (1.0f / 16777216.0f);
}

// e^{-x} through the hardware exp2.
__device__ __forceinline__ float exp_neg(float x) {
    return exp2f(x * -1.4426950408889634f);
}

constexpr float TWO_PI = 6.28318530717958647692f;

// XORed into the launch seed to key the Worldline kernels (ops/philox.py
// WORLDLINE_SALT), so a Villain and a Worldline call never share draws.
__host__ __device__ __forceinline__ uint2 worldline_key(unsigned long long seed) {
    const unsigned long long k = seed ^ 0x243F6A8885A308D3ull;
    return make_uint2((uint32_t)k, (uint32_t)(k >> 32));
}

}  // namespace sv
