// Arithmetic shared by the Worldline sweep and worm kernels.
//
// Every rounding step is an explicit _rn intrinsic, so that nvcc contracts no
// multiply-add into an FMA and each value is bit for bit the one the plain
// PyTorch twin computes (ops/worldline.py, ops/worldline_worm.py) from the
// same draws.
#pragma once
#include <cstdint>

#include "philox.cuh"

namespace sv {

__device__ __forceinline__ int wrap(int a, int N) { return a < 0 ? a + N : (a >= N ? a - N : a); }

// Uniform over ±{1..i} as floor(u·2i) − i, shifted past zero: the TPU kernels'
// _int_nonzero (pallas_worldline.py).
__device__ __forceinline__ int draw_nonzero(uint32_t w, int interval) {
    const int r = (int)floorf(u24(w) * (float)(2 * interval)) - interval;
    return r < 0 ? r : r + 1;
}

// δv/_W of a link on axis ax from the two v of its δv, v_here at the link's
// site and v_back one step back along ax ((δv)_0[t,x] = v[t,x] − v[t,x−1],
// (δv)_1[t,x] = −(v[t,x] − v[t−1,x])), with inv_w = 1/_W.
template <typename V>
__device__ __forceinline__ float dual_part(V v_here, V v_back, int ax, float inv_w) {
    const V dv = ax == 0 ? v_here - v_back : -(v_here - v_back);
    return __fmul_rn((float)dv, inv_w);
}

// The residual u = m − δv/_W of a link from its m and its dual_part.
__device__ __forceinline__ float residual(int m, float dvw) { return __fsub_rn((float)m, dvw); }

// The residual of link (ax, t, x) of one chain in the public (2, N, N) and
// (1, N, N) layouts of m and v.
template <typename V>
__device__ __forceinline__ float link_residual(const int* m, const V* v, int ax, int t, int x,
                                               int N, float inv_w) {
    const int s = t * N + x;
    const int back = ax == 0 ? t * N + (x == 0 ? N - 1 : x - 1) : (t == 0 ? N - 1 : t - 1) * N + x;
    return residual(m[ax * N * N + s], dual_part(v[s], v[back], ax, inv_w));
}

// ΔS = (1/2κ)·du·(2u + du) of one link whose residual u changes by du.
__device__ __forceinline__ float link_term(float inv2k, float u, float du) {
    return __fmul_rn(__fmul_rn(inv2k, du), __fadd_rn(2.f * u, du));
}

// Metropolis acceptance of ΔS for a uniform u01, with expf as torch.exp
// computes it.  At finite W the residuals are multiples of 1/W, so ΔS takes a
// few discrete values many times over; an exponential one ulp off (exp2f)
// would flip the decisions at one of them systematically against the plain
// twin.
__device__ __forceinline__ bool metropolis(float u01, float dS) {
    return u01 < expf(-dS);
}

}  // namespace sv
