// Villain neighborhood sweeps on Hopper.
//
// Replaces supervillain_tpu/ops/pallas_sweep.py:neighborhood_sweeps (its
// kernel bodies _make_kernel and _make_strip_kernel).  Same transition kernel
// as generators/villain.py:NeighborhoodUpdate: each site of checkerboard color
// c proposes Δφ ~ U(±interval_phi) and Δn ∈ W·{-i..i} on its 4 adjacent links
// (zero-inflated when p_n >= 0), or at W = ∞ (W == 0 here) an integer Δz with
// Δn = d(Δz); ΔS = Σ_links (κ/2)·cr·(2r + cr) with cr the change of the link
// residual r = dφ − 2πn; Metropolis on u < exp(−ΔS).
//
// What bounds it on the H100: device-memory traffic.  One chain at L=256 is
// 1.25 MB (φ 4 B + n 8 B + r 8 B per site), far above the 227 KB of shared
// memory a block can use, so the chain state cannot stay on chip across a
// sweep the way it stays in VMEM on the TPU.  The state lives in device
// memory and every color pass streams it: a color-c site reads φ and its 4
// links' r and n (36 B) and writes them back when accepted, and the per-sweep
// inline sums read r and n once more (16 B/site) — about 70-90 B of traffic
// per site-update, so the card's 3.35 TB/s caps this design near 4e10
// site-updates/s before any other limit.
//
// Design: one thread per (chain, site of color c), one launch per color pass
// (the other color's sites read the links this pass writes, so a pass must
// finish before the next begins): 2·sweeps color passes per call, plus one
// reduction launch per sweep for the inline ActionDensity and WindingSquared.
// Each link is adjacent to exactly one site of each color, so no two threads
// of a pass write the same word and no atomics touch the fields.  Accepted
// counts are aggregated per warp (peers by chain) before one atomicAdd.  The
// residual r is recomputed from (φ, n) at the start of every call, as the TPU
// kernel does at every launch, so its f32 drift is bounded by one call.
// Same-color sites of a row sit two words apart, so a warp uses half of each
// 32-byte sector it loads; a color-major layout would fix that (later work).
#include <cstdint>
#include <cuda_runtime.h>

#include "philox.cuh"

namespace {

using sv::philox4x32_10;
using sv::u24;
using sv::exp_neg;
using sv::TWO_PI;

// Uniform in {-i..i} as floor(u·(2i+1)) − i, or the zero-inflated ±k (k
// uniform in 1..i, each sign with probability p/2) when p >= 0 — the TPU
// kernels' draw formulas (pallas_sweep.py _int_in and _int_sparse).
__device__ __forceinline__ int draw_int(uint32_t a, uint32_t b, int interval, float p) {
    if (p < 0.f) {
        return (int)floorf(u24(a) * (float)(2 * interval + 1)) - interval;
    }
    const float u = u24(a);
    const int mag = interval == 1 ? 1 : (int)floorf(u24(b) * (float)interval) + 1;
    const int sign = (u < 0.5f * p) ? 1 : ((u < p) ? -1 : 0);
    return sign * mag;
}

// r_mu[x] = φ[x + e_mu] − φ[x] − 2π n_mu[x], one thread per (chain, site).
__global__ void init_residual(const float* __restrict__ phi, const int* __restrict__ n,
                              float* __restrict__ r, int B, int N) {
    const long long NN = (long long)N * N;
    const long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
    if (idx >= B * NN) return;
    const long long chain = idx / NN;
    const int s = (int)(idx - chain * NN);
    const int t = s / N, x = s - t * N;
    const int tp = t + 1 == N ? 0 : t + 1, xp = x + 1 == N ? 0 : x + 1;
    const float* ph = phi + chain * NN;
    const int* n0 = n + chain * 2 * NN;
    float* r0 = r + chain * 2 * NN;
    const float p = ph[s];
    r0[s] = (ph[tp * N + x] - p) - TWO_PI * (float)n0[s];
    r0[NN + s] = (ph[t * N + xp] - p) - TWO_PI * (float)n0[NN + s];
}

__global__ void color_pass(float* __restrict__ phi, int* __restrict__ n, float* __restrict__ r,
                           int* __restrict__ accepted, int B, int N, int color, uint32_t pass,
                           uint2 key, float kappa, int W, float interval_phi, int interval_n,
                           float p_n) {
    const int hN = N / 2;
    const long long NN = (long long)N * N;
    const long long half = NN / 2;
    const long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
    const bool active = idx < B * half;
    int chain = -1;
    bool accept = false;
    if (active) {
        chain = (int)(idx / half);
        const int k = (int)(idx - chain * half);
        const int t = k / hN;
        const int x = 2 * (k - t * hN) + ((t + color) & 1);
        const int s = t * N + x;
        const int tm = t == 0 ? N - 1 : t - 1, xm = x == 0 ? N - 1 : x - 1;
        const int lb0 = tm * N + x, lb1 = t * N + xm;  // backward links; forward ones are s

        float* ph = phi + chain * NN;
        int* n0 = n + chain * 2 * NN;
        int* n1 = n0 + NN;
        float* r0 = r + chain * 2 * NN;
        float* r1 = r0 + NN;

        const uint4 w0 = philox4x32_10(make_uint4((uint32_t)s, (uint32_t)chain, pass, 0u), key);
        const uint4 w1 = philox4x32_10(make_uint4((uint32_t)s, (uint32_t)chain, pass, 1u), key);
        uint4 w2 = make_uint4(0u, 0u, 0u, 0u);
        if (p_n >= 0.f && interval_n > 1) {
            w2 = philox4x32_10(make_uint4((uint32_t)s, (uint32_t)chain, pass, 2u), key);
        }
        const float dphi = (2.f * u24(w0.x) - 1.f) * interval_phi;
        int cf0, cf1, cb0, cb1;
        if (W == 0) {
            // z-mode: Δn = d(Δz) with Δz on this site only.
            const int dz = draw_int(w0.z, w1.z, interval_n, p_n);
            cf0 = -dz; cf1 = -dz; cb0 = dz; cb1 = dz;
        } else {
            cf0 = W * draw_int(w0.z, w1.z, interval_n, p_n);
            cf1 = W * draw_int(w0.w, w1.w, interval_n, p_n);
            cb0 = W * draw_int(w1.x, w2.x, interval_n, p_n);
            cb1 = W * draw_int(w1.y, w2.y, interval_n, p_n);
        }
        const float rf0 = r0[s], rb0 = r0[lb0], rf1 = r1[s], rb1 = r1[lb1];
        const float crf0 = -dphi - TWO_PI * (float)cf0;
        const float crb0 = dphi - TWO_PI * (float)cb0;
        const float crf1 = -dphi - TWO_PI * (float)cf1;
        const float crb1 = dphi - TWO_PI * (float)cb1;
        const float dS = 0.5f * kappa * (crf0 * (2.f * rf0 + crf0) + crb0 * (2.f * rb0 + crb0)
                                         + crf1 * (2.f * rf1 + crf1) + crb1 * (2.f * rb1 + crb1));
        accept = u24(w0.y) < exp_neg(dS);
        if (accept) {
            ph[s] += dphi;
            n0[s] += cf0;
            n0[lb0] += cb0;
            n1[s] += cf1;
            n1[lb1] += cb1;
            r0[s] = rf0 + crf0;
            r0[lb0] = rb0 + crb0;
            r1[s] = rf1 + crf1;
            r1[lb1] = rb1 + crb1;
        }
    }
    // Every lane reaches here; lanes of one chain add their accepts once.
    const unsigned peers = __match_any_sync(0xffffffffu, chain);
    const unsigned votes = __ballot_sync(0xffffffffu, accept);
    if (active && (int)(threadIdx.x & 31) == __ffs(peers) - 1) {
        const int c = __popc(votes & peers);
        if (c) atomicAdd(accepted + chain, c);
    }
}

constexpr int kSumThreads = 256;

// One block per chain: add Σ r² and Σ (dn)² over the chain's sites to sums[chain].
__global__ void inline_sums(const float* __restrict__ r, const int* __restrict__ n,
                            double* __restrict__ sums, int N) {
    const long long NN = (long long)N * N;
    const int chain = blockIdx.x;
    const float* r0 = r + chain * 2 * NN;
    const int* n0 = n + chain * 2 * NN;
    const int* n1 = n0 + NN;
    double a = 0.0, b = 0.0;
    for (int s = threadIdx.x; s < NN; s += blockDim.x) {
        const int t = s / N, x = s - t * N;
        const int tp = t + 1 == N ? 0 : t + 1, xp = x + 1 == N ? 0 : x + 1;
        const float v0 = r0[s], v1 = r0[NN + s];
        a += (double)v0 * v0 + (double)v1 * v1;
        const int dn = (n1[tp * N + x] - n1[s]) - (n0[t * N + xp] - n0[s]);
        b += (double)dn * dn;
    }
    __shared__ double sa[kSumThreads], sb[kSumThreads];
    sa[threadIdx.x] = a;
    sb[threadIdx.x] = b;
    __syncthreads();
    for (int h = kSumThreads / 2; h > 0; h /= 2) {
        if ((int)threadIdx.x < h) {
            sa[threadIdx.x] += sa[threadIdx.x + h];
            sb[threadIdx.x] += sb[threadIdx.x + h];
        }
        __syncthreads();
    }
    if (threadIdx.x == 0) {
        sums[2 * chain] += sa[0];
        sums[2 * chain + 1] += sb[0];
    }
}

}  // namespace

extern "C" {

const char* sv_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// Copies (phi_in, n_in) into (phi, n), then runs `sweeps` two-color sweeps in
// place.  accepted (B,) int32 receives the accepted site updates; sums (B, 2)
// double receives Σ_sweeps Σ r² and Σ_sweeps Σ (dn)².  r (B, 2, N, N) f32 is
// scratch.  W == 0 selects z-mode (W = ∞); p_n < 0 means no zero inflation.
int sv_sweeps(const float* phi_in, const int* n_in, float* phi, int* n, float* r,
              int* accepted, double* sums, int B, int N, int sweeps, float kappa, int W,
              float interval_phi, int interval_n, float p_n, unsigned long long seed,
              void* stream_ptr) {
    cudaStream_t stream = (cudaStream_t)stream_ptr;
    const size_t NN = (size_t)N * N;
    cudaError_t e;
    if ((e = cudaMemcpyAsync(phi, phi_in, B * NN * sizeof(float), cudaMemcpyDeviceToDevice, stream))) return e;
    if ((e = cudaMemcpyAsync(n, n_in, 2 * B * NN * sizeof(int), cudaMemcpyDeviceToDevice, stream))) return e;
    if ((e = cudaMemsetAsync(accepted, 0, B * sizeof(int), stream))) return e;
    if ((e = cudaMemsetAsync(sums, 0, 2 * B * sizeof(double), stream))) return e;

    const int threads = 256;
    init_residual<<<(unsigned)((B * NN + threads - 1) / threads), threads, 0, stream>>>(phi, n, r, B, N);
    if ((e = cudaGetLastError())) return e;

    const uint2 key = make_uint2((uint32_t)seed, (uint32_t)(seed >> 32));
    const unsigned pass_blocks = (unsigned)((B * NN / 2 + threads - 1) / threads);
    for (int sweep = 0; sweep < sweeps; ++sweep) {
        for (int color = 0; color < 2; ++color) {
            color_pass<<<pass_blocks, threads, 0, stream>>>(
                phi, n, r, accepted, B, N, color, (uint32_t)(2 * sweep + color), key, kappa, W,
                interval_phi, interval_n, p_n);
            if ((e = cudaGetLastError())) return e;
        }
        inline_sums<<<B, kSumThreads, 0, stream>>>(r, n, sums, N);
        if ((e = cudaGetLastError())) return e;
    }
    return cudaGetLastError();
}

}  // extern "C"
