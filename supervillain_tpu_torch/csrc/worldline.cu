// Worldline local-update sweeps on Hopper.
//
// Replaces supervillain_tpu/ops/pallas_worldline.py:worldline_sweeps (its
// kernel bodies _monolithic_passes/_make_kernel and _strip_sweep_section) and
// the sweep section of ops/pallas_worldline_hammer.py:worldline_hammer_sweeps.
// Same transition kernel as generators/worldline.py: per sweep a VortexUpdate
// (Δv on the plaquettes of color 0, then 1; Δv ∈ ±{1..interval_v}, or
// U(±interval_v) at W = ∞ with float v), a CoexactUpdate (Δm = δt, t ∈
// ±{1..interval_t}, per color) and a WrappingUpdate (Δm ∈ ±{1..interval_w}
// along every column cycle, μ = 0, and every row cycle, μ = 1).  ΔS sums
// (1/2κ)·du·(2u + du) over the changed links, u = m − δv/_W; Metropolis on
// u01 < exp(−ΔS) (expf, as the plain twin's torch.exp).
//
// What bounds it on the H100: device-memory traffic, as for the Villain sweep
// (sweep.cu).  One L=256 chain holds m 512 KB, v 256 KB and the residual u
// 512 KB, far above a block's 227 KB of shared memory, so the state stays in
// device memory and every pass streams it: a plaquette reads its 4 links' u
// (16 B) and writes them and v or m back when accepted; the wrapping pass and
// the per-sweep action sum read u once more.
//
// Design: one thread per (chain, plaquette of color c) and one launch per
// plaquette pass (4 per sweep): same-color plaquettes share no link, so each
// link has one writer per pass and nothing is atomic on the fields.  The
// residual u (float32, 2 links per site) is rebuilt from (m, v) at the start
// of every call, which bounds its f32 drift to one call (at W = ∞, where v is
// a float, too).  The wrapping pass is one thread per (chain, μ, cycle): it
// sums the N links of its cycle in double, decides, and applies the shift to
// its own cycle; both directions read u from before the pass (μ = 0 writes only
// u_0, μ = 1 reads only u_1).  Its sum order differs from torch.sum's, so a
// same-draws comparison with the plain twin can part on a wrapping decision.
// One reduction launch per sweep adds Σu² (in double) for the inline
// ActionDensity.  Accepted counts are aggregated per warp before one atomic.
// Draws: Philox keyed by the seed's Worldline key, countered by (plaquette or
// cycle, chain, 6·sweep + pass, 0).
#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

#include "philox.cuh"
#include "worldline.cuh"

namespace {

using sv::draw_nonzero;
using sv::link_residual;
using sv::link_term;
using sv::metropolis;
using sv::philox4x32_10;
using sv::u24;

// Adds each active lane's accept to its chain's count, one atomic per chain per warp.
__device__ __forceinline__ void count_accepts(int* accepted, int chain, bool active, bool accept) {
    const unsigned peers = __match_any_sync(0xffffffffu, chain);
    const unsigned votes = __ballot_sync(0xffffffffu, accept);
    if (active && (int)(threadIdx.x & 31) == __ffs(peers) - 1) {
        const int c = __popc(votes & peers);
        if (c) atomicAdd(accepted + chain, c);
    }
}

// u_mu[x] = m_mu[x] − (δv)_mu[x]/_W, one thread per (chain, site).
template <typename V>
__global__ void init_residual(const int* __restrict__ m, const V* __restrict__ v,
                              float* __restrict__ u, int B, int N, float inv_w) {
    const long long NN = (long long)N * N;
    const long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
    if (idx >= B * NN) return;
    const long long chain = idx / NN;
    const int s = (int)(idx - chain * NN);
    const int t = s / N, x = s - t * N;
    const int* mc = m + chain * 2 * NN;
    const V* vc = v + chain * NN;
    float* uc = u + chain * 2 * NN;
    uc[s] = link_residual(mc, vc, 0, t, x, N, inv_w);
    uc[NN + s] = link_residual(mc, vc, 1, t, x, N, inv_w);
}

// One vortex (kVortex) or coexact pass over the plaquettes of one color.
template <bool kVortex, typename V>
__global__ void plaquette_pass(int* __restrict__ m, V* __restrict__ v, float* __restrict__ u,
                               int* __restrict__ accepted, int B, int N, int color, uint32_t pass,
                               uint2 key, float inv2k, float inv_w, float interval_v,
                               int interval_t) {
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
        const int tp = t + 1 == N ? 0 : t + 1, xp = x + 1 == N ? 0 : x + 1;
        // The plaquette's links ℓ0[t,x], ℓ0[t,x+1], ℓ1[t,x], ℓ1[t+1,x].
        const int la = s, lb = t * N + xp, lc = s, ld = tp * N + x;
        float* u0 = u + chain * 2 * NN;
        float* u1 = u0 + NN;
        int* m0 = m + chain * 2 * NN;
        int* m1 = m0 + NN;

        const uint4 w = philox4x32_10(make_uint4((uint32_t)s, (uint32_t)chain, pass, 0u), key);
        // δ of a change on this plaquette is (+c, −c, −c, +c) on its 4 links.
        V dv = 0;
        int dt = 0;
        float du;  // the residual's change on ℓ0[t,x]; the others follow the signs
        if (kVortex) {
            if constexpr (std::is_same<V, float>::value) {
                dv = (2.f * u24(w.x) - 1.f) * interval_v;
            } else {
                dv = draw_nonzero(w.x, (int)interval_v);
            }
            du = -__fmul_rn((float)dv, inv_w);     // u changes by −δ(Δv)/_W
        } else {
            dt = draw_nonzero(w.x, interval_t);
            du = (float)dt;                        // u changes by +δt
        }
        const float ua = u0[la], ub = u0[lb], uc = u1[lc], ud = u1[ld];
        const float dS = __fadd_rn(__fadd_rn(link_term(inv2k, uc, -du), link_term(inv2k, ud, du)),
                                   __fadd_rn(link_term(inv2k, ua, du), link_term(inv2k, ub, -du)));
        accept = metropolis(u24(w.y), dS);
        if (accept) {
            u0[la] = __fadd_rn(ua, du);
            u0[lb] = __fadd_rn(ub, -du);
            u1[lc] = __fadd_rn(uc, -du);
            u1[ld] = __fadd_rn(ud, du);
            if (kVortex) {
                v[chain * NN + s] += dv;
            } else {
                m0[la] += dt;
                m0[lb] -= dt;
                m1[lc] -= dt;
                m1[ld] += dt;
            }
        }
    }
    count_accepts(accepted, chain, active, accept);
}

// The wrapping pass: one thread per (chain, μ, cycle).  μ = 0 shifts m_0 on
// the column x = k (its ΔS sums over t); μ = 1 shifts m_1 on the row t = k.
__global__ void wrapping_pass(int* __restrict__ m, float* __restrict__ u,
                              int* __restrict__ accepted, int B, int N, uint32_t pass0, uint2 key,
                              float inv2k, int interval_w) {
    const long long NN = (long long)N * N;
    const long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
    const bool active = idx < (long long)B * 2 * N;
    int chain = -1;
    bool accept = false;
    if (active) {
        chain = (int)(idx / (2 * N));
        const int r = (int)(idx - (long long)chain * 2 * N);
        const int mu = r / N, k = r - mu * N;
        const uint4 w = philox4x32_10(
            make_uint4((uint32_t)k, (uint32_t)chain, pass0 + (uint32_t)mu, 0u), key);
        const int c = draw_nonzero(w.x, interval_w);
        const float cf = (float)c;
        float* uc = u + chain * 2 * NN + mu * NN;
        int* mc = m + chain * 2 * NN + mu * NN;
        const int base = mu == 0 ? k : k * N, stride = mu == 0 ? N : 1;
        double dS = 0.0;
        for (int i = 0; i < N; ++i) {
            dS += (double)link_term(inv2k, uc[base + i * stride], cf);
        }
        accept = metropolis(u24(w.y), (float)dS);
        if (accept) {
            for (int i = 0; i < N; ++i) {
                const int l = base + i * stride;
                mc[l] += c;
                uc[l] = __fadd_rn(uc[l], cf);
            }
        }
    }
    count_accepts(accepted, chain, active, accept);
}

constexpr int kSumThreads = 256;

// One block per chain: add Σ u² over the chain's links to sums[chain].
__global__ void residual_squares(const float* __restrict__ u, double* __restrict__ sums, int N) {
    const long long links = 2LL * N * N;
    const float* uc = u + blockIdx.x * links;
    double a = 0.0;
    for (long long l = threadIdx.x; l < links; l += blockDim.x) {
        const double x = uc[l];
        a += x * x;
    }
    __shared__ double sa[kSumThreads];
    sa[threadIdx.x] = a;
    __syncthreads();
    for (int h = kSumThreads / 2; h > 0; h /= 2) {
        if ((int)threadIdx.x < h) sa[threadIdx.x] += sa[threadIdx.x + h];
        __syncthreads();
    }
    if (threadIdx.x == 0) sums[blockIdx.x] += sa[0];
}

template <typename V>
int worldline_sweeps(const int* m_in, const V* v_in, int* m, V* v, float* u, int* accepted,
                     double* sums, int B, int N, int sweeps, float inv2k, float inv_w,
                     float interval_v, int interval_t, int interval_w, unsigned long long seed,
                     void* stream_ptr) {
    cudaStream_t stream = (cudaStream_t)stream_ptr;
    const size_t NN = (size_t)N * N;
    cudaError_t e;
    if ((e = cudaMemcpyAsync(m, m_in, 2 * B * NN * sizeof(int), cudaMemcpyDeviceToDevice, stream))) return e;
    if ((e = cudaMemcpyAsync(v, v_in, B * NN * sizeof(V), cudaMemcpyDeviceToDevice, stream))) return e;
    if ((e = cudaMemsetAsync(accepted, 0, B * sizeof(int), stream))) return e;
    if ((e = cudaMemsetAsync(sums, 0, B * sizeof(double), stream))) return e;

    const int threads = 256;
    init_residual<V><<<(unsigned)((B * NN + threads - 1) / threads), threads, 0, stream>>>(
        m, v, u, B, N, inv_w);
    if ((e = cudaGetLastError())) return e;

    const uint2 key = sv::worldline_key(seed);
    const unsigned pass_blocks = (unsigned)((B * NN / 2 + threads - 1) / threads);
    const unsigned wrap_blocks = (unsigned)((2ULL * B * N + threads - 1) / threads);
    for (int sweep = 0; sweep < sweeps; ++sweep) {
        const uint32_t pass0 = 6u * (uint32_t)sweep;
        for (int color = 0; color < 2; ++color) {
            plaquette_pass<true, V><<<pass_blocks, threads, 0, stream>>>(
                m, v, u, accepted, B, N, color, pass0 + color, key, inv2k, inv_w, interval_v,
                interval_t);
            if ((e = cudaGetLastError())) return e;
        }
        for (int color = 0; color < 2; ++color) {
            plaquette_pass<false, V><<<pass_blocks, threads, 0, stream>>>(
                m, v, u, accepted, B, N, color, pass0 + 2 + color, key, inv2k, inv_w, interval_v,
                interval_t);
            if ((e = cudaGetLastError())) return e;
        }
        wrapping_pass<<<wrap_blocks, threads, 0, stream>>>(m, u, accepted, B, N, pass0 + 4, key,
                                                            inv2k, interval_w);
        if ((e = cudaGetLastError())) return e;
        residual_squares<<<B, kSumThreads, 0, stream>>>(u, sums, N);
        if ((e = cudaGetLastError())) return e;
    }
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// Copies (m_in, v_in) into (m, v), then runs `sweeps` worldline sweeps in
// place.  accepted (B,) int32 receives the accepted proposals; sums (B,)
// double receives Σ_sweeps Σ u² after each sweep.  u (B, 2, N, N) f32 is
// scratch.  v is int32 (finite W); the _winf entry takes float32 v (W = ∞).
int sv_worldline_sweeps(const int* m_in, const int* v_in, int* m, int* v, float* u, int* accepted,
                        double* sums, int B, int N, int sweeps, float inv2k, float inv_w,
                        float interval_v, int interval_t, int interval_w, unsigned long long seed,
                        void* stream) {
    return worldline_sweeps<int>(m_in, v_in, m, v, u, accepted, sums, B, N, sweeps, inv2k, inv_w,
                                 interval_v, interval_t, interval_w, seed, stream);
}

int sv_worldline_sweeps_winf(const int* m_in, const float* v_in, int* m, float* v, float* u,
                             int* accepted, double* sums, int B, int N, int sweeps, float inv2k,
                             float inv_w, float interval_v, int interval_t, int interval_w,
                             unsigned long long seed, void* stream) {
    return worldline_sweeps<float>(m_in, v_in, m, v, u, accepted, sums, B, N, sweeps, inv2k, inv_w,
                                   interval_v, interval_t, interval_w, seed, stream);
}

}  // extern "C"
