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
// What bounds it on the H100: device-memory traffic and instruction issue
// (one Philox call per proposal).  One L=256 chain holds m 512 KB, v 256 KB
// and the residual u 512 KB, far above a block's 227 KB of shared memory, so
// the state stays in device memory and every pass streams it.
//
// Design (even N): a call works on v, the residual u and two integer tallies in a
// layout private to the kernel, built by one launch at the start and turned
// back into the public (m, v) by one at the end.  Each field is split by site
// color c = (t + x) & 1 into planes of N rows of N/2 entries, site (t, x) at
// [c][t][x >> 1], so the plaquettes of one color (one per site of that color;
// a plaquette's links are ℓ0[t,x], ℓ0[t,x+1], ℓ1[t,x], ℓ1[t+1,x]) read their
// 4 links' u at neighbouring addresses for neighbouring threads: 4-byte
// accesses that use every sector they touch.  m is not touched during the
// call: a coexact proposal adds its t to the plaquette's own entry of T, a
// wrapping shift to its cycle's entry of `shifts`, and the last launch writes
// m = m_in + δT + shifts.  So an accepted proposal writes 4 u and one v or T,
// all of its own, and each thread loads the links and v or T of 4 plaquettes
// of its row before it decides any (same-color plaquettes share no link, so
// nothing is atomic on the fields): one round trip serves 4 proposals.  The
// grid puts 8 rows of one chain in a block (a warp per row, lanes along it)
// and the chain on blockIdx.y, so no thread divides; a block counts its
// accepted proposals with one sum and one atomic.  The wrapping pass gives a
// row cycle (μ = 1, contiguous in both color planes) to one warp, and 32
// column cycles (μ = 0) to one block whose 8 warps each sum a strided eighth
// of the rows along the 32 columns: both directions load coalesced.  Cycle
// sums are in double, reduced in a fixed order; the same threads then add Σu²
// of their cycle after its decision, since the cycles cover every link once,
// to a per-cycle total that one warp per chain sums at the end of the call
// (the inline ActionDensity, with no pass of its own).  u (float32) is
// rebuilt from (m, v) at every call, which bounds its f32 drift to one call
// (at W = ∞, where v is a float, too).  The double sums' order differs from
// torch.sum's, so a same-draws comparison with the plain twin can part on a
// wrapping decision.  Draws: Philox keyed by the seed's Worldline key,
// countered by (plaquette or cycle, chain0 + chain, (2·n_colors + 2)·sweep + pass, 0)
// (chain0: the global index of the call's first chain),
// pass counting the vortex colors, the coexact colors, then the two wrapping
// directions: 6·sweep + pass at even N.
//
// Odd N: a torus of odd side needs 4 plaquette colors (ops/lattice.py
// checkerboard_masks), so the color planes above do not exist.  The call then
// keeps v, T and u in the public layout (the same launches, indexed t·N + x),
// and each plaquette pass is one thread per plaquette of a row, reading its
// color from an int8 table uploaded once and idling unless it is the pass's;
// its links wrap by comparison.  The wrapping pass and the inline sums are the
// even-N ones over the public layout.
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

constexpr unsigned kAll = 0xffffffffu;
constexpr int kLanes = 32, kRows = 8;  // a block: 8 warps, each along one row

// Index of site (t, x) in one chain's field of the private layout.
__device__ __forceinline__ int private_index(int t, int x, int N) {
    return ((t + x) & 1) * (N * N / 2) + t * (N / 2) + (x >> 1);
}

// Index of site (t, x) in one chain's field of the call's layout: private at
// even N, public (kPublic) at odd N.
template <bool kPublic>
__device__ __forceinline__ int field_index(int t, int x, int N) {
    return kPublic ? t * N + x : private_index(t, x, N);
}

// Adds the block's accepted proposals (every thread passes its own) to *accepted.
__device__ __forceinline__ void count_block(int* accepted, int mine) {
    __shared__ int per_warp[kRows];
    const int total = __reduce_add_sync(kAll, mine);
    if (threadIdx.x == 0) per_warp[threadIdx.y] = total;
    __syncthreads();
    if (threadIdx.y == 0) {
        const int all = __reduce_add_sync(kAll, (int)threadIdx.x < kRows ? per_warp[threadIdx.x] : 0);
        if (threadIdx.x == 0 && all) atomicAdd(accepted, all);
    }
}

// The sum of a double over a warp, in a fixed order, as every lane sees it.
__device__ __forceinline__ double warp_total(double a) {
    for (int o = kLanes / 2; o > 0; o /= 2) a += __shfl_down_sync(kAll, a, o);
    return __shfl_sync(kAll, a, 0);
}

// Public v into the call's layout, and the residual u_mu = m_mu − (δv)_mu/_W.
template <typename V, bool kPublic>
__global__ void __launch_bounds__(kLanes * kRows) to_private(const int* __restrict__ m,
                                                             const V* __restrict__ v,
                                                             V* __restrict__ vp,
                                                             float* __restrict__ u, int N,
                                                             float inv_w) {
    const int t = blockIdx.x * kRows + threadIdx.y;
    if (t >= N) return;
    const int NN = N * N, chain = blockIdx.y;
    const int* mc = m + chain * 2 * NN;
    const V* vc = v + chain * NN;
    for (int x = threadIdx.x; x < N; x += kLanes) {
        const int q = field_index<kPublic>(t, x, N);
        vp[chain * NN + q] = vc[t * N + x];
        u[chain * 2 * NN + q] = link_residual(mc, vc, 0, t, x, N, inv_w);
        u[chain * 2 * NN + NN + q] = link_residual(mc, vc, 1, t, x, N, inv_w);
    }
}

// The call's result in the public layout: v from the call's layout, and
// m = m_in + δT + the wrapping shifts, where T (call's layout) sums the
// accepted coexact changes t of each plaquette: plaquette (t, x) adds T to
// ℓ0[t,x] and ℓ1[t+1,x] and subtracts it from ℓ0[t,x+1] and ℓ1[t,x].
template <typename V, bool kPublic>
__global__ void __launch_bounds__(kLanes * kRows) to_public(const int* __restrict__ m_in,
                                                            const V* __restrict__ vp,
                                                            const int* __restrict__ tp,
                                                            const int* __restrict__ shifts,
                                                            int* __restrict__ m,
                                                            V* __restrict__ v, int N) {
    const int t = blockIdx.x * kRows + threadIdx.y;
    if (t >= N) return;
    const int NN = N * N, chain = blockIdx.y;
    const int* tc = tp + chain * NN;
    const int* shift = shifts + chain * 2 * N;
    const int tb = t == 0 ? N - 1 : t - 1;
    for (int x = threadIdx.x; x < N; x += kLanes) {
        const int here = tc[field_index<kPublic>(t, x, N)];
        const int left = tc[field_index<kPublic>(t, x == 0 ? N - 1 : x - 1, N)];
        const int below = tc[field_index<kPublic>(tb, x, N)];
        const int s0 = chain * 2 * NN + t * N + x;
        m[s0] = m_in[s0] + here - left + shift[x];
        m[s0 + NN] = m_in[s0 + NN] - here + below + shift[N + t];
        v[chain * NN + t * N + x] = vp[chain * NN + field_index<kPublic>(t, x, N)];
    }
}

// One vortex (kVortex) or coexact pass over the plaquettes of one color.  A
// thread loads the links of kBatch plaquettes of its row, and the field their
// proposals change (v, or T), before it decides any: same-color plaquettes
// share nothing, and one round trip to memory then serves kBatch proposals.
constexpr int kBatch = 4;

template <bool kVortex, typename V>
__global__ void __launch_bounds__(kLanes * kRows) plaquette_pass(
    V* __restrict__ vp, int* __restrict__ tp, float* __restrict__ u, int* __restrict__ accepted,
    int N, int color, uint32_t pass, uint2 key, uint32_t chain0, float inv2k, float inv_w,
    float interval_v, int interval_t) {
    using F = std::conditional_t<kVortex, V, int>;  // v, or T of Δm = δt
    const int t = blockIdx.x * kRows + threadIdx.y, chain = blockIdx.y;
    int count = 0;
    if (t < N) {
        const int NN = N * N, hN = N / 2, p = (t + color) & 1;
        const int tn = t + 1 == N ? 0 : t + 1;
        float* u0 = u + chain * 2 * NN;
        float* u1 = u0 + NN;
        F* fc;
        if constexpr (kVortex) {
            fc = vp + chain * NN;
        } else {
            fc = tp + chain * NN;
        }
        // Row starts: this color's row t, and the other color's rows t and t + 1.
        const int own = color * (NN / 2) + t * hN;
        const int other = (1 - color) * (NN / 2) + t * hN;
        const int above = (1 - color) * (NN / 2) + tn * hN;
        for (int j0 = threadIdx.x; j0 < hN; j0 += kLanes * kBatch) {
            // The plaquettes' links ℓ0[t,x], ℓ0[t,x+1], ℓ1[t,x], ℓ1[t+1,x], x = 2j + p.
            float ua[kBatch], ub[kBatch], uc[kBatch], ud[kBatch];
            F f[kBatch];
#pragma unroll
            for (int i = 0; i < kBatch; ++i) {
                const int j = j0 + i * kLanes;
                if (j < hN) {
                    ua[i] = u0[own + j];
                    ub[i] = u0[other + (j + p == hN ? 0 : j + p)];
                    uc[i] = u1[own + j];
                    ud[i] = u1[above + j];
                    f[i] = fc[own + j];
                }
            }
#pragma unroll
            for (int i = 0; i < kBatch; ++i) {
                const int j = j0 + i * kLanes;
                if (j >= hN) break;
                const int x = 2 * j + p;
                const uint4 w = philox4x32_10(
                    make_uint4((uint32_t)(t * N + x), chain0 + (uint32_t)chain, pass, 0u), key);
                // δ of a change on this plaquette is (+c, −c, −c, +c) on its 4 links.
                F change;
                float du;  // the residual's change on ℓ0[t,x]; the others follow the signs
                if constexpr (!kVortex) {
                    change = draw_nonzero(w.x, interval_t);
                    du = (float)change;                     // u changes by +δt
                } else if constexpr (std::is_same<V, float>::value) {
                    change = (2.f * u24(w.x) - 1.f) * interval_v;
                    du = -__fmul_rn(change, inv_w);         // u changes by −δ(Δv)/_W
                } else {
                    change = draw_nonzero(w.x, (int)interval_v);
                    du = -__fmul_rn((float)change, inv_w);
                }
                const float dS = __fadd_rn(
                    __fadd_rn(link_term(inv2k, uc[i], -du), link_term(inv2k, ud[i], du)),
                    __fadd_rn(link_term(inv2k, ua[i], du), link_term(inv2k, ub[i], -du)));
                if (metropolis(u24(w.y), dS)) {
                    u0[own + j] = __fadd_rn(ua[i], du);
                    u0[other + (j + p == hN ? 0 : j + p)] = __fadd_rn(ub[i], -du);
                    u1[own + j] = __fadd_rn(uc[i], -du);
                    u1[above + j] = __fadd_rn(ud[i], du);
                    fc[own + j] = f[i] + change;
                    ++count;
                }
            }
        }
    }
    count_block(accepted + chain, count);
}

// A plaquette pass at any N over the public layout: one thread per
// plaquette of a row, acting where colors (N·N int8) says the plaquette is of
// `color`.  The same proposal, ΔS and rounding as plaquette_pass.
template <bool kVortex, typename V>
__global__ void __launch_bounds__(kLanes * kRows) plaquette_pass_table(
    V* __restrict__ vp, int* __restrict__ tp, float* __restrict__ u, int* __restrict__ accepted,
    const int8_t* __restrict__ colors, int N, int color, uint32_t pass, uint2 key, uint32_t chain0,
    float inv2k, float inv_w, float interval_v, int interval_t) {
    using F = std::conditional_t<kVortex, V, int>;
    const int t = blockIdx.x * kRows + threadIdx.y, chain = blockIdx.y;
    int count = 0;
    if (t < N) {
        const int NN = N * N, tn = t + 1 == N ? 0 : t + 1;
        float* u0 = u + chain * 2 * NN;
        float* u1 = u0 + NN;
        F* fc;
        if constexpr (kVortex) {
            fc = vp + chain * NN;
        } else {
            fc = tp + chain * NN;
        }
        for (int x = threadIdx.x; x < N; x += kLanes) {
            const int s = t * N + x;
            if (colors[s] != color) continue;
            // The plaquette's links ℓ0[t,x], ℓ0[t,x+1], ℓ1[t,x], ℓ1[t+1,x].
            const int ib = t * N + (x + 1 == N ? 0 : x + 1), id = tn * N + x;
            const float ua = u0[s], ub = u0[ib], uc = u1[s], ud = u1[id];
            const uint4 w =
                philox4x32_10(make_uint4((uint32_t)s, chain0 + (uint32_t)chain, pass, 0u), key);
            F change;
            float du;
            if constexpr (!kVortex) {
                change = draw_nonzero(w.x, interval_t);
                du = (float)change;
            } else if constexpr (std::is_same<V, float>::value) {
                change = (2.f * u24(w.x) - 1.f) * interval_v;
                du = -__fmul_rn(change, inv_w);
            } else {
                change = draw_nonzero(w.x, (int)interval_v);
                du = -__fmul_rn((float)change, inv_w);
            }
            const float dS = __fadd_rn(
                __fadd_rn(link_term(inv2k, uc, -du), link_term(inv2k, ud, du)),
                __fadd_rn(link_term(inv2k, ua, du), link_term(inv2k, ub, -du)));
            if (metropolis(u24(w.y), dS)) {
                u0[s] = __fadd_rn(ua, du);
                u0[ib] = __fadd_rn(ub, -du);
                u1[s] = __fadd_rn(uc, -du);
                u1[id] = __fadd_rn(ud, du);
                fc[s] = fc[s] + change;
                ++count;
            }
        }
    }
    count_block(accepted + chain, count);
}

// The wrapping pass.  Blocks below `row_blocks` take 8 row cycles (μ = 1, Δm
// on m_1 along row t = k, one warp each); the others take 32 column cycles
// (μ = 0, Δm on m_0 along column x = k, one lane of each warp per column).
// An accepted shift changes u along the cycle and adds to shifts[chain][μ·N + k]
// (m follows at the end of the call); each cycle adds Σu² after its decision
// to squares[chain][μ·N + k].  kPublic: u in the public layout (odd N).
template <bool kPublic>
__global__ void __launch_bounds__(kLanes * kRows) wrapping_pass(
    float* __restrict__ u, int* __restrict__ shifts, int* __restrict__ accepted,
    double* __restrict__ squares, int N, int row_blocks, uint32_t pass0, uint2 key, uint32_t chain0,
    float inv2k, int interval_w) {
    const int chain = blockIdx.y, lane = threadIdx.x, warp = threadIdx.y;
    const int NN = N * N, hN = N / 2;
    float* uc = u + chain * 2 * NN;
    int* shift = shifts + chain * 2 * N;
    double* sq = squares + chain * 2 * N;
    int count = 0;
    if ((int)blockIdx.x < row_blocks) {
        const int t = blockIdx.x * kRows + warp;
        if (t < N) {
            const uint4 w = philox4x32_10(
                make_uint4((uint32_t)t, chain0 + (uint32_t)chain, pass0 + 1u, 0u), key);
            const int c = draw_nonzero(w.x, interval_w);
            const float cf = (float)c;
            double dS = 0.0, s = 0.0;
            bool accept;
            if constexpr (kPublic) {
                // Row t of ℓ1: N consecutive entries of u_1.
                float* row = uc + NN + t * N;
                for (int x = lane; x < N; x += kLanes) dS += (double)link_term(inv2k, row[x], cf);
                accept = metropolis(u24(w.y), (float)warp_total(dS));
                for (int x = lane; x < N; x += kLanes) {
                    float a = row[x];
                    if (accept) {
                        a = __fadd_rn(a, cf);
                        row[x] = a;
                    }
                    s += (double)a * a;
                }
            } else {
                // Row t of ℓ1 is row t of both color planes of u_1.
                float* row0 = uc + NN + t * hN;
                float* row1 = row0 + NN / 2;
                for (int j = lane; j < hN; j += kLanes) {
                    dS += (double)link_term(inv2k, row0[j], cf);
                    dS += (double)link_term(inv2k, row1[j], cf);
                }
                accept = metropolis(u24(w.y), (float)warp_total(dS));
                for (int j = lane; j < hN; j += kLanes) {
                    float a = row0[j], b = row1[j];
                    if (accept) {
                        a = __fadd_rn(a, cf);
                        b = __fadd_rn(b, cf);
                        row0[j] = a;
                        row1[j] = b;
                    }
                    s += (double)a * a + (double)b * b;
                }
            }
            s = warp_total(s);
            if (lane == 0) {
                sq[N + t] += s;
                if (accept) shift[N + t] += c;
                count = accept;
            }
        }
    } else {
        __shared__ double part[kRows][kLanes];
        const int x = ((int)blockIdx.x - row_blocks) * kLanes + lane;
        const bool active = x < N;
        int c = 0;
        float cf = 0.f, u01 = 0.f;
        if (active) {
            const uint4 w =
                philox4x32_10(make_uint4((uint32_t)x, chain0 + (uint32_t)chain, pass0, 0u), key);
            c = draw_nonzero(w.x, interval_w);
            cf = (float)c;
            u01 = u24(w.y);
        }
        double dS = 0.0;
        if (active) {
            for (int t = warp; t < N; t += kRows) {
                dS += (double)link_term(inv2k, uc[field_index<kPublic>(t, x, N)], cf);
            }
        }
        part[warp][lane] = dS;
        __syncthreads();
        double total = 0.0;
        for (int r = 0; r < kRows; ++r) total += part[r][lane];
        const bool accept = active && metropolis(u01, (float)total);
        __syncthreads();
        double s = 0.0;
        if (active) {
            for (int t = warp; t < N; t += kRows) {
                const int q = field_index<kPublic>(t, x, N);
                float a = uc[q];
                if (accept) {
                    a = __fadd_rn(a, cf);
                    uc[q] = a;
                }
                s += (double)a * a;
            }
        }
        part[warp][lane] = s;
        __syncthreads();
        if (warp == 0 && active) {
            double all = 0.0;
            for (int r = 0; r < kRows; ++r) all += part[r][lane];
            sq[x] += all;
            if (accept) shift[x] += c;
            count = accept;
        }
    }
    count_block(accepted + chain, count);
}

// One warp per chain: sums[chain] = Σ over its 2N cycles of squares, in a fixed order.
__global__ void __launch_bounds__(kLanes) sum_squares(const double* __restrict__ squares,
                                                      double* __restrict__ sums, int N) {
    const double* sq = squares + blockIdx.x * 2 * N;
    double a = 0.0;
    for (int k = threadIdx.x; k < 2 * N; k += kLanes) a += sq[k];
    a = warp_total(a);
    if (threadIdx.x == 0) sums[blockIdx.x] = a;
}

template <typename V>
int worldline_sweeps(const int* m_in, const V* v_in, int* m, V* v, V* vp, int* tp, float* u,
                     int* shifts, double* squares, int* accepted, double* sums,
                     const int8_t* colors, int n_colors, int B, int N, int sweeps, float inv2k,
                     float inv_w, float interval_v, int interval_t, int interval_w,
                     unsigned long long seed, unsigned int chain0, void* stream_ptr) {
    if (colors == nullptr && (N % 2 != 0 || n_colors != 2)) return cudaErrorInvalidValue;
    cudaStream_t stream = (cudaStream_t)stream_ptr;
    cudaError_t e;
    if ((e = cudaMemsetAsync(accepted, 0, B * sizeof(int), stream))) return e;
    if ((e = cudaMemsetAsync(tp, 0, (size_t)B * N * N * sizeof(int), stream))) return e;
    if ((e = cudaMemsetAsync(shifts, 0, 2 * (size_t)B * N * sizeof(int), stream))) return e;
    if ((e = cudaMemsetAsync(squares, 0, 2 * (size_t)B * N * sizeof(double), stream))) return e;

    const dim3 block(kLanes, kRows);
    const int row_blocks = (N + kRows - 1) / kRows, column_blocks = (N + kLanes - 1) / kLanes;
    const dim3 rows(row_blocks, B), cycles(row_blocks + column_blocks, B);
    const bool table = colors != nullptr;
    if (table) {
        to_private<V, true><<<rows, block, 0, stream>>>(m_in, v_in, vp, u, N, inv_w);
    } else {
        to_private<V, false><<<rows, block, 0, stream>>>(m_in, v_in, vp, u, N, inv_w);
    }
    if ((e = cudaGetLastError())) return e;

    const uint2 key = sv::worldline_key(seed);
    const uint32_t per_sweep = 2u * (uint32_t)n_colors + 2u;
    for (int sweep = 0; sweep < sweeps; ++sweep) {
        const uint32_t pass0 = per_sweep * (uint32_t)sweep;
        for (int color = 0; color < n_colors; ++color) {
            if (table) {
                plaquette_pass_table<true, V><<<rows, block, 0, stream>>>(
                    vp, tp, u, accepted, colors, N, color, pass0 + color, key, chain0, inv2k,
                    inv_w, interval_v, interval_t);
            } else {
                plaquette_pass<true, V><<<rows, block, 0, stream>>>(
                    vp, tp, u, accepted, N, color, pass0 + color, key, chain0, inv2k, inv_w,
                    interval_v, interval_t);
            }
            if ((e = cudaGetLastError())) return e;
        }
        for (int color = 0; color < n_colors; ++color) {
            const uint32_t pass = pass0 + (uint32_t)(n_colors + color);
            if (table) {
                plaquette_pass_table<false, V><<<rows, block, 0, stream>>>(
                    vp, tp, u, accepted, colors, N, color, pass, key, chain0, inv2k, inv_w,
                    interval_v, interval_t);
            } else {
                plaquette_pass<false, V><<<rows, block, 0, stream>>>(
                    vp, tp, u, accepted, N, color, pass, key, chain0, inv2k, inv_w, interval_v,
                    interval_t);
            }
            if ((e = cudaGetLastError())) return e;
        }
        const uint32_t wrap0 = pass0 + 2u * (uint32_t)n_colors;
        if (table) {
            wrapping_pass<true><<<cycles, block, 0, stream>>>(u, shifts, accepted, squares, N,
                                                              row_blocks, wrap0, key, chain0,
                                                              inv2k, interval_w);
        } else {
            wrapping_pass<false><<<cycles, block, 0, stream>>>(u, shifts, accepted, squares, N,
                                                               row_blocks, wrap0, key, chain0,
                                                               inv2k, interval_w);
        }
        if ((e = cudaGetLastError())) return e;
    }
    if (table) {
        to_public<V, true><<<rows, block, 0, stream>>>(m_in, vp, tp, shifts, m, v, N);
    } else {
        to_public<V, false><<<rows, block, 0, stream>>>(m_in, vp, tp, shifts, m, v, N);
    }
    if ((e = cudaGetLastError())) return e;
    sum_squares<<<B, kLanes, 0, stream>>>(squares, sums, N);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// Runs `sweeps` worldline sweeps from (m_in, v_in) and writes the result to
// (m, v).  accepted (B,) int32 receives the accepted proposals; sums (B,)
// double receives Σ_sweeps Σ u² after each sweep.  Scratch: vp (B, 1, N, N)
// like v, tp (B, 1, N, N) int32 and u (B, 2, N, N) f32 in the call's layout,
// shifts (B, 2N) int32 and squares (B, 2N) double.  colors is null at even N
// (two colors, private layout), else the plaquettes' colors (N·N int8, values
// 0..n_colors-1; public layout).  v is int32 (finite W); the _winf entry takes
// float32 v (W = ∞).  B may be at most 65535 (the grid's y extent).  chain0 is
// the global index of the first chain, which the draws count from.
int sv_worldline_sweeps(const int* m_in, const int* v_in, int* m, int* v, int* vp, int* tp,
                        float* u, int* shifts, double* squares, int* accepted, double* sums,
                        const int8_t* colors, int n_colors, int B, int N, int sweeps, float inv2k,
                        float inv_w, float interval_v, int interval_t, int interval_w,
                        unsigned long long seed, unsigned int chain0, void* stream) {
    return worldline_sweeps<int>(m_in, v_in, m, v, vp, tp, u, shifts, squares, accepted, sums,
                                 colors, n_colors, B, N, sweeps, inv2k, inv_w, interval_v,
                                 interval_t, interval_w, seed, chain0, stream);
}

int sv_worldline_sweeps_winf(const int* m_in, const float* v_in, int* m, float* v, float* vp,
                             int* tp, float* u, int* shifts, double* squares, int* accepted,
                             double* sums, const int8_t* colors, int n_colors, int B, int N,
                             int sweeps, float inv2k, float inv_w, float interval_v,
                             int interval_t, int interval_w, unsigned long long seed,
                             unsigned int chain0, void* stream) {
    return worldline_sweeps<float>(m_in, v_in, m, v, vp, tp, u, shifts, squares, accepted, sums,
                                   colors, n_colors, B, N, sweeps, inv2k, inv_w, interval_v,
                                   interval_t, interval_w, seed, chain0, stream);
}

}  // extern "C"
