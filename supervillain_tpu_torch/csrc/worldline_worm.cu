// Worldline classic (site) worms on Hopper.
//
// Replaces supervillain_tpu/ops/pallas_worldline_hammer.py:worldline_worms
// (kernel body _make_worm_kernel, worm section _worm_section) and the worm
// section of worldline_hammer_sweeps.  Same move rule as
// generators/worldline.py:ClassicWorm: the worm starts closed (head = tail)
// at a random site with a random orientation; the head moves to one of the 4
// neighbouring sites (+e0, +e1, −e0, −e1); a forward move crosses the link at
// the head, a backward move the link at the arrival site, and the crossed link
// changes by Δm = orientation·(+1, +1, −1, −1)[choice]; Metropolis on
// ΔS = (1/2κ)Δm(2u + Δm) with u = m − δv/_W; when head == tail a move closes
// the worm with probability 1/(2D+1) = 0.2; every other move, accepted or
// not, tallies (head − tail) mod N into the chain's Spin_Spin histogram.
//
// What bounds it on the H100: the latency of one move, times the moves of the
// longest worm.  A worm is a serial random walk, so a call lasts as long as
// its longest worm (over a million moves at L=256, κ=0.5), and each move
// waits for the crossed link's m and δv, at an address set by the previous
// moves.  The bytes the call must move are no bound at all.
//
// Design: one warp per chain, one block per warp, so 512 chains spread over
// all 132 SMs, with L1 given the SM's whole 256 KB.  A call first packs each
// chain's links site by site, (m, δv/_W) in 8 bytes, link (ax, s) at
// [2s + ax] (δv/_W is the value the residual's rounding uses, and the worm
// never changes it): one load per link, and no δv/_W to compute per
// candidate (loading m and both v makes a move at N = 256 7% slower; PERF.md
// §6).  The walk is one serial chain of decisions, and the lanes take
// everything else off it:
// - Philox: every 32 moves each lane draws one of the next 32 moves (same
//   counters as before), and the walk takes them by __shfl_sync.
// - Loads: a move's direction is known from its draw, so while move k
//   resolves, lane i loads the link of move k + 3 from the head the walk
//   reaches if moves k, k + 1, k + 2 are accepted as lane i's bits 0, 1, 2
//   say (8 heads), and two moves later decides on it whether move k + 3
//   would be accepted (residual, ΔS, expf).  Move k + 3 then costs the walk
//   three shuffles from the lane its accepts name.  Those loads were issued
//   before the stores of moves k .. k + 2, so when move k + 3 recrosses a
//   link one of them changed (a backtrack) the walk adds their Δm and decides
//   again itself.
// - Nothing else waits: the Spin_Spin tallies go out 32 at a time, one
//   reduction (atomicAdd whose result is unused) per lane; the undo log's
//   2-bit word is kept in a register and stored once per 16 accepted moves;
//   the draws and candidates sit in 4 rotating register slots (the loop is
//   unrolled by 4), since copying a value in flight would wait for it; the
//   step is free of branches but the rare ones, and a power-of-two N wraps
//   by a mask (each move wraps 6 coordinates; the general wrap makes a move
//   at N = 256 a third slower).
// The packed m goes back to the public layout at the end of the call.
//
// Cap and rollback: an open worldline worm breaks δm = 0 at every W, so with a
// cap a worm still open after `cap` moves is always undone, at W = 1 too.  The
// log holds the direction of each accepted move (cap/16 words per chain); on
// truncation the pending word is flushed and one lane replays the path from
// the tail, subtracting each Δm: exact on integers, O(moves).  Draws: Philox
// keyed by the seed's Worldline key, countered by (chain, worm, 0, 2) for a
// worm's start and (chain, worm, move, odd) for each move, the chain word
// being chain0 + the chain's index in the call (chain0: the global index of
// the call's first chain).
//
// Next step (not taken): a chain resident in shared memory, which would cut a
// move to shared-memory latency.  It needs an exact compact encoding of the
// chain, and m and δv drift without bound along a zero-action gauge direction
// (only W·u = W·m − δv is bounded), so neither fits a narrow type as it is.
#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

#include "philox.cuh"
#include "worldline.cuh"

namespace {

using sv::dual_part;
using sv::link_term;
using sv::metropolis;
using sv::philox4x32_10;
using sv::residual;
using sv::u24;
using sv::wrap;

constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ int rand_site(uint32_t w, int N) {
    return (int)(((uint64_t)w * (uint32_t)N) >> 32);
}

// a in [−2N, 3N) into [0, N): a mask when N is a power of two.
template <bool kPow2>
__device__ __forceinline__ int wrap_to(int a, int N) {
    return kPow2 ? (a & (N - 1)) : wrap(wrap(a, N), N);
}

// The packed links of one chain: link (ax, site s) at [2s + ax], holding m
// and the float bits of its δv/_W, which the worm never changes.
template <typename V>
__global__ void __launch_bounds__(256) pack_links(const int* __restrict__ m,
                                                  const V* __restrict__ v,
                                                  int2* __restrict__ packed, int total, int N,
                                                  float inv_w) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;  // (chain, site)
    if (i >= total) return;
    const int NN = N * N, chain = i / NN, s = i - chain * NN, t = s / N, x = s - t * N;
    const V* vc = v + chain * NN;
    const V here = vc[s];
    const V left = vc[t * N + (x == 0 ? N - 1 : x - 1)];
    const V below = vc[(t == 0 ? N - 1 : t - 1) * N + x];
    packed[2 * i] = make_int2(m[(2 * chain) * NN + s], __float_as_int(dual_part(here, left, 0, inv_w)));
    packed[2 * i + 1] = make_int2(m[(2 * chain + 1) * NN + s],
                                  __float_as_int(dual_part(here, below, 1, inv_w)));
}

// The packed links back into the public m (B, 2, N, N).
__global__ void __launch_bounds__(256) unpack_m(const int2* __restrict__ packed,
                                                int* __restrict__ m, int total, int NN) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;  // (chain, site)
    if (i >= total) return;
    const int chain = i / NN, s = i - chain * NN;
    m[(2 * chain) * NN + s] = packed[2 * i].x;
    m[(2 * chain + 1) * NN + s] = packed[2 * i + 1].x;
}

// One lane's candidate for a move: the link the move crosses from one of the
// heads the walk may have reached, as loaded (its index in the chain's packed
// links, m, δv/_W), and whether the move would be accepted on that m.
struct Candidate {
    int link, m;
    float dvw;
    int accept;
};

// A move's draws as the walk uses them: choice c and close bit (code), the
// Metropolis uniform, the head's step and the offset from the head to the
// crossed link's site (the step for c ≥ 2, else 0), in (t, x).
struct Move {
    int code;
    float u;
    int st, sx, ot, ox;
};

__device__ __forceinline__ Move make_move(int code, float u) {
    const int c = code & 3;
    const int st = (c & 1) ? 0 : 1 - c, sx = (c & 1) ? 2 - c : 0;
    return {code, u, st, sx, c >= 2 ? st : 0, c >= 2 ? sx : 0};
}

// This lane's draw of move `move` of worm w: the choice in bits 0-1 and the
// close decision (u < 1/(2D+1)) in bit 2, and the Metropolis uniform.
__device__ __forceinline__ void draw_move(uint32_t chain, int w, long long move, uint2 key,
                                          int& code, float& u) {
    const uint4 r = philox4x32_10(make_uint4(chain, (uint32_t)w, (uint32_t)move,
                                             2u * (uint32_t)(move >> 32) + 1u), key);
    code = (int)(r.y & 3u) | (u24(r.x) < 0.2f ? 4 : 0);
    u = u24(r.z);
}

// Δm of a move of choice c.
__device__ __forceinline__ int delta_m(int c, int orientation) { return c < 2 ? orientation : -orientation; }

// Whether move `mv` would be accepted on a candidate's m.
__device__ __forceinline__ int accepts(const Candidate& a, const Move& mv, int orientation,
                                       float inv2k) {
    return metropolis(mv.u, link_term(inv2k, residual(a.m, a.dvw),
                                      (float)delta_m(mv.code & 3, orientation)));
}

template <bool kPow2>
__global__ void __launch_bounds__(32) worm_kernel(int2* __restrict__ packed, float* __restrict__ hist,
                                                  float* __restrict__ stat, uint32_t* __restrict__ log,
                                                  long long log_words, int N, float inv2k, int worms,
                                                  long long cap, uint2 key, uint32_t chain0) {
    const int chain = blockIdx.x, lane = threadIdx.x;
    const uint32_t global = chain0 + (uint32_t)chain;  // the chain's word of every counter
    const int NN = N * N;
    int2* P = packed + chain * 2 * NN;
    float* h = hist + chain * NN;
    uint32_t* lg = cap >= 0 ? log + chain * log_words : nullptr;
    // The lane's bits 0, 1, 2 as masks: which of three moves its candidate assumes accepted.
    const int bit0 = -(lane & 1), bit1 = -((lane >> 1) & 1), bit2 = -((lane >> 2) & 1);

    // Loads the link that move `mv` crosses from head (t, x), t and x not yet wrapped.
    auto fetch = [&](int t, int x, const Move& mv) {
        const int link = 2 * (wrap_to<kPow2>(t + mv.ot, N) * N + wrap_to<kPow2>(x + mv.ox, N)) +
                         (mv.code & 1);
        const int2 e = P[link];
        return Candidate{link, e.x, __int_as_float(e.y), 0};
    };

    long long length = 0;
    int truncations = 0;
    for (int w = 0; w < worms; ++w) {
        const uint4 s = philox4x32_10(make_uint4(global, (uint32_t)w, 0u, 2u), key);
        const int orientation = (s.x >> 31) ? 1 : -1;
        const int tail_t = rand_site(s.y, N), tail_x = rand_site(s.z, N);
        int head_t = tail_t, head_x = tail_x;

        // The draws of moves k .. k + 3 and the candidates of moves k .. k + 3
        // sit in rotating slots [(k + i) & 3], filled from this lane's draw in
        // the current batch of 32 moves and from loads issued three moves
        // ahead.  A value in flight is never copied (the copy would wait for
        // it), so the loop is unrolled by the 4 slots.
        Move mv[4];
        Candidate cand[4];
        int mine;
        float mine_u;
        draw_move(global, w, lane, key, mine, mine_u);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            mv[i] = make_move(__shfl_sync(kAll, mine, i), __shfl_sync(kAll, mine_u, i));
        }
        // Moves before the first count as refused: the lanes whose bits stand
        // for them are never read.
        cand[0] = fetch(head_t, head_x, mv[0]);
        cand[1] = fetch(head_t + (mv[0].st & bit2), head_x + (mv[0].sx & bit2), mv[1]);
        cand[2] = fetch(head_t + (mv[0].st & bit1) + (mv[1].st & bit2),
                        head_x + (mv[0].sx & bit1) + (mv[1].sx & bit2), mv[2]);
        cand[0].accept = accepts(cand[0], mv[0], orientation, inv2k);
        // Whether moves k − 3, k − 2 and k − 1 were accepted (bits 0, 1, 2: the
        // lane of move k's candidate), and the links those moves changed (−1
        // for none) with their Δm: a candidate's load was issued before those
        // moves' stores.
        int recent = 0;
        int link1 = -1, dm1 = 0, link2 = -1, dm2 = 0, link3 = -1, dm3 = 0;
        int pending = -1;  // this lane's Spin_Spin tally of its slot in the batch

        bool done = false;
        long long k = 0;
        unsigned accepted = 0;  // moves; a capped worm has fewer than 2^31
        uint32_t word = 0;
        // Move k, in slot J = k & 3; false once the worm has closed or hit the cap.
        auto step = [&](auto slot) {
            constexpr int J = decltype(slot)::value, J1 = (J + 1) & 3, J2 = (J + 2) & 3,
                          J3 = (J + 3) & 3;
            if (done || (cap >= 0 && k >= cap)) return false;
            const Move& m0 = mv[J];
            const int c = m0.code & 3, dm = delta_m(c, orientation);
            // Move k: its candidate as loaded, and the accept decided on it.
            const int link = __shfl_sync(kAll, cand[J].link, recent);
            int mk = __shfl_sync(kAll, cand[J].m, recent);
            int accept = __shfl_sync(kAll, cand[J].accept, recent);
            // Move k + 3's candidates from the 8 heads moves k .. k + 2 may
            // leave, and whether move k + 1 would be accepted on its candidates.
            cand[J3] = fetch(head_t + (m0.st & bit0) + (mv[J1].st & bit1) + (mv[J2].st & bit2),
                             head_x + (m0.sx & bit0) + (mv[J1].sx & bit1) + (mv[J2].sx & bit2),
                             mv[J3]);
            cand[J1].accept = accepts(cand[J1], mv[J1], orientation, inv2k);

            done = head_t == tail_t && head_x == tail_x && (m0.code & 4);
            // Correct the candidate for the moves since its load (a backtrack).
            const int fix = (link == link1 ? dm1 : 0) + (link == link2 ? dm2 : 0) +
                            (link == link3 ? dm3 : 0);
            if (fix) {
                mk += fix;
                const float dvw = __shfl_sync(kAll, cand[J].dvw, recent);
                accept = metropolis(m0.u, link_term(inv2k, residual(mk, dvw), (float)dm));
            }
            const bool take = !done && accept;
            if (take) P[link].x = mk + dm;
            link3 = link2;
            dm3 = dm2;
            link2 = link1;
            dm2 = dm1;
            link1 = take ? link : -1;
            dm1 = dm;
            recent = (recent >> 1) | (take ? 4 : 0);
            const int nt = wrap_to<kPow2>(head_t + m0.st, N), nx = wrap_to<kPow2>(head_x + m0.sx, N);
            head_t = take ? nt : head_t;
            head_x = take ? nx : head_x;
            word |= take ? (uint32_t)c << (2 * (accepted & 15)) : 0u;
            if (take && (accepted & 15) == 15) {
                if (lg) lg[accepted >> 4] = word;
                word = 0;
            }
            accepted += take;
            // The tallies go to the histogram 32 moves at a time, one per lane.
            const int tally = wrap_to<kPow2>(head_t - tail_t, N) * N + wrap_to<kPow2>(head_x - tail_x, N);
            pending = lane == (int)(k & 31) ? (done ? -1 : tally) : pending;
            if ((k & 31) == 31) {
                if (pending >= 0) atomicAdd(h + pending, 1.f);
                pending = -1;
            }
            ++k;
            // Move k + 3's draws into the slot move k − 1 left; a new batch
            // starts every 32 moves.
            if (((k + 3) & 31) == 0) draw_move(global, w, k + 3 + lane, key, mine, mine_u);
            mv[J] = make_move(__shfl_sync(kAll, mine, (int)((k + 3) & 31)),
                              __shfl_sync(kAll, mine_u, (int)((k + 3) & 31)));
            return true;
        };
        while (step(std::integral_constant<int, 0>{}) && step(std::integral_constant<int, 1>{}) &&
               step(std::integral_constant<int, 2>{}) && step(std::integral_constant<int, 3>{})) {
        }
        if (pending >= 0) atomicAdd(h + pending, 1.f);
        length += k - done;  // every move but a closing one is tallied
        if (!done) {
            // Capped and still open: flush the pending log word, then replay the
            // accepted path from the tail, undoing each Δm.
            if (accepted & 15) lg[accepted >> 4] = word;
            __syncwarp();
            if (lane == 0) {
                int t = tail_t, x = tail_x;
                for (unsigned i = 0; i < accepted; ++i) {
                    const Move back = make_move((int)((lg[i >> 4] >> (2 * (i & 15))) & 3u), 0.f);
                    const int link = 2 * (wrap_to<kPow2>(t + back.ot, N) * N +
                                          wrap_to<kPow2>(x + back.ox, N)) + (back.code & 1);
                    P[link].x -= delta_m(back.code, orientation);
                    t = wrap_to<kPow2>(t + back.st, N);
                    x = wrap_to<kPow2>(x + back.sx, N);
                }
            }
            __syncwarp();
            ++truncations;
        }
    }
    if (lane == 0) {
        stat[2 * chain] = (float)length;
        stat[2 * chain + 1] = (float)truncations;
    }
}

template <typename V>
int worldline_worms(const int* m_in, const V* v, int* m, int2* packed, float* hist, float* stat,
                    uint32_t* log, long long log_words, int B, int N, float inv2k, float inv_w,
                    int worms, long long cap, unsigned long long seed, unsigned int chain0,
                    void* stream_ptr) {
    cudaStream_t stream = (cudaStream_t)stream_ptr;
    const int NN = N * N, total = B * NN, threads = 256;
    const int blocks = (total + threads - 1) / threads;
    cudaError_t e;
    if ((e = cudaMemsetAsync(hist, 0, (size_t)total * sizeof(float), stream))) return e;
    pack_links<V><<<blocks, threads, 0, stream>>>(m_in, v, packed, total, N, inv_w);
    if ((e = cudaGetLastError())) return e;
    const auto kernel = (N & (N - 1)) == 0 ? worm_kernel<true> : worm_kernel<false>;
    if ((e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                  cudaSharedmemCarveoutMaxL1))) return e;
    kernel<<<B, 32, 0, stream>>>(packed, hist, stat, log, log_words, N, inv2k, worms, cap,
                                 sv::worldline_key(seed), chain0);
    if ((e = cudaGetLastError())) return e;
    unpack_m<<<blocks, threads, 0, stream>>>(packed, m, total, NN);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// Runs `worms` worms per chain from m_in (v is read only) and writes the
// result to m.  hist (B, N, N) f32 receives the Spin_Spin tallies, stat (B, 2)
// f32 the worm length and the truncation count.  packed (B, N, N, 2) int2 is
// scratch.  cap < 0 means unbounded; with a cap, log holds log_words 32-bit
// words per chain (at least ceil(cap / 16)).  v is int32 (finite W); the
// _winf entry takes float32 v (W = ∞).  chain0 is the global index of the
// first chain, which the draws count from.
int sv_worldline_worms(const int* m_in, const int* v, int* m, int2* packed, float* hist,
                       float* stat, uint32_t* log, long long log_words, int B, int N, float inv2k,
                       float inv_w, int worms, long long cap, unsigned long long seed,
                       unsigned int chain0, void* stream) {
    return worldline_worms<int>(m_in, v, m, packed, hist, stat, log, log_words, B, N, inv2k, inv_w,
                                worms, cap, seed, chain0, stream);
}

int sv_worldline_worms_winf(const int* m_in, const float* v, int* m, int2* packed, float* hist,
                            float* stat, uint32_t* log, long long log_words, int B, int N,
                            float inv2k, float inv_w, int worms, long long cap,
                            unsigned long long seed, unsigned int chain0, void* stream) {
    return worldline_worms<float>(m_in, v, m, packed, hist, stat, log, log_words, B, N, inv2k,
                                  inv_w, worms, cap, seed, chain0, stream);
}

}  // extern "C"
