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
// What bounds it on the H100: dependent-load latency, as for the Villain worm
// (worm.cu).  A worm is a random walk: each move loads the crossed link's m
// and the two v values of its δv, at an address set by the previous move, and
// then adds to the histogram at the new head, so one chain waits about two
// device-memory round trips per move.  Worms at κ=0.5 run tens of thousands
// of moves, and a warp of 32 chains runs until its longest worm closes.
//
// Design: one thread per chain, running its `worms` worms in sequence; the
// thread owns its chain's m and histogram, so nothing is atomic.  The worm
// changes only m, never v, so the link residual is recomputed from m and v at
// each move (as the XLA ClassicWorm does) instead of being kept in a buffer:
// no scratch, and no f32 drift to undo.  Cap and rollback: an open worldline
// worm breaks δm = 0 at every W, so with a cap a worm still open after `cap`
// moves is always undone, at W = 1 too.  The thread logs the direction (2
// bits) of each accepted move in its chain's slice of `log` (cap/16 words)
// and on truncation replays the path from the tail, subtracting each Δm:
// exact on integers, O(moves).  Draws: Philox keyed by the seed's Worldline
// key, countered by (chain, worm, 0, 2) for a worm's start and (chain, worm,
// move, odd) for each move.
#include <cstdint>
#include <cuda_runtime.h>

#include "philox.cuh"
#include "worldline.cuh"

namespace {

using sv::link_residual;
using sv::link_term;
using sv::metropolis;
using sv::philox4x32_10;
using sv::u24;
using sv::wrap;

// Moves +e0, +e1, −e0, −e1 in (t, x); the crossed link's direction is choice & 1
// and it lies at the head for choice < 2, at the arrival site otherwise.
__constant__ int MOVE_T[4] = {1, 0, -1, 0};
__constant__ int MOVE_X[4] = {0, 1, 0, -1};
__constant__ int SGN[4] = {1, 1, -1, -1};

__device__ __forceinline__ int rand_site(uint32_t w, int N) {
    return (int)(((uint64_t)w * (uint32_t)N) >> 32);
}

template <typename V>
__global__ void worm_kernel(const V* __restrict__ v, int* __restrict__ m, float* __restrict__ hist,
                            float* __restrict__ stat, uint32_t* __restrict__ log,
                            long long log_words, int B, int N, float inv2k, float inv_w,
                            int worms, long long cap, uint2 key) {
    const int chain = blockIdx.x * blockDim.x + threadIdx.x;
    if (chain >= B) return;
    const long long NN = (long long)N * N;
    const V* vc = v + chain * NN;
    int* mc = m + chain * 2 * NN;
    float* h = hist + chain * NN;
    uint32_t* lg = cap >= 0 ? log + chain * log_words : nullptr;

    long long length = 0;
    int truncations = 0;
    for (int w = 0; w < worms; ++w) {
        const uint4 s = philox4x32_10(make_uint4((uint32_t)chain, (uint32_t)w, 0u, 2u), key);
        const int orientation = (s.x >> 31) ? 1 : -1;
        const int tail_t = rand_site(s.y, N), tail_x = rand_site(s.z, N);
        int head_t = tail_t, head_x = tail_x;

        bool done = false;
        long long moves = 0, accepted = 0;
        while (!done && (cap < 0 || moves < cap)) {
            const uint4 r = philox4x32_10(
                make_uint4((uint32_t)chain, (uint32_t)w, (uint32_t)moves,
                           2u * (uint32_t)(moves >> 32) + 1u), key);
            done = head_t == tail_t && head_x == tail_x && u24(r.x) < 0.2f;
            if (!done) {
                const int c = (int)(r.y & 3u);
                const int ax = c & 1;
                const int nt = wrap(head_t + MOVE_T[c], N), nx = wrap(head_x + MOVE_X[c], N);
                const int lt = c < 2 ? head_t : nt, lx = c < 2 ? head_x : nx;
                const int dm = orientation * SGN[c];
                const float dS = link_term(inv2k, link_residual(mc, vc, ax, lt, lx, N, inv_w),
                                           (float)dm);
                if (metropolis(u24(r.z), dS)) {
                    mc[ax * NN + lt * N + lx] += dm;
                    head_t = nt;
                    head_x = nx;
                    if (lg) {
                        const long long word = accepted >> 4;
                        const uint32_t bits = (uint32_t)c << (2 * (accepted & 15));
                        lg[word] = (accepted & 15) ? (lg[word] | bits) : bits;
                    }
                    ++accepted;
                }
                h[wrap(head_t - tail_t, N) * N + wrap(head_x - tail_x, N)] += 1.f;
                ++length;
            }
            ++moves;
        }
        if (!done) {
            // Capped and still open: replay the accepted path from the tail, undoing each Δm.
            int t = tail_t, x = tail_x;
            for (long long i = 0; i < accepted; ++i) {
                const int c = (int)((lg[i >> 4] >> (2 * (i & 15))) & 3u);
                const int nt = wrap(t + MOVE_T[c], N), nx = wrap(x + MOVE_X[c], N);
                const int lt = c < 2 ? t : nt, lx = c < 2 ? x : nx;
                mc[(c & 1) * NN + lt * N + lx] -= orientation * SGN[c];
                t = nt;
                x = nx;
            }
            ++truncations;
        }
    }
    stat[2 * chain] = (float)length;
    stat[2 * chain + 1] = (float)truncations;
}

template <typename V>
int worldline_worms(const int* m_in, const V* v, int* m, float* hist, float* stat, uint32_t* log,
                    long long log_words, int B, int N, float inv2k, float inv_w, int worms,
                    long long cap, unsigned long long seed, void* stream_ptr) {
    cudaStream_t stream = (cudaStream_t)stream_ptr;
    const size_t NN = (size_t)N * N;
    cudaError_t e;
    if ((e = cudaMemcpyAsync(m, m_in, 2 * B * NN * sizeof(int), cudaMemcpyDeviceToDevice, stream))) return e;
    if ((e = cudaMemsetAsync(hist, 0, B * NN * sizeof(float), stream))) return e;
    const int threads = 32;
    worm_kernel<V><<<(B + threads - 1) / threads, threads, 0, stream>>>(
        v, m, hist, stat, log, log_words, B, N, inv2k, inv_w, worms, cap, sv::worldline_key(seed));
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// Copies m_in into m, then runs `worms` worms per chain in place (v is read
// only).  hist (B, N, N) f32 receives the Spin_Spin tallies, stat (B, 2) f32
// the worm length and the truncation count.  cap < 0 means unbounded; with a
// cap, log holds log_words 32-bit words per chain (at least ceil(cap / 16)).
// v is int32 (finite W); the _winf entry takes float32 v (W = ∞).
int sv_worldline_worms(const int* m_in, const int* v, int* m, float* hist, float* stat,
                       uint32_t* log, long long log_words, int B, int N, float inv2k, float inv_w,
                       int worms, long long cap, unsigned long long seed, void* stream) {
    return worldline_worms<int>(m_in, v, m, hist, stat, log, log_words, B, N, inv2k, inv_w, worms,
                                cap, seed, stream);
}

int sv_worldline_worms_winf(const int* m_in, const float* v, int* m, float* hist, float* stat,
                            uint32_t* log, long long log_words, int B, int N, float inv2k,
                            float inv_w, int worms, long long cap, unsigned long long seed,
                            void* stream) {
    return worldline_worms<float>(m_in, v, m, hist, stat, log, log_words, B, N, inv2k, inv_w,
                                  worms, cap, seed, stream);
}

}  // extern "C"
