// Villain classic (plaquette) worms on Hopper.
//
// Replaces supervillain_tpu/ops/pallas_worm.py:classic_worms (kernel body
// _make_worm_kernel) and the worm section of ops/pallas_hammer.py.  Same
// move semantics as generators/villain.py:ClassicWorm: the head moves to one
// of the 4 neighboring plaquettes (east, north, west, south), Metropolis on
// ΔS = (κ/2)(−2πΔn)(2r − 2πΔn) of the crossed link; when closed (head ==
// tail, or always at W = 1) a move closes the worm with probability 0.2; every
// non-close move tallies head − tail into the chain's Vortex_Vortex histogram.
//
// What bounds it on the H100: dependent-load latency.  A worm is a random
// walk; each move's link and site addresses depend on the previous move's
// outcome, so one chain makes one round of loads (φ at the two ends of the
// link and the link's n, in parallel) per move and waits one device-memory
// round trip for it.  Throughput comes only from running many chains at once.
//
// Design: one thread per chain, running its `worms` worms in sequence.  The
// thread owns its chain's n and histogram, so nothing is atomic.  The link
// residual is recomputed from φ and n at each move instead of being kept in a
// residual array, which keeps the worm independent of the sweep's scratch and
// matches the XLA ClassicWorm.  Lanes of a warp wait for the longest worm of
// the warp (per-warp "max, not mean"); blocks of 32 threads spread the warps
// over the SMs.  Whether a warp per chain does better is later work.
//
// The same file holds K1, the ChunkedWorm's kernel (chunked_worm_kernel below).
//
// Cap and rollback: with a move cap at W != 1 a worm still open at the cap
// leaves dn ≢ 0 (mod W) and is undone.  Instead of the TPU's O(N²) snapshot
// of (n, r) before every worm, the thread logs the direction (2 bits) of each
// accepted move in its chain's slice of `log` (cap/16 words), and on
// truncation replays the path from the start plaquette, subtracting each Δn:
// exact (integers), O(moves) work, bounded memory.  At W = 1 an open worm is a
// valid configuration and is kept (no log is needed).
#include <cstdint>
#include <cuda_runtime.h>

#include "philox.cuh"

namespace {

using sv::philox4x32_10;
using sv::u24;
using sv::exp_neg;
using sv::TWO_PI;

// Moves (east, north, west, south) in (t, x), the crossed link's direction and
// offset from the head, and the constraint-restoring Δn sign — the tables of
// generators/villain.py:ClassicWorm.
__constant__ int MOVE_T[4] = {0, 1, 0, -1};
__constant__ int MOVE_X[4] = {-1, 0, 1, 0};
__constant__ int LINK_DIR[4] = {0, 1, 0, 1};
__constant__ int OFF_T[4] = {0, 1, 0, 0};
__constant__ int OFF_X[4] = {0, 0, 1, 0};
__constant__ int PLAQ[4] = {1, 1, -1, -1};

__device__ __forceinline__ int wrap(int a, int N) { return a < 0 ? a + N : (a >= N ? a - N : a); }

// Uniform site index in [0, N) from a 32-bit word.
__device__ __forceinline__ int rand_site(uint32_t w, int N) {
    return (int)(((uint64_t)w * (uint32_t)N) >> 32);
}

__global__ void worm_kernel(const float* __restrict__ phi, int* __restrict__ n,
                            float* __restrict__ hist, float* __restrict__ stat,
                            uint32_t* __restrict__ log, long long log_words, int B, int N,
                            float kappa, int closed_always, int worms, long long cap, int rollback,
                            uint2 key, uint32_t chain0) {
    const int chain = blockIdx.x * blockDim.x + threadIdx.x;
    if (chain >= B) return;
    const long long NN = (long long)N * N;
    const float* ph = phi + chain * NN;
    int* nc = n + chain * 2 * NN;
    float* h = hist + chain * NN;
    uint32_t* lg = rollback ? log + chain * log_words : nullptr;
    const uint32_t global = chain0 + (uint32_t)chain;  // the chain's word of every counter

    float length = 0.f;
    int truncations = 0;
    for (int w = 0; w < worms; ++w) {
        // Counters: (chain, worm, k, even) for the start, (chain, worm, move, odd) per move.
        const uint4 s0 = philox4x32_10(make_uint4(global, (uint32_t)w, 0u, 0u), key);
        const int orientation = (s0.x >> 31) ? 1 : -1;
        const int tail_t = rand_site(s0.y, N), tail_x = rand_site(s0.z, N);
        int head_t = tail_t, head_x = tail_x;
        if (closed_always) {
            const uint4 s1 = philox4x32_10(make_uint4(global, (uint32_t)w, 1u, 0u), key);
            head_t = rand_site(s1.x, N);
            head_x = rand_site(s1.y, N);
        }
        const int start_t = head_t, start_x = head_x;

        bool done = false;
        long long moves = 0, accepted = 0;
        while (!done && (cap < 0 || moves < cap)) {
            const uint4 m = philox4x32_10(
                make_uint4(global, (uint32_t)w, (uint32_t)moves,
                           2u * (uint32_t)(moves >> 32) + 1u), key);
            const bool closed = closed_always || (head_t == tail_t && head_x == tail_x);
            done = closed && u24(m.x) >= 0.8f;
            if (!done) {
                const int c = (int)(m.y & 3u);
                const int ld = LINK_DIR[c];
                const int lt = wrap(head_t + OFF_T[c], N), lx = wrap(head_x + OFF_X[c], N);
                const int ls = lt * N + lx;
                const int nb = ld == 0 ? wrap(lt + 1, N) * N + lx : lt * N + wrap(lx + 1, N);
                int* link = nc + ld * NN + ls;
                const int dn = orientation * PLAQ[c];
                const float link_val = (ph[nb] - ph[ls]) - TWO_PI * (float)(*link);
                const float cr = -TWO_PI * (float)dn;
                const float dS = 0.5f * kappa * cr * (2.f * link_val + cr);
                if (u24(m.z) < exp_neg(dS)) {
                    *link += dn;
                    head_t = wrap(head_t + MOVE_T[c], N);
                    head_x = wrap(head_x + MOVE_X[c], N);
                    if (rollback) {
                        const long long word = accepted >> 4;
                        const uint32_t bits = (uint32_t)c << (2 * (accepted & 15));
                        lg[word] = (accepted & 15) ? (lg[word] | bits) : bits;
                    }
                    ++accepted;
                }
                h[wrap(head_t - tail_t, N) * N + wrap(head_x - tail_x, N)] += 1.f;
                length += 1.f;
            }
            ++moves;
        }
        if (!done && rollback) {
            // Replay the accepted path from the start plaquette, undoing each Δn.
            int t = start_t, x = start_x;
            for (long long i = 0; i < accepted; ++i) {
                const int c = (int)((lg[i >> 4] >> (2 * (i & 15))) & 3u);
                const int lt = wrap(t + OFF_T[c], N), lx = wrap(x + OFF_X[c], N);
                nc[LINK_DIR[c] * NN + lt * N + lx] -= orientation * PLAQ[c];
                t = wrap(t + MOVE_T[c], N);
                x = wrap(x + MOVE_X[c], N);
            }
            ++truncations;
        }
    }
    stat[2 * chain] = length;
    stat[2 * chain + 1] = (float)truncations;
}

// K1: the Villain ChunkedWorm (D=2, W=1).  Replaces no Pallas kernel: it puts
// on the card the lax.fori_loop of supervillain_tpu/generators/villain.py
// ChunkedWorm.step, which the port otherwise runs as about 15 PyTorch
// launches a micro-move.  Each chain makes exactly `moves` micro-moves from
// its carried worm (head, tail, orientation): a close with probability 0.2
// (W=1: always closed) restarts a fresh worm at once with a new tail, head and
// orientation; any other move is B2's Metropolis move and tallies head − tail.
// At W=1 an open worm is a valid configuration, so nothing is rolled back.
//
// What bounds it: the bytes of the call (the copy of n and the zeroed
// histogram) at the main path's shape; below them, `moves` dependent rounds of
// loads, one device-memory round trip each.  Design: B2's, one thread per
// chain owning its chain's n and histogram (nothing atomic), the link residual
// recomputed from φ and n at each move; the next move's draw is evaluated
// while this move's loads are in flight (it does not depend on them).
//
// Draws: Philox keyed by the seed XOR CHUNKED_SALT (ops/philox.py), countered
// by (chain0 + chain, move, 0, 0) for the close uniform, the choice, the
// Metropolis uniform and the restart's orientation (top bit of the fourth
// word), and (chain0 + chain, move, 1, 0) for the restart's tail and head, so
// the stream does not depend on how the chains are laid out.
constexpr unsigned long long CHUNKED_SALT = 0x13198A2E03707344ull;

__global__ void chunked_worm_kernel(const float* __restrict__ phi, int* __restrict__ n,
                                    const int* __restrict__ worm_in, int* __restrict__ worm_out,
                                    float* __restrict__ hist, float* __restrict__ stat, int B,
                                    int N, float half_kappa, int moves, uint2 key,
                                    uint32_t chain0) {
    const int chain = blockIdx.x * blockDim.x + threadIdx.x;
    if (chain >= B) return;
    const long long NN = (long long)N * N;
    const float* ph = phi + chain * NN;
    int* nc = n + chain * 2 * NN;
    float* h = hist + chain * NN;
    const uint32_t global = chain0 + (uint32_t)chain;
    const int* ws = worm_in + 5 * chain;
    int head_t = ws[0], head_x = ws[1], tail_t = ws[2], tail_x = ws[3], orientation = ws[4];

    int closes = 0;
    uint4 m = philox4x32_10(make_uint4(global, 0u, 0u, 0u), key);
    for (int t = 0; t < moves; ++t) {
        const uint4 next = philox4x32_10(make_uint4(global, (uint32_t)t + 1u, 0u, 0u), key);
        if (u24(m.x) >= 0.8f) {
            // Close and restart: a fresh worm within the same chunk.
            const uint4 r = philox4x32_10(make_uint4(global, (uint32_t)t, 1u, 0u), key);
            tail_t = rand_site(r.x, N);
            tail_x = rand_site(r.y, N);
            head_t = rand_site(r.z, N);
            head_x = rand_site(r.w, N);
            orientation = (m.w >> 31) ? 1 : -1;
            ++closes;
        } else {
            const int c = (int)(m.y & 3u);
            const int ld = LINK_DIR[c];
            const int lt = wrap(head_t + OFF_T[c], N), lx = wrap(head_x + OFF_X[c], N);
            const int ls = lt * N + lx;
            const int nb = ld == 0 ? wrap(lt + 1, N) * N + lx : lt * N + wrap(lx + 1, N);
            int* link = nc + ld * NN + ls;
            const int dn = orientation * PLAQ[c];
            // The plain twin's order of float32 roundings (ops/worm.py
            // plain_chunked_worms), each explicit so that nothing contracts
            // into an FMA.
            const float link_val = __fsub_rn(__fsub_rn(ph[nb], ph[ls]),
                                             __fmul_rn(TWO_PI, (float)(*link)));
            const float cr = __fmul_rn(-TWO_PI, (float)dn);
            const float dS = __fmul_rn(__fmul_rn(half_kappa, cr), __fadd_rn(2.f * link_val, cr));
            if (u24(m.z) < expf(-dS)) {
                *link += dn;
                head_t = wrap(head_t + MOVE_T[c], N);
                head_x = wrap(head_x + MOVE_X[c], N);
            }
            h[wrap(head_t - tail_t, N) * N + wrap(head_x - tail_x, N)] += 1.f;
        }
        m = next;
    }
    int* wo = worm_out + 5 * chain;
    wo[0] = head_t;
    wo[1] = head_x;
    wo[2] = tail_t;
    wo[3] = tail_x;
    wo[4] = orientation;
    stat[2 * chain] = (float)(moves - closes);
    stat[2 * chain + 1] = (float)closes;
}

}  // namespace

extern "C" {

// Copies n_in into n, then runs `worms` worms per chain in place.  hist
// (B, N, N) f32 receives the Vortex_Vortex tallies, stat (B, 2) f32 the worm
// length and the truncation count.  cap < 0 means unbounded; with rollback,
// log holds log_words 32-bit words per chain (at least ceil(cap / 16)).
// chain0 is the global index of the first chain, which the draws count from.
int sv_worms(const float* phi, const int* n_in, int* n, float* hist, float* stat,
             uint32_t* log, long long log_words, int B, int N, float kappa, int closed_always,
             int worms, long long cap, int rollback, unsigned long long seed, unsigned int chain0,
             void* stream_ptr) {
    cudaStream_t stream = (cudaStream_t)stream_ptr;
    const size_t NN = (size_t)N * N;
    cudaError_t e;
    if ((e = cudaMemcpyAsync(n, n_in, 2 * B * NN * sizeof(int), cudaMemcpyDeviceToDevice, stream))) return e;
    if ((e = cudaMemsetAsync(hist, 0, B * NN * sizeof(float), stream))) return e;
    const uint2 key = make_uint2((uint32_t)seed, (uint32_t)(seed >> 32));
    const int threads = 32;
    worm_kernel<<<(B + threads - 1) / threads, threads, 0, stream>>>(
        phi, n, hist, stat, log, log_words, B, N, kappa, closed_always, worms, cap, rollback, key,
        chain0);
    return cudaGetLastError();
}

// K1: copies n_in into n and runs `moves` ChunkedWorm micro-moves per chain
// in place, from the carried worm state worm_in (B, 5) int32 (head t, x, tail
// t, x, orientation) to worm_out.  hist (B, N, N) f32 receives the
// Vortex_Vortex tallies, stat (B, 2) f32 the worm length (moves tallied) and
// the closes.  chain0 is the global index of the first chain.
int sv_chunked_worms(const float* phi, const int* n_in, int* n, const int* worm_in, int* worm_out,
                     float* hist, float* stat, int B, int N, float half_kappa, int moves,
                     unsigned long long seed, unsigned int chain0, void* stream_ptr) {
    cudaStream_t stream = (cudaStream_t)stream_ptr;
    const size_t NN = (size_t)N * N;
    cudaError_t e;
    if ((e = cudaMemcpyAsync(n, n_in, 2 * B * NN * sizeof(int), cudaMemcpyDeviceToDevice, stream))) return e;
    if ((e = cudaMemsetAsync(hist, 0, B * NN * sizeof(float), stream))) return e;
    const unsigned long long k = seed ^ CHUNKED_SALT;
    const uint2 key = make_uint2((uint32_t)k, (uint32_t)(k >> 32));
    const int threads = 32;
    chunked_worm_kernel<<<(B + threads - 1) / threads, threads, 0, stream>>>(
        phi, n, worm_in, worm_out, hist, stat, B, N, half_kappa, moves, key, chain0);
    return cudaGetLastError();
}

}  // extern "C"
