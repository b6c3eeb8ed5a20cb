// K2: the Worldline classic (site) worm in any dimension D on Hopper.
//
// Replaces no Pallas kernel (the TPU kernels are D=2 only): it puts on the
// card the lax.while_loop of supervillain_tpu/generators/worldline.py
// ClassicWorm.step at D >= 3, which the port otherwise runs as about 15
// PyTorch launches and one host synchronisation a move
// (ops/worldline_worm.py plain_worldline_worms).  Same move rule: the worm
// starts closed (head = tail) at a random site with a random orientation; the
// head moves to one of the 2D neighbouring sites (+e_k for choice k < D, −e_k
// for choice D + k); a forward move crosses the link at the head, a backward
// move the link at the arrival site, and the crossed link changes by
// Δm = ±orientation; Metropolis on ΔS = (1/2κ)Δm(2u + Δm) with u = m − δv/_W;
// when head == tail a move closes the worm with probability 1/(2D+1); every
// other move, accepted or not, tallies (head − tail) mod N into the chain's
// Spin_Spin histogram.
//
// What bounds it on the H100: the latency of one move times the moves of the
// longest worm, as for B5: each move waits for the crossed link's m and δv/_W
// at an address set by the previous moves.  The bytes of the call are no bound.
//
// Design: one thread per chain, in blocks of 32, as B2.  Sites are flat
// indices of the chain's N^D torus (axis 0 most significant, stride N^(D−1−k)
// for axis k) with D a runtime value, so no largest D is fixed: a move reads
// one coordinate of the head by a division and wraps it by comparison, and the
// displacement head − tail is carried as a flat index of its own that moves as
// the head does (it is 0 exactly when head == tail).  δv/_W is computed once a
// call by the wrapper (calc.delta in PyTorch, the plain twin's own expression)
// and read beside m.  The next move's draw is evaluated while this move's
// loads are in flight.
//
// Cap and rollback: an open worldline worm breaks δm = 0 at every W, so with a
// cap a worm still open after `cap` moves is undone.  The log holds the choice
// of each accepted move in `bits` = ⌈log₂ 2D⌉ bits, 32/bits to a word; on
// truncation the thread replays the path from the tail, subtracting each Δm:
// exact on integers, O(moves).
//
// Draws: exactly those of ops/worldline_worm.py KernelWorldlineWormDraws with
// D: Philox keyed by the seed's Worldline key; the start from (chain, worm, 0,
// 2) (orientation from the top bit of word 0, the tail's coordinates from
// words 1..3) and (chain, worm, j, 2), j = 1, 2, ... (4 coordinates each); each
// move from (chain, worm, move, odd): the close uniform, the choice as the word
// modulo 2D, the Metropolis uniform.  The chain word is chain0 + the chain's
// index in the call.
#include <cstdint>
#include <cuda_runtime.h>

#include "philox.cuh"
#include "worldline.cuh"

namespace {

using sv::link_term;
using sv::metropolis;
using sv::philox4x32_10;
using sv::residual;
using sv::u24;

__device__ __forceinline__ int rand_coordinate(uint32_t w, int N) {
    return (int)(((uint64_t)w * (uint32_t)N) >> 32);
}

// The flat index one step along the axis of stride `stride` from `site`,
// forward or back, wrapping by comparison (any N).
// (The wrapper keeps B·D·N^D below 2^31, so a chain's indices fit an int.)
__device__ __forceinline__ int step_site(int site, int stride, int N, bool forward) {
    const int c = (site / stride) % N;
    if (forward) return c == N - 1 ? site - (N - 1) * stride : site + stride;
    return c == 0 ? site + (N - 1) * stride : site - stride;
}

__device__ __forceinline__ int stride_of(int axis, int D, int N) {
    int stride = 1;
    for (int j = axis + 1; j < D; ++j) stride *= N;
    return stride;
}

__global__ void general_worm_kernel(int* __restrict__ m, const float* __restrict__ dvw,
                                    float* __restrict__ hist, float* __restrict__ stat,
                                    uint32_t* __restrict__ log, long long log_words, int B, int D,
                                    int N, int V, float inv2k, float close_p, int worms,
                                    long long cap, int bits, uint2 key, uint32_t chain0) {
    const int chain = blockIdx.x * blockDim.x + threadIdx.x;
    if (chain >= B) return;
    int* mc = m + (long long)chain * D * V;
    const float* dc = dvw + (long long)chain * D * V;
    float* h = hist + (long long)chain * V;
    const bool rollback = cap >= 0;
    uint32_t* lg = rollback ? log + (long long)chain * log_words : nullptr;
    const uint32_t global = chain0 + (uint32_t)chain;
    const uint32_t choices = 2u * (uint32_t)D;
    const int per_word = 32 / bits;
    const uint32_t field = (1u << bits) - 1u;

    float length = 0.f;
    int truncations = 0;
    for (int w = 0; w < worms; ++w) {
        const uint32_t worm = (uint32_t)w;
        const uint4 s = philox4x32_10(make_uint4(global, worm, 0u, 2u), key);
        const int orientation = (s.x >> 31) ? 1 : -1;
        int tail = 0;
        uint4 block = s;
        for (int k = 0; k < D; ++k) {
            uint32_t word;
            if (k < 3) {
                word = k == 0 ? s.y : (k == 1 ? s.z : s.w);
            } else {
                const int i = (k - 3) % 4;
                if (i == 0) {
                    const uint32_t j = 1u + (uint32_t)((k - 3) / 4);
                    block = philox4x32_10(make_uint4(global, worm, j, 2u), key);
                }
                word = i == 0 ? block.x : (i == 1 ? block.y : (i == 2 ? block.z : block.w));
            }
            tail = tail * N + rand_coordinate(word, N);
        }
        int head = tail, disp = 0;

        bool done = false;
        long long moves = 0, accepted = 0;
        uint32_t pending = 0;  // the log word being filled
        uint4 mv = philox4x32_10(make_uint4(global, worm, 0u, 1u), key);
        while (!done && (cap < 0 || moves < cap)) {
            const long long t1 = moves + 1;
            const uint4 next = philox4x32_10(
                make_uint4(global, worm, (uint32_t)t1, 2u * (uint32_t)(t1 >> 32) + 1u), key);
            done = disp == 0 && u24(mv.x) < close_p;
            if (!done) {
                const uint32_t c = mv.y % choices;
                const bool forward = c < (uint32_t)D;
                const int axis = forward ? (int)c : (int)c - D;
                const int stride = stride_of(axis, D, N);
                const int next_head = step_site(head, stride, N, forward);
                const int l = axis * V + (forward ? head : next_head);
                const int dm = forward ? orientation : -orientation;
                const float u = residual(mc[l], dc[l]);
                if (metropolis(u24(mv.z), link_term(inv2k, u, (float)dm))) {
                    mc[l] += dm;
                    head = next_head;
                    disp = step_site(disp, stride, N, forward);
                    if (rollback) {
                        const int slot = (int)(accepted % per_word);
                        pending = slot ? (pending | (c << (bits * slot))) : c;
                        if (slot == per_word - 1) lg[accepted / per_word] = pending;
                    }
                    ++accepted;
                }
                h[disp] += 1.f;
                length += 1.f;
            }
            mv = next;
            ++moves;
        }
        if (!done && rollback) {
            // Flush the pending word, then replay the accepted path from the
            // tail, undoing each Δm.
            if (accepted % per_word) lg[accepted / per_word] = pending;
            int at = tail;
            for (long long i = 0; i < accepted; ++i) {
                const uint32_t c = (lg[i / per_word] >> (bits * (int)(i % per_word))) & field;
                const bool forward = c < (uint32_t)D;
                const int axis = forward ? (int)c : (int)c - D;
                const int to = step_site(at, stride_of(axis, D, N), N, forward);
                mc[axis * V + (forward ? at : to)] -= forward ? orientation : -orientation;
                at = to;
            }
            ++truncations;
        }
    }
    stat[2 * chain] = length;
    stat[2 * chain + 1] = (float)truncations;
}

}  // namespace

extern "C" {

// Copies m_in into m, then runs `worms` worms per chain in place.  m is
// (B, D, N^D) int32 and dvw (B, D, N^D) f32 holds δv/_W of every link; hist
// (B, N^D) f32 receives the Spin_Spin tallies, stat (B, 2) f32 the worm
// length and the truncation count.  cap < 0 means unbounded; with a cap, log
// holds log_words 32-bit words per chain (at least ⌈cap / (32/bits)⌉).
// chain0 is the global index of the first chain, which the draws count from.
int sv_worldline_worms_general(const int* m_in, const float* dvw, int* m, float* hist,
                               float* stat, uint32_t* log, long long log_words, int B, int D,
                               int N, int V, float inv2k, float close_p, int worms,
                               long long cap, int bits, unsigned long long seed,
                               unsigned int chain0, void* stream_ptr) {
    cudaStream_t stream = (cudaStream_t)stream_ptr;
    cudaError_t e;
    const size_t links = (size_t)B * D * V;
    if ((e = cudaMemcpyAsync(m, m_in, links * sizeof(int), cudaMemcpyDeviceToDevice, stream))) return e;
    if ((e = cudaMemsetAsync(hist, 0, (size_t)B * V * sizeof(float), stream))) return e;
    const uint2 key = sv::worldline_key(seed);
    const int threads = 32;
    general_worm_kernel<<<(B + threads - 1) / threads, threads, 0, stream>>>(
        m, dvw, hist, stat, log, log_words, B, D, N, V, inv2k, close_p, worms, cap, bits, key,
        chain0);
    return cudaGetLastError();
}

}  // extern "C"
