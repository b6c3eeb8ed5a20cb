// Villain neighborhood sweeps on Hopper.
//
// Replaces supervillain_tpu/ops/pallas_sweep.py:neighborhood_sweeps (its
// kernel bodies _make_kernel and _make_strip_kernel).  Same transition kernel
// as generators/villain.py:NeighborhoodUpdate: each site of checkerboard color
// c proposes Δφ ~ U(±interval_phi) and Δn ∈ W·{-i..i} on its 4 adjacent links
// (zero-inflated when p_n >= 0), or at W = ∞ (W == 0 here) an integer Δz with
// Δn = d(Δz); ΔS = Σ_links (κ/2)·cr·(2r + cr) with cr the change of the link
// residual r = dφ − 2πn; Metropolis on u < exp(−ΔS).  Draws: Philox keyed by
// the seed, countered by (site t·N + x, chain, pass n_colors·sweep + color, k),
// with n_colors = 2 at even N and 4 at odd N.  The chain word is chain0 +
// the chain's index in the call: chain0, the global index of the call's first
// chain, lets a fleet cut into shards draw what it draws whole.
//
// Three regimes, chosen on the host from N alone (ops/sweep.py sweep_plan):
// resident and streaming at even N, and at odd N a colour table.
//
// Resident (N ≤ 304): a chain needs 20 B a site (φ f32, n 2×i32, r 2×f32),
// 1.25 MB at L=256, more than one block's 227 KB of shared memory but not
// more than a thread-block cluster's.  So a cluster of k blocks (k = 1, 2, 4
// or 8, the fewest that fit) holds one chain for the whole call, as VMEM holds
// it on the TPU: each block loads a band of rows once, builds r, runs every
// color pass in shared memory and stores φ and n once.  Device-memory traffic
// is then 24 B a site a call, and what bounds the kernel is the integer pipe,
// which issues the two Philox calls of a site-update (20 rounds of two 32-bit
// multiplies and two XORs, at half the float rate), with the int-float
// conversions of the draws (at an eighth); so the draws stay floats until a
// move is accepted.  Thread 0 of a block waits about 15% of its time at the
// cluster barriers, three a sweep: after each color pass, and after the
// inline sums, which read the next band's first row that the next pass may
// change.
// Each field is split by site color c = (t + x) & 1 into planes of rows of
// N/2 entries, so a pass reads its color's sites at consecutive words and the
// other color's links shifted by at most one word: unit stride, no bank
// conflicts.  A site of a band's first row reads and, on accept, writes its
// backward t-link ℓ0[t−1, x] in place in the block above (block k−1 for block
// 0) through distributed shared memory; same-color sites share no link, so
// nothing races inside a pass.  The chain is the cluster's index, the band
// the block's rank; a thread walks its entries with a cursor and never
// divides.  Each thread sums r² and (dn)² of its own sites after every sweep
// and its accepts over the call; the block and then rank 0 of the cluster add
// them in a fixed order, so a seed gives the same sums bit for bit, and rank
// 0 writes the chain's totals with no atomics.  A cluster that cannot be
// scheduled is an error; nothing falls back to the streaming regime.
//
// Streaming (N > 304): the state lives in device memory and every color pass
// streams it: a color-c site reads φ and its 4 links' r and n (36 B) and
// writes them back when accepted, and the per-sweep inline sums read r and n
// once more (16 B/site) — about 70-90 B of traffic per site-update, so the
// card's 3.35 TB/s caps it near 4e10 site-updates/s.
// One thread per (chain, site of color c), one launch per color pass.  Each
// link is adjacent to exactly one site of each color, so no two threads of a
// pass write the same word.  Accepted counts are aggregated per warp (peers by
// chain) before one atomicAdd.  Same-color sites of a row sit two words apart,
// so a warp uses half of each 32-byte sector it loads; B4's color planes
// would fix that (later work).
// The inline sums take one launch a sweep over the whole card: each chain is
// cut into k bands of rows, a block a band, k chosen on the host from N alone
// (ops/sweep.py sum_bands: about 16384 sites a block, 64 bands at N = 1024),
// so that a chain's sums are added in one order whatever the batch and the
// card; 64 chains of N = 1024 launch 4096 blocks.  A block walks its
// band with a (t, x) cursor and coalesced loads, adds r² in float64 and (dn)²
// in int64, reduces in a fixed order and keeps its total in a slot of its own
// across the call's sweeps; one launch at the call's end adds each chain's
// slots in band order.  No float atomics: a seed gives the same sums bit for
// bit.
//
// Colour table (odd N): a torus of odd side is not two-colourable, so the
// lattice colours it with 4 colours (ops/lattice.py checkerboard_masks: pairs
// of opposite quadrants by parity), no two neighbours alike.  The streaming
// regime then runs one launch per colour over every site of the chain, a site
// reading its colour from an int8 table uploaded once and idling unless it is
// the pass's.  Same-colour sites still share no link, so nothing races; the
// site's 4 neighbours wrap by comparison, as init_residual and inline_sums do
// at any N.  Half to three quarters of the threads of a pass idle: the simple
// design, left for later work to compact.
//
// Every regime rebuilds r from (φ, n) at the start of every call, as the TPU
// kernel does at every launch, so its f32 drift is bounded by one call, and
// both run the same arithmetic on the same draws: they give the same φ, n and
// accepted counts bit for bit.
#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "philox.cuh"

namespace {

using sv::philox4x32_10;
using sv::u24;
using sv::exp_neg;
using sv::TWO_PI;

// Uniform in {-i..i} as floor(u·(2i+1)) − i, or the zero-inflated ±k (k
// uniform in 1..i, each sign with probability p/2) when p >= 0 — the TPU
// kernels' draw formulas (pallas_sweep.py _int_in and _int_sparse).  The
// integer is returned as an exact float: the residuals take it as one, and
// only an accepted move converts it (int-float conversions issue at an
// eighth of the float rate and bound the kernel with the Philox rounds).
__device__ __forceinline__ float draw(uint32_t a, uint32_t b, int interval, float p) {
    if (p < 0.f) {
        return floorf(u24(a) * (float)(2 * interval + 1)) - (float)interval;
    }
    const float u = u24(a);
    const float mag = interval == 1 ? 1.f : floorf(u24(b) * (float)interval) + 1.f;
    return (u < 0.5f * p) ? mag : ((u < p) ? -mag : 0.f);
}

// One site's proposal and its Metropolis decision, in both regimes: Δφ, the
// Δn of its forward (f) and backward (b) links (exact integers in floats), the
// changes cr = ±Δφ − 2πΔn of their residuals, and whether u < exp(−ΔS) given
// the 4 residuals r.
struct Move {
    float dphi, crf0, crb0, crf1, crb1;
    float cf0, cf1, cb0, cb1;
    bool accept;
};

__device__ __forceinline__ Move propose(uint32_t s, uint32_t chain, uint32_t pass, uint2 key,
                                        float kappa, int W, float interval_phi, int interval_n,
                                        float p_n, float rf0, float rb0, float rf1, float rb1) {
    const uint4 w0 = philox4x32_10(make_uint4(s, chain, pass, 0u), key);
    const uint4 w1 = philox4x32_10(make_uint4(s, chain, pass, 1u), key);
    uint4 w2 = make_uint4(0u, 0u, 0u, 0u);
    if (p_n >= 0.f && interval_n > 1) {
        w2 = philox4x32_10(make_uint4(s, chain, pass, 2u), key);
    }
    Move m;
    m.dphi = (2.f * u24(w0.x) - 1.f) * interval_phi;
    if (W == 0) {
        // z-mode: Δn = d(Δz) with Δz on this site only (0 − Δz keeps a zero
        // draw +0, as the integer was).
        const float dz = draw(w0.z, w1.z, interval_n, p_n);
        m.cf0 = 0.f - dz; m.cf1 = 0.f - dz; m.cb0 = dz; m.cb1 = dz;
    } else {
        const float w = (float)W;
        m.cf0 = w * draw(w0.z, w1.z, interval_n, p_n);
        m.cf1 = w * draw(w0.w, w1.w, interval_n, p_n);
        m.cb0 = w * draw(w1.x, w2.x, interval_n, p_n);
        m.cb1 = w * draw(w1.y, w2.y, interval_n, p_n);
    }
    m.crf0 = -m.dphi - TWO_PI * m.cf0;
    m.crb0 = m.dphi - TWO_PI * m.cb0;
    m.crf1 = -m.dphi - TWO_PI * m.cf1;
    m.crb1 = m.dphi - TWO_PI * m.cb1;
    const float dS = 0.5f * kappa *
                     (m.crf0 * (2.f * rf0 + m.crf0) + m.crb0 * (2.f * rb0 + m.crb0)
                      + m.crf1 * (2.f * rf1 + m.crf1) + m.crb1 * (2.f * rb1 + m.crb1));
    m.accept = u24(w0.y) < exp_neg(dS);
    return m;
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
                           uint2 key, uint32_t chain0, float kappa, int W, float interval_phi,
                           int interval_n, float p_n) {
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

        const float rf0 = r0[s], rb0 = r0[lb0], rf1 = r1[s], rb1 = r1[lb1];
        const Move m = propose((uint32_t)s, chain0 + (uint32_t)chain, pass, key, kappa, W,
                               interval_phi, interval_n, p_n, rf0, rb0, rf1, rb1);
        accept = m.accept;
        if (accept) {
            ph[s] += m.dphi;
            n0[s] += __float2int_rn(m.cf0);
            n0[lb0] += __float2int_rn(m.cb0);
            n1[s] += __float2int_rn(m.cf1);
            n1[lb1] += __float2int_rn(m.cb1);
            r0[s] = rf0 + m.crf0;
            r0[lb0] = rb0 + m.crb0;
            r1[s] = rf1 + m.crf1;
            r1[lb1] = rb1 + m.crb1;
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

// color_pass at any N: one thread per (chain, site), the site's colour from
// colors (N·N int8); a thread whose site is not of `color` only joins the
// warp's accept count.
__global__ void color_pass_table(float* __restrict__ phi, int* __restrict__ n,
                                 float* __restrict__ r, int* __restrict__ accepted,
                                 const int8_t* __restrict__ colors, int B, int N, int color,
                                 uint32_t pass, uint2 key, uint32_t chain0, float kappa, int W,
                                 float interval_phi, int interval_n, float p_n) {
    const long long NN = (long long)N * N;
    const long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
    int chain = -1;
    bool active = idx < B * NN;
    bool accept = false;
    if (active) {
        chain = (int)(idx / NN);
        const int s = (int)(idx - chain * NN);
        active = colors[s] == color;
        if (active) {
            const int t = s / N, x = s - t * N;
            const int tm = t == 0 ? N - 1 : t - 1, xm = x == 0 ? N - 1 : x - 1;
            const int lb0 = tm * N + x, lb1 = t * N + xm;

            float* ph = phi + chain * NN;
            int* n0 = n + chain * 2 * NN;
            int* n1 = n0 + NN;
            float* r0 = r + chain * 2 * NN;
            float* r1 = r0 + NN;

            const float rf0 = r0[s], rb0 = r0[lb0], rf1 = r1[s], rb1 = r1[lb1];
            const Move m = propose((uint32_t)s, chain0 + (uint32_t)chain, pass, key, kappa, W,
                                   interval_phi, interval_n, p_n, rf0, rb0, rf1, rb1);
            accept = m.accept;
            if (accept) {
                ph[s] += m.dphi;
                n0[s] += __float2int_rn(m.cf0);
                n0[lb0] += __float2int_rn(m.cb0);
                n1[s] += __float2int_rn(m.cf1);
                n1[lb1] += __float2int_rn(m.cb1);
                r0[s] = rf0 + m.crf0;
                r0[lb0] = rb0 + m.crb0;
                r1[s] = rf1 + m.crf1;
                r1[lb1] = rb1 + m.crb1;
            }
        }
    }
    const unsigned peers = __match_any_sync(0xffffffffu, active ? chain : -1);
    const unsigned votes = __ballot_sync(0xffffffffu, accept);
    if (active && (int)(threadIdx.x & 31) == __ffs(peers) - 1) {
        const int c = __popc(votes & peers);
        if (c) atomicAdd(accepted + chain, c);
    }
}

// Rows [start, start + rows) of band `rank` of k of a chain (a resident
// block's, or a streaming sums block's): N / k rows each, one more for the
// first N % k bands (ops/sweep.py bands).
struct Band {
    int start, rows;
};

__device__ __forceinline__ Band band_of(int rank, int N, int k) {
    const int base = N / k, extra = N - base * k;
    return {rank * base + min(rank, extra), base + (rank < extra ? 1 : 0)};
}

// (row, col) of a thread's entries over rows of `width` columns: it starts at
// entry threadIdx.x and steps by blockDim.x, carrying the column over.
struct Cursor {
    int row, col, drow, dcol, width;
    __device__ __forceinline__ Cursor(int width_) : width(width_) {
        row = (int)threadIdx.x / width;
        col = (int)threadIdx.x - row * width;
        drow = (int)blockDim.x / width;
        dcol = (int)blockDim.x - drow * width;
    }
    __device__ __forceinline__ void next() {
        row += drow;
        col += dcol;
        if (col >= width) {
            col -= width;
            ++row;
        }
    }
};

// The sum of a value over a warp, in a fixed order, in lane 0.
template <typename T>
__device__ __forceinline__ T warp_sum(T a) {
    for (int o = 16; o > 0; o /= 2) a += __shfl_down_sync(0xffffffffu, a, o);
    return a;
}

constexpr int kSumThreads = 256;

// A sweep's inline sums over one band of rows of a chain: block b is band
// b mod k of chain b / k (band_of).  A thread walks the band's sites with a
// cursor, never dividing, and reads r0, r1, n0 and n1 at its site, coalesced,
// and n1[t+1, x] and n0[t, x+1] from the band's own rows or the next band's
// first row, through the cache.  r² adds up in float64 and (dn)² in int64,
// exactly; the warp, then thread 0 over the warps, adds the threads' sums in
// a fixed order, and the block stores them in its own slot at the call's
// first sweep and adds them to it at every later one.
__global__ void inline_sums(const float* __restrict__ r, const int* __restrict__ n,
                            double* __restrict__ slot_r2, long long* __restrict__ slot_dn2,
                            int N, int k, bool first) {
    const long long NN = (long long)N * N;
    const int chain = blockIdx.x / k;
    const Band band = band_of(blockIdx.x - chain * k, N, k);
    const float* r0 = r + chain * 2 * NN;
    const float* r1 = r0 + NN;
    const int* n0 = n + chain * 2 * NN;
    const int* n1 = n0 + NN;
    const int end = (band.start + band.rows) * N;
    Cursor c(N);
    double a = 0.0;
    long long b = 0;
#pragma unroll 4
    for (int s = band.start * N + (int)threadIdx.x; s < end; s += kSumThreads, c.next()) {
        const int t = band.start + c.row, x = c.col;
        const int up = t + 1 == N ? x : s + N;              // (t+1, x)
        const int right = x + 1 == N ? s + 1 - N : s + 1;   // (t, x+1)
        const float v0 = r0[s], v1 = r1[s];
        a += (double)v0 * v0 + (double)v1 * v1;
        const int dn = (n1[up] - n1[s]) - (n0[right] - n0[s]);
        b += (long long)dn * dn;
    }
    a = warp_sum(a);
    b = warp_sum(b);
    __shared__ double warp_r2[kSumThreads / 32];
    __shared__ long long warp_dn2[kSumThreads / 32];
    if ((threadIdx.x & 31) == 0) {
        warp_r2[threadIdx.x / 32] = a;
        warp_dn2[threadIdx.x / 32] = b;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        a = 0.0;
        b = 0;
        for (int w = 0; w < kSumThreads / 32; ++w) {
            a += warp_r2[w];
            b += warp_dn2[w];
        }
        slot_r2[blockIdx.x] = first ? a : slot_r2[blockIdx.x] + a;
        slot_dn2[blockIdx.x] = first ? b : slot_dn2[blockIdx.x] + b;
    }
}

// The call's last step, under the same name: sums[chain] gets the chain's k
// slots added in band order, a thread a chain.
__global__ void inline_sums(const double* __restrict__ slot_r2,
                            const long long* __restrict__ slot_dn2, double* __restrict__ sums,
                            int B, int k) {
    const int chain = blockIdx.x * blockDim.x + threadIdx.x;
    if (chain >= B) return;
    double a = 0.0;
    long long b = 0;
    for (int i = chain * k; i < (chain + 1) * k; ++i) {
        a += slot_r2[i];
        b += slot_dn2[i];
    }
    sums[2 * chain] = a;
    sums[2 * chain + 1] = (double)b;
}

// The band sums of one sweep over B chains in k bands each (first: the call's
// first sweep, which stores rather than adds).
cudaError_t band_sums(const float* r, const int* n, double* slot_r2, long long* slot_dn2, int B,
                      int N, int k, bool first, cudaStream_t stream) {
    inline_sums<<<(unsigned)(B * k), kSumThreads, 0, stream>>>(r, n, slot_r2, slot_dn2, N, k,
                                                              first);
    return cudaGetLastError();
}

// The call's fold of the slots of B chains of k bands into sums (B, 2).
cudaError_t fold_sums(const double* slot_r2, const long long* slot_dn2, double* sums, int B,
                      int k, cudaStream_t stream) {
    inline_sums<<<(unsigned)((B + kSumThreads - 1) / kSumThreads), kSumThreads, 0, stream>>>(
        slot_r2, slot_dn2, sums, B, k);
    return cudaGetLastError();
}


// -- the slab form ------------------------------------------------------------------
//
// A chain × space mesh (parallel/space.py) cuts each chain's torus along x
// into slabs of `width` columns and holds each slab padded with `ghost`
// columns of its neighbours on either side: fields (B, ·, N, P), P = width +
// 2·ghost, padded column j being global column (first + j) mod N.  The host
// fills the ghosts (a halo exchange) before every pass.  A pass runs the
// streaming regime's arithmetic (propose) on every site of its colour in the
// padded columns 1..P−2, the wrap holding along t only: the sites of the
// first ghost column on each side change the slab's own boundary links as the
// neighbour's own pass does, on the same draws, since a site's Philox counter
// is its global t·N + x.  So a slab's own columns come out bit for bit as on
// the whole torus.  One thread per (chain, site) of the columns 1..P−2, half
// of them idle: the simple design.

// r_mu[t, j] = φ[(t, j) + e_mu] − φ[t, j] − 2π n_mu[t, j] on the padded slab;
// the forward x-link of the last column leaves it and is set to 0.
__global__ void init_residual_slab(const float* __restrict__ phi, const int* __restrict__ n,
                                   float* __restrict__ r, int B, int N, int P) {
    const long long NP = (long long)N * P;
    const long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
    if (idx >= B * NP) return;
    const long long chain = idx / NP;
    const int s = (int)(idx - chain * NP);
    const int t = s / P, j = s - t * P;
    const int tp = t + 1 == N ? 0 : t + 1;
    const float* ph = phi + chain * NP;
    const int* n0 = n + chain * 2 * NP;
    float* r0 = r + chain * 2 * NP;
    const float p = ph[s];
    r0[s] = (ph[tp * P + j] - p) - TWO_PI * (float)n0[s];
    r0[NP + s] = j + 1 < P ? (ph[s + 1] - p) - TWO_PI * (float)n0[NP + s] : 0.f;
}

__global__ void color_pass_slab(float* __restrict__ phi, int* __restrict__ n,
                                float* __restrict__ r, int* __restrict__ accepted, int B, int N,
                                int P, int first, int ghost, int width, int color, uint2 key,
                                uint32_t chain0, float kappa, int W, float interval_phi,
                                int interval_n, float p_n) {
    const int inner = P - 2;
    const long long per_chain = (long long)N * inner;
    const long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
    int chain = -1;
    bool active = idx < B * per_chain;
    bool accept = false;
    bool own = false;
    if (active) {
        chain = (int)(idx / per_chain);
        const int k = (int)(idx - chain * per_chain);
        const int t = k / inner;
        const int j = k - t * inner + 1;
        const int x = (first + j) % N;
        active = ((t + x) & 1) == color;
        own = j >= ghost && j < ghost + width;
        if (active) {
            const long long NP = (long long)N * P;
            const int s = t * P + j;
            const int tm = t == 0 ? N - 1 : t - 1;
            const int lb0 = tm * P + j, lb1 = s - 1;

            float* ph = phi + chain * NP;
            int* n0 = n + chain * 2 * NP;
            int* n1 = n0 + NP;
            float* r0 = r + chain * 2 * NP;
            float* r1 = r0 + NP;

            const float rf0 = r0[s], rb0 = r0[lb0], rf1 = r1[s], rb1 = r1[lb1];
            const Move m = propose((uint32_t)(t * N + x), chain0 + (uint32_t)chain,
                                   (uint32_t)color, key, kappa, W, interval_phi, interval_n, p_n, rf0, rb0, rf1, rb1);
            accept = m.accept;
            if (accept) {
                ph[s] += m.dphi;
                n0[s] += __float2int_rn(m.cf0);
                n0[lb0] += __float2int_rn(m.cb0);
                n1[s] += __float2int_rn(m.cf1);
                n1[lb1] += __float2int_rn(m.cb1);
                r0[s] = rf0 + m.crf0;
                r0[lb0] = rb0 + m.crb0;
                r1[s] = rf1 + m.crf1;
                r1[lb1] = rb1 + m.crb1;
            }
        }
    }
    const bool counted = active && own;
    const unsigned peers = __match_any_sync(0xffffffffu, counted ? chain : -1);
    const unsigned votes = __ballot_sync(0xffffffffu, accept && own);
    if (counted && (int)(threadIdx.x & 31) == __ffs(peers) - 1) {
        const int c = __popc(votes & peers);
        if (c) atomicAdd(accepted + chain, c);
    }
}


// -- the resident regime ----------------------------------------------------------

namespace cg = cooperative_groups;

constexpr int kResidentThreads = 1024;  // the most a plan asks for (ops/sweep.py)
constexpr int kWarps = kResidentThreads / 32;

// cluster.sync(); when timing, adds the cycles the thread spent in it to *waited.
__device__ __forceinline__ void cluster_sync(cg::cluster_group& cluster, bool timing,
                                             long long* waited) {
    const long long t0 = timing ? clock64() : 0;
    cluster.sync();
    if (timing) *waited += clock64() - t0;
}

// One cluster of k blocks per chain (the chain is the cluster's index, the
// band of rows the block's rank).  Dynamic shared memory holds the band's
// φ, r0, r1 (f32) and n0, n1 (i32), each in two color planes of `hmax` rows
// of N/2 entries: site (t, x) of the band at plane (t + x) & 1, row
// t − band.start, entry x >> 1.  Writes φ and n of the chain, its accepted
// site updates, and Σ_sweeps Σ r² and Σ_sweeps Σ (dn)² to sums[chain].  When
// `cycles` is not null, thread 0 of each block writes the clock cycles it
// waited at cluster barriers and its cycles in all to cycles[2·block], [+1].
__global__ void __launch_bounds__(kResidentThreads, 1) resident_sweeps(
    const float* __restrict__ phi_in, const int* __restrict__ n_in, float* __restrict__ phi_out,
    int* __restrict__ n_out, int* __restrict__ accepted, double* __restrict__ sums,
    long long* __restrict__ cycles, int N, int k, int hmax, int sweeps, uint2 key, uint32_t chain0,
    float kappa, int W, float interval_phi, int interval_n, float p_n) {
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ double warp_r2[kWarps], warp_dn2[kWarps];
    __shared__ int warp_acc[kWarps];
    __shared__ double block_sums[2];
    __shared__ int block_acc;

    const bool timing = cycles != nullptr;
    const long long start = timing ? clock64() : 0;
    long long waited = 0;
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = (int)cluster.block_rank();
    const int chain = (int)blockIdx.x / k;
    const int hN = N / 2, P = hmax * hN;  // entries of one color plane
    float* phi = reinterpret_cast<float*>(smem);
    float* r0 = phi + 2 * P;
    float* r1 = r0 + 2 * P;
    int* n0 = reinterpret_cast<int*>(r1 + 2 * P);
    int* n1 = n0 + 2 * P;

    const Band band = band_of(rank, N, k);
    const int prev = rank == 0 ? k - 1 : rank - 1, next = rank + 1 == k ? 0 : rank + 1;
    // ℓ0[t − 1, x] of the band's first row is in the last row of the previous
    // band; n1 of the next band's first row enters dn of this band's last row.
    const int prev_last = (band_of(prev, N, k).rows - 1) * hN;
    float* r0_prev = cluster.map_shared_rank(r0, prev) + prev_last;
    int* n0_prev = cluster.map_shared_rank(n0, prev) + prev_last;
    const int* n1_next = cluster.map_shared_rank(n1, next);

    const size_t NN = (size_t)N * N;
    const float* ph_in = phi_in + chain * NN;
    const int* m0_in = n_in + chain * 2 * NN;
    const int* m1_in = m0_in + NN;

    // Load the band and build r = dφ − 2πn (φ of the next row from device
    // memory, so no block reads another before the first barrier).
    for (Cursor e(N); e.row < band.rows; e.next()) {
        const int t = band.start + e.row, x = e.col;
        const int tp = t + 1 == N ? 0 : t + 1, xp = x + 1 == N ? 0 : x + 1;
        const int s = t * N + x;
        const int q = ((t + x) & 1) * P + e.row * hN + (x >> 1);
        const float p = ph_in[s];
        const int m0 = m0_in[s], m1 = m1_in[s];
        phi[q] = p;
        n0[q] = m0;
        n1[q] = m1;
        r0[q] = (ph_in[tp * N + x] - p) - TWO_PI * (float)m0;
        r1[q] = (ph_in[t * N + xp] - p) - TWO_PI * (float)m1;
    }
    cluster_sync(cluster, timing, &waited);

    int count = 0;
    double r2 = 0.0;
    long long dn2 = 0;
    for (int sweep = 0; sweep < sweeps; ++sweep) {
        for (int color = 0; color < 2; ++color) {
            const uint32_t pass = (uint32_t)(2 * sweep + color);
            const int own = color * P, other = (1 - color) * P;
            for (Cursor e(hN); e.row < band.rows; e.next()) {
                const int row = e.row, j = e.col;
                const int t = band.start + row, p = (t + color) & 1;
                const int s = t * N + 2 * j + p;
                const int q = own + row * hN + j;
                // ℓ1[t, x − 1] is in the other plane, one entry left when x is even.
                const int lb1 = other + row * hN + (p ? j : (j == 0 ? hN - 1 : j - 1));
                const int lb0 = other + (row - 1) * hN + j;  // ℓ0[t − 1, x] when row > 0
                const float rf0 = r0[q], rf1 = r1[q], rb1 = r1[lb1];
                const float rb0 = row > 0 ? r0[lb0] : r0_prev[other + j];
                const Move m = propose((uint32_t)s, chain0 + (uint32_t)chain, pass, key, kappa,
                                       W, interval_phi, interval_n, p_n, rf0, rb0, rf1, rb1);
                if (m.accept) {
                    ++count;
                    phi[q] += m.dphi;
                    n0[q] += __float2int_rn(m.cf0);
                    n1[q] += __float2int_rn(m.cf1);
                    n1[lb1] += __float2int_rn(m.cb1);
                    r0[q] = rf0 + m.crf0;
                    r1[q] = rf1 + m.crf1;
                    r1[lb1] = rb1 + m.crb1;
                    if (row > 0) {
                        n0[lb0] += __float2int_rn(m.cb0);
                        r0[lb0] = rb0 + m.crb0;
                    } else {
                        n0_prev[other + j] += __float2int_rn(m.cb0);
                        r0_prev[other + j] = rb0 + m.crb0;
                    }
                }
            }
            cluster_sync(cluster, timing, &waited);
        }
        // The inline sums of this sweep: r² of each site's forward links and
        // (dn)² of its plaquette, dn = n1[t+1, x] − n1[t, x] − n0[t, x+1] + n0[t, x].
        for (int color = 0; color < 2; ++color) {
            const int own = color * P, other = (1 - color) * P;
            for (Cursor e(hN); e.row < band.rows; e.next()) {
                const int row = e.row, j = e.col;
                const int p = (band.start + row + color) & 1;
                const int q = own + row * hN + j;
                const float a = r0[q], b = r1[q];
                r2 += (double)a * a + (double)b * b;
                const int up = row + 1 < band.rows ? n1[other + (row + 1) * hN + j]
                                                   : n1_next[other + j];
                const int right = n0[other + row * hN + (p ? (j + 1 == hN ? 0 : j + 1) : j)];
                const int dn = (up - n1[q]) - (right - n0[q]);
                dn2 += dn * dn;
            }
        }
        // The next pass may change the first row of this band, which the
        // block above has just read.
        if (sweep + 1 < sweeps) cluster_sync(cluster, timing, &waited);
    }

    // The band back to device memory.
    float* ph_out = phi_out + chain * NN;
    int* m0_out = n_out + chain * 2 * NN;
    int* m1_out = m0_out + NN;
    for (Cursor e(N); e.row < band.rows; e.next()) {
        const int t = band.start + e.row, x = e.col;
        const int s = t * N + x;
        const int q = ((t + x) & 1) * P + e.row * hN + (x >> 1);
        ph_out[s] = phi[q];
        m0_out[s] = n0[q];
        m1_out[s] = n1[q];
    }

    // Totals in a fixed order: lanes, warps, then the cluster's ranks.
    const int lane = (int)threadIdx.x & 31, warp = (int)threadIdx.x >> 5;
    const double w_r2 = warp_sum(r2), w_dn2 = warp_sum((double)dn2);
    const int w_acc = warp_sum(count);
    if (lane == 0) {
        warp_r2[warp] = w_r2;
        warp_dn2[warp] = w_dn2;
        warp_acc[warp] = w_acc;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        double a = 0.0, b = 0.0;
        int c = 0;
        for (int w = 0; w < (int)(blockDim.x + 31) / 32; ++w) {
            a += warp_r2[w];
            b += warp_dn2[w];
            c += warp_acc[w];
        }
        block_sums[0] = a;
        block_sums[1] = b;
        block_acc = c;
    }
    cluster_sync(cluster, timing, &waited);
    if (rank == 0 && threadIdx.x == 0) {
        double a = 0.0, b = 0.0;
        int c = 0;
        for (int i = 0; i < k; ++i) {
            const double* bs = cluster.map_shared_rank(block_sums, i);
            a += bs[0];
            b += bs[1];
            c += *cluster.map_shared_rank(&block_acc, i);
        }
        sums[2 * chain] = a;
        sums[2 * chain + 1] = b;
        accepted[chain] = c;
    }
    // No block may leave while rank 0 reads its totals.
    cluster_sync(cluster, timing, &waited);
    if (timing && threadIdx.x == 0) {
        cycles[2 * blockIdx.x] = waited;
        cycles[2 * blockIdx.x + 1] = clock64() - start;
    }
}

// The launch configuration of resident_sweeps for B chains under a plan.
struct ResidentLaunch {
    cudaLaunchConfig_t config;
    cudaLaunchAttribute cluster;
    ResidentLaunch(int B, int k, int threads, int shared_bytes, cudaStream_t stream)
        : config{}, cluster{} {
        config.gridDim = dim3((unsigned)(B * k));
        config.blockDim = dim3((unsigned)threads);
        config.dynamicSmemBytes = (size_t)shared_bytes;
        config.stream = stream;
        cluster.id = cudaLaunchAttributeClusterDimension;
        cluster.val.clusterDim.x = (unsigned)k;
        cluster.val.clusterDim.y = 1;
        cluster.val.clusterDim.z = 1;
        config.attrs = &cluster;
        config.numAttrs = 1;
    }
};

// A refused call's error, taken out of the runtime's last-error slot so the
// next launch's check does not report it again.
cudaError_t refused(cudaError_t e) {
    cudaGetLastError();
    return e;
}

// How many clusters of the plan the card runs at once; 0 means the launch
// would be refused.
cudaError_t active_clusters(int k, int threads, int shared_bytes, int* active) {
    cudaError_t e = cudaFuncSetAttribute(resident_sweeps,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, shared_bytes);
    if (e) return refused(e);
    ResidentLaunch launch(1, k, threads, shared_bytes, 0);
    e = cudaOccupancyMaxActiveClusters(active, resident_sweeps, &launch.config);
    return e ? refused(e) : e;
}

}  // namespace

extern "C" {

const char* sv_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// Copies (phi_in, n_in) into (phi, n), then runs `sweeps` sweeps in place:
// two-color passes when colors is null (N even), else one pass per color of
// the table colors (N·N int8, values 0..n_colors-1).  accepted (B,) int32
// receives the accepted site updates; sums (B, 2) double receives Σ_sweeps Σ r²
// and Σ_sweeps Σ (dn)².  r (B, 2, N, N) f32 and the slots (B·bands) of the
// inline sums, slot_r2 double and slot_dn2 int64, are scratch; bands (1..N)
// is the sums' blocks a chain.  W == 0 selects z-mode (W = ∞); p_n < 0 means
// no zero inflation.  chain0 is the global index of the first chain, which
// the chains' draws count from.
int sv_sweeps(const float* phi_in, const int* n_in, float* phi, int* n, float* r,
              double* slot_r2, long long* slot_dn2, int* accepted, double* sums,
              const int8_t* colors, int n_colors, int bands, int B, int N, int sweeps,
              float kappa, int W, float interval_phi, int interval_n, float p_n,
              unsigned long long seed, unsigned int chain0, void* stream_ptr) {
    if (colors == nullptr && (N % 2 != 0 || n_colors != 2)) return cudaErrorInvalidValue;
    if (sweeps < 1 || bands < 1 || bands > N) return cudaErrorInvalidValue;
    cudaStream_t stream = (cudaStream_t)stream_ptr;
    const size_t NN = (size_t)N * N;
    cudaError_t e;
    if ((e = cudaMemcpyAsync(phi, phi_in, B * NN * sizeof(float), cudaMemcpyDeviceToDevice, stream))) return e;
    if ((e = cudaMemcpyAsync(n, n_in, 2 * B * NN * sizeof(int), cudaMemcpyDeviceToDevice, stream))) return e;
    if ((e = cudaMemsetAsync(accepted, 0, B * sizeof(int), stream))) return e;

    const int threads = 256;
    init_residual<<<(unsigned)((B * NN + threads - 1) / threads), threads, 0, stream>>>(phi, n, r, B, N);
    if ((e = cudaGetLastError())) return e;

    const uint2 key = make_uint2((uint32_t)seed, (uint32_t)(seed >> 32));
    const unsigned pass_blocks = (unsigned)((B * NN / 2 + threads - 1) / threads);
    const unsigned table_blocks = (unsigned)((B * NN + threads - 1) / threads);
    for (int sweep = 0; sweep < sweeps; ++sweep) {
        for (int color = 0; color < n_colors; ++color) {
            const uint32_t pass = (uint32_t)(n_colors * sweep + color);
            if (colors == nullptr) {
                color_pass<<<pass_blocks, threads, 0, stream>>>(
                    phi, n, r, accepted, B, N, color, pass, key, chain0, kappa, W, interval_phi,
                    interval_n, p_n);
            } else {
                color_pass_table<<<table_blocks, threads, 0, stream>>>(
                    phi, n, r, accepted, colors, B, N, color, pass, key, chain0, kappa, W,
                    interval_phi, interval_n, p_n);
            }
            if ((e = cudaGetLastError())) return e;
        }
        if ((e = band_sums(r, n, slot_r2, slot_dn2, B, N, bands, sweep == 0, stream))) return e;
    }
    return fold_sums(slot_r2, slot_dn2, sums, B, bands, stream);
}

// One sweep's inline sums of (r, n) as sv_sweeps takes them, alone: sums (B, 2)
// double gets Σ r² and Σ (dn)² of each chain, through the same bands and slots.
int sv_inline_sums(const float* r, const int* n, double* slot_r2, long long* slot_dn2,
                   double* sums, int bands, int B, int N, void* stream_ptr) {
    if (bands < 1 || bands > N) return cudaErrorInvalidValue;
    cudaStream_t stream = (cudaStream_t)stream_ptr;
    cudaError_t e = band_sums(r, n, slot_r2, slot_dn2, B, N, bands, true, stream);
    return e ? e : fold_sums(slot_r2, slot_dn2, sums, B, bands, stream);
}

// The resident regime under the plan (k, hmax, threads, shared_bytes) that
// ops/sweep.py sweep_plan computes from N: reads (phi_in, n_in) and writes
// (phi, n), accepted (B,) int32 and sums (B, 2) double as sv_sweeps does, with
// no scratch; cycles (B·k, 2) int64 or null as resident_sweeps takes it.  A
// plan whose cluster the card cannot schedule returns an error (the runtime's,
// or cudaErrorLaunchOutOfResources) before anything is launched.
int sv_sweeps_resident(const float* phi_in, const int* n_in, float* phi, int* n, int* accepted,
                       double* sums, long long* cycles, int B, int N, int sweeps, float kappa,
                       int W, float interval_phi, int interval_n, float p_n,
                       unsigned long long seed, unsigned int chain0, int k, int hmax, int threads,
                       int shared_bytes, void* stream_ptr) {
    int active = 0;
    cudaError_t e = active_clusters(k, threads, shared_bytes, &active);
    if (e) return e;
    if (active < 1) return cudaErrorLaunchOutOfResources;
    const uint2 key = make_uint2((uint32_t)seed, (uint32_t)(seed >> 32));
    ResidentLaunch launch(B, k, threads, shared_bytes, (cudaStream_t)stream_ptr);
    e = cudaLaunchKernelEx(&launch.config, resident_sweeps, phi_in, n_in, phi, n, accepted, sums,
                           cycles, N, k, hmax, sweeps, key, chain0, kappa, W, interval_phi,
                           interval_n, p_n);
    if (e) return refused(e);
    return cudaGetLastError();
}

// The residual of a batch of padded slabs (B, ·, N, P) into r (B, 2, N, P).
int sv_slab_residual(const float* phi, const int* n, float* r, int B, int N, int P,
                     void* stream_ptr) {
    const int threads = 256;
    const long long sites = (long long)B * N * P;
    init_residual_slab<<<(unsigned)((sites + threads - 1) / threads), threads, 0,
                         (cudaStream_t)stream_ptr>>>(phi, n, r, B, N, P);
    return cudaGetLastError();
}

// One colour pass in place over a batch of padded slabs whose column 0 is
// global column `first`, the slab's own columns being ghost..ghost+width−1;
// accepted (B,) int32 adds the accepts of its own sites.  The Philox pass
// word is the colour, as in the whole torus's first sweep of a call (a step
// of the space-sharded NeighborhoodUpdate is one sweep on a fresh seed); W ==
// 0 z-mode, p_n < 0 no zero inflation, as sv_sweeps takes them.
int sv_slab_color_pass(float* phi, int* n, float* r, int* accepted, int B, int N, int P,
                       int first, int ghost, int width, int color, unsigned long long seed,
                       unsigned int chain0, float kappa, int W, float interval_phi,
                       int interval_n, float p_n, void* stream_ptr) {
    if (N % 2 != 0 || P < 3 || ghost < 1 || width < 1 || ghost + width > P - 1)
        return cudaErrorInvalidValue;
    const int threads = 256;
    const long long sites = (long long)B * N * (P - 2);
    const uint2 key = make_uint2((uint32_t)seed, (uint32_t)(seed >> 32));
    color_pass_slab<<<(unsigned)((sites + threads - 1) / threads), threads, 0,
                      (cudaStream_t)stream_ptr>>>(phi, n, r, accepted, B, N, P, first, ghost,
                                                  width, color, key, chain0, kappa, W,
                                                  interval_phi, interval_n, p_n);
    return cudaGetLastError();
}

// How many clusters of a resident plan the card runs at once, in *active.
int sv_sweeps_resident_clusters(int k, int threads, int shared_bytes, int* active) {
    return active_clusters(k, threads, shared_bytes, active);
}

}  // extern "C"
