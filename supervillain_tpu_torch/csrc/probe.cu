// A measurement probe, not a kernel of the port: one thread follows a chain of
// dependent loads, i = next[i], so that a call's time over its steps is one
// round trip of a load: to device memory through a buffer much larger than
// the L2 cache, to the L2 cache through a warmed buffer that fits in it.
// chip_smoke.py takes it as the latency of one round of a worm's loads, the
// floor under a kernel whose moves each wait for loads at addresses set by
// the move before (K1 csrc/worm.cu through device memory, K2
// csrc/worldline_worm_general.cu through a buffer the size of its working set).
#include <cuda_runtime.h>

namespace {

__global__ void pointer_chase_kernel(const int* __restrict__ next, int steps, int start,
                                     int* __restrict__ out) {
    int i = start;
    for (int s = 0; s < steps; ++s) i = next[i];
    *out = i;  // keeps the chain from being optimised away
}

}  // namespace

extern "C" {

// Follows `steps` links of `next` from `start` on one thread, writing the end
// of the chain to out[0].
int sv_pointer_chase(const int* next, int steps, int start, int* out, void* stream_ptr) {
    pointer_chase_kernel<<<1, 1, 0, (cudaStream_t)stream_ptr>>>(next, steps, start, out);
    return cudaGetLastError();
}

}  // extern "C"
