// Bloom-filter probe, one thread per query: the Hopper form of the Pallas
// _probe_kernel (repro/kernels/bloom_filter.py:32) and of the per-level
// probe of the fused descent (repro/core/jax_nbtree.py:388-395).
//
// H rounds of 32-bit multiply-xorshift, `% nbits`, a word gather and a bit
// test: bit pos % 32 of word pos / 32.  The arithmetic is uint32_t, so the
// products wrap mod 2^32 exactly as the TPU's uint32 lanes do.
//
// What bounds it: latency.  A query moves ~40 bytes, so even 4096 of them
// are a fraction of a microsecond of bytes; what a query waits on is its
// dependent device-memory round trips.  The probe is a template on H (1-6,
// the wrapper rejects anything else), fully unrolled: a thread computes all
// H positions, issues all H word loads through the read-only path and only
// then tests the bits, so it waits one round trip for rows[t] / q[t] and one
// for its words, not one per hash.  The filter rows of a node table are
// cold (the NB-tree path's hold ~0.9 GB), so the second trip goes to device
// memory; a launch carries few queries (~205 on the descent), so the CTA is
// small enough that they spread over several SMs.
#include "common.cuh"

// Threads per CTA, from a sweep on the card (PERF.md).  The build never sets
// it; chip_smoke.py's sweep compiles variants with -D.
#ifndef BP_THREADS
#define BP_THREADS 128
#endif

__constant__ uint32_t kBloomMults[6] = {0x85EBCA6Bu, 0xC2B2AE35u, 0x9E3779B1u,
                                        0x27D4EB2Fu, 0x165667B1u, 0xD3A2646Cu};

template <int H>
__device__ __forceinline__ int probe(const long long* __restrict__ words,
                                     long long key, uint32_t nbits) {
    uint32_t pos[H], w[H];
#pragma unroll
    for (int r = 0; r < H; ++r) {
        uint32_t x = (uint32_t)key * kBloomMults[r];
        x ^= x >> 15;
        x *= 0x2C1B3C6Du;
        x ^= x >> 12;
        x *= 0x297A2D39u;
        x ^= x >> 15;
        pos[r] = x % nbits;
    }
#pragma unroll
    for (int r = 0; r < H; ++r) w[r] = (uint32_t)__ldg(words + (pos[r] >> 5));
    uint32_t hit = 1;
#pragma unroll
    for (int r = 0; r < H; ++r) hit &= w[r] >> (pos[r] & 31u);
    return (int)(hit & 1u);
}

template <int H>
__global__ void __launch_bounds__(BP_THREADS)
probe_kernel(const long long* __restrict__ words,
             const long long* __restrict__ q, int* __restrict__ out,
             uint32_t nbits, int Q) {
    const int t = blockIdx.x * BP_THREADS + threadIdx.x;
    if (t >= Q) return;
    out[t] = probe<H>(words, q[t], nbits);
}

// Query t probes the filter in table row rows[t].
template <int H>
__global__ void __launch_bounds__(BP_THREADS)
probe_rows_kernel(const long long* __restrict__ table, long long row_words,
                  const int* __restrict__ rows,
                  const long long* __restrict__ q, bool* __restrict__ out,
                  uint32_t nbits, int Q) {
    const int t = blockIdx.x * BP_THREADS + threadIdx.x;
    if (t >= Q) return;
    out[t] = probe<H>(table + (long long)rows[t] * row_words, q[t], nbits);
}

// One instantiation per hash count; h outside 1..6 is refused.
#define BP_DISPATCH(h, KERNEL, ...)                                           \
    switch (h) {                                                              \
        case 1: KERNEL<1><<<grid, BP_THREADS, 0, stream>>>(__VA_ARGS__); break; \
        case 2: KERNEL<2><<<grid, BP_THREADS, 0, stream>>>(__VA_ARGS__); break; \
        case 3: KERNEL<3><<<grid, BP_THREADS, 0, stream>>>(__VA_ARGS__); break; \
        case 4: KERNEL<4><<<grid, BP_THREADS, 0, stream>>>(__VA_ARGS__); break; \
        case 5: KERNEL<5><<<grid, BP_THREADS, 0, stream>>>(__VA_ARGS__); break; \
        case 6: KERNEL<6><<<grid, BP_THREADS, 0, stream>>>(__VA_ARGS__); break; \
        default: return (int)cudaErrorInvalidValue;                           \
    }

extern "C" int bloom_probe_launch(const long long* words, const long long* q,
                                  int* out, int nbits, int h, int Q,
                                  cudaStream_t stream) {
    const int grid = repro_blocks(Q, BP_THREADS);
    BP_DISPATCH(h, probe_kernel, words, q, out, (uint32_t)nbits, Q)
    return (int)cudaGetLastError();
}

extern "C" int bloom_probe_rows_launch(const long long* table,
                                       long long row_words, const int* rows,
                                       const long long* q, bool* out,
                                       int nbits, int h, int Q,
                                       cudaStream_t stream) {
    const int grid = repro_blocks(Q, BP_THREADS);
    BP_DISPATCH(h, probe_rows_kernel, table, row_words, rows, q, out,
                (uint32_t)nbits, Q)
    return (int)cudaGetLastError();
}
