// Bloom-filter probe, one thread per query: the Hopper form of the Pallas
// _probe_kernel (repro/kernels/bloom_filter.py:32) and of the per-level
// probe of the fused descent (repro/core/jax_nbtree.py:388-395).
//
// h rounds of 32-bit multiply-xorshift, `% nbits`, a word gather and a bit
// test: bit pos % 32 of word pos / 32.  The arithmetic is uint32_t, so the
// products wrap mod 2^32 exactly as the TPU's uint32 lanes do.
#include "common.cuh"

__constant__ uint32_t kBloomMults[6] = {0x85EBCA6Bu, 0xC2B2AE35u, 0x9E3779B1u,
                                        0x27D4EB2Fu, 0x165667B1u, 0xD3A2646Cu};

__device__ __forceinline__ int probe(const long long* __restrict__ words,
                                     long long key, uint32_t nbits, int h) {
    int hit = 1;
    for (int r = 0; r < h; ++r) {
        uint32_t x = (uint32_t)key * kBloomMults[r];
        x ^= x >> 15;
        x *= 0x2C1B3C6Du;
        x ^= x >> 12;
        x *= 0x297A2D39u;
        x ^= x >> 15;
        const uint32_t pos = x % nbits;
        const uint32_t w = (uint32_t)words[pos >> 5];
        hit &= (int)((w >> (pos & 31u)) & 1u);
    }
    return hit;
}

__global__ void probe_kernel(const long long* __restrict__ words,
                             const long long* __restrict__ q,
                             int* __restrict__ out, uint32_t nbits, int h,
                             int Q) {
    const int t = blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= Q) return;
    out[t] = probe(words, q[t], nbits, h);
}

// Query t probes the filter in table row rows[t].
__global__ void probe_rows_kernel(const long long* __restrict__ table,
                                  long long row_words,
                                  const int* __restrict__ rows,
                                  const long long* __restrict__ q,
                                  bool* __restrict__ out, uint32_t nbits,
                                  int h, int Q) {
    const int t = blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= Q) return;
    out[t] = probe(table + (long long)rows[t] * row_words, q[t], nbits, h);
}

extern "C" int bloom_probe_launch(const long long* words, const long long* q,
                                  int* out, int nbits, int h, int Q,
                                  cudaStream_t stream) {
    const int threads = 256;
    probe_kernel<<<repro_blocks(Q, threads), threads, 0, stream>>>(
        words, q, out, (uint32_t)nbits, h, Q);
    return (int)cudaGetLastError();
}

extern "C" int bloom_probe_rows_launch(const long long* table,
                                       long long row_words, const int* rows,
                                       const long long* q, bool* out,
                                       int nbits, int h, int Q,
                                       cudaStream_t stream) {
    const int threads = 256;
    probe_rows_kernel<<<repro_blocks(Q, threads), threads, 0, stream>>>(
        table, row_words, rows, q, out, (uint32_t)nbits, h, Q);
    return (int)cudaGetLastError();
}
