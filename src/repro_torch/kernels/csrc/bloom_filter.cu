// Bloom filters: the probe, one thread per query (the Hopper form of the
// Pallas _probe_kernel, repro/kernels/bloom_filter.py:32, and of the
// per-level probe of the fused descent, repro/core/jax_nbtree.py:388-395),
// and the build and O(batch) update of the write path, one CTA per filter
// row (no TPU kernel: the JAX package leaves the build to XLA).
//
// Both take their bit positions from one device function, bloom_positions:
// H rounds of 32-bit multiply-xorshift and `% nbits`; bit pos % 32 of word
// pos / 32.  The arithmetic is uint32_t, so the products wrap mod 2^32
// exactly as the TPU's uint32 lanes do.
//
// Probe.  What bounds it: latency.  A query moves ~40 bytes, so even 4096
// of them are a fraction of a microsecond of bytes; what a query waits on is
// its dependent device-memory round trips.  The probe is a template on H
// (1-6, the wrapper rejects anything else), fully unrolled: a thread
// computes all H positions, issues all H word loads through the read-only
// path and only then tests the bits, so it waits one round trip for
// rows[t] / q[t] and one for its words, not one per hash.  The filter rows
// of a node table are cold (the NB-tree path's hold ~0.9 GB), so the second
// trip goes to device memory; a launch carries few queries (~205 on the
// descent), so the CTA is small enough that they spread over several SMs.
//
// Build and update.  They replace a chain of ~90 small PyTorch passes
// (kernels/ref.py::bloom_build_ref: the 16-bit-half multiplies, a zeroed
// (rows, nbits) int64 cell array, a scatter-amax and a 32-cell pack), which
// the write path ran from the host on every insert, flush and split; what
// they cost was host calls, so one launch is the point.  What bounds the
// kernel: its bytes do not.  At the flush shape (5 rows of 21,504 keys,
// nbits 217,088) it reads 0.86 MB of keys and writes 0.27 MB of words,
// ~0.34 us at 3.35 TB/s, under the ~1-2 us launch floor; it takes ~12 us
// (PERF.md), as one SM hashes each row's live keys.  One CTA owns one row:
// it holds the row's nbits / 32 words as uint32 in dynamic shared memory
// (27,136 B at nbits 217,088), zeroed or loaded from the old filter (the
// update), ORs every key's H bits into them with shared-memory atomicOr
// (order-free, so the words are the plain version's bit for bit; KEY_MAX
// padding sets none), and writes the row out once as int64 words with a
// zero high half, so the output needs no zero pass of its own.  A row whose
// words pass the shared memory a CTA may take (BB_MAX_SMEM: nbits over
// 1,859,584) does the same in the output row itself, with 64-bit atomicOr
// on device memory; nbits alone picks the path.  Keys are read
// BB_UNROLL a thread before any is hashed, so a thread waits one round
// trip a round, not one a key.
#include "common.cuh"

// Threads per probe CTA, from a sweep on the card (PERF.md).  The build
// never sets it; chip_smoke.py's sweep compiles variants with -D.
#ifndef BP_THREADS
#define BP_THREADS 128
#endif

// Threads per build CTA (one CTA a filter row) and keys a thread loads
// before it hashes them.
#define BB_THREADS 1024
#define BB_UNROLL 4
// Dynamic shared memory a CTA may take on the H100 (232,448 B): a row of
// more words than this / 4 is built in device memory.  The build never sets
// it; chip_smoke.py compiles a variant with -DBB_MAX_SMEM=0 to time the
// device-memory body at the cells' shapes.
#ifndef BB_MAX_SMEM
#define BB_MAX_SMEM 232448
#endif
// Dynamic shared memory a launch may take without opting in.
#define BB_DEFAULT_SMEM 49152

__constant__ uint32_t kBloomMults[6] = {0x85EBCA6Bu, 0xC2B2AE35u, 0x9E3779B1u,
                                        0x27D4EB2Fu, 0x165667B1u, 0xD3A2646Cu};

// The key's H bit positions in a filter of nbits bits (build and probe).
template <int H>
__device__ __forceinline__ void bloom_positions(long long key, uint32_t nbits,
                                                uint32_t (&pos)[H]) {
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
}

template <int H>
__device__ __forceinline__ int probe(const long long* __restrict__ words,
                                     long long key, uint32_t nbits) {
    uint32_t pos[H], w[H];
    bloom_positions<H>(key, nbits, pos);
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

// One CTA builds filter row blockIdx.x from that row's N keys: old (the
// update's filter, rows of nw words) or zero, ORed with every key's bits.
// SMEM: the row's words live in shared memory until the one write-out;
// else they are built in the output row with device-memory atomics.
template <int H, bool SMEM>
__global__ void __launch_bounds__(BB_THREADS)
bloom_build_kernel(const long long* __restrict__ keys,
                   const long long* __restrict__ old,
                   long long* __restrict__ out, int N, int nw,
                   uint32_t nbits) {
    extern __shared__ uint32_t bb_words[];
    const int tid = threadIdx.x;
    const long long* k = keys + (long long)blockIdx.x * N;
    long long* o = out + (long long)blockIdx.x * nw;
    const long long* p = old ? old + (long long)blockIdx.x * nw : nullptr;
    for (int i = tid; i < nw; i += BB_THREADS) {
        const uint32_t w = p ? (uint32_t)p[i] : 0u;
        if constexpr (SMEM) bb_words[i] = w;
        else o[i] = (long long)w;
    }
    __syncthreads();
    for (int base = 0; base < N; base += BB_THREADS * BB_UNROLL) {
        long long key[BB_UNROLL];
#pragma unroll
        for (int u = 0; u < BB_UNROLL; ++u) {
            const int i = base + u * BB_THREADS + tid;
            key[u] = i < N ? __ldg(k + i) : REPRO_KEY_MAX;
        }
#pragma unroll
        for (int u = 0; u < BB_UNROLL; ++u) {
            if (key[u] == REPRO_KEY_MAX) continue;       // padding: no bits
            uint32_t pos[H];
            bloom_positions<H>(key[u], nbits, pos);
#pragma unroll
            for (int r = 0; r < H; ++r) {
                if constexpr (SMEM)
                    atomicOr(bb_words + (pos[r] >> 5), 1u << (pos[r] & 31u));
                else
                    atomicOr((unsigned long long*)(o + (pos[r] >> 5)),
                             1ull << (pos[r] & 31u));
            }
        }
    }
    if constexpr (SMEM) {
        __syncthreads();
        for (int i = tid; i < nw; i += BB_THREADS)
            o[i] = (long long)bb_words[i];
    }
}

template <int H>
static int bloom_build_h(const long long* keys, const long long* old,
                         long long* out, int R, int N, int nw, uint32_t nbits,
                         cudaStream_t stream) {
    const size_t smem = (size_t)nw * sizeof(uint32_t);
    if (smem > BB_MAX_SMEM) {
        bloom_build_kernel<H, false><<<R, BB_THREADS, 0, stream>>>(
            keys, old, out, N, nw, nbits);
        return (int)cudaGetLastError();
    }
    auto kernel = bloom_build_kernel<H, true>;
    // the opt-in holds for the current device's context only, so a row over
    // the default asks on every launch (a cheap call)
    if (smem > BB_DEFAULT_SMEM) {
        const cudaError_t attr = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (attr != cudaSuccess) return (int)attr;
    }
    kernel<<<R, BB_THREADS, smem, stream>>>(keys, old, out, N, nw, nbits);
    return (int)cudaGetLastError();
}

// R filter rows of nbits bits from R rows of N keys (row-major, int64 uint32
// values); old is null for a build, else R rows of nbits / 32 words to OR
// onto.  The wrapper checks shapes; nbits % 32 and h outside 1..6 are
// refused here too.
extern "C" int bloom_build_launch(const long long* keys, const long long* old,
                                  long long* out, int R, int N, int nbits,
                                  int h, cudaStream_t stream) {
    if (nbits <= 0 || nbits % 32 || R <= 0 || N < 0)
        return (int)cudaErrorInvalidValue;
    const int nw = nbits / 32;
    const uint32_t nb = (uint32_t)nbits;
    switch (h) {
        case 1: return bloom_build_h<1>(keys, old, out, R, N, nw, nb, stream);
        case 2: return bloom_build_h<2>(keys, old, out, R, N, nw, nb, stream);
        case 3: return bloom_build_h<3>(keys, old, out, R, N, nw, nb, stream);
        case 4: return bloom_build_h<4>(keys, old, out, R, N, nw, nb, stream);
        case 5: return bloom_build_h<5>(keys, old, out, R, N, nw, nb, stream);
        case 6: return bloom_build_h<6>(keys, old, out, R, N, nw, nb, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}
