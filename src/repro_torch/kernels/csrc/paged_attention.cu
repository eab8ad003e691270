// Decode attention over a paged KV cache, one query token per sequence: the
// Hopper form of the Pallas _paged_attn_kernel
// (repro/kernels/paged_attention.py:35, pallas_call at :95).
//
// One CTA per (sequence b, KV head h) walks the pages block_tables[b, 0..MP)
// in order and carries the fp32 online-softmax state (m, l, acc) of the G
// query heads of that KV head in shared memory, where the Pallas kernel
// carries it in VMEM scratch across its sequential page axis.  It takes
// the pages in rounds of up to PA_CHUNK slots (8 pages of 8 slots at the
// serving shapes).  Per round the CTA copies the round's K and V pages
// into shared memory with asynchronous copies (cp.async), then one warp
// per slot scores (lanes over D, a shuffle sum), one warp per query head
// rescales, and one thread per (query head, d) accumulates p @ V.  When
// B*KVH CTAs would leave SMs idle, each (b, kv head)'s query heads are
// split over several CTAs (PA_MIN_CTAS), which read the same pages.  Slots at or past seq_lens[b] score -1e30, a finite value
// as in Pallas, so an empty sequence averages V over every gathered slot.
// The division by l guards l == 0 as Pallas does.
//
// Bytes bound it: each K and V element of the named pages is read once
// (~2 flops per byte).  At the serving shapes each CTA still walks its 36
// pages in five dependent rounds, so the kernel is latency-bound.  Split-K
// over pages, double-buffered staging (TMA) and wgmma are left for later.
#include <cuda_bf16.h>

#include "common.cuh"

#define PA_NEG_INF (-1e30f)
#define PA_THREADS 256
#define PA_CHUNK 64
#define PA_TILE 16384
#define PA_MIN_CTAS 132
#define PA_MAX_SMEM 232448

__device__ __forceinline__ float pa_load(const float* p, long long i) {
    return p[i];
}
__device__ __forceinline__ float pa_load(const __nv_bfloat16* p, long long i) {
    return __bfloat162float(p[i]);
}
__device__ __forceinline__ void pa_store(float* p, long long i, float x) {
    p[i] = x;
}
__device__ __forceinline__ void pa_store(__nv_bfloat16* p, long long i, float x) {
    p[i] = __float2bfloat16(x);
}

__device__ __forceinline__ float pa_warp_sum(float x) {
    for (int o = 16; o; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    return x;
}
__device__ __forceinline__ float pa_warp_max(float x) {
    for (int o = 16; o; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
    return x;
}

// Pages per round: whole pages, at most PA_CHUNK slots and PA_TILE floats
// of K (and of V) per round; one page if a page is larger.
__host__ __device__ __forceinline__ int pa_pages_per_round(int S, int D) {
    const int slots = PA_TILE / D < PA_CHUNK ? PA_TILE / D : PA_CHUNK;
    return slots >= S ? slots / S : 1;
}

// Shared memory bytes for a CTA of G query heads: q (G*D), acc (G*D),
// scores (G*C), m, l, alpha (G each) as floats, the round's page ids
// (ppc ints), then the round's K and V tiles (C rows of D) in the pages'
// own type.
__host__ __device__ __forceinline__ long long pa_smem_bytes(int G, int D, int ppc,
                                                            int S, int kv_bytes) {
    return 4LL * (2LL * G * D + (long long)G * ppc * S + 3LL * G + ppc)
           + 2LL * ppc * S * D * kv_bytes;
}

// Asynchronous 4-byte copy from device to shared memory (sm_80+): a thread
// issues all of its copies of a round before it waits on any.
__device__ __forceinline__ void pa_cp_async4(void* dst, const void* src) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(PA_THREADS)
paged_attention_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k_pages,
                       const TKV* __restrict__ v_pages,
                       const int* __restrict__ block_tables,
                       const int* __restrict__ seq_lens, TQ* __restrict__ out,
                       int KVH, int G_all, int D, int P, int S, int MP,
                       int GC, float scale) {
    extern __shared__ float smem[];
    const int n_gc = (G_all + GC - 1) / GC;    // CTAs per (b, kv head)
    const int bh = blockIdx.x / n_gc, g0 = (blockIdx.x - bh * n_gc) * GC;
    const int G = min(GC, G_all - g0);         // this CTA's query heads
    const int ppc = pa_pages_per_round(S, D), C = ppc * S, GD = G * D;
    float* qs = smem;
    float* acc = qs + GD;
    float* sc = acc + GD;
    float* m = sc + G * C;
    float* l = m + G;
    float* alpha = l + G;
    int* pg = (int*)(alpha + G);
    TKV* ks = (TKV*)(pg + ppc);
    TKV* vs = ks + C * D;

    const int b = bh / KVH, h = bh - b * KVH;
    const int tid = threadIdx.x, nt = blockDim.x;
    const int lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5;
    const long long qoff = ((long long)bh * G_all + g0) * D;
    for (int i = tid; i < GD; i += nt) {
        qs[i] = pa_load(q, qoff + i);
        acc[i] = 0.f;
    }
    for (int g = tid; g < G; g += nt) {
        m[g] = PA_NEG_INF;
        l[g] = 0.f;
    }
    const int len = seq_lens[b];
    const long long page_elems = (long long)S * D;
    const int page_words = (int)(page_elems * sizeof(TKV) / 4);   // S*D even for bf16
    const TKV* k_head = k_pages + (long long)h * P * page_elems;
    const TKV* v_head = v_pages + (long long)h * P * page_elems;

    for (int p0 = 0; p0 < MP; p0 += ppc) {
        const int np = min(ppc, MP - p0), nc = np * S;
        for (int i = tid; i < np; i += nt) pg[i] = block_tables[(long long)b * MP + p0 + i];
        __syncthreads();
        // stage the round's K and V pages as they are, page after page (a
        // page is S*D contiguous elements), in 4-byte asynchronous copies:
        // neighbouring threads on neighbouring words, every copy in flight
        // before the wait
        for (int pi = 0; pi < np; ++pi) {
            const unsigned* kpg = (const unsigned*)(k_head + pg[pi] * page_elems);
            const unsigned* vpg = (const unsigned*)(v_head + pg[pi] * page_elems);
            unsigned* kt = (unsigned*)(ks + pi * page_elems);
            unsigned* vt = (unsigned*)(vs + pi * page_elems);
            for (int j = tid; j < page_words; j += nt) {
                pa_cp_async4(kt + j, kpg + j);
                pa_cp_async4(vt + j, vpg + j);
            }
        }
        asm volatile("cp.async.wait_all;\n" ::);
        __syncthreads();
        // scores (G, nc): one warp per slot, lanes over D, a shuffle sum
        const int valid = len - p0 * S;       // slots of this round below seq_len
        for (int c = warp; c < nc; c += nwarps) {
            const TKV* kr = ks + c * D;
            for (int g = 0; g < G; ++g) {
                const float* qr = qs + g * D;
                float part = 0.f;
                for (int d = lane; d < D; d += 32) part += qr[d] * pa_load(kr, d);
                part = pa_warp_sum(part);
                if (lane == 0) sc[g * C + c] = c < valid ? part * scale : PA_NEG_INF;
            }
        }
        __syncthreads();
        // online softmax: one warp per query head
        for (int g = warp; g < G; g += nwarps) {
            float* row = sc + g * C;
            float mc = PA_NEG_INF;
            for (int c = lane; c < nc; c += 32) mc = fmaxf(mc, row[c]);
            mc = pa_warp_max(mc);
            const float m_prev = m[g];
            const float m_new = fmaxf(m_prev, mc);
            float sum = 0.f;
            for (int c = lane; c < nc; c += 32) {
                const float e = expf(row[c] - m_new);
                row[c] = e;
                sum += e;
            }
            sum = pa_warp_sum(sum);
            if (lane == 0) {
                const float a = expf(m_prev - m_new);
                alpha[g] = a;
                l[g] = a * l[g] + sum;
                m[g] = m_new;
            }
        }
        __syncthreads();
        // acc (G, D) = acc * alpha + p @ V, one thread per (g, d)
        for (int i = tid; i < GD; i += nt) {
            const int g = i / D, d = i - g * D;
            const float* row = sc + g * C;
            float pv = 0.f;
            for (int c = 0; c < nc; ++c) pv += row[c] * pa_load(vs, (long long)c * D + d);
            acc[i] = acc[i] * alpha[g] + pv;
        }
        __syncthreads();
    }
    __syncthreads();                          // MP == 0: no round synced the init
    for (int i = tid; i < GD; i += nt) {
        const float lg = l[i / D];
        pa_store(out, qoff + i, acc[i] / (lg == 0.f ? 1.f : lg));
    }
}

template <typename TQ, typename TKV>
static int pa_launch(const void* q, const void* k_pages, const void* v_pages,
                     const int* block_tables, const int* seq_lens, void* out,
                     int B, int KVH, int G, int D, int P, int S, int MP,
                     float scale, cudaStream_t stream) {
    // Split each (b, kv head)'s G query heads over CTAs until the grid
    // covers the card's SMs: CTAs of one (b, h) read the same pages, the
    // later ones from L2.
    const int split = (PA_MIN_CTAS + B * KVH - 1) / (B * KVH);
    const int GC = (G + (split < G ? split : G) - 1) / (split < G ? split : G);
    const int ppc = pa_pages_per_round(S, D);
    const long long smem = pa_smem_bytes(GC, D, ppc, S, (int)sizeof(TKV));
    if (smem > PA_MAX_SMEM) return (int)cudaErrorInvalidValue;
    auto kernel = paged_attention_kernel<TQ, TKV>;
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    kernel<<<B * KVH * ((G + GC - 1) / GC), PA_THREADS, (size_t)smem, stream>>>(
        (const TQ*)q, (const TKV*)k_pages, (const TKV*)v_pages, block_tables,
        seq_lens, (TQ*)out, KVH, G, D, P, S, MP, GC, scale);
    return (int)cudaGetLastError();
}

extern "C" int paged_attention_launch(const void* q, const void* k_pages,
                                      const void* v_pages,
                                      const int* block_tables,
                                      const int* seq_lens, void* out, int B,
                                      int KVH, int G, int D, int P, int S,
                                      int MP, float scale, int q_bf16,
                                      int kv_bf16, cudaStream_t stream) {
    if (q_bf16 && kv_bf16)
        return pa_launch<__nv_bfloat16, __nv_bfloat16>(
            q, k_pages, v_pages, block_tables, seq_lens, out, B, KVH, G, D, P,
            S, MP, scale, stream);
    if (q_bf16)
        return pa_launch<__nv_bfloat16, float>(
            q, k_pages, v_pages, block_tables, seq_lens, out, B, KVH, G, D, P,
            S, MP, scale, stream);
    if (kv_bf16)
        return pa_launch<float, __nv_bfloat16>(
            q, k_pages, v_pages, block_tables, seq_lens, out, B, KVH, G, D, P,
            S, MP, scale, stream);
    return pa_launch<float, float>(q, k_pages, v_pages, block_tables, seq_lens,
                                   out, B, KVH, G, D, P, S, MP, scale, stream);
}
