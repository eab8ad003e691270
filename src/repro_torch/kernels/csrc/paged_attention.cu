// Decode attention over a paged KV cache, one query token per sequence: the
// Hopper form of the Pallas _paged_attn_kernel
// (repro/kernels/paged_attention.py:35, pallas_call at :95).
//
// What bounds it: bytes.  Every K and V element of the named pages is read
// once (~2 flops per byte): 9.4 MB at the serving shapes (B=4, KVH=8, G=4,
// D=128, S=8, MP=36, fp32 pages), 2.8 us at 3.35 TB/s.  What keeps a kernel
// from that at these sizes is latency: a CTA's chain of dependent steps
// (page ids, staging, scoring, softmax, p @ V, combining) costs more than
// its share of the bytes.
//
// Design: split-K over pages (flash-decoding).  The grid is (B*KVH*HG) x NS.
// A CTA holds up to GB query heads of one KV head (HG = ceil(G / GB) head
// groups; GB = 4 or 8, so at the serving shapes one CTA carries all G heads
// of its KV head, and each named K and V byte is read from device memory
// once).  Split s takes the pages [s*pps, (s+1)*pps) of block_tables[b];
// NS comes from B, KVH and MP alone (pa_splits: the fewest splits that
// give PA_SPLIT_CTAS CTAs, at most MP), never from seq_lens, so choosing
// it needs no sync.
//  1. Staging: the split's pages go into shared memory in chunks of up to
//     PA_CHUNK_SLOTS slots, with 16-byte cp.async (a page is S*D contiguous
//     elements; the wrapper checks 16-byte alignment), in a ring of
//     PA_STAGES chunks: the next two chunks' copies are in flight while a
//     chunk is used, so at the serving shapes a split's pages are all
//     requested before its first chunk is scored.
//  2. Each warp takes blocks of 4 slots of a chunk and keeps its own fp32
//     online-softmax state (m, l, acc) in registers: 8 lanes per slot score
//     it against every head of the group (4-wide pieces of D, one load of
//     K for all heads, a 3-step shuffle sum), two more shuffles give the
//     block's max and sum, and each lane adds p @ V for its 4-wide pieces
//     of D.  No barrier inside a chunk: only the ring's two per chunk.
//  3. The 8 warps' states merge through shared memory into the CTA's
//     partial (m, l, acc[GB, D]).  With NS == 1 that is the output;
//     otherwise it goes to the wrapper's fp32 workspace, and the last CTA of
//     each (b, h, head group) to arrive, found by an atomic ticket that it
//     resets to 0, combines the splits: m* = max m_s, l = sum e^(m_s - m*)
//     l_s, out = sum e^(m_s - m*) acc_s / l, with every split's partial
//     fetched in one round (cp.async for acc) into shared memory.  One
//     launch.
// Slots at or past seq_lens[b] score -1e30, a finite value as in Pallas: a
// split wholly past the sequence has m = -1e30 and weighs exactly 0, and an
// empty sequence averages V over every gathered slot.  Slots past a chunk's
// end score -inf and weigh nothing.  The division by l guards l == 0 as
// Pallas does.  D must be a multiple of 32 and at most 256.
//
// Left: the dot products run on the CUDA cores (wgmma does not pay at G = 4
// query rows); a CTA still waits two dependent device-memory round trips
// (page ids, then its first chunk) before it computes, and a split's
// partial one more (the ticket) before the combine.
#include <cuda_bf16.h>

#include "common.cuh"

#define PA_NEG_INF (-1e30f)
#define PA_THREADS 256
#define PA_WARPS (PA_THREADS / 32)
#define PA_CHUNK_SLOTS 32      // slots per staged chunk (whole pages)
#define PA_STAGE_BYTES 65536   // K + V bytes of one chunk (one page if more)
#define PA_STAGES 3            // chunks of the ring: two in flight while one is used
#define PA_MAX_D 256           // a lane holds D / 128 4-wide pieces, at most 2
#define PA_MAX_SMEM 232448
#define PA_MAX_SPLITS 16       // bounds the combine's shared memory
// CTAs the split aims at, from a sweep on the card (PERF.md); the build
// never sets it, chip_smoke.py's sweep compiles variants with -D.
#ifndef PA_SPLIT_CTAS
#define PA_SPLIT_CTAS 256
#endif

__device__ __forceinline__ float pa_load(const float* p, long long i) {
    return p[i];
}
__device__ __forceinline__ float pa_load(const __nv_bfloat16* p, long long i) {
    return __bfloat162float(p[i]);
}
// Four consecutive elements (16 bytes of fp32, 8 of bf16) as floats; p is
// aligned to them (D is a multiple of 32).
__device__ __forceinline__ float4 pa_load4(const float* p) {
    return *(const float4*)p;
}
__device__ __forceinline__ float4 pa_load4(const __nv_bfloat16* p) {
    const uint2 u = *(const uint2*)p;
    const float2 lo = __bfloat1622float2(*(const __nv_bfloat162*)&u.x);
    const float2 hi = __bfloat1622float2(*(const __nv_bfloat162*)&u.y);
    return make_float4(lo.x, lo.y, hi.x, hi.y);
}
__device__ __forceinline__ void pa_store(float* p, long long i, float x) {
    p[i] = x;
}
__device__ __forceinline__ void pa_store(__nv_bfloat16* p, long long i, float x) {
    p[i] = __float2bfloat16(x);
}

__device__ __forceinline__ void pa_cp_async16(void* dst, const void* src) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void pa_cp_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void pa_cp_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Splits of each (b, kv head): the fewest that give PA_SPLIT_CTAS CTAs, at
// most MP and PA_MAX_SPLITS, then as many as whole runs of ceil(MP / splits) pages need (no
// split is empty).
static int pa_splits(int B, int KVH, int MP) {
    const int bh = B * KVH > 0 ? B * KVH : 1;
    int ns = (PA_SPLIT_CTAS + bh - 1) / bh;
    ns = ns < MP ? ns : MP;
    ns = ns < PA_MAX_SPLITS ? ns : PA_MAX_SPLITS;
    if (ns < 1) return 1;
    const int pps = (MP + ns - 1) / ns;
    return (MP + pps - 1) / pps;
}

// Pages per staged chunk: whole pages, at most PA_CHUNK_SLOTS slots and
// PA_STAGE_BYTES of K and V; one page if a page is larger.
__host__ __device__ __forceinline__ int pa_pages_per_chunk(int S, int D,
                                                           int kv_bytes) {
    const int by_slots = PA_CHUNK_SLOTS / S;
    const int by_bytes = (int)(PA_STAGE_BYTES / (2LL * S * D * kv_bytes));
    const int ppc = by_slots < by_bytes ? by_slots : by_bytes;
    return ppc > 1 ? ppc : 1;
}

// Bytes of the first region of shared memory: the ring (PA_STAGES stages of
// ppc pages of K, then of V, in the pages' own type) while the pages stream,
// then the warps' states (m, l: PA_WARPS x GB each; acc: PA_WARPS x GB x D)
// for the merge, then the splits' acc (NS x GB x D) for the combine.  A
// multiple of 16.
__host__ __device__ __forceinline__ long long pa_region_bytes(int GB, int D,
                                                              int S, int ppc,
                                                              int NS,
                                                              int kv_bytes) {
    const long long ring = 2LL * PA_STAGES * ppc * S * D * kv_bytes;
    const long long merge = 4LL * PA_WARPS * GB * (2 + D);
    const long long comb = 4LL * NS * GB * D;
    long long r = ring > merge ? ring : merge;
    r = r > comb ? r : comb;
    return (r + 15) / 16 * 16;
}

// Shared memory: the region above, then as floats q (GB*D), the combine's
// weights and l (NS x GB each) and totals (GB), then the split's page ids
// (pps ints) and the last-CTA flag.  No static shared memory: the kernel
// may take all of PA_MAX_SMEM.
__host__ __device__ __forceinline__ long long pa_smem_bytes(int GB, int D, int S,
                                                            int ppc, int pps,
                                                            int NS,
                                                            int kv_bytes) {
    return pa_region_bytes(GB, D, S, ppc, NS, kv_bytes)
           + 4LL * ((long long)GB * D + 2LL * NS * GB + GB + pps + 1);
}

// Issue chunk c's copies into stage c % PA_STAGES of the ring: page after
// page, neighbouring threads on neighbouring 16 bytes.
template <typename TKV>
__device__ __forceinline__ void pa_stage(TKV* ring, const TKV* k_head,
                                         const TKV* v_head, const int* pg,
                                         int c, int ppc, int n_pages,
                                         long long page_elems,
                                         long long stage_elems, int page_vecs,
                                         int tid) {
    const int p0 = c * ppc, np = min(ppc, n_pages - p0);
    uint4* ks = (uint4*)(ring + (c % PA_STAGES) * stage_elems);
    uint4* vs = (uint4*)(ring + (c % PA_STAGES) * stage_elems + ppc * page_elems);
    for (int pi = 0; pi < np; ++pi) {
        const long long off = (long long)pg[p0 + pi] * page_elems;
        const uint4* kpg = (const uint4*)(k_head + off);
        const uint4* vpg = (const uint4*)(v_head + off);
        for (int j = tid; j < page_vecs; j += PA_THREADS) {
            pa_cp_async16(ks + pi * page_vecs + j, kpg + j);
            pa_cp_async16(vs + pi * page_vecs + j, vpg + j);
        }
    }
}

template <typename TQ, typename TKV, int GB>
__global__ void __launch_bounds__(PA_THREADS)
paged_attention_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k_pages,
                       const TKV* __restrict__ v_pages,
                       const int* __restrict__ block_tables,
                       const int* __restrict__ seq_lens, TQ* __restrict__ out,
                       float* __restrict__ ws, unsigned* __restrict__ tickets,
                       int KVH, int G, int D, int P, int S, int MP, int NS,
                       int pps, int ppc, float scale) {
    extern __shared__ __align__(16) unsigned char pa_smem[];
    const long long page_elems = (long long)S * D;
    const long long stage_elems = 2LL * ppc * page_elems;     // K, then V
    const long long region = pa_region_bytes(GB, D, S, ppc, NS, (int)sizeof(TKV));
    TKV* ring = (TKV*)pa_smem;
    float* wm = (float*)pa_smem;              // the merge, once the ring is done
    float* wl = wm + PA_WARPS * GB;
    float* wa = wl + PA_WARPS * GB;
    float* qs = (float*)(pa_smem + region);
    float* cw = qs + GB * D;                  // combine: m, then weights
    float* cl = cw + NS * GB;
    float* cL = cl + NS * GB;
    int* pg = (int*)(cL + GB);
    int* is_last = pg + pps;

    const int HG = (G + GB - 1) / GB;
    const int split = blockIdx.x % NS, bhg = blockIdx.x / NS;
    const int hg = bhg % HG, bh = bhg / HG;
    const int b = bh / KVH, h = bh - b * KVH;
    const int g0 = hg * GB, Gc = min(GB, G - g0);     // this CTA's heads
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int grp = lane >> 3, seg = lane & 7;        // slot of 4, lane in it
    const int p_begin = split * pps;
    const int n_pages = max(0, min(MP, p_begin + pps) - p_begin);
    const long long qoff = ((long long)bh * G + g0) * D;
    for (int i = tid; i < n_pages; i += PA_THREADS)
        pg[i] = block_tables[(long long)b * MP + p_begin + i];
    for (int i = tid; i < GB * D; i += PA_THREADS)
        qs[i] = i < Gc * D ? pa_load(q, qoff + i) : 0.f;
    const int len = seq_lens[b];
    __syncthreads();

    float m[GB], l[GB];
    float4 acc[PA_MAX_D / 128][GB];
#pragma unroll
    for (int g = 0; g < GB; ++g) {
        m[g] = PA_NEG_INF;
        l[g] = 0.f;
#pragma unroll
        for (int k = 0; k < PA_MAX_D / 128; ++k) acc[k][g] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    const int page_vecs = (int)(page_elems * sizeof(TKV) / 16);
    const TKV* k_head = k_pages + (long long)h * P * page_elems;
    const TKV* v_head = v_pages + (long long)h * P * page_elems;
    const int n_chunks = (n_pages + ppc - 1) / ppc;
    // one cp.async group per chunk (empty past the last), PA_STAGES - 1 of
    // them in flight while a chunk is used
    for (int c = 0; c < PA_STAGES - 1; ++c) {
        if (c < n_chunks)
            pa_stage(ring, k_head, v_head, pg, c, ppc, n_pages, page_elems,
                     stage_elems, page_vecs, tid);
        pa_cp_commit();
    }
    for (int c = 0; c < n_chunks; ++c) {
        if (c + PA_STAGES - 1 < n_chunks)         // into the stage of c - 1
            pa_stage(ring, k_head, v_head, pg, c + PA_STAGES - 1, ppc, n_pages,
                     page_elems, stage_elems, page_vecs, tid);
        pa_cp_commit();
        pa_cp_wait<PA_STAGES - 1>();              // chunk c has landed
        __syncthreads();
        const TKV* ks = ring + (c % PA_STAGES) * stage_elems;
        const TKV* vs = ks + ppc * page_elems;
        const int nc = min(ppc, n_pages - c * ppc) * S;
        const int valid = len - (p_begin + c * ppc) * S;   // live slots here
        for (int sb = warp * 4; sb < nc; sb += PA_WARPS * 4) {   // warp-uniform
            const int cc = sb + grp;
            const TKV* kr = ks + (long long)(cc < nc ? cc : 0) * D;
            float s[GB];
#pragma unroll
            for (int g = 0; g < GB; ++g) s[g] = 0.f;
            for (int d = 4 * seg; d < D; d += 32) {
                const float4 k4 = pa_load4(kr + d);
#pragma unroll
                for (int g = 0; g < GB; ++g) {
                    const float4 q4 = *(const float4*)(qs + g * D + d);
                    s[g] += q4.x * k4.x + q4.y * k4.y + q4.z * k4.z + q4.w * k4.w;
                }
            }
            float p[GB];
#pragma unroll
            for (int g = 0; g < GB; ++g) {
                float x = s[g];
                x += __shfl_xor_sync(0xffffffffu, x, 4);
                x += __shfl_xor_sync(0xffffffffu, x, 2);
                x += __shfl_xor_sync(0xffffffffu, x, 1);
                x = cc >= nc ? -INFINITY : (cc < valid ? x * scale : PA_NEG_INF);
                float mx = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 8));
                mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
                const float m_new = fmaxf(m[g], mx);
                const float alpha = expf(m[g] - m_new);
                p[g] = expf(x - m_new);                    // this lane's slot
                float ps = p[g];
                ps += __shfl_xor_sync(0xffffffffu, ps, 8);
                ps += __shfl_xor_sync(0xffffffffu, ps, 16);
                l[g] = l[g] * alpha + ps;
                m[g] = m_new;
#pragma unroll
                for (int k = 0; k < PA_MAX_D / 128; ++k) {
                    acc[k][g].x *= alpha;
                    acc[k][g].y *= alpha;
                    acc[k][g].z *= alpha;
                    acc[k][g].w *= alpha;
                }
            }
            // p @ V: lane holds the 4-wide pieces d = 4*lane + 128*k
#pragma unroll
            for (int t = 0; t < 4; ++t) {
                if (sb + t >= nc) break;                   // warp-uniform
                float pt[GB];
#pragma unroll
                for (int g = 0; g < GB; ++g) pt[g] = __shfl_sync(0xffffffffu, p[g], 8 * t);
                const TKV* vr = vs + (long long)(sb + t) * D;
#pragma unroll
                for (int k = 0; k < PA_MAX_D / 128; ++k) {
                    const int d = 4 * lane + 128 * k;
                    if (d < D) {
                        const float4 v4 = pa_load4(vr + d);
#pragma unroll
                        for (int g = 0; g < GB; ++g) {
                            acc[k][g].x += pt[g] * v4.x;
                            acc[k][g].y += pt[g] * v4.y;
                            acc[k][g].z += pt[g] * v4.z;
                            acc[k][g].w += pt[g] * v4.w;
                        }
                    }
                }
            }
        }
        __syncthreads();        // the stage is free for chunk c + PA_STAGES
    }

    // merge the warps' states (the ring's memory is free now)
    if (lane == 0) {
#pragma unroll
        for (int g = 0; g < GB; ++g) {
            wm[warp * GB + g] = m[g];
            wl[warp * GB + g] = l[g];
        }
    }
#pragma unroll
    for (int k = 0; k < PA_MAX_D / 128; ++k) {
        const int d = 4 * lane + 128 * k;
        if (d < D) {
#pragma unroll
            for (int g = 0; g < GB; ++g)
                *(float4*)(wa + (warp * GB + g) * D + d) = acc[k][g];
        }
    }
    __syncthreads();
    const long long part = (long long)bh * NS + split;
    float* ws_acc = ws;                                // (bh, split, g) x D
    float* ws_ml = ws + (long long)(gridDim.x / (HG * NS)) * NS * G * D;   // x (m, l)
    for (int i = tid; i < Gc * D; i += PA_THREADS) {
        const int g = i / D, d = i - g * D;
        float mc = PA_NEG_INF;
#pragma unroll
        for (int w = 0; w < PA_WARPS; ++w) mc = fmaxf(mc, wm[w * GB + g]);
        float lc = 0.f, ac = 0.f;
#pragma unroll
        for (int w = 0; w < PA_WARPS; ++w) {
            const float e = expf(wm[w * GB + g] - mc);
            lc += e * wl[w * GB + g];
            ac += e * wa[(w * GB + g) * D + d];
        }
        if (NS == 1) {
            pa_store(out, qoff + i, ac / (lc == 0.f ? 1.f : lc));
        } else {
            const long long row = part * G + g0 + g;
            ws_acc[row * D + d] = ac;
            if (d == 0) {
                ws_ml[row * 2] = mc;
                ws_ml[row * 2 + 1] = lc;
            }
        }
    }
    if (NS == 1) return;
    __threadfence();
    __syncthreads();
    if (tid == 0) {
        const unsigned t = atomicAdd(&tickets[bhg], 1u);
        *is_last = t == (unsigned)(NS - 1);
        if (*is_last) tickets[bhg] = 0;        // ready for the next launch
    }
    __syncthreads();
    if (!*is_last) return;
    __threadfence();
    // every split's partial in one round: acc rows into shared memory (the
    // ring's memory) with cp.async, (m, l) beside them
    const long long first = (long long)bh * NS;
    float* ca = (float*)pa_smem;                       // NS x GB x D
    const int row_vecs = Gc * D / 4;
    for (int i = tid; i < NS * row_vecs; i += PA_THREADS) {
        const int s = i / row_vecs, j = i - s * row_vecs;
        pa_cp_async16(ca + s * GB * D + 4 * j,
                      ws_acc + ((first + s) * G + g0) * D + 4 * j);
    }
    pa_cp_commit();
    for (int i = tid; i < NS * Gc; i += PA_THREADS) {
        const int s = i / Gc, g = i - s * Gc;
        const long long row = (first + s) * G + g0 + g;
        cw[s * GB + g] = __ldcg(&ws_ml[row * 2]);
        cl[s * GB + g] = __ldcg(&ws_ml[row * 2 + 1]);
    }
    pa_cp_wait<0>();
    __syncthreads();
    for (int g = tid; g < Gc; g += PA_THREADS) {
        float ms = PA_NEG_INF;
        for (int s = 0; s < NS; ++s) ms = fmaxf(ms, cw[s * GB + g]);
        float lsum = 0.f;
        for (int s = 0; s < NS; ++s) {
            const float w = expf(cw[s * GB + g] - ms);
            cw[s * GB + g] = w;
            lsum += w * cl[s * GB + g];
        }
        cL[g] = lsum == 0.f ? 1.f : lsum;
    }
    __syncthreads();
    for (int i = tid; i < Gc * D; i += PA_THREADS) {
        const int g = i / D, d = i - g * D;
        float o = 0.f;
        for (int s = 0; s < NS; ++s) o += cw[s * GB + g] * ca[(s * GB + g) * D + d];
        pa_store(out, qoff + i, o / cL[g]);
    }
}

template <typename TQ, typename TKV, int GB>
static int pa_launch(const void* q, const void* k_pages, const void* v_pages,
                     const int* block_tables, const int* seq_lens, void* out,
                     float* ws, unsigned* tickets, int B, int KVH, int G,
                     int D, int P, int S, int MP, float scale,
                     cudaStream_t stream) {
    auto kernel = paged_attention_kernel<TQ, TKV, GB>;
    // once per instantiation: allow every size up to the card's limit
    static const cudaError_t attr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, PA_MAX_SMEM);
    if (attr != cudaSuccess) return (int)attr;
    const int NS = pa_splits(B, KVH, MP);
    const int pps = MP > 0 ? (MP + NS - 1) / NS : 0;
    const int ppc = pa_pages_per_chunk(S, D, (int)sizeof(TKV));
    const long long smem = pa_smem_bytes(GB, D, S, ppc, pps, NS, (int)sizeof(TKV));
    if (smem > PA_MAX_SMEM || D % 32 || D > PA_MAX_D)
        return (int)cudaErrorInvalidValue;
    const int HG = (G + GB - 1) / GB;
    kernel<<<B * KVH * HG * NS, PA_THREADS, (size_t)smem, stream>>>(
        (const TQ*)q, (const TKV*)k_pages, (const TKV*)v_pages, block_tables,
        seq_lens, (TQ*)out, ws, tickets, KVH, G, D, P, S, MP, NS, pps, ppc,
        scale);
    return (int)cudaGetLastError();
}

// Heads per CTA: 4 up to G = 4, else 8 (more head groups past 8).
template <typename TQ, typename TKV>
static int pa_launch_g(const void* q, const void* k_pages, const void* v_pages,
                       const int* block_tables, const int* seq_lens, void* out,
                       float* ws, unsigned* tickets, int B, int KVH, int G,
                       int D, int P, int S, int MP, float scale,
                       cudaStream_t stream) {
    if (G <= 4)
        return pa_launch<TQ, TKV, 4>(q, k_pages, v_pages, block_tables,
                                     seq_lens, out, ws, tickets, B, KVH, G, D,
                                     P, S, MP, scale, stream);
    return pa_launch<TQ, TKV, 8>(q, k_pages, v_pages, block_tables, seq_lens,
                                 out, ws, tickets, B, KVH, G, D, P, S, MP,
                                 scale, stream);
}

// Splits per (b, kv head) at these sizes: the wrapper sizes the workspace
// of partials by it.
extern "C" int paged_attention_splits(int B, int KVH, int MP) {
    return pa_splits(B, KVH, MP);
}

extern "C" int paged_attention_launch(const void* q, const void* k_pages,
                                      const void* v_pages,
                                      const int* block_tables,
                                      const int* seq_lens, void* out,
                                      float* ws, unsigned* tickets, int B,
                                      int KVH, int G, int D, int P, int S,
                                      int MP, float scale, int q_bf16,
                                      int kv_bf16, cudaStream_t stream) {
    if (q_bf16 && kv_bf16)
        return pa_launch_g<__nv_bfloat16, __nv_bfloat16>(
            q, k_pages, v_pages, block_tables, seq_lens, out, ws, tickets, B,
            KVH, G, D, P, S, MP, scale, stream);
    if (q_bf16)
        return pa_launch_g<__nv_bfloat16, float>(
            q, k_pages, v_pages, block_tables, seq_lens, out, ws, tickets, B,
            KVH, G, D, P, S, MP, scale, stream);
    if (kv_bf16)
        return pa_launch_g<float, __nv_bfloat16>(
            q, k_pages, v_pages, block_tables, seq_lens, out, ws, tickets, B,
            KVH, G, D, P, S, MP, scale, stream);
    return pa_launch_g<float, float>(q, k_pages, v_pages, block_tables,
                                     seq_lens, out, ws, tickets, B, KVH, G, D,
                                     P, S, MP, scale, stream);
}
