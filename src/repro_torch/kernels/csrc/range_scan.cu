// Inclusive range scan [lo, hi]: the Hopper form of the Pallas
// _range_scan_kernel (repro/kernels/range_scan.py:44) and of the multi-run
// search + gather of the range descent (repro/core/jax_nbtree.py:435-457).
//
// What bounds it: memory traffic.  A candidate writes cap slots of 12
// bytes (B=1024, M=8, cap=128: 12.6 MB of output, ~3.8 us at 3.35 TB/s)
// after two bounds over a run of up to 21,504 keys.  A binary search reads
// ~15 keys one after another; a k-ary one reads fewer in turn but more in
// all, and each key it probes costs a whole 32-byte sector: at 16 lanes a
// bound a candidate moves ~4 KB of sectors, more than its output.
//
// Design: a group of 2 x RS_W lanes per candidate, RS_WARPS warps a CTA.
// The group's first RS_W lanes find the leftmost key >= lo and the other
// RS_W the leftmost key >= hi + 1 (keys are integers, so that is the
// leftmost key > hi) at the same time, each by the k-ary search of
// common.cuh.  The one-run form needs no third search for the live prefix:
// its end, min(ub(hi), n_live) with n_live = ub(KEY_MAX - 1), is
// lb(min(hi, KEY_MAX - 1) + 1), since ub is monotone.  The group then writes
// the candidate's cap slots with 16-byte stores (longlong2 for keys, int4
// for values) where the slot's address allows, scalar stores at the ragged
// ends; its loads from the matched span stay coalesced, and slots past the
// span get KEY_MAX / 0 without a load.  The match count is the total before
// the cap, the caller's truncation signal.
#include "common.cuh"

// Lanes per bound and warps per CTA, from sweeps on the card (PERF.md): at
// the ycsb-e path's launch (B=1024, M=16, cap=256) 4 lanes a bound beat 8
// and 16 (fewer sectors over 7 rounds); 8 wins only at phase 1's smaller
// launch, which no path makes.  RS_WARPS 2, 4 and 8 tie.  The build never
// sets them; chip_smoke.py's sweeps compile variants with -D.
#ifndef RS_W
#define RS_W 4
#endif
#ifndef RS_WARPS
#define RS_WARPS 4
#endif
#define RS_G (2 * RS_W)                           // lanes per candidate
#define RS_THREADS (32 * RS_WARPS)

static_assert(RS_W == 4 || RS_W == 8 || RS_W == 16, "RS_W is 4, 8 or 16");

// [start, end) of the keys in [lo, hi_excl) among n sorted keys, found by
// the candidate's group (glane = its lane in the group, gbase = the group's
// first lane in the warp); every lane of the group gets both.
__device__ __forceinline__ void rs_bounds(const long long* __restrict__ keys,
                                          int n, long long lo,
                                          long long hi_excl, int glane,
                                          int gbase, int& start, int& end) {
    const int half = glane / RS_W;
    long long key;
    int val;
    const int pos = repro_lower_bound<RS_W>(keys, nullptr, n,
                                            half ? hi_excl : lo, glane % RS_W,
                                            gbase + half * RS_W, key, val);
    const unsigned gmask = (RS_G == 32 ? 0xffffffffu : (1u << RS_G) - 1u)
                           << gbase;
    start = __shfl_sync(gmask, pos, gbase);
    end = __shfl_sync(gmask, pos, gbase + RS_W);
}

// The group writes the cap slots at out_k / out_v: keys[start + c] /
// vals[start + c] while start + c < end, KEY_MAX / 0 after.  Keys go as one
// scalar slot up to a 16-byte boundary, pairs (longlong2), one at the end;
// values as up to 3 scalar slots, quads (int4), up to 3 at the end.
__device__ __forceinline__ void rs_gather(const long long* __restrict__ keys,
                                          const int* __restrict__ vals,
                                          int start, int end,
                                          long long* __restrict__ out_k,
                                          int* __restrict__ out_v, int cap,
                                          int glane) {
    auto key_at = [&](int c) {
        return start + c < end ? keys[start + c] : REPRO_KEY_MAX;
    };
    auto val_at = [&](int c) { return start + c < end ? vals[start + c] : 0; };
    const int hk = min(cap, (int)(((uintptr_t)out_k >> 3) & 1));
    const int nk = (cap - hk) / 2;
    const int tk = hk + 2 * nk;
    if (glane < hk) out_k[glane] = key_at(glane);
    longlong2* vk = reinterpret_cast<longlong2*>(out_k + hk);
    for (int j = glane; j < nk; j += RS_G) {
        const int c = hk + 2 * j;
        vk[j] = make_longlong2(key_at(c), key_at(c + 1));
    }
    if (tk + glane < cap) out_k[tk + glane] = key_at(tk + glane);
    const int hv = min(cap, (int)(((16 - ((uintptr_t)out_v & 15)) & 15) >> 2));
    const int nv = (cap - hv) / 4;
    const int tv = hv + 4 * nv;
    if (glane < hv) out_v[glane] = val_at(glane);
    int4* vv = reinterpret_cast<int4*>(out_v + hv);
    for (int j = glane; j < nv; j += RS_G) {
        const int c = hv + 4 * j;
        vv[j] = make_int4(val_at(c), val_at(c + 1), val_at(c + 2), val_at(c + 3));
    }
    if (tv + glane < cap) out_v[tv + glane] = val_at(tv + glane);
}

// One sorted run of n keys, KEY_MAX padding after its live prefix; query q
// is the group's candidate.
__global__ void __launch_bounds__(RS_THREADS)
range_scan_kernel(const long long* __restrict__ keys,
                  const int* __restrict__ vals, int n,
                  const long long* __restrict__ lo,
                  const long long* __restrict__ hi,
                  long long* __restrict__ out_k, int* __restrict__ out_v,
                  int* __restrict__ count, int Q, int cap) {
    const long long q = ((long long)blockIdx.x * RS_THREADS + threadIdx.x) / RS_G;
    if (q >= Q) return;                            // the whole group leaves
    const int glane = threadIdx.x % RS_G, gbase = (threadIdx.x & 31) - glane;
    int start, end;
    rs_bounds(keys, n, lo[q], min(hi[q], REPRO_KEY_MAX - 1) + 1, glane, gbase,
              start, end);
    if (glane == 0) count[q] = max(end - start, 0);
    rs_gather(keys, vals, start, end, out_k + q * cap, out_v + q * cap, cap,
              glane);
}

// Candidate p = b * M + m scans the first counts[p] keys of table row
// nodes[p] for query b (counts exclude KEY_MAX padding; an empty candidate
// has count 0).
__global__ void __launch_bounds__(RS_THREADS)
range_scan_rows_kernel(const long long* __restrict__ table_keys,
                       const int* __restrict__ table_vals, long long row_len,
                       const int* __restrict__ nodes,
                       const int* __restrict__ counts,
                       const long long* __restrict__ lo,
                       const long long* __restrict__ hi,
                       long long* __restrict__ out_k, int* __restrict__ out_v,
                       int* __restrict__ n_match, int P, int M, int cap) {
    const long long p = ((long long)blockIdx.x * RS_THREADS + threadIdx.x) / RS_G;
    if (p >= P) return;
    const int glane = threadIdx.x % RS_G, gbase = (threadIdx.x & 31) - glane;
    const long long b = p / M;
    const long long base = (long long)nodes[p] * row_len;
    int start, end;
    rs_bounds(table_keys + base, counts[p], lo[b], hi[b] + 1, glane, gbase,
              start, end);
    if (glane == 0) n_match[p] = max(end - start, 0);
    rs_gather(table_keys + base, table_vals + base, start, end,
              out_k + p * cap, out_v + p * cap, cap, glane);
}

extern "C" int range_scan_launch(const long long* keys, const int* vals, int n,
                                 const long long* lo, const long long* hi,
                                 long long* out_k, int* out_v, int* count,
                                 int Q, int cap, cudaStream_t stream) {
    range_scan_kernel<<<repro_blocks((long long)Q * RS_G, RS_THREADS),
                        RS_THREADS, 0, stream>>>(keys, vals, n, lo, hi, out_k,
                                                 out_v, count, Q, cap);
    return (int)cudaGetLastError();
}

extern "C" int range_scan_rows_launch(const long long* table_keys,
                                      const int* table_vals, long long row_len,
                                      const int* nodes, const int* counts,
                                      const long long* lo, const long long* hi,
                                      long long* out_k, int* out_v,
                                      int* n_match, int P, int M, int cap,
                                      cudaStream_t stream) {
    range_scan_rows_kernel<<<repro_blocks((long long)P * RS_G, RS_THREADS),
                             RS_THREADS, 0, stream>>>(
        table_keys, table_vals, row_len, nodes, counts, lo, hi, out_k, out_v,
        n_match, P, M, cap);
    return (int)cudaGetLastError();
}
