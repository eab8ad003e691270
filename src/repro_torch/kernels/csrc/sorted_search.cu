// Leftmost-match search, a group of SS_W lanes per query: the Hopper form
// of the Pallas _search_kernel (repro/kernels/sorted_search.py:34) and of
// the per-level search of the fused descent (repro/core/jax_nbtree.py:
// 399-409).
//
// What bounds it: latency.  A query reads a few keys of a run of up to
// 21,504 (a node row at f=4, sigma=4096), under a microsecond of bytes at
// any main-path shape; a binary search makes ~15 of those reads one after
// another, each an L2 or device-memory round trip (the leaf rows are cold:
// the node tables hold gigabytes), and the descent's launches carry few
// queries (144-205), so the card has little else to hide them behind.
//
// Design: a k-ary lower-bound search.  The SS_W lanes of a group hold the
// window [lo, hi] that contains the answer (keys before lo are < q; the key
// at hi is >= q, or hi is the count).  Each round every lane loads its probe
// first, at lo + (j + 1) * (hi - lo) / (SS_W + 1), then the group votes
// (__ballot_sync) on the leftmost probe whose key is >= q, and the window
// shrinks to the gap before it: by SS_W + 1 a round.  Once the window holds
// at most SS_W keys, one coalesced round reads all of them, with their
// values, and the vote gives the answer.  A 21,504-key run takes 3 rounds
// at SS_W = 32, 4 at 16, 5 at 8, not ~15.  Queries that share a row (all of
// them at the root level and in serving) probe the same addresses, which L2
// serves.
//
// Left: the descent still launches this kernel and the Bloom probe once per
// level from Python; fusing the levels into one launch is a later kernel.
#include "common.cuh"

// Lanes per query, from a sweep on the card (PERF.md): 32 is fastest at
// the descent's shape (205 queries a launch) and ties at the page index's
// (144 on one row); 16 wins only at 4096 queries, which no path launches.
// The build never sets it; chip_smoke.py's sweep compiles variants with -D.
#ifndef SS_W
#define SS_W 32
#endif
#define SS_THREADS 256

static_assert(SS_W == 8 || SS_W == 16 || SS_W == 32, "a group is 8, 16 or 32 lanes");

// Leftmost index in [0, n) whose key is >= q, or n; hit when the key there
// equals q, and then its value.  Called by the SS_W lanes of one group
// (lane = its lane in the group, gbase = the group's first lane in the
// warp); every lane gets the same answer.
__device__ __forceinline__ void ss_search(const long long* __restrict__ keys,
                                          const int* __restrict__ vals, int n,
                                          long long q, int lane, int gbase,
                                          int& pos, bool& hit, int& val) {
    const unsigned low = SS_W == 32 ? 0xffffffffu : (1u << SS_W) - 1u;
    const unsigned gmask = low << gbase;
    int lo = 0, hi = n;
    while (hi - lo >= SS_W) {
        const long long span = hi - lo;
        const long long p = lo + (lane + 1) * span / (SS_W + 1);
        const bool ge = keys[p] >= q;
        const unsigned votes = (__ballot_sync(gmask, ge) >> gbase) & low;
        const int j = votes ? __ffs(votes) - 1 : SS_W;   // first probe >= q
        const int new_lo = j > 0 ? (int)(lo + j * span / (SS_W + 1)) + 1 : lo;
        if (j < SS_W) hi = (int)(lo + (j + 1) * span / (SS_W + 1));
        lo = new_lo;
    }
    // at most SS_W keys left, lo..hi (hi only if below n): read them all
    const int i = lo + lane;
    const bool in = i <= hi && i < n;
    const long long k = in ? keys[i] : 0;
    const int v = in ? vals[i] : 0;
    const unsigned votes = (__ballot_sync(gmask, in && k >= q) >> gbase) & low;
    if (votes) {
        const int j = __ffs(votes) - 1;
        pos = lo + j;
        hit = __shfl_sync(gmask, k, gbase + j) == q;
        val = __shfl_sync(gmask, v, gbase + j);
    } else {
        pos = hi;                              // == n: every key is < q
        hit = false;
        val = 0;
    }
}

// One sorted run of n keys.  KEY_MAX queries never match.
__global__ void __launch_bounds__(SS_THREADS)
search_kernel(const long long* __restrict__ keys, const int* __restrict__ vals,
              const long long* __restrict__ q, int* __restrict__ found,
              int* __restrict__ out, int* __restrict__ idx, int n, int Q) {
    const int t = (blockIdx.x * SS_THREADS + threadIdx.x) / SS_W;
    if (t >= Q) return;                        // the whole group leaves
    const int lane = threadIdx.x % SS_W, gbase = (threadIdx.x & 31) - lane;
    const long long qq = q[t];
    int pos, v;
    bool hit;
    ss_search(keys, vals, n, qq, lane, gbase, pos, hit, v);
    hit = hit && qq != REPRO_KEY_MAX;
    if (lane == 0) {
        found[t] = hit;
        out[t] = hit ? v : -1;
        idx[t] = pos;
    }
}

// Query t searches the first counts[t] keys of table row rows[t]
// (hi = cnt, as in the descent), so one launch serves a whole level.
__global__ void __launch_bounds__(SS_THREADS)
search_rows_kernel(const long long* __restrict__ table_keys,
                   const int* __restrict__ table_vals, long long row_len,
                   const int* __restrict__ rows, const int* __restrict__ counts,
                   const long long* __restrict__ q, bool* __restrict__ found,
                   int* __restrict__ out, int* __restrict__ idx, int Q) {
    const int t = (blockIdx.x * SS_THREADS + threadIdx.x) / SS_W;
    if (t >= Q) return;
    const int lane = threadIdx.x % SS_W, gbase = (threadIdx.x & 31) - lane;
    const long long base = (long long)rows[t] * row_len;
    int pos, v;
    bool hit;
    ss_search(table_keys + base, table_vals + base, counts[t], q[t], lane,
              gbase, pos, hit, v);
    if (lane == 0) {
        found[t] = hit;
        out[t] = hit ? v : -1;
        idx[t] = pos;
    }
}

extern "C" int sorted_search_launch(const long long* keys, const int* vals,
                                    const long long* q, int* found, int* out,
                                    int* idx, int n, int Q,
                                    cudaStream_t stream) {
    search_kernel<<<repro_blocks((long long)Q * SS_W, SS_THREADS), SS_THREADS,
                    0, stream>>>(keys, vals, q, found, out, idx, n, Q);
    return (int)cudaGetLastError();
}

extern "C" int sorted_search_rows_launch(const long long* table_keys,
                                         const int* table_vals,
                                         long long row_len, const int* rows,
                                         const int* counts, const long long* q,
                                         bool* found, int* out, int* idx,
                                         int Q, cudaStream_t stream) {
    search_rows_kernel<<<repro_blocks((long long)Q * SS_W, SS_THREADS),
                         SS_THREADS, 0, stream>>>(
        table_keys, table_vals, row_len, rows, counts, q, found, out, idx, Q);
    return (int)cudaGetLastError();
}
