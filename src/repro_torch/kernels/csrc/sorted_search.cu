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
// Design: the k-ary lower-bound search of common.cuh (repro_lower_bound)
// by a group of SS_W lanes a query: a 21,504-key run takes 3 dependent
// rounds at SS_W = 32, the last one a coalesced read of the remaining keys
// and their values, so a hit costs no extra round.  Queries that share a
// row (all of them at the root level and in serving) probe the same
// addresses, which L2 serves.
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

// Leftmost index in [0, n) whose key is >= q, or n; hit when the key there
// equals q, and then its value.  Every lane of the group gets the answer.
__device__ __forceinline__ int ss_search(const long long* __restrict__ keys,
                                         const int* __restrict__ vals, int n,
                                         long long q, int lane, int gbase,
                                         bool& hit, int& val) {
    long long key = 0;
    val = 0;
    const int pos = repro_lower_bound<SS_W>(keys, vals, n, q, lane, gbase,
                                            key, val);
    hit = pos < n && key == q;
    return pos;
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
    int v;
    bool hit;
    const int pos = ss_search(keys, vals, n, qq, lane, gbase, hit, v);
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
    int v;
    bool hit;
    const int pos = ss_search(table_keys + base, table_vals + base, counts[t],
                              q[t], lane, gbase, hit, v);
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
