// Leftmost-match binary search, one thread per query: the Hopper form of
// the Pallas _search_kernel (repro/kernels/sorted_search.py:34) and of the
// per-level search of the fused descent (repro/core/jax_nbtree.py:399-409).
#include "common.cuh"

// One sorted run of n keys.  KEY_MAX queries never match.
__global__ void search_kernel(const long long* __restrict__ keys,
                              const int* __restrict__ vals,
                              const long long* __restrict__ q,
                              int* __restrict__ found, int* __restrict__ out,
                              int* __restrict__ idx, int n, int Q) {
    const int t = blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= Q) return;
    const long long qq = q[t];
    const int lo = repro_bound(keys, n, qq, false);
    const bool hit = lo < n && keys[lo] == qq && qq != REPRO_KEY_MAX;
    found[t] = hit;
    out[t] = hit ? vals[lo] : -1;
    idx[t] = lo;
}

// Query t searches the first counts[t] keys of table row rows[t]
// (hi = cnt, as in the descent), so one launch serves a whole level.
__global__ void search_rows_kernel(const long long* __restrict__ table_keys,
                                   const int* __restrict__ table_vals,
                                   long long row_len,
                                   const int* __restrict__ rows,
                                   const int* __restrict__ counts,
                                   const long long* __restrict__ q,
                                   bool* __restrict__ found,
                                   int* __restrict__ out,
                                   int* __restrict__ idx, int Q) {
    const int t = blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= Q) return;
    const long long base = (long long)rows[t] * row_len;
    const int cnt = counts[t];
    const long long qq = q[t];
    const int lo = repro_bound(table_keys + base, cnt, qq, false);
    const bool hit = lo < cnt && table_keys[base + lo] == qq;
    found[t] = hit;
    out[t] = hit ? table_vals[base + lo] : -1;
    idx[t] = lo;
}

extern "C" int sorted_search_launch(const long long* keys, const int* vals,
                                    const long long* q, int* found, int* out,
                                    int* idx, int n, int Q,
                                    cudaStream_t stream) {
    const int threads = 256;
    search_kernel<<<repro_blocks(Q, threads), threads, 0, stream>>>(
        keys, vals, q, found, out, idx, n, Q);
    return (int)cudaGetLastError();
}

extern "C" int sorted_search_rows_launch(const long long* table_keys,
                                         const int* table_vals,
                                         long long row_len, const int* rows,
                                         const int* counts, const long long* q,
                                         bool* found, int* out, int* idx,
                                         int Q, cudaStream_t stream) {
    const int threads = 256;
    search_rows_kernel<<<repro_blocks(Q, threads), threads, 0, stream>>>(
        table_keys, table_vals, row_len, rows, counts, q, found, out, idx, Q);
    return (int)cudaGetLastError();
}
