// Inclusive range scan [lo, hi]: the Hopper form of the Pallas
// _range_scan_kernel (repro/kernels/range_scan.py:44) and of the multi-run
// search + gather of the range descent (repro/core/jax_nbtree.py:435-457).
//
// One block per (query, run): thread 0 runs the two bounds (leftmost key
// >= lo, leftmost key > hi), then the block gathers cap slots, KEY_MAX / 0
// past the end of the span.  The match count is the total before the cap,
// the caller's truncation signal.
#include "common.cuh"

__device__ __forceinline__ void gather_span(
        const long long* __restrict__ keys, const int* __restrict__ vals,
        int start, int end, long long* __restrict__ out_k,
        int* __restrict__ out_v, int cap) {
    for (int c = threadIdx.x; c < cap; c += blockDim.x) {
        const int i = start + c;
        const bool valid = i < end;
        out_k[c] = valid ? keys[i] : REPRO_KEY_MAX;
        out_v[c] = valid ? vals[i] : 0;
    }
}

// One sorted run of n keys; the upper bound is clamped to the live
// (non-KEY_MAX) prefix so padding never matches.
__global__ void range_scan_kernel(const long long* __restrict__ keys,
                                  const int* __restrict__ vals, int n,
                                  const long long* __restrict__ lo,
                                  const long long* __restrict__ hi,
                                  long long* __restrict__ out_k,
                                  int* __restrict__ out_v,
                                  int* __restrict__ count, int cap) {
    __shared__ int span[2];
    const long long q = blockIdx.x;
    if (threadIdx.x == 0) {
        const int n_live = repro_bound(keys, n, REPRO_KEY_MAX, false);
        const int start = repro_bound(keys, n, lo[q], false);
        const int end = min(repro_bound(keys, n, hi[q], true), n_live);
        span[0] = start;
        span[1] = end;
        count[q] = max(end - start, 0);
    }
    __syncthreads();
    gather_span(keys, vals, span[0], span[1], out_k + q * cap,
                out_v + q * cap, cap);
}

// Candidate p = b * M + m scans the first counts[p] keys of table row
// nodes[p] for query b (counts exclude KEY_MAX padding; an empty candidate
// has count 0).
__global__ void range_scan_rows_kernel(const long long* __restrict__ table_keys,
                                       const int* __restrict__ table_vals,
                                       long long row_len,
                                       const int* __restrict__ nodes,
                                       const int* __restrict__ counts,
                                       const long long* __restrict__ lo,
                                       const long long* __restrict__ hi,
                                       long long* __restrict__ out_k,
                                       int* __restrict__ out_v,
                                       int* __restrict__ n_match, int M,
                                       int cap) {
    __shared__ int span[2];
    const long long p = blockIdx.x;
    const long long base = (long long)nodes[p] * row_len;
    if (threadIdx.x == 0) {
        const long long b = p / M;
        const int cnt = counts[p];
        const int start = repro_bound(table_keys + base, cnt, lo[b], false);
        const int end = repro_bound(table_keys + base, cnt, hi[b], true);
        span[0] = start;
        span[1] = end;
        n_match[p] = max(end - start, 0);
    }
    __syncthreads();
    gather_span(table_keys + base, table_vals + base, span[0], span[1],
                out_k + p * cap, out_v + p * cap, cap);
}

extern "C" int range_scan_launch(const long long* keys, const int* vals, int n,
                                 const long long* lo, const long long* hi,
                                 long long* out_k, int* out_v, int* count,
                                 int Q, int cap, cudaStream_t stream) {
    range_scan_kernel<<<Q, 128, 0, stream>>>(keys, vals, n, lo, hi, out_k,
                                             out_v, count, cap);
    return (int)cudaGetLastError();
}

extern "C" int range_scan_rows_launch(const long long* table_keys,
                                      const int* table_vals, long long row_len,
                                      const int* nodes, const int* counts,
                                      const long long* lo, const long long* hi,
                                      long long* out_k, int* out_v,
                                      int* n_match, int P, int M, int cap,
                                      cudaStream_t stream) {
    range_scan_rows_kernel<<<P, 128, 0, stream>>>(
        table_keys, table_vals, row_len, nodes, counts, lo, hi, out_k, out_v,
        n_match, M, cap);
    return (int)cudaGetLastError();
}
