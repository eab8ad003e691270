// Merge-path merge of R pairs of sorted runs: the Hopper form of the Pallas
// _merge_kernel (repro/kernels/merge_sorted.py:47).
//
// One thread per output element k of row r: binary-search the diagonal
// split i(k) = |{a-elements among the first k merged}| over global memory,
// then take a[i] or b[k - i].  Equal keys take a (the newer run) first:
// go right while a[i] <= b[k-i-1]; take_a = j >= m || (i < n && a[i] <= b[j])
// (merge_sorted.py:70,78).
//
// Padding: the JAX wrapper pads a and b to multiples of 1024 with KEY_MAX
// keys and 0 values before merging, and where those pads land among a
// row's stale KEY_MAX tail decides the tail of the merged values.  The
// kernel reproduces that without copying: a row of a_raw real elements is
// read as n elements, the last n - a_raw of them KEY_MAX / 0 (same for b).
#include "common.cuh"

__device__ __forceinline__ long long key_at(const long long* __restrict__ k,
                                            int raw, int i) {
    return i < raw ? k[i] : REPRO_KEY_MAX;
}

__global__ void merge_path_kernel(const long long* __restrict__ ak,
                                  const int* __restrict__ av,
                                  const long long* __restrict__ bk,
                                  const int* __restrict__ bv,
                                  long long* __restrict__ ok,
                                  int* __restrict__ ov,
                                  int a_raw, int n, int b_raw, int m) {
    const int total = n + m;
    const int k = blockIdx.x * blockDim.x + threadIdx.x;
    if (k >= total) return;
    const long long r = blockIdx.y;
    ak += r * a_raw;
    av += r * a_raw;
    bk += r * b_raw;
    bv += r * b_raw;

    int lo = max(0, k - m);
    int hi = min(k, n);
    while (lo < hi) {              // i in [lo, hi): 0 <= k-i-1 < m holds
        const int i = (lo + hi) >> 1;
        if (key_at(ak, a_raw, i) <= key_at(bk, b_raw, k - i - 1)) {
            lo = i + 1;
        } else {
            hi = i;
        }
    }
    const int i = lo;
    const int j = k - lo;
    const bool take_a =
        j >= m || (i < n && key_at(ak, a_raw, i) <= key_at(bk, b_raw, j));
    const long long out = r * total + k;
    if (take_a) {
        ok[out] = key_at(ak, a_raw, i);
        ov[out] = i < a_raw ? av[i] : 0;
    } else {
        ok[out] = key_at(bk, b_raw, j);
        ov[out] = j < b_raw ? bv[j] : 0;
    }
}

// a: (R, a_raw) read as (R, n); b: (R, b_raw) read as (R, m);
// out: (R, n + m).  Contiguous rows.
extern "C" int merge_sorted_launch(const long long* ak, const int* av,
                                   const long long* bk, const int* bv,
                                   long long* ok, int* ov, int R, int a_raw,
                                   int n, int b_raw, int m,
                                   cudaStream_t stream) {
    const int threads = 256;
    dim3 grid(repro_blocks((long long)n + m, threads), R);
    merge_path_kernel<<<grid, threads, 0, stream>>>(ak, av, bk, bv, ok, ov,
                                                    a_raw, n, b_raw, m);
    return (int)cudaGetLastError();
}
