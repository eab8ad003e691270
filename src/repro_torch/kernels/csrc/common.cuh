// Shared definitions of the repro_torch CUDA kernels.
//
// Keys and Bloom words arrive as int64 holding a uint32 value (the port's
// key representation, see kernels/ref.py); KEY_MAX is the padding sentinel
// and sorts after every real key.  Values are int32.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define REPRO_KEY_MAX 0xFFFFFFFFLL

// Leftmost index in [0, n) whose key is >= q (closed == false) or > q
// (closed == true); n if there is none.  The converged form of the Pallas
// kernels' fixed-step lockstep search: both stop at the same index.
__device__ __forceinline__ int repro_bound(const long long* __restrict__ keys,
                                           int n, long long q, bool closed) {
    int lo = 0, hi = n;
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        const long long k = keys[mid];
        if (closed ? (k <= q) : (k < q)) {
            lo = mid + 1;
        } else {
            hi = mid;
        }
    }
    return lo;
}

static inline int repro_blocks(long long n, int threads) {
    return (int)((n + threads - 1) / threads);
}
