// Shared definitions of the repro_torch CUDA kernels.
//
// Keys and Bloom words arrive as int64 holding a uint32 value (the port's
// key representation, see kernels/ref.py); KEY_MAX is the padding sentinel
// and sorts after every real key.  Values are int32.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define REPRO_KEY_MAX 0xFFFFFFFFLL

// Leftmost index in [0, n) whose key is >= q, or n: the converged form of
// the Pallas kernels' fixed-step lockstep search (both stop at the same
// index), found by a group of W lanes of one warp (lane = its lane in the
// group, gbase = the group's first lane in the warp).  Every lane of the
// group gets the same answer; the groups of a warp search independently.
//
// A k-ary search.  The lanes hold the window [lo, hi] that contains the
// answer (keys before lo are < q; the key at hi is >= q, or hi is n).  Each
// round every lane loads its probe first, at lo + (j + 1) * (hi - lo) /
// (W + 1), then the group votes (__ballot_sync) on the leftmost probe whose
// key is >= q, and the window shrinks to the gap before it: by W + 1 a
// round.  Once the window holds at most W keys, one coalesced round reads
// all of them (with their values, when vals is not null) and the vote gives
// the answer.  A 21,504-key run takes 3 rounds at W = 32, 4 at 16, 5 at 8
// and 7 at 4, not ~15; a probe round reads W 32-byte sectors.  On return
// `key` and `val` hold the key and value at the answer (val 0 when vals is
// null); both are unset when the answer is n.
template <int W>
__device__ __forceinline__ int repro_lower_bound(
        const long long* __restrict__ keys, const int* __restrict__ vals,
        int n, long long q, int lane, int gbase, long long& key, int& val) {
    static_assert(W == 4 || W == 8 || W == 16 || W == 32,
                  "a group is 4, 8, 16 or 32 lanes");
    const unsigned low = W == 32 ? 0xffffffffu : (1u << W) - 1u;
    const unsigned gmask = low << gbase;
    int lo = 0, hi = n;
    while (hi - lo >= W) {
        const long long span = hi - lo;
        const long long p = lo + (lane + 1) * span / (W + 1);
        const bool ge = keys[p] >= q;
        const unsigned votes = (__ballot_sync(gmask, ge) >> gbase) & low;
        const int j = votes ? __ffs(votes) - 1 : W;      // first probe >= q
        const int new_lo = j > 0 ? (int)(lo + j * span / (W + 1)) + 1 : lo;
        if (j < W) hi = (int)(lo + (j + 1) * span / (W + 1));
        lo = new_lo;
    }
    // at most W keys left, lo..hi (hi only if below n): read them all
    const int i = lo + lane;
    const bool in = i <= hi && i < n;
    const long long k = in ? keys[i] : 0;
    const int v = in && vals != nullptr ? vals[i] : 0;
    const unsigned votes = (__ballot_sync(gmask, in && k >= q) >> gbase) & low;
    if (!votes) return hi;                     // == n: every key is < q
    const int j = __ffs(votes) - 1;
    key = __shfl_sync(gmask, k, gbase + j);
    val = __shfl_sync(gmask, v, gbase + j);
    return lo + j;
}

static inline int repro_blocks(long long n, int threads) {
    return (int)((n + threads - 1) / threads);
}
