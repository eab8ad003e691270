// Merge-path merge of R pairs of sorted runs: the Hopper form of the Pallas
// _merge_kernel (repro/kernels/merge_sorted.py:47), behind both of its entry
// points (merge_sorted, pallas_call at :122; merge_sorted_batch, at :177).
//
// Equal keys take a (the newer run) first: the merge path goes right while
// a[i] <= b[k-i-1], and output k is a[i] when j >= m || (i < n && a[i] <=
// b[j]) (merge_sorted.py:70,78).
//
// Padding: the JAX wrapper pads a and b to multiples of 1024 with KEY_MAX
// keys and 0 values before merging, and where those pads land among a
// row's stale KEY_MAX tail decides the tail of the merged values.  The
// kernel reproduces that without copying: a row of a_raw real elements is
// read as n elements, the last n - a_raw of them KEY_MAX / 0 (same for b).
//
// What bounds it: bytes.  Each input element is read once and each output
// written once, 12 bytes each (an int64 key, an int32 value): 2.46 MB at the
// flush shape (R = 4, n = 4096, m = 21504), 0.73 us at 3.35 TB/s.  What
// keeps it from that is latency: a merge-path search per output element is
// a chain of ~15 dependent L2/HBM loads for every element.
//
// The design cuts that chain to two dependent device-memory round trips
// per tile.  CTA (t, r) owns the T outputs [t*T, (t+1)*T) of row r:
//  1. Narrowing: warps 0 and 1 each take one end of the tile and search its
//     merge-path split in device memory, 32 probes a round (loads issued
//     before any is used; a ballot keeps the interval between the last true
//     and the first false probe), until it is known to within MS_W: one
//     round at these shapes.
//  2. Staging: the spans of a and b that cover both ends' intervals (at most
//     T + 4 * MS_W + 2 elements) are copied into shared memory with cp.async
//     (8-byte keys, 4-byte values; the spans are ragged, so 16-byte copies
//     and TMA do not fit); indices at or past a_raw / b_raw are written as
//     KEY_MAX / 0.
//  3. Each thread finds the merge-path split of its first output in shared
//     memory and merges MS_E outputs in registers, with the predicate and
//     tie-break above, so tiles and threads cut tie groups where the
//     per-element search does.
//  4. The merged tile goes back through shared memory and out with 16-byte
//     stores, contiguous across the warp.
// One launch per call, no second pass.  T = MS_T = 512 outputs a CTA, from
// a sweep of T = 256 / 512 / 1024 on the card (PERF.md): 512 was within 4 %
// of the fastest at both main-path shapes.
//
// nvcc -Xptxas -v (sm_90a, -O3; chip_smoke.py prints it): 42 registers,
// 12,328 bytes of shared memory, no spills (0-byte stack frame).
#include "common.cuh"

#define MS_T 512               // outputs per CTA
#define MS_E 4                 // outputs per thread
#define MS_W 128               // device-memory search stops at this width

__device__ __forceinline__ long long ms_key(const long long* __restrict__ k,
                                            int raw, int i) {
    return i < raw ? k[i] : REPRO_KEY_MAX;
}

__device__ __forceinline__ void ms_cp_async(void* dst, const void* src,
                                            int bytes) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    if (bytes == 8) {
        asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
                     "l"(src));
    } else {
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                     "l"(src));
    }
}

// Narrow the merge-path split of diagonal k, the least i in [max(0, k-m),
// min(k, n)] with !(a[i] <= b[k-i-1]), to an interval [lo, hi] of width <=
// MS_W, searching device memory.  The predicate falls from true to false
// along the diagonal, so when the 32 probes lo, lo + s, ... find c true,
// the split lies between the last true and the first false one.  Called by
// a whole warp; every lane gets the same [lo, hi].
__device__ void ms_corank_device(const long long* __restrict__ ak, int a_raw,
                                 int n, const long long* __restrict__ bk,
                                 int b_raw, int m, int k, int lane, int& lo,
                                 int& hi) {
    lo = max(0, k - m);
    hi = min(k, n);
    while (hi - lo > MS_W) {
        // both loads are issued before either is used; a lane past hi
        // probes hi - 1 and is masked out of the ballot
        const int s = (hi - lo + 31) >> 5;
        const int i = min(lo + lane * s, hi - 1);
        const long long ka = ms_key(ak, a_raw, i);
        const long long kb = ms_key(bk, b_raw, k - i - 1);
        const int c = __popc(__ballot_sync(0xffffffffu,
                                           lo + lane * s < hi && ka <= kb));
        if (c == 0) {
            hi = lo;
        } else {
            lo += (c - 1) * s + 1;
            hi = min(hi, lo + s - 1);
        }
    }
}

__global__ void __launch_bounds__(MS_T / MS_E)
merge_tile_kernel(const long long* __restrict__ ak, const int* __restrict__ av,
                  const long long* __restrict__ bk, const int* __restrict__ bv,
                  long long* __restrict__ ok, int* __restrict__ ov,
                  int a_raw, int n, int b_raw, int m) {
    constexpr int T = MS_T;
    // a[a_lo .. a_hi] then b[b_lo .. b_hi] (at most T + 4 * MS_W + 2
    // elements); later the merged tile
    __shared__ __align__(16) long long sk[T + 4 * MS_W + 2];
    __shared__ __align__(16) int sv[T + 4 * MS_W + 2];
    __shared__ int bounds[2][2];

    const int total = n + m;
    const long long r = blockIdx.y;
    ak += r * a_raw;
    av += r * a_raw;
    bk += r * b_raw;
    bv += r * b_raw;
    const int k0 = blockIdx.x * T, tid = threadIdx.x;
    const int end = tid >> 5;               // warps 0 and 1: the tile's ends

    // 1. narrow the splits of both ends in device memory
    if (end < 2) {
        int lo, hi;
        ms_corank_device(ak, a_raw, n, bk, b_raw, m, k0 + end * T, tid & 31,
                         lo, hi);
        if ((tid & 31) == 0) {
            bounds[end][0] = lo;
            bounds[end][1] = hi;
        }
    }
    __syncthreads();

    // 2. stage a[a_lo .. a_hi] and b[b_lo .. b_hi]: every split of the tile
    //    lies in [a_lo, a_hi] x [b_lo, b_hi], and the merge reads the
    //    element at each split.  Past a_raw / b_raw: KEY_MAX / 0.
    const int lo0 = bounds[0][0], hi0 = bounds[0][1];
    const int lo1 = bounds[1][0], hi1 = bounds[1][1];
    const int a_lo = min(lo0, lo1), a_hi = max(hi0, hi1);
    const int b_lo = min(k0 - hi0, k0 + T - hi1);
    const int b_hi = max(k0 - lo0, k0 + T - lo1);
    const int la = a_hi - a_lo + 1, lb = b_hi - b_lo + 1;
    for (int x = tid; x < la + lb; x += T / MS_E) {
        const bool in_a = x < la;
        const int src = in_a ? a_lo + x : b_lo + x - la;
        if (src < (in_a ? a_raw : b_raw)) {
            ms_cp_async(&sk[x], (in_a ? ak : bk) + src, 8);
            ms_cp_async(&sv[x], (in_a ? av : bv) + src, 4);
        } else {
            sk[x] = REPRO_KEY_MAX;
            sv[x] = 0;
        }
    }
    asm volatile("cp.async.wait_all;\n" ::);
    __syncthreads();

    // 3. each thread finds the split of its first output k in shared
    //    memory, then merges MS_E outputs (global indices throughout)
    const long long* SA = sk - a_lo;        // SA[i] == a[i], i in [a_lo, a_hi]
    const long long* SB = sk + la - b_lo;   // SB[j] == b[j], j in [b_lo, b_hi]
    const int* VA = sv - a_lo;
    const int* VB = sv + la - b_lo;
    const int k = k0 + tid * MS_E;
    int lo = max(a_lo, k - b_hi), hi = min(a_hi, k - b_lo);
    while (lo < hi) {
        const int i = (lo + hi) >> 1;
        if (SA[i] <= SB[k - i - 1]) {
            lo = i + 1;
        } else {
            hi = i;
        }
    }
    int i = lo, j = k - lo;
    long long rk[MS_E];
    int rv[MS_E];
#pragma unroll
    for (int e = 0; e < MS_E; ++e) {
        if (j >= m || (i < n && SA[i] <= SB[j])) {
            rk[e] = SA[i];
            rv[e] = VA[i++];
        } else {
            rk[e] = SB[j];
            rv[e] = VB[j++];
        }
    }
    __syncthreads();

    // 4. write back through shared memory, 16 bytes a store
    static_assert(MS_E == 4, "the stores below write 4 outputs a thread");
    reinterpret_cast<longlong2*>(sk)[2 * tid] = make_longlong2(rk[0], rk[1]);
    reinterpret_cast<longlong2*>(sk)[2 * tid + 1] = make_longlong2(rk[2], rk[3]);
    reinterpret_cast<int4*>(sv)[tid] = make_int4(rv[0], rv[1], rv[2], rv[3]);
    __syncthreads();
    const long long out = r * total + k0;
    longlong2* okv = reinterpret_cast<longlong2*>(ok + out);
    int4* ovv = reinterpret_cast<int4*>(ov + out);
    for (int x = tid; x < T / 2; x += T / MS_E)
        okv[x] = reinterpret_cast<const longlong2*>(sk)[x];
    for (int x = tid; x < T / 4; x += T / MS_E)
        ovv[x] = reinterpret_cast<const int4*>(sv)[x];
}

// a: (R, a_raw) read as (R, n); b: (R, b_raw) read as (R, m);
// out: (R, n + m), 16-byte aligned.  Contiguous rows; n and m multiples of
// 1024.
extern "C" int merge_sorted_launch(const long long* ak, const int* av,
                                   const long long* bk, const int* bv,
                                   long long* ok, int* ov, int R, int a_raw,
                                   int n, int b_raw, int m,
                                   cudaStream_t stream) {
    if (n % 1024 || m % 1024 || a_raw > n || b_raw > m ||
        (reinterpret_cast<uintptr_t>(ok) | reinterpret_cast<uintptr_t>(ov)) % 16)
        return (int)cudaErrorInvalidValue;
    dim3 grid((n + m) / MS_T, R);
    merge_tile_kernel<<<grid, MS_T / MS_E, 0, stream>>>(ak, av, bk, bv, ok, ov,
                                                        a_raw, n, b_raw, m);
    return (int)cudaGetLastError();
}
