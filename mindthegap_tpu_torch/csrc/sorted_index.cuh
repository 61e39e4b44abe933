// The bucket index of a sorted set of u64 words held in int64
// (mindthegap_tpu_torch/ops/sorted_index.py), shared by its build kernel
// (sorted_index.cu), K13's probe (sharded_member.cu) and K14
// (scan_sorted.cu).
//
// A sorted array A[0..n) may end in a tail of SENTINEL (all-ones) keys;
// n_real keys lie below it. The index covers the range [lo, hi] of those
// keys (lo = A[0], hi = A[n_real - 1]) with B = 2^b buckets: key x falls in
// bucket (x - lo) >> s, s = max(0, bitlen(hi - lo) - b), so every bucket
// number is below B. start[j] (int32, j = 0..B) is the first i < n_real
// whose bucket is >= j (n_real past the last). The header holds lo, hi, s
// and n_real as four int64 words on the device; with no key below SENTINEL
// it holds lo = SENTINEL, hi = 0, an empty range.
//
// A lookup of q is membership, what a lower bound plus equality gives:
//   - q outside [lo, hi] (SENTINEL among them): found exactly when q is
//     SENTINEL and the set has a SENTINEL tail (n_real < n); no load;
//   - otherwise two dependent steps: start[j] and start[j + 1] (adjacent
//     words, one sector but for one bucket in eight), then the bucket's
//     first LOOKUP_KEYS keys, all loads issued together; a longer bucket
//     whose first LOOKUP_KEYS keys are all below q is searched on by
//     bisection, so the answer is exact however skewed the set.
// The callers split a lookup in these steps (range, keys, resolve) so that
// a thread issues the loads of all its lookups before it waits on any.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace sidx {

typedef unsigned long long u64;

constexpr u64 SENTINEL = ~0ull;
// the keys of a bucket a lookup loads at once (bounds.py LOOKUP_KEYS mirrors it)
constexpr int LOOKUP_KEYS = 4;

struct Index {
    const long long* keys;
    const int* start;
    u64 lo, hi;
    int shift;
    bool has_sentinel;
};

// the index of keys[0..n) from its start array and its header
__device__ __forceinline__ Index load_index(const long long* keys, int64_t n, const int* start,
                                            const long long* head) {
    Index x;
    x.keys = keys;
    x.start = start;
    x.lo = (u64)__ldg(head);
    x.hi = (u64)__ldg(head + 1);
    x.shift = (int)__ldg(head + 2);
    x.has_sentinel = __ldg(head + 3) < n;
    return x;
}

// q's bucket, or -1 outside [lo, hi]
__device__ __forceinline__ int bucket_of(u64 q, u64 lo, u64 hi, int shift) {
    return q < lo || q > hi ? -1 : (int)((q - lo) >> shift);
}

// step 1: the bucket's key range [x, y), empty outside [lo, hi]
__device__ __forceinline__ int2 bucket_range(const Index& x, u64 q) {
    const int j = bucket_of(q, x.lo, x.hi, x.shift);
    int2 r = make_int2(0, 0);
    if (j >= 0) {
        r.x = __ldg(x.start + j);
        r.y = __ldg(x.start + j + 1);
    }
    return r;
}

// step 2: the range's first LOOKUP_KEYS keys (SENTINEL past its end: never
// equal to a q inside [lo, hi])
__device__ __forceinline__ void load_keys(const Index& x, int2 r, u64 (&kv)[LOOKUP_KEYS]) {
#pragma unroll
    for (int t = 0; t < LOOKUP_KEYS; t++) kv[t] = r.x + t < r.y ? (u64)__ldg(x.keys + r.x + t) : SENTINEL;
}

// step 3: whether q is in the set
__device__ __forceinline__ bool resolve(const Index& x, int2 r, const u64 (&kv)[LOOKUP_KEYS], u64 q) {
    if (q == SENTINEL) return x.has_sentinel;
    bool found = false;
#pragma unroll
    for (int t = 0; t < LOOKUP_KEYS; t++) found |= kv[t] == q;
    if (!found && r.y - r.x > LOOKUP_KEYS && kv[LOOKUP_KEYS - 1] < q) {
        int lo = r.x + LOOKUP_KEYS, hi = r.y;  // the first key >= q in the rest of the bucket
        while (lo < hi) {
            const int mid = (lo + hi) >> 1;
            if ((u64)__ldg(x.keys + mid) < q) lo = mid + 1; else hi = mid;
        }
        found = lo < r.y && (u64)__ldg(x.keys + lo) == q;
    }
    return found;
}

}  // namespace sidx
