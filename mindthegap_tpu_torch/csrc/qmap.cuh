// The probe primitives of the fused quotient maps over canonical (k-1)-mers
// (mindthegap_tpu_torch/ops/extmap.py QMap and QMapB, k <= 32), shared by K5
// (walk.cu) and K8 and K9 (scan_planes.cu).
//
// QMap is a 2-choice cuckoo table of u64 slots; QMapB a table of 16-slot
// buckets (128 bytes, one line), probed under the first hash alone. The
// hash `mix` is a bijection on u64, so a slot stores only the remainder of
// the hash below the bits that chose it, and a hit names one key exactly:
//   QMap slot:  [ rem : 64-log_size ][ valid:1 ][ choice:1 ][ payload:9 ]
//   QMapB slot: [ rem : 64-log_nb ][ valid:1 ][ payload:9 ]
// The payload is ext (bits 0-3), pre (bits 4-7) and the repeat bit (8) of
// the canonical (k-1)-mer. The <= 64-entry stash is searched by the callers
// (in shared memory).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace qmap {

typedef unsigned long long u64;

constexpr u64 H1 = 0x9E3779B97F4A7C15ull;
constexpr u64 H2 = 0xC2B2AE3D27D4EB4Full;
constexpr u64 PAY_MASK = 0x1FF;
constexpr u64 Q_VALID = 1ull << 10;
constexpr u64 Q_CHOICE = 1ull << 9;
constexpr int Q_SHIFT_PAY = 11;
constexpr u64 QB_VALID = 1ull << 9;
constexpr int QB_SHIFT_PAY = 10;
constexpr int QB_SLOTS = 16;
constexpr int MAX_STASH = 64;

__device__ __forceinline__ u64 mix(u64 key, u64 c) {
    u64 h = (key ^ (key >> 33)) * c;
    return h ^ (h >> 29);
}

// reverse complement of a k-mer, 1 <= k <= 32
__device__ __forceinline__ u64 revcomp(u64 x, int k) {
    x ^= 0xAAAAAAAAAAAAAAAAull;  // complement every base
    x = ((x >> 2) & 0x3333333333333333ull) | ((x & 0x3333333333333333ull) << 2);
    x = ((x >> 4) & 0x0F0F0F0F0F0F0F0Full) | ((x & 0x0F0F0F0F0F0F0F0Full) << 4);
    x = ((x >> 8) & 0x00FF00FF00FF00FFull) | ((x & 0x00FF00FF00FF00FFull) << 8);
    x = ((x >> 16) & 0x0000FFFF0000FFFFull) | ((x & 0x0000FFFF0000FFFFull) << 16);
    x = (x >> 32) | (x << 32);
    return x >> (64 - 2 * k);
}

// a 4-bit bitmap with positions b -> b^2 (the other strand's view)
__device__ __forceinline__ unsigned shuffle02(unsigned b) { return ((b >> 2) & 3) | ((b & 3) << 2); }

// whether cuckoo slot word v holds the key whose hash under `choice` (0: H1,
// 1: H2) has remainder rem
__device__ __forceinline__ bool q_slot_hit(u64 v, u64 rem, int choice) {
    return (v >> Q_SHIFT_PAY) == rem && (v & Q_VALID) && (((v & Q_CHOICE) != 0) == (choice == 1));
}

// the 16 slots of bucket b as eight 16-byte loads through the read-only path
__device__ __forceinline__ void qb_line(const u64* __restrict__ slots, u64 b, u64 (&w)[QB_SLOTS]) {
    const ulonglong2* row = reinterpret_cast<const ulonglong2*>(slots + b * QB_SLOTS);
#pragma unroll
    for (int i = 0; i < QB_SLOTS / 2; i++) {
        const ulonglong2 v = __ldg(row + i);
        w[2 * i] = v.x;
        w[2 * i + 1] = v.y;
    }
}

// the payload of the key with remainder rem in a bucket line: the max over
// the slots that hold it (0 if none), as the plain version reduces them
__device__ __forceinline__ unsigned qb_payload(const u64 (&w)[QB_SLOTS], u64 rem) {
    unsigned tbl = 0;
#pragma unroll
    for (int i = 0; i < QB_SLOTS; i++) {
        const unsigned p = (w[i] & QB_VALID) && (w[i] >> QB_SHIFT_PAY) == rem ? (unsigned)(w[i] & PAY_MASK) : 0u;
        tbl = tbl > p ? tbl : p;
    }
    return tbl;
}

}  // namespace qmap
