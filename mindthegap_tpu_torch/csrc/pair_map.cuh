// The probe primitives of the pair-coalesced quotient map
// (mindthegap_tpu_torch/ops/extmap.py QMapP, 3 <= k <= 32), shared by K1
// and K10 (scan_qp.cu) and K15 (scan_planes.cu).
//
// One 16-byte row holds both payloads of the two (k-1)-mers that share a
// canonical (k-2)-mer: a 2-choice cuckoo table under qmap.cuh's mix (a
// bijection on u64, so a row's remainder and choice bit name one key),
//   lane0: [ rem : 45 ][ valid:1 ][ choice:1 ][ L bits 28..35 : 8 ]
//   lane1: [ L bits 0..27 : 28 ][ R : 36 ]
// L36 and R36 hold four 9-bit payloads each (ext | pre << 4 | rep << 8),
// one for each flanking base; a <= 64-entry stash of (key, L36, R36) rows,
// sorted by key with EMPTY padding, holds the keys the table could not
// place.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "qmap.cuh"

namespace pair_map {

using qmap::H1;
using qmap::H2;
using qmap::MAX_STASH;
using qmap::mix;

constexpr unsigned long long QP_REM_MASK = (1ull << 45) - 1;
constexpr unsigned long long QP_CHOICE = 1ull << 8;
constexpr unsigned long long QP_VALID = 1ull << 9;
constexpr unsigned long long QP_L36 = (1ull << 36) - 1;

// the rc transform of a 9-bit payload (as read -> the other strand)
__device__ __forceinline__ unsigned long long flip9(unsigned long long p) {
    return qmap::shuffle02((unsigned)(p >> 4) & 0xF) | (qmap::shuffle02((unsigned)p & 0xF) << 4) | (p & 0x100);
}

// the payload of flanking base i4 in a 36-bit block
__device__ __forceinline__ unsigned long long sub9(unsigned long long blk, unsigned long long i4) {
    return (blk >> (9 * i4)) & 0x1FF;
}

// whether `row` holds the key whose hash under `choice` (0: H1, 1: H2) is h
__device__ __forceinline__ bool row_hit(ulonglong2 row, unsigned long long h, unsigned long long rem_mask,
                                        int choice) {
    return (((row.x >> 10) & QP_REM_MASK) == (h & rem_mask)) && (row.x & QP_VALID)
        && (((row.x & QP_CHOICE) != 0) == (choice == 1));
}

// the (L36, R36) of a hit row, 0 for a miss
__device__ __forceinline__ void row_blocks(ulonglong2 row, bool hit, unsigned long long& l36,
                                           unsigned long long& r36) {
    l36 = hit ? ((row.x & 0xFF) << 28) | (row.y >> 36) : 0;
    r36 = hit ? row.y & QP_L36 : 0;
}

// the stash's (L36, R36) of `key`, OR-ed in: a lower bound over the 64
// sorted slots then one compare, or a full scan of an unsorted stash
__device__ __forceinline__ void stash_rows(const unsigned long long* s_k, const unsigned long long* s_l,
                                           const unsigned long long* s_r, int n_stash, bool sorted,
                                           unsigned long long key, unsigned long long& l36, unsigned long long& r36) {
    if (sorted) {
        int i = 0;
#pragma unroll
        for (int step = MAX_STASH / 2; step >= 1; step >>= 1)
            if (s_k[i + step - 1] < key) i += step;
        if (s_k[i] == key) {
            l36 |= s_l[i];
            r36 |= s_r[i];
        }
    } else {
        for (int s = 0; s < n_stash; s++) {
            if (s_k[s] == key) {
                l36 |= s_l[s];
                r36 |= s_r[s];
            }
        }
    }
}

// the payloads of entries 2m and 2m + 1 (oriented as read) from the pair's
// blocks: y is base 2m, x base 2m + k - 1, strand whether the (k-2)-mer at
// base 2m + 1 is read on its canonical strand
__device__ __forceinline__ void pair_payloads(bool strand, unsigned long long l36, unsigned long long r36,
                                              unsigned long long y, unsigned long long x,
                                              unsigned long long& pe, unsigned long long& po) {
    pe = strand ? sub9(l36, y) : flip9(sub9(r36, y ^ 2));
    po = strand ? sub9(r36, x) : flip9(sub9(l36, x ^ 2));
}

}  // namespace pair_map
