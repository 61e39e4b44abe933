// The seven planes of find/scan.py Planes as the plane kernels write them
// (K8, K9 and K15 in scan_planes.cu, K16 in scan_planes_span.cu): the
// output pointers, a thread's vector stores of R consecutive positions, and
// a canonical payload turned to the strand it is read on.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace planes {

typedef unsigned long long u64;

// fwd: P words (k <= 32) or Wk rows of P words (the span planes, word 0
// first); the others P entries each
struct PlaneOut {
    long long* fwd;
    uint8_t* valid;
    uint8_t* contains;
    int32_t* nb_in;
    int32_t* nb_out;
    uint8_t* suffix_rep;
    uint8_t* prefix_rep;
};

// a thread's R outputs of one plane from position i0 (n of them in the
// window): one vector store where all R are, R is 2 or 4 and the plane is
// aligned
template <int R>
__device__ __forceinline__ void put(uint8_t* __restrict__ out, int64_t i0, const uint8_t (&v)[R], int n, bool vec) {
    if constexpr (R == 2 || R == 4) {
        if (vec && n == R) {
            uint32_t x = 0;
#pragma unroll
            for (int e = 0; e < R; e++) x |= (uint32_t)v[e] << (8 * e);
            if constexpr (R == 4) *reinterpret_cast<uint32_t*>(out + i0) = x;
            else *reinterpret_cast<uint16_t*>(out + i0) = (uint16_t)x;
            return;
        }
    }
#pragma unroll
    for (int e = 0; e < R; e++)
        if (e < n) out[i0 + e] = v[e];
}

template <int R>
__device__ __forceinline__ void put(int32_t* __restrict__ out, int64_t i0, const int32_t (&v)[R], int n, bool vec) {
    if constexpr (R == 2 || R == 4) {
        if (vec && n == R) {
            if constexpr (R == 4) *reinterpret_cast<int4*>(out + i0) = make_int4(v[0], v[1], v[2], v[3]);
            else *reinterpret_cast<int2*>(out + i0) = make_int2(v[0], v[1]);
            return;
        }
    }
#pragma unroll
    for (int e = 0; e < R; e++)
        if (e < n) out[i0 + e] = v[e];
}

template <int R>
__device__ __forceinline__ void put(long long* __restrict__ out, int64_t i0, const u64 (&v)[R], int n, bool vec) {
    if constexpr (R == 2 || R == 4) {
        if (vec && n == R) {
#pragma unroll
            for (int h = 0; h < R / 2; h++)
                reinterpret_cast<ulonglong2*>(out + i0)[h] = make_ulonglong2(v[2 * h], v[2 * h + 1]);
            return;
        }
    }
#pragma unroll
    for (int e = 0; e < R; e++)
        if (e < n) out[i0 + e] = (long long)v[e];
}

// a canonical payload oriented to its strand: ext | pre << 4 | rep << 8,
// the other strand's ext and pre being pre's and ext's bitmaps with
// positions b -> b^2
__device__ __forceinline__ unsigned orient(unsigned p, bool strand) {
    const unsigned ext_c = p & 0xF, pre_c = (p >> 4) & 0xF;
    const unsigned ext_r = ((pre_c >> 2) & 3) | ((pre_c & 3) << 2), pre_r = ((ext_c >> 2) & 3) | ((ext_c & 3) << 2);
    return (strand ? (ext_c | pre_c << 4) : (ext_r | pre_r << 4)) | (p & 0x100);
}

// the flag of a tile's published payload (the look-forward of K15 and K16:
// a tile's last position needs the next tile's first payload, so the next
// tile writes it, from the payload this tile publishes)
constexpr u64 PUBLISHED = 1ull << 32;

__device__ __forceinline__ void publish_last(u64* state, unsigned opay) { atomicExch(state, PUBLISHED | opay); }

// the payload tile t - 1 published, once it has (tiles are claimed in order
// from a counter, so tile t - 1 runs or has run and never waits on t)
__device__ __forceinline__ unsigned wait_last(const u64* state) {
    u64 st;
    do {
        st = *(const volatile u64*)state;
    } while (!(st & PUBLISHED));
    return (unsigned)st & 0x1FF;
}

}  // namespace planes
