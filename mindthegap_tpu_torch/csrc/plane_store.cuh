// The seven planes of find/scan.py Planes as the plane kernels write them
// (K8, K9 and K15 in scan_planes.cu, K16 in scan_planes_span.cu): the
// output pointers, a thread's vector stores of R consecutive positions, a
// canonical payload turned to the strand it is read on, and the grid of
// persistent blocks.

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
// window): vector stores where all R are, R is 2, 4 or 8 and the plane is
// aligned
template <int R>
__device__ __forceinline__ void put(uint8_t* __restrict__ out, int64_t i0, const uint8_t (&v)[R], int n, bool vec) {
    if constexpr (R == 2 || R == 4 || R == 8) {
        if (vec && n == R) {
            u64 x = 0;
#pragma unroll
            for (int e = 0; e < R; e++) x |= (u64)v[e] << (8 * e);
            if constexpr (R == 8) *reinterpret_cast<u64*>(out + i0) = x;
            else if constexpr (R == 4) *reinterpret_cast<uint32_t*>(out + i0) = (uint32_t)x;
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
    if constexpr (R == 2 || R == 4 || R == 8) {
        if (vec && n == R) {
            if constexpr (R == 2) {
                *reinterpret_cast<int2*>(out + i0) = make_int2(v[0], v[1]);
            } else {
#pragma unroll
                for (int h = 0; h < R / 4; h++)
                    reinterpret_cast<int4*>(out + i0)[h] =
                        make_int4(v[4 * h], v[4 * h + 1], v[4 * h + 2], v[4 * h + 3]);
            }
            return;
        }
    }
#pragma unroll
    for (int e = 0; e < R; e++)
        if (e < n) out[i0 + e] = v[e];
}

template <int R>
__device__ __forceinline__ void put(long long* __restrict__ out, int64_t i0, const u64 (&v)[R], int n, bool vec) {
    if constexpr (R == 2 || R == 4 || R == 8) {
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

// blocks of KERNEL (static shared memory only, `threads` a block) that the
// card holds at once, at most one a tile: the grid of a kernel whose blocks
// each take every gridDim.x-th tile (K8, K15, K16)
template <auto KERNEL>
int resident_grid(int64_t n_tiles, int threads) {
    static int per_sm = 0;
    if (!per_sm && cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, KERNEL, threads, 0) != cudaSuccess)
        per_sm = 1;
    int dev = 0, sms = 1;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const int64_t most = (int64_t)(per_sm > 0 ? per_sm : 1) * sms;
    return (int)(n_tiles < most ? n_tiles : most);
}

}  // namespace planes
