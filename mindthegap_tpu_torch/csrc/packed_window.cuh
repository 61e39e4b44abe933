// A block's span of 2-bit packed bases and their bad bits, staged in shared
// memory, and the word tricks that read a k-mer out of it in constant time.
// Shared by K1 (scan_qp.cu) and K3 (count_kmers.cu).
//
// The inputs are pack_codes_host's (mindthegap_tpu_torch/find/scan_device.py):
// base q in bits 2*(q%4) of packed byte q/4, lowest first, and its bad bit
// (an invalid base or a separator) at bit 7 - q%8 of bad byte q/8, the
// big-endian order of np.packbits. The window holds w bases, w % 8 == 0.
//
// Staged, both streams are little-endian bit streams of 32-bit words:
//   s_code: base b0 + i in bits 2*(i%16) of word i/16, a bad base as 0;
//   s_bad:  base b0 + i at bit i%32 of word i/32, and 1 for every base
//           outside [0, w).
// So 64 bits read at bit 2*i of s_code are the 32 bases from b0 + i, the
// first in the lowest bits: a k-mer in reverse base order. Its reverse
// complement is that word complemented and masked; its forward word is one
// reversal of the 2-bit groups.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace packed_window {

typedef unsigned long long u64;

constexpr u64 COMP = 0xAAAAAAAAAAAAAAAAull;  // complement every base (A<->T, C<->G)

// 16 bits spread to the even bits of a 32-bit word
__device__ __forceinline__ uint32_t spread16(uint32_t x) {
    x = (x | (x << 8)) & 0x00FF00FFu;
    x = (x | (x << 4)) & 0x0F0F0F0Fu;
    x = (x | (x << 2)) & 0x33333333u;
    return (x | (x << 1)) & 0x55555555u;
}

// Stage bases [b0, b0 + 64 * n_chunks), b0 % 64 == 0 (b0 may be negative),
// one chunk of 64 bases per thread: 16 bytes of codes and 8 bytes of bad
// bits, each one vector load where the chunk lies inside the window and
// the pointers are aligned (packed to 16 bytes, bad to 8). The caller
// synchronises the block before reading.
__device__ __forceinline__ void stage(const uint8_t* __restrict__ packed, const uint8_t* __restrict__ bad,
                                      int64_t w, int64_t b0, int n_chunks, bool aligned,
                                      uint32_t* s_code, uint32_t* s_bad)
{
    for (int c = threadIdx.x; c < n_chunks; c += blockDim.x) {
        const int64_t q = b0 + 64 * (int64_t)c;
        uint32_t cw[4], bw[2];
        if (aligned && q >= 0 && q + 64 <= w) {
            const uint4 cv = __ldg(reinterpret_cast<const uint4*>(packed + q / 4));
            const uint2 bv = __ldg(reinterpret_cast<const uint2*>(bad + q / 8));
            cw[0] = cv.x, cw[1] = cv.y, cw[2] = cv.z, cw[3] = cv.w;
            bw[0] = bv.x, bw[1] = bv.y;
        } else {  // the window's edges: byte by byte, codes 0 and bad bits 1 outside
            for (int i = 0; i < 4; i++) {
                uint32_t v = 0;
                for (int j = 0; j < 4; j++) {
                    const int64_t byte = q / 4 + 4 * i + j;
                    v |= (uint32_t)(byte >= 0 && byte < w / 4 ? packed[byte] : 0) << (8 * j);
                }
                cw[i] = v;
            }
            for (int i = 0; i < 2; i++) {
                uint32_t v = 0;
                for (int j = 0; j < 4; j++) {
                    const int64_t byte = q / 8 + 4 * i + j;
                    v |= (uint32_t)(byte >= 0 && byte < w / 8 ? bad[byte] : 0xFF) << (8 * j);
                }
                bw[i] = v;
            }
        }
        // np.packbits order to little-endian bits: reverse the bits of each byte
        for (int i = 0; i < 2; i++) bw[i] = __byte_perm(__brev(bw[i]), 0, 0x0123);
        for (int i = 0; i < 4; i++) {
            const uint32_t m = spread16((bw[i >> 1] >> (16 * (i & 1))) & 0xFFFFu);
            s_code[4 * c + i] = cw[i] & ~(m | (m << 1));
        }
        s_bad[2 * c] = bw[0];
        s_bad[2 * c + 1] = bw[1];
    }
}

// 16 base codes (bytes in {0, 1, 2, 3, 255}, 255 = invalid) as the staged
// streams hold them: (32 bits of 2-bit codes, first base lowest; 16 bad
// bits, first base lowest). An invalid base keeps code 3 (255 & 3): every
// window that reads it is bad.
__device__ __forceinline__ void pack16(uint4 v, uint32_t& code, uint32_t& bad16) {
    const uint32_t x[4] = {v.x, v.y, v.z, v.w};
    code = 0, bad16 = 0;
#pragma unroll
    for (int i = 0; i < 4; i++) {
        uint32_t t = x[i] & 0x03030303u;                 // the low two bits of each byte
        t |= t >> 6;                                     // bytes 0, 1 in bits 0-3; bytes 2, 3 in bits 16-19
        code |= ((t & 0xFu) | ((t >> 12) & 0xF0u)) << (8 * i);
        const uint32_t m = (__vcmpeq4(x[i], 0xFFFFFFFFu) & 0x80808080u) >> 7;  // a bit at 0, 8, 16, 24
        bad16 |= ((m * 0x01020408u) >> 24 & 0xFu) << (4 * i);                    // gathered to bits 0-3
    }
}

// Stage bases [b0, b0 + 16 * n_units) of n u8 codes, b0 % 16 == 0, one
// unit of 16 bases per thread: one 16-byte load where the unit lies inside
// the codes and the pointer is 16-byte aligned, else byte by byte (255
// outside [0, n)). s_code as stage() leaves it (but for an invalid base's
// code, see pack16), s_bad as n_units / 2 words. The caller synchronises
// the block before reading.
__device__ __forceinline__ void stage_codes(const uint8_t* __restrict__ codes, int64_t n, int64_t b0, int n_units,
                                            bool aligned, uint32_t* s_code, uint32_t* s_bad)
{
    uint16_t* s_bad16 = reinterpret_cast<uint16_t*>(s_bad);
    for (int u = threadIdx.x; u < n_units; u += blockDim.x) {
        const int64_t q = b0 + 16 * (int64_t)u;
        uint4 v;
        if (aligned && q + 16 <= n) {
            v = __ldg(reinterpret_cast<const uint4*>(codes + q));
        } else {
            uint32_t w[4];
            for (int i = 0; i < 4; i++) {
                uint32_t x = 0;
                for (int j = 0; j < 4; j++) {
                    const int64_t p = q + 4 * i + j;
                    x |= (uint32_t)(p < n ? codes[p] : 255) << (8 * j);
                }
                w[i] = x;
            }
            v = make_uint4(w[0], w[1], w[2], w[3]);
        }
        uint32_t code, bad16;
        pack16(v, code, bad16);
        s_code[u] = code;
        s_bad16[u] = (uint16_t)bad16;
    }
}

// 64 bits of a staged stream from bit `bit` on (three word loads, two funnel shifts)
__device__ __forceinline__ u64 bits64(const uint32_t* s, int bit) {
    const int i = bit >> 5, sh = bit & 31;
    const uint32_t a = s[i], b = s[i + 1], c = s[i + 2];
    return ((u64)__funnelshift_r(b, c, sh) << 32) | __funnelshift_r(a, b, sh);
}

// 32 bits of a staged stream from bit `bit` on
__device__ __forceinline__ uint32_t bits32(const uint32_t* s, int bit) {
    return __funnelshift_r(s[bit >> 5], s[(bit >> 5) + 1], bit & 31);
}

// the 2-bit groups of x in reverse order
__device__ __forceinline__ u64 rev2(u64 x) {
    x = __brevll(x);
    return ((x >> 1) & 0x5555555555555555ull) | ((x & 0x5555555555555555ull) << 1);
}

// mask of the low 2k bits, 1 <= k <= 32
__device__ __forceinline__ u64 kmer_mask(int k) { return k == 32 ? ~0ull : (1ull << (2 * k)) - 1; }

// (forward word, reverse complement) of the k-mer whose bases are the low
// 2k bits of the little-endian window L (first base lowest)
__device__ __forceinline__ void kmer_words(u64 L, int k, u64& fwd, u64& rc) {
    fwd = rev2(L) >> (64 - 2 * k);
    rc = (L ^ COMP) & kmer_mask(k);
}

}  // namespace packed_window
