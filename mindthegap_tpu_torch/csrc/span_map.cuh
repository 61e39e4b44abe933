// The multi-word span map's probe, for keys of WQ <= 8 words held in
// registers: the canonical form of a (k-1)-mer, its digest and its lookup.
// Shared by K6 (scan_span.cu) and K7 (walk_span.cu), so both probe with the
// same code.
//
// The map is mindthegap_tpu_torch/ops/extmap.py QMapSpan (its int64 tensors
// from QMapSpan.to): `slots` u64[S], S = 2^log_size, in QMap's quotient
// encoding ([rem : 64-log_size][valid:1][choice:1][payload:9]); `sat`
// u64[WQ-1, S], words 1..WQ-1 of the key in each slot; a stash of 1..64
// entries (salted digest, WQ-1 words, payload), padded to one EMPTY entry
// of payload 0. Words are u64, word 0 most significant, the value right
// aligned (ops/span_device.py).
//
// lookup() computes extmap.lookup_q_span for one key:
//   - the digest chain of span_device.digest64, then the salt;
//   - the two slots from H1 and H2 (mix is a bijection on u64, so a slot's
//     remainder and choice bit name one digest);
//   - the slot test, then the satellite compare;
//   - the stash compare, whose payload is ORed into the result.
// Two shortcuts change nothing in the result and cut the sectors read:
// the satellites are read only after the slot's remainder matches, and the
// second slot only after the first misses (a key sits in one place).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace span_map {

typedef unsigned long long u64;

constexpr u64 H1 = 0x9E3779B97F4A7C15ull;
constexpr u64 H2 = 0xC2B2AE3D27D4EB4Full;
constexpr u64 H3 = 0xD6E8FEB86659FD93ull;  // digest64's mix
constexpr u64 PAY_MASK = 0x1FF;
constexpr u64 Q_VALID = 1ull << 10;
constexpr u64 Q_CHOICE = 1ull << 9;
constexpr int Q_SHIFT_PAY = 11;
constexpr int MAX_STASH = 64;
constexpr int MAX_WQ = 8;  // k <= 256: (k-1)-mers of at most 8 words

__device__ __forceinline__ u64 mix(u64 key, u64 c) {
    u64 h = (key ^ (key >> 33)) * c;
    return h ^ (h >> 29);
}

// all 32 bases of x reversed and complemented
__device__ __forceinline__ u64 revcomp_word(u64 x) {
    x ^= 0xAAAAAAAAAAAAAAAAull;
    x = ((x >> 2) & 0x3333333333333333ull) | ((x & 0x3333333333333333ull) << 2);
    x = ((x >> 4) & 0x0F0F0F0F0F0F0F0Full) | ((x & 0x0F0F0F0F0F0F0F0Full) << 4);
    x = ((x >> 8) & 0x00FF00FF00FF00FFull) | ((x & 0x00FF00FF00FF00FFull) << 8);
    x = ((x >> 16) & 0x0000FFFF0000FFFFull) | ((x & 0x0000FFFF0000FFFFull) << 16);
    return (x >> 32) | (x << 32);
}

// mask of the top word of an nb-base value in W words
__device__ __forceinline__ u64 top_mask(int nb, int W) {
    const int bits = 2 * nb - 64 * (W - 1);
    return bits >= 64 ? ~0ull : (1ull << bits) - 1;
}

// min(w, revcomp(w)) of an nb-base value in WQ words, by an unsigned
// compare from word 0; is_canon: w itself was the minimum (ties too)
template <int WQ>
__device__ __forceinline__ void canonical(const u64 (&w)[WQ], int nb, u64 (&out)[WQ], bool& is_canon) {
    u64 rc[WQ];
#pragma unroll
    for (int i = 0; i < WQ; i++) rc[i] = revcomp_word(w[WQ - 1 - i]);
    const int s = 64 * WQ - 2 * nb;  // 0 when 2 nb fills the words
    if (s) {
#pragma unroll
        for (int i = WQ - 1; i > 0; i--) rc[i] = (rc[i] >> s) | (rc[i - 1] << (64 - s));
        rc[0] >>= s;
    }
    bool take_f = true, decided = false;
#pragma unroll
    for (int i = 0; i < WQ; i++) {
        if (!decided && w[i] != rc[i]) {
            take_f = w[i] < rc[i];
            decided = true;
        }
    }
    is_canon = take_f;
#pragma unroll
    for (int i = 0; i < WQ; i++) out[i] = take_f ? w[i] : rc[i];
}

// key64 = w0 ^ G(w1..w_{WQ-1}), G a chain of 64-bit mixes
template <int WQ>
__device__ __forceinline__ u64 digest(const u64 (&w)[WQ]) {
    u64 g = 0;
#pragma unroll
    for (int i = 1; i < WQ; i++) {
        const u64 x = i == 1 ? w[1] : (g ^ w[i]);
        const u64 h = (x ^ (x >> 33)) * H3;
        g = h ^ (h >> 29);
    }
    return w[0] ^ g;
}

struct Map {
    const u64* slots;
    const u64* sat;  // [WQ-1][size]; null when WQ == 1
    int64_t size;
    int shift;  // 64 - log_size
    u64 rem_mask;
    u64 salt;
    const u64* stash_k;    // in shared memory once stage_stash ran
    const u64* stash_sat;  // [n_stash][WQ-1]
    const u64* stash_v;
    int n_stash;
};

// copy the stash into the block's shared memory and point `m` at it; the
// caller synchronises the block before the first lookup
template <int WQ>
__device__ __forceinline__ void stage_stash(Map& m, u64* s_k, u64* s_sat, u64* s_v) {
    for (int s = threadIdx.x; s < m.n_stash; s += blockDim.x) {
        s_k[s] = m.stash_k[s];
        s_v[s] = m.stash_v[s];
        for (int j = 0; j < WQ - 1; j++) s_sat[s * (WQ - 1) + j] = m.stash_sat[s * (WQ - 1) + j];
    }
    m.stash_k = s_k;
    m.stash_sat = s_sat;
    m.stash_v = s_v;
}

// the 9-bit payload of canonical key w (0 when absent)
template <int WQ>
__device__ __forceinline__ unsigned lookup(const Map& m, const u64 (&w)[WQ]) {
    const u64 dig = digest<WQ>(w) ^ m.salt;
    unsigned pay = 0;
#pragma unroll
    for (int i = 0; i < 2; i++) {
        const u64 h = mix(dig, i ? H2 : H1);
        const int64_t slot = (int64_t)(h >> m.shift);
        const u64 v = __ldg(m.slots + slot);
        bool hit = (v >> Q_SHIFT_PAY) == (h & m.rem_mask) && (v & Q_VALID) && (((v & Q_CHOICE) != 0) == (i == 1));
#pragma unroll
        for (int j = 1; j < WQ; j++)
            hit = hit && __ldg(m.sat + (int64_t)(j - 1) * m.size + slot) == w[j];
        if (hit) {
            pay = (unsigned)(v & PAY_MASK);
            break;
        }
    }
    for (int s = 0; s < m.n_stash; s++) {
        if (m.stash_k[s] != dig) continue;
        bool eq = true;
#pragma unroll
        for (int j = 1; j < WQ; j++) eq = eq && m.stash_sat[s * (WQ - 1) + j - 1] == w[j];
        if (eq) pay |= (unsigned)m.stash_v[s];
    }
    return pay;
}

// bitmap positions b -> b^2 (the other strand's view of a 4-bit set)
__device__ __forceinline__ unsigned shuffle02(unsigned b) {
    return ((b >> 2) & 3) | ((b & 3) << 2);
}

}  // namespace span_map
