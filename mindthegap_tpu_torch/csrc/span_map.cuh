// The multi-word span map's probe, for keys of WQ <= 8 words held in
// registers: the canonical form of a (k-1)-mer, its digest, and its lookup
// in two halves, issue and resolve, so that a caller puts many probes in
// flight before it waits on any. Shared by K6 (scan_span.cu) and K7
// (walk_span.cu), so both probe with the same code.
//
// The map is mindthegap_tpu_torch/ops/extmap.py QMapSpan (its int64 tensors
// from QMapSpan.to): `slots` u64[S], S = 2^log_size, in QMap's quotient
// encoding ([rem : 64-log_size][valid:1][choice:1][payload:9]); `sat`
// u64[WQ-1, S], words 1..WQ-1 of the key in each slot; a stash of 1..64
// entries (salted digest, WQ-1 words, payload), padded to one EMPTY entry
// of payload 0. Words are u64, word 0 most significant, the value right
// aligned (ops/span_device.py).
//
// A probe computes extmap.lookup_q_span for one key:
//   - the digest chain of span_device.digest64, then the salt;
//   - the two slots from H1 and H2 (mix is a bijection on u64, so a slot's
//     remainder and choice bit name one digest);
//   - the slot test (remainder, valid bit, choice bit), then the satellite
//     compare; the second choice's hit is taken over the first's, as in the
//     plain version (a key sits in one place, so at most one hits);
//   - the stash compare, whose payload is ORed into the result.
//
// Issue (load_word, load_sat, load_slot) computes a choice's slot index
// from the digest and loads the slot word and, where WQ > 1, its WQ-1
// satellite words. The satellite address depends only on the slot index,
// so the satellites can go out with the slot word: every slot index is <
// S, so those speculative loads stay in range; at WQ = 1 `sat` is null and
// none is formed. Resolve (slot_here, sat_equal, slot_holds, stash_pay)
// does the tests; the stash compare reads shared memory, so a caller runs
// it while the table loads are in flight. Two ways to issue, one per
// kernel's bound:
//   - eager (Eager, issue_eager / resolve_eager): both choices with all
//     their words at once, 2 WQ sectors and one round trip a probe. K7's
//     walk is a chain of dependent probes, latency bound, and takes this.
//   - lazy, with many keys in flight (probe_lazy): a caller issues the
//     first slot word of every key it holds at once (issue_lazy), then
//     round by round each key's next load (resolve_lazy: the satellites
//     where the slot holds the digest, the second slot after a miss), so it
//     reads only the sectors the lookup needs. K6 runs at the card's rate
//     of random sectors and takes this; loading the first slot's satellites
//     with it read 7-11% more sectors and was slower (scan_span.cu). K16
//     calls the two halves apart, to write a tile's planes between them.
// staged_keys builds the keys of consecutive (k-1)-mers of a window staged
// in shared memory (packed_window.cuh) for K6 and K16.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "packed_window.cuh"

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

// the map of a launch's arguments (the tables of QMapSpan.to, stash in
// device memory until stage_stash)
__host__ inline Map make_map(const void* slots, const void* sat, int log_size, int64_t salt,
                             const void* stash_k, const void* stash_sat, const void* stash_v, int n_stash) {
    Map m;
    m.slots = (const u64*)slots;
    m.sat = (const u64*)sat;
    m.size = 1ll << log_size;
    m.shift = 64 - log_size;
    m.rem_mask = (1ull << m.shift) - 1;
    m.salt = (u64)salt;
    m.stash_k = (const u64*)stash_k;
    m.stash_sat = (const u64*)stash_sat;
    m.stash_v = (const u64*)stash_v;
    m.n_stash = n_stash;
    return m;
}

// copy the stash into the block's shared memory and point `m` at it; the
// caller synchronises the block before the first probe
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

// one choice's loads: the slot word and its WQ-1 satellite words
template <int WQ>
struct Slot {
    u64 v;
    u64 sat[WQ > 1 ? WQ - 1 : 1];
};

// issue: the slot word that hash h names
__device__ __forceinline__ u64 load_word(const Map& m, u64 h) {
    return __ldg(m.slots + (int64_t)(h >> m.shift));
}

// issue: the satellite words of the slot that hash h names
template <int WQ>
__device__ __forceinline__ void load_sat(const Map& m, u64 h, Slot<WQ>& s) {
    const int64_t slot = (int64_t)(h >> m.shift);
#pragma unroll
    for (int j = 0; j < WQ - 1; j++) s.sat[j] = __ldg(m.sat + (int64_t)j * m.size + slot);
}

// issue: all the loads of the slot that hash h names at once
template <int WQ>
__device__ __forceinline__ void load_slot(const Map& m, u64 h, Slot<WQ>& s) {
    s.v = load_word(m, h);
    load_sat<WQ>(m, h, s);
}

// resolve: whether slot word v (choice i, hash h) holds the key's digest:
// its remainder, valid bit and choice bit
__device__ __forceinline__ bool slot_here(const Map& m, u64 v, u64 h, int i) {
    return (v >> Q_SHIFT_PAY) == (h & m.rem_mask) && (v & Q_VALID) && (((v & Q_CHOICE) != 0) == (i == 1));
}

// resolve: whether the satellite words equal words 1..WQ-1 of key w
template <int WQ>
__device__ __forceinline__ bool sat_equal(const Slot<WQ>& s, const u64 (&w)[WQ]) {
    bool eq = true;
#pragma unroll
    for (int j = 1; j < WQ; j++) eq = eq && s.sat[j - 1] == w[j];
    return eq;
}

// resolve: whether slot s (choice i, hash h) holds key w
template <int WQ>
__device__ __forceinline__ bool slot_holds(const Map& m, const Slot<WQ>& s, u64 h, int i, const u64 (&w)[WQ]) {
    return slot_here(m, s.v, h, i) && sat_equal<WQ>(s, w);
}

// resolve: the payload the stash holds for key w of salted digest dig (0
// when none); reads shared memory only
template <int WQ>
__device__ __forceinline__ unsigned stash_pay(const Map& m, u64 dig, const u64 (&w)[WQ]) {
    unsigned pay = 0;
    for (int s = 0; s < m.n_stash; s++) {
        if (m.stash_k[s] != dig) continue;
        bool eq = true;
#pragma unroll
        for (int j = 1; j < WQ; j++) eq = eq && m.stash_sat[s * (WQ - 1) + j - 1] == w[j];
        if (eq) pay |= (unsigned)m.stash_v[s];
    }
    return pay;
}

// the canonical words, the strand (whether each is canonical as read, ties
// too) and the salted digest of PER consecutive (k-1)-mers of nb bases, the
// first at base o of a staged window (packed_window.cuh): the first from
// 64-bit reads of the staged stream, each next one by shifting in a base
template <int WQ, int PER>
__device__ __forceinline__ void staged_keys(const Map& m, const uint32_t* s_code, int o, int nb,
                                            u64 (&cq)[PER][WQ], bool (&is_canon)[PER], u64 (&dig)[PER]) {
    using packed_window::bits64;
    using packed_window::rev2;
    const int tb = nb - 32 * (WQ - 1);  // bases in word 0, 1..32
    const u64 top = top_mask(nb, WQ);
    u64 q[WQ];
    q[0] = rev2(bits64(s_code, 2 * o)) >> (64 - 2 * tb);
#pragma unroll
    for (int i = 1; i < WQ; i++) q[i] = rev2(bits64(s_code, 2 * (o + tb + 32 * (i - 1))));
#pragma unroll
    for (int p = 0; p < PER; p++) {
        if (p > 0) {  // shift in the key's last base
            const int ob = o + p + nb - 1;
            const u64 c = (s_code[ob >> 4] >> (2 * (ob & 15))) & 3;
#pragma unroll
            for (int i = 0; i < WQ - 1; i++) q[i] = (q[i] << 2) | (q[i + 1] >> 62);
            q[WQ - 1] = (q[WQ - 1] << 2) | c;
            q[0] &= top;
        }
        canonical<WQ>(q, nb, cq[p], is_canon[p]);
        dig[p] = digest<WQ>(cq[p]) ^ m.salt;
    }
}

// a key's next load in probe_lazy: its first slot word, that slot's
// satellite words, the second slot word, its satellite words, or none (its
// payload is known)
enum LazyStep { SLOT0, SAT0, SLOT1, SAT1, DONE };

// a thread's keys in probe_lazy: each one's loads and its next load (a LazyStep)
template <int WQ, int PER>
struct Lazy {
    Slot<WQ> s[PER];
    int next[PER];
};

// issue: the first slot word of each of the first n of PER keys of salted
// digests dig, all at once
template <int WQ, int PER>
__device__ __forceinline__ void issue_lazy(const Map& m, const u64 (&dig)[PER], int n, Lazy<WQ, PER>& z) {
#pragma unroll
    for (int p = 0; p < PER; p++) {
        z.next[p] = p < n ? SLOT0 : DONE;
        if (p < n) z.s[p].v = load_word(m, mix(dig[p], H1));
    }
}

// resolve: the 9-bit payloads of the first n of PER canonical keys (0 for
// the others) whose first slot words issue_lazy issued: the stash (shared
// memory) first, then round by round a test of what arrived and every
// key's next load together (the satellites where a slot holds the digest,
// the second slot after a miss). A key in its first slot waits two round
// trips, in its second three.
template <int WQ, int PER>
__device__ __forceinline__ void resolve_lazy(const Map& m, const u64 (&cq)[PER][WQ], const u64 (&dig)[PER], int n,
                                             Lazy<WQ, PER>& z, unsigned (&pay)[PER]) {
    Slot<WQ>(&s)[PER] = z.s;
    int(&next)[PER] = z.next;
#pragma unroll
    for (int p = 0; p < PER; p++) pay[p] = p < n ? stash_pay<WQ>(m, dig[p], cq[p]) : 0u;
    for (;;) {
        bool pending = false;
#pragma unroll
        for (int p = 0; p < PER; p++) {
            const int i = next[p] == SLOT1 || next[p] == SAT1;  // the choice
            const u64 h = mix(dig[p], i ? H2 : H1);
            if (next[p] == SLOT0 || next[p] == SLOT1) {
                if (slot_here(m, s[p].v, h, i)) {
                    if (WQ > 1) {
                        next[p] = i ? SAT1 : SAT0;
                    } else {
                        pay[p] |= (unsigned)(s[p].v & PAY_MASK);
                        next[p] = DONE;
                    }
                } else {
                    next[p] = i ? DONE : SLOT1;
                }
            } else if (next[p] != DONE) {
                if (sat_equal<WQ>(s[p], cq[p])) {
                    pay[p] |= (unsigned)(s[p].v & PAY_MASK);
                    next[p] = DONE;
                } else {
                    next[p] = i ? DONE : SLOT1;  // the digest's other key: the second slot
                }
            }
            pending |= next[p] != DONE;
        }
        if (!pending) break;
#pragma unroll
        for (int p = 0; p < PER; p++) {
            if (next[p] == SLOT1) s[p].v = load_word(m, mix(dig[p], H2));
            if (next[p] == SAT0 || next[p] == SAT1) load_sat<WQ>(m, mix(dig[p], next[p] == SAT1 ? H2 : H1), s[p]);
        }
    }
}

// the 9-bit payloads of the first n of PER canonical keys (0 for the
// others), all of their probes in flight together: issue_lazy, then
// resolve_lazy
template <int WQ, int PER>
__device__ __forceinline__ void probe_lazy(const Map& m, const u64 (&cq)[PER][WQ], const u64 (&dig)[PER], int n,
                                           unsigned (&pay)[PER]) {
    Lazy<WQ, PER> z;
    issue_lazy<WQ, PER>(m, dig, n, z);
    resolve_lazy<WQ, PER>(m, cq, dig, n, z, pay);
}

// an eager probe in flight: the salted digest, both hashes, both slots
template <int WQ>
struct Eager {
    u64 dig, h[2];
    Slot<WQ> s[2];
};

// issue both choices of canonical key w, 2 WQ loads in one round trip
template <int WQ>
__device__ __forceinline__ void issue_eager(const Map& m, const u64 (&w)[WQ], Eager<WQ>& p) {
    p.dig = digest<WQ>(w) ^ m.salt;
#pragma unroll
    for (int i = 0; i < 2; i++) {
        p.h[i] = mix(p.dig, i ? H2 : H1);
        load_slot<WQ>(m, p.h[i], p.s[i]);
    }
}

// the 9-bit payload of an eager probe of w (0 when absent): the stash
// first, from shared memory while the table loads arrive
template <int WQ>
__device__ __forceinline__ unsigned resolve_eager(const Map& m, const u64 (&w)[WQ], const Eager<WQ>& p) {
    const unsigned stash = stash_pay<WQ>(m, p.dig, w);
    unsigned tbl = 0;
#pragma unroll
    for (int i = 0; i < 2; i++)
        if (slot_holds<WQ>(m, p.s[i], p.h[i], i, w)) tbl = (unsigned)(p.s[i].v & PAY_MASK);
    return stash | tbl;
}

// bitmap positions b -> b^2 (the other strand's view of a 4-bit set)
__device__ __forceinline__ unsigned shuffle02(unsigned b) {
    return ((b >> 2) & 3) | ((b & 3) << 2);
}

}  // namespace span_map
