// K8, K9 and K15: the plane pass of one window over the fused quotient maps
// (mindthegap_tpu_torch/find/scan_device.py _scan_planes_q_plain,
// _scan_planes_qb_plain and _scan_planes_qp_plain, which these kernels must
// equal bit for bit).
//
// Replaces: mindthegap_tpu/find/scan_device.py scan_planes_device_q (K8,
// over the 2-choice cuckoo QMap), scan_planes_device_qb (K9, over the
// 16-slot bucket QMapB) and scan_planes_device_qp (K15, over the
// pair-coalesced QMapP, with _pair_pay_device), with
// mindthegap_tpu/ops/extmap.py lookup_q, lookup_qb_chunked, lookup_qp and
// planes_from_payload: XLA programs on the TPU.
//
// For each position i of the window (P = w - k + 1 of them; a bad base
// reads as A) the seven planes of find/scan.py Planes: the forward k-mer
// (fwd), its validity (no bad base), and from the 9-bit payloads of the
// canonical (k-1)-mers q_i and q_{i+1}, each oriented to its strand:
//   contains = ext(q_i) has the k-mer's last base,
//   nb_in = popcount(pre(q_i)), nb_out = popcount(ext(q_{i+1})), both 0
//   where contains is false,
//   prefix_rep = the repeat bit of q_i, suffix_rep that of q_{i+1}.
//
// Bound on this card: the probes, random reads of a table far above the 50
// MB L2 (128 MB cuckoo, 256 MB bucket at a bacterial genome): one 32-byte
// sector for each (k-1)-mer's first-choice slot, one more where the key is
// not there (K8), or the 128-byte bucket line, four sectors (K9); and the
// 20 bytes of planes written per position (84 MB per 2^22-base window).
// bounds.py plane_scan_sectors counts the sectors of a run's window. The
// card reads random rows of a 128 MB table at ~30 G a second by
// torch.index_select and ~34 G by a hand gather with 8 loads in flight a
// thread (plane_trials.py), far below 3.35 TB/s over 32-byte sectors: K8's
// 4.80 M probe sectors of a 2^22-base window take 0.140 ms at 34 G/s.
//
// Both kernels take a block of 256 threads and stage the bases of its
// positions in shared memory (packed_window.cuh, as K1 and K3): each
// (k-1)-mer and k-mer is one 64-bit funnel-shifted read, its reverse
// complement a complement and a mask. A thread takes R consecutive
// positions, and each plane is written as one vector store per thread (R
// bytes, 4R bytes or 8R bytes), consecutive threads on consecutive
// addresses; a plane view that is not 16-byte aligned is written element
// by element. The stash is searched in shared memory, by bisection when
// sorted (as the maps keep it). The maps place each key once (its first
// slot, its second or the stash), so a hit names the key's payload.
//
// K8 (R = 4: tiles of 1,024 positions and their 1,025 (k-1)-mers) is a
// software pipeline over persistent blocks, each taking every G-th tile
// (G blocks, as many as the card holds at once):
//   - a tile's first-choice slot loads are issued in the iteration before
//     the one that writes its planes, together with the second-choice
//     loads of the tile before it, so that every iteration waits for one
//     round trip to device memory, not two;
//   - the keys that miss their first choice go to a queue in shared memory,
//     and the block's threads take them densely: the second choice is read
//     only after a miss (K1's finding: ~43% fewer sectors than both), and
//     no warp waits on the one key of its 128 that missed;
//   - the oriented payloads of a tile are kept in shared memory until its
//     planes are written, so a tile's last (k-1)-mer is probed once, and
//     the planes' stores of one tile go out while the next tile's
//     first-choice loads are in flight;
//   - the bases of three tiles are staged in a ring (the tile being
//     written, the one being probed, the next), the payloads and queues of
//     two, so two barriers an iteration keep them apart.
//   Measured on an H100 80GB HBM3 at 700 W (kernel_bench.py, the 2^22
//   window over a bacterial map): 0.173-0.175 ms in turns against
//   0.180-0.182 for a block a tile with the second round in each warp's
//   registers. The stores cost ~0.038 ms, which neither TMA bulk copies
//   nor coalesced stores of the planes staged in shared memory won back,
//   and staging the next tile by cp.async gained nothing (plane_trials.py);
//   without its stores K8 reads its probe sectors at ~36 G a second.
// K9 (R = 2, a block a tile) issues the R bucket lines of a thread as eight
// 16-byte loads each before reducing any; the payload past a thread's run,
// q_{i+R}, is its right neighbour's first, taken by a shuffle (the warp's
// last lane probes it itself).
// K15 is K10's probe (scan_qp.cu; pair_map.cuh) with K8's plane stores: one
// 16-byte row a pair of positions holds both of their payloads, already
// oriented as read, so the bound is K10's row sectors (bounds.py
// scan_probe_sectors; one lookup per two positions, half K8's) and the 20
// bytes of planes a position. One launch of persistent blocks, each taking
// every G-th tile of 512 pairs (G blocks, as many as the card holds at
// once); a thread takes K10's 2 pairs, their first-choice rows in flight
// together, the second choice after a miss, then the planes of its 4
// positions. The payload past a thread's run is its right neighbour's
// first: a shuffle in the warp, shared memory across warps; past the tile,
// the halo, the pair past the tile's end, which the tile's last thread
// probes as a third pair (one more row per 512 pairs, +0.2% of the
// sectors), so a tile writes all of its positions and tiles run in any
// order. An iteration issues the next tile's first-choice rows, then
// writes the planes of the tile it resolved before while they are in
// flight (the keys are formed again from the staged bases rather than kept
// in registers over the stores); the bases of three tiles are staged in a
// ring.
//   Measured on an H100 80GB HBM3 at 700 W (kernel_bench.py --only
//   plane_passes, the 2^22 window): 0.1155-0.1189 ms in turns against
//   0.1209-0.1216 for the design before it (a block a tile, each tile's
//   last position written by the next tile from the payload it published,
//   a scratch zeroed by a memset), by launch 0.1107-0.1110 against
//   0.1131-0.1132 and a 0.0011 memset. A grid of one block a tile ties
//   this one; the stores issued before the next tile's rows lose 2-3%, 4
//   pairs a thread 14% (plane_trials.py). Without its stores K15 takes
//   0.085 ms, K10's time: the stores add about their byte time (0.025 ms),
//   since the probes hold the card's rate of random sectors, a rate of the
//   memory and not of latency, which the stores draw on too.

#include <cstdint>
#include <cuda_runtime.h>

#include "packed_window.cuh"
#include "pair_map.cuh"
#include "plane_store.cuh"
#include "qmap.cuh"

namespace {

using namespace packed_window;
using planes::orient;
using planes::PlaneOut;
using planes::put;

constexpr int THREADS = 256;
constexpr unsigned FULL = 0xFFFFFFFFu;

// K9: positions a thread takes, positions a block takes, 64-base chunks it stages
constexpr int QB_R = 2;
constexpr int QB_TPOS = THREADS * QB_R;
constexpr int QB_CHUNKS = QB_TPOS / 64 + 2;  // and the k - 1 bases past them

// K8: positions a thread takes, positions a tile holds, its (k-1)-mers, its chunks
constexpr int Q_R = 4;
constexpr int Q_TPOS = THREADS * Q_R;
constexpr int Q_KEYS = Q_TPOS + 1;
constexpr int Q_CHUNKS = Q_TPOS / 64 + 2;
constexpr int Q_KEYS_A_THREAD = (Q_KEYS + THREADS - 1) / THREADS;  // queue entries a thread takes at most

// the stash's payload of `key` (0 if absent): a lower bound over the 64
// sorted slots then one compare, or the sum over a full scan of an
// unsorted stash (the plain version sums the matches)
__device__ __forceinline__ unsigned stash_payload(const u64* s_k, const unsigned* s_v, int n_stash, bool sorted,
                                                  u64 key) {
    if (sorted) {
        int i = 0;
#pragma unroll
        for (int step = qmap::MAX_STASH / 2; step >= 1; step >>= 1)
            if (s_k[i + step - 1] < key) i += step;
        return s_k[i] == key ? s_v[i] : 0u;
    }
    unsigned pay = 0;
    for (int s = 0; s < n_stash; s++) pay += s_k[s] == key ? s_v[s] : 0u;
    return pay;
}

// the stash in shared memory, the padding past n_stash sorting last and
// equal to no key; whether it is sorted (every thread of the block calls)
__device__ __forceinline__ bool stage_stash(const u64* __restrict__ stash_k, const u64* __restrict__ stash_v,
                                            int n_stash, u64* s_k, unsigned* s_v) {
    const int tid = threadIdx.x;
    for (int s = tid; s < qmap::MAX_STASH; s += THREADS) {
        s_k[s] = s < n_stash ? stash_k[s] : ~0ull;
        s_v[s] = s < n_stash ? (unsigned)stash_v[s] : 0u;
    }
    __syncthreads();
    return !__syncthreads_or(tid + 1 < n_stash && s_k[tid] >= s_k[tid + 1]);
}

// the canonical (k-1)-mer at `rel` of a staged tile, and whether it is read on its canonical strand
__device__ __forceinline__ u64 canonical_km1(const uint32_t* s_code, int rel, int k, bool& strand) {
    u64 f, r;
    kmer_words(bits64(s_code, 2 * rel), k - 1, f, r);
    const u64 key = f < r ? f : r;
    strand = f == key;
    return key;
}

// the planes of a thread's R positions from i0 = p0 + rel0 (the window's
// n_pos positions; bases staged from p0), from the oriented payloads of
// their R (k-1)-mers and the one past them
template <int R>
__device__ __forceinline__ void write_planes(const uint32_t* s_code, const uint32_t* s_bad, int rel0, int64_t i0,
                                             const unsigned (&opay)[R + 1], int k, int64_t n_pos,
                                             const PlaneOut& o, bool vec) {
    u64 fwd[R];
    uint8_t valid[R], contains[R], srep[R], prep[R];
    int32_t nbi[R], nbo[R];
    const u64 kbits = (1ull << k) - 1;
#pragma unroll
    for (int e = 0; e < R; e++) {
        const int rel = rel0 + e;
        u64 f, r;
        kmer_words(bits64(s_code, 2 * rel), k, f, r);
        fwd[e] = f;
        valid[e] = (bits64(s_bad, rel) & kbits) == 0;
        const unsigned ext = opay[e] & 0xF, pre = (opay[e] >> 4) & 0xF;
        const bool c = (ext >> (unsigned)(f & 3)) & 1;  // the k-mer's last base
        contains[e] = c;
        nbi[e] = c ? __popc(pre) : 0;
        nbo[e] = c ? __popc(opay[e + 1] & 0xF) : 0;
        prep[e] = (opay[e] >> 8) & 1;
        srep[e] = (opay[e + 1] >> 8) & 1;
    }
    const int64_t left = n_pos - i0;
    if (left <= 0) return;
    const int n = left < R ? (int)left : R;
    put<R>(o.fwd, i0, fwd, n, vec);
    put<R>(o.valid, i0, valid, n, vec);
    put<R>(o.contains, i0, contains, n, vec);
    put<R>(o.nb_in, i0, nbi, n, vec);
    put<R>(o.nb_out, i0, nbo, n, vec);
    put<R>(o.suffix_rep, i0, srep, n, vec);
    put<R>(o.prefix_rep, i0, prep, n, vec);
}

// ---------------------------------------------------------------------------
// K8

// whether entry e of the thread's (k-1)-mers of the tile at p0 is in the
// window and the thread's own: entries 4 tid .. 4 tid + 3, and 1,024 (the
// one past the tile) for the last thread
__device__ __forceinline__ bool q_live(int64_t p0, int e, int64_t n_pos) {
    return p0 + Q_R * threadIdx.x + e <= n_pos && (e < Q_R || threadIdx.x == THREADS - 1);
}

// the first-choice slot loads of the thread's (k-1)-mers of the tile staged
// in s_code at p0, issued
__device__ __forceinline__ void issue_first(const uint32_t* s_code, int64_t p0, int64_t n_pos, int k,
                                            const u64* __restrict__ slots, int shift, u64 (&v1)[Q_R + 1]) {
    const int rel0 = Q_R * threadIdx.x;
#pragma unroll
    for (int e = 0; e <= Q_R; e++) {
        bool strand;
        const u64 key = canonical_km1(s_code, rel0 + e, k, strand);
        v1[e] = q_live(p0, e, n_pos) ? __ldg(slots + (qmap::mix(key, qmap::H1) >> shift)) : 0;
    }
}

// the first round resolved (the keys recomputed from the staged bases):
// each entry's oriented payload, with the stash's, into s_pay; the entries
// whose key is not in its first slot also into the queue s_q (*s_n of them)
__device__ __forceinline__ void resolve_first(const uint32_t* s_code, int64_t p0, int64_t n_pos, int k, int shift,
                                              const u64 (&v1)[Q_R + 1], const u64* s_k, const unsigned* s_v,
                                              int n_stash, bool sorted, uint16_t* s_pay, uint16_t* s_q, int* s_n) {
    const int rel0 = Q_R * threadIdx.x, lane = threadIdx.x & 31;
    const u64 rem_mask = (1ull << shift) - 1;
    unsigned miss = 0;
#pragma unroll
    for (int e = 0; e <= Q_R; e++) {
        if (!q_live(p0, e, n_pos)) {
            if (e < Q_R || threadIdx.x == THREADS - 1) s_pay[rel0 + e] = 0;
            continue;
        }
        bool strand;
        const u64 key = canonical_km1(s_code, rel0 + e, k, strand);
        const bool hit = qmap::q_slot_hit(v1[e], qmap::mix(key, qmap::H1) & rem_mask, 0);
        const unsigned p = (hit ? (unsigned)(v1[e] & qmap::PAY_MASK) : 0u)
                         | stash_payload(s_k, s_v, n_stash, sorted, key);
        s_pay[rel0 + e] = (uint16_t)orient(p, strand);
        miss |= (unsigned)!hit << e;
    }
    // the warp's misses take consecutive queue entries
    const int c = __popc(miss);
    int incl = c;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(FULL, incl, d);
        if (lane >= d) incl += y;
    }
    int base = 0;
    if (lane == 31 && incl) base = atomicAdd(s_n, incl);
    int j = __shfl_sync(FULL, base, 31) + incl - c;
#pragma unroll
    for (int e = 0; e <= Q_R; e++)
        if ((miss >> e) & 1) s_q[j++] = (uint16_t)(rel0 + e);
}

// the second round of the tile staged in s_code: the queued entries'
// second-choice slots, all of a thread's loads issued before the first
// compare, OR-ed into s_pay
__device__ __forceinline__ void second_round(const uint32_t* s_code, int k, const u64* __restrict__ slots,
                                             int shift, const uint16_t* s_q, int n, uint16_t* s_pay) {
    const u64 rem_mask = (1ull << shift) - 1;
    u64 h2[Q_KEYS_A_THREAD], v2[Q_KEYS_A_THREAD];
    bool strand[Q_KEYS_A_THREAD];
#pragma unroll
    for (int r = 0; r < Q_KEYS_A_THREAD; r++) {
        const int j = threadIdx.x + r * THREADS;
        h2[r] = j < n ? qmap::mix(canonical_km1(s_code, s_q[j], k, strand[r]), qmap::H2) : 0;
        v2[r] = j < n ? __ldg(slots + (h2[r] >> shift)) : 0;
    }
#pragma unroll
    for (int r = 0; r < Q_KEYS_A_THREAD; r++) {
        const int j = threadIdx.x + r * THREADS;
        if (j < n && qmap::q_slot_hit(v2[r], h2[r] & rem_mask, 1))
            s_pay[s_q[j]] |= (uint16_t)orient((unsigned)(v2[r] & qmap::PAY_MASK), strand[r]);
    }
}

__global__ void __launch_bounds__(THREADS) scan_planes_q_kernel(
    const uint8_t* __restrict__ packed, const uint8_t* __restrict__ bad, int64_t w, bool aligned,
    const u64* __restrict__ slots, int log_size,
    const u64* __restrict__ stash_k, const u64* __restrict__ stash_v, int n_stash, int k,
    PlaneOut o, bool vec, int64_t n_tiles)
{
    __shared__ uint32_t s_code[3][4 * Q_CHUNKS], s_bad[3][2 * Q_CHUNKS];  // a ring of three tiles' bases
    __shared__ __align__(8) uint16_t s_pay[2][Q_KEYS + 3];               // two tiles' oriented payloads
    __shared__ uint16_t s_q[2][Q_KEYS];                                   // and their queues
    __shared__ int s_n[2];
    __shared__ u64 s_k[qmap::MAX_STASH];
    __shared__ unsigned s_v[qmap::MAX_STASH];

    const int tid = threadIdx.x, rel0 = Q_R * tid;
    const int shift = 64 - log_size;
    const int64_t n_pos = w - k + 1;  // payload entries 0 .. n_pos
    const int64_t g = gridDim.x;

    // the first tile: staged, probed, its first round resolved
    int64_t t = blockIdx.x;
    if (tid == 0) s_n[0] = 0;
    stage(packed, bad, w, t * Q_TPOS, Q_CHUNKS, aligned, s_code[0], s_bad[0]);
    const bool sorted = stage_stash(stash_k, stash_v, n_stash, s_k, s_v);  // its barriers cover the staging
    u64 v1[Q_R + 1];
    issue_first(s_code[0], t * Q_TPOS, n_pos, k, slots, shift, v1);
    resolve_first(s_code[0], t * Q_TPOS, n_pos, k, shift, v1, s_k, s_v, n_stash, sorted, s_pay[0], s_q[0], &s_n[0]);

    for (int it = 0;; it++, t += g) {
        const int rb = it % 3, rn = (it + 1) % 3, pb = it & 1, pn = pb ^ 1;
        const int64_t tn = t + g;
        const bool more = tn < n_tiles;
        if (more) stage(packed, bad, w, tn * Q_TPOS, Q_CHUNKS, aligned, s_code[rn], s_bad[rn]);
        if (tid == 0) s_n[pn] = 0;
        __syncthreads();  // the next tile staged; this tile's first round and queue complete
        if (more) issue_first(s_code[rn], tn * Q_TPOS, n_pos, k, slots, shift, v1);
        second_round(s_code[rb], k, slots, shift, s_q[pb], s_n[pb], s_pay[pb]);
        __syncthreads();  // this tile's payloads complete
        unsigned opay[Q_R + 1];
        const uint2 four = *reinterpret_cast<const uint2*>(&s_pay[pb][rel0]);
        opay[0] = four.x & 0xFFFF, opay[1] = four.x >> 16, opay[2] = four.y & 0xFFFF, opay[3] = four.y >> 16;
        opay[Q_R] = s_pay[pb][rel0 + Q_R];
        write_planes<Q_R>(s_code[rb], s_bad[rb], rel0, t * Q_TPOS + rel0, opay, k, n_pos, o, vec);
        if (!more) break;
        resolve_first(s_code[rn], tn * Q_TPOS, n_pos, k, shift, v1, s_k, s_v, n_stash, sorted, s_pay[pn], s_q[pn],
                      &s_n[pn]);
    }
}

// ---------------------------------------------------------------------------
// K9

__global__ void __launch_bounds__(THREADS) scan_planes_qb_kernel(
    const uint8_t* __restrict__ packed, const uint8_t* __restrict__ bad, int64_t w, bool aligned,
    const u64* __restrict__ slots, int log_size,
    const u64* __restrict__ stash_k, const u64* __restrict__ stash_v, int n_stash, int k,
    PlaneOut o, bool vec)
{
    constexpr int R = QB_R, NE = R + 1;  // the run's payload entries and the one past it
    __shared__ uint32_t s_code[4 * QB_CHUNKS], s_bad[2 * QB_CHUNKS];
    __shared__ u64 s_k[qmap::MAX_STASH];
    __shared__ unsigned s_v[qmap::MAX_STASH];

    const int tid = threadIdx.x, lane = tid & 31;
    const int64_t p0 = (int64_t)blockIdx.x * QB_TPOS;
    stage(packed, bad, w, p0, QB_CHUNKS, aligned, s_code, s_bad);
    const bool sorted = stage_stash(stash_k, stash_v, n_stash, s_k, s_v);

    const int64_t n_pos = w - k + 1;  // payload entries 0 .. n_pos
    const int shift = 64 - log_size;
    const u64 rem_mask = (1ull << shift) - 1;
    const int rel0 = R * tid;         // the run's first position, relative to p0
    const int64_t i0 = p0 + rel0;

    // the canonical (k-1)-mers q_{i0} .. q_{i0+R}, the last for lane 31 only
    u64 key[NE], h1[NE];
    bool strand[NE], live[NE];
#pragma unroll
    for (int e = 0; e < NE; e++) {
        live[e] = i0 + e <= n_pos && (e < R || lane == 31);
        key[e] = canonical_km1(s_code, rel0 + e, k, strand[e]);
        h1[e] = qmap::mix(key[e], qmap::H1);
    }

    // their 9-bit payloads, the bucket lines' loads issued before the first reduction
    u64 line[NE][qmap::QB_SLOTS];
#pragma unroll
    for (int e = 0; e < NE; e++) {
        if (live[e]) {
            qmap::qb_line(slots, h1[e] >> shift, line[e]);
        } else {
#pragma unroll
            for (int i = 0; i < qmap::QB_SLOTS; i++) line[e][i] = 0;
        }
    }
    unsigned opay[NE];
#pragma unroll
    for (int e = 0; e < NE; e++) {
        const unsigned p = qmap::qb_payload(line[e], h1[e] & rem_mask)
                         | (live[e] ? stash_payload(s_k, s_v, n_stash, sorted, key[e]) : 0u);
        opay[e] = orient(p, strand[e]);
    }
    // q_{i0+R} is the right neighbour's first (lane 31 probed it)
    const unsigned next = __shfl_down_sync(FULL, opay[0], 1);
    if (lane != 31) opay[R] = next;
    write_planes<R>(s_code, s_bad, rel0, i0, opay, k, n_pos, o, vec);
}

// ---------------------------------------------------------------------------
// K15

constexpr int QP_P = 2;                    // pairs a thread (K10's)
constexpr int QP_TP = THREADS * QP_P;      // pairs a tile
constexpr int QP_R = 2 * QP_P;             // positions a thread
constexpr int QP_CHUNKS = QP_TP / 32 + 2;  // the 2 TP bases of a tile, and the k - 1 past them and the halo's
constexpr int WARPS = THREADS / 32;

// pair e of the thread's pairs of the tile of pairs from m0 (bases staged
// from 2 m0; e = QP_P is the halo, the pair past the tile, the last
// thread's only): whether it is in the window and the thread's, its key
// (the canonical (k-2)-mer at base 2m + 1), its strand, its flanking bases
// y (base 2m) and x (base 2m + k - 1)
struct PairKey {
    bool live, strand;
    u64 key, y, x;
};

__device__ __forceinline__ PairKey pair_key(const uint32_t* s_code, int64_t m0, int64_t n_pairs, int k, int e) {
    PairKey p;
    const int rel = 2 * (QP_P * threadIdx.x + e);  // base 2m, staged
    p.live = m0 + QP_P * threadIdx.x + e < n_pairs && (e < QP_P || threadIdx.x == THREADS - 1);
    const u64 win = bits64(s_code, 2 * rel);  // bases 2m .. 2m+31
    p.y = win & 3;
    p.x = bits32(s_code, 2 * (rel + k - 1)) & 3;
    u64 fwd, rc;
    kmer_words(win >> 2, k - 2, fwd, rc);
    p.key = fwd < rc ? fwd : rc;
    p.strand = fwd == p.key;
    return p;
}

// the first-choice rows of the thread's pairs (and the halo), issued
__device__ __forceinline__ void qp_issue(const uint32_t* s_code, int64_t m0, int64_t n_pairs, int k, int shift,
                                         const ulonglong2* __restrict__ slots, ulonglong2 (&first)[QP_P + 1]) {
    using namespace pair_map;
#pragma unroll
    for (int e = 0; e <= QP_P; e++) {
        const PairKey p = pair_key(s_code, m0, n_pairs, k, e);
        first[e] = p.live ? __ldg(&slots[mix(p.key, H1) >> shift]) : make_ulonglong2(0, 0);
    }
}

// the payloads of the thread's positions from its rows in flight (the keys
// formed again from the staged bases; the second choices after a miss, all
// issued before the first compare, then the stash); opay[QP_R], the payload
// past them, is the halo's in the last thread and left to the caller in the
// others
__device__ __forceinline__ void qp_resolve(const uint32_t* s_code, int64_t m0, int64_t n_pairs, int k, int shift,
                                           const ulonglong2* __restrict__ slots, const ulonglong2 (&first)[QP_P + 1],
                                           const u64* s_k, const u64* s_l, const u64* s_r, int n_stash, bool sorted,
                                           unsigned (&opay)[QP_R + 1]) {
    using namespace pair_map;
    const u64 rem_mask = (1ull << shift) - 1;
    PairKey p[QP_P + 1];
    ulonglong2 row[QP_P + 1];
    bool hit[QP_P + 1];
#pragma unroll
    for (int e = 0; e <= QP_P; e++) {
        p[e] = pair_key(s_code, m0, n_pairs, k, e);
        row[e] = first[e];
        hit[e] = row_hit(row[e], mix(p[e].key, H1), rem_mask, 0);
        if (!hit[e] && p[e].live) row[e] = __ldg(&slots[mix(p[e].key, H2) >> shift]);
    }
#pragma unroll
    for (int e = 0; e <= QP_P; e++) {
        if (!hit[e] && p[e].live) hit[e] = row_hit(row[e], mix(p[e].key, H2), rem_mask, 1);
        u64 l36, r36, pe = 0, po = 0;
        row_blocks(row[e], hit[e], l36, r36);
        stash_rows(s_k, s_l, s_r, n_stash, sorted, p[e].key, l36, r36);
        if (p[e].live) pair_payloads(p[e].strand, l36, r36, p[e].y, p[e].x, pe, po);
        if (e < QP_P) {
            opay[2 * e] = (unsigned)pe;
            opay[2 * e + 1] = (unsigned)po;
        } else if (threadIdx.x == THREADS - 1) {
            opay[QP_R] = (unsigned)pe;
        }
    }
}

// persistent blocks, each taking every G-th tile of QP_TP pairs; an
// iteration waits on the barrier, issues the next tile's first-choice rows,
// writes the planes of the tile probed before while they are in flight,
// then resolves them
__global__ void __launch_bounds__(THREADS) scan_planes_qp_kernel(
    const uint8_t* __restrict__ packed, const uint8_t* __restrict__ bad, int64_t w, bool aligned,
    const ulonglong2* __restrict__ slots, int log_size,
    const u64* __restrict__ stash_k, const u64* __restrict__ stash_l, const u64* __restrict__ stash_r,
    int n_stash, int k, PlaneOut o, bool vec, int64_t n_tiles)
{
    using namespace pair_map;
    __shared__ uint32_t s_code[3][4 * QP_CHUNKS], s_bad[3][2 * QP_CHUNKS];  // a ring of three tiles' bases
    __shared__ u64 s_k[MAX_STASH], s_l[MAX_STASH], s_r[MAX_STASH];
    __shared__ unsigned s_head[2][WARPS];  // each warp's first payload, of two tiles

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int64_t n_pos = w - k + 1, n_pairs = (n_pos + 2) / 2;  // payload entries 0 .. n_pos
    const int shift = 64 - log_size;
    const int64_t g = gridDim.x;
    for (int s = tid; s < MAX_STASH; s += THREADS) {
        s_k[s] = s < n_stash ? stash_k[s] : ~0ull;  // the padding sorts last and equals no key
        s_l[s] = s < n_stash ? stash_l[s] : 0;
        s_r[s] = s < n_stash ? stash_r[s] : 0;
    }
    int64_t tp = blockIdx.x, tw = -1;  // the tile to probe, the tile to write
    stage(packed, bad, w, 2 * tp * QP_TP, QP_CHUNKS, aligned, s_code[0], s_bad[0]);
    __syncthreads();
    const bool sorted = !__syncthreads_or(tid + 1 < n_stash && s_k[tid] >= s_k[tid + 1]);

    ulonglong2 first[QP_P + 1];  // the rows of tile tp in flight
    unsigned opay[QP_R + 1], next = 0;
    for (int it = 0;; it++) {
        __syncthreads();  // tile tp staged; tile tw's heads written
        // the payload past the thread's run: its right neighbour's first (a
        // shuffle in the warp, shared memory across warps), the halo's in the last thread
        if (tw >= 0) opay[QP_R] = lane < 31 ? next : warp + 1 < WARPS ? s_head[(it + 1) & 1][warp + 1] : opay[QP_R];
        if (tp < n_tiles) qp_issue(s_code[it % 3], tp * QP_TP, n_pairs, k, shift, slots, first);
        if (tw >= 0)
            write_planes<QP_R>(s_code[(it + 2) % 3], s_bad[(it + 2) % 3], QP_R * tid, 2 * (tw * QP_TP + QP_P * tid),
                               opay, k, n_pos, o, vec);
        if (tp >= n_tiles) break;
        const int64_t tn = tp + g;
        if (tn < n_tiles)
            stage(packed, bad, w, 2 * tn * QP_TP, QP_CHUNKS, aligned, s_code[(it + 1) % 3], s_bad[(it + 1) % 3]);
        qp_resolve(s_code[it % 3], tp * QP_TP, n_pairs, k, shift, slots, first, s_k, s_l, s_r, n_stash, sorted, opay);
        next = __shfl_down_sync(FULL, opay[0], 1);
        if (lane == 0) s_head[it & 1][warp] = opay[0];
        tw = tp;
        tp = tn;
    }
}

}  // namespace

// packed: w / 4 bytes, bad: w / 8 bytes (pack_codes_host); slots: the
// QMap's 2^log_size words (bucket 0) or the QMapB's 16 * 2^log_size
// (bucket 1); stash: n_stash keys and payloads (int64); the seven planes:
// P = w - k + 1 entries each (fwd int64, nb_in and nb_out int32, the rest
// one byte).
extern "C" int scan_planes_launch(const void* packed, const void* bad, int64_t w, const void* slots, int log_size,
                                  int bucket, const void* stash_k, const void* stash_v, int n_stash, int k,
                                  void* fwd, void* valid, void* contains, void* nb_in, void* nb_out,
                                  void* suffix_rep, void* prefix_rep, void* stream)
{
    const PlaneOut o = {(long long*)fwd, (uint8_t*)valid, (uint8_t*)contains, (int32_t*)nb_in, (int32_t*)nb_out,
                        (uint8_t*)suffix_rep, (uint8_t*)prefix_rep};
    cudaStream_t st = (cudaStream_t)stream;
    const uint8_t *pk = (const uint8_t*)packed, *bd = (const uint8_t*)bad;
    const u64 *sl = (const u64*)slots, *sk = (const u64*)stash_k, *sv = (const u64*)stash_v;
    const int64_t n_pos = w - k + 1;
    const bool aligned = (uintptr_t)packed % 16 == 0 && (uintptr_t)bad % 8 == 0;
    const bool vec = ((uintptr_t)fwd | (uintptr_t)valid | (uintptr_t)contains | (uintptr_t)nb_in | (uintptr_t)nb_out
                      | (uintptr_t)suffix_rep | (uintptr_t)prefix_rep) % 16 == 0;
    if (bucket) {
        scan_planes_qb_kernel<<<(unsigned)((n_pos + QB_TPOS - 1) / QB_TPOS), THREADS, 0, st>>>(
            pk, bd, w, aligned, sl, log_size, sk, sv, n_stash, k, o, vec);
    } else {
        const int64_t n_tiles = (n_pos + Q_TPOS - 1) / Q_TPOS;
        const int grid = planes::resident_grid<scan_planes_q_kernel>(n_tiles, THREADS);
        scan_planes_q_kernel<<<(unsigned)grid, THREADS, 0, st>>>(
            pk, bd, w, aligned, sl, log_size, sk, sv, n_stash, k, o, vec, n_tiles);
    }
    return (int)cudaGetLastError();
}

// K15: packed and bad as above; slots: the QMapP's [2^log_size, 2] words;
// stash: n_stash keys and (L36, R36) blocks; the seven planes: P = w - k + 1
// entries each.
extern "C" int scan_planes_qp_launch(const void* packed, const void* bad, int64_t w, const void* slots, int log_size,
                                     const void* stash_k, const void* stash_l, const void* stash_r, int n_stash,
                                     int k, void* fwd, void* valid, void* contains, void* nb_in, void* nb_out,
                                     void* suffix_rep, void* prefix_rep, void* stream)
{
    const PlaneOut o = {(long long*)fwd, (uint8_t*)valid, (uint8_t*)contains, (int32_t*)nb_in, (int32_t*)nb_out,
                        (uint8_t*)suffix_rep, (uint8_t*)prefix_rep};
    const int64_t n_pairs = (w - k + 3) / 2, n_tiles = (n_pairs + QP_TP - 1) / QP_TP;
    const bool aligned = (uintptr_t)packed % 16 == 0 && (uintptr_t)bad % 8 == 0;
    const bool vec = ((uintptr_t)fwd | (uintptr_t)valid | (uintptr_t)contains | (uintptr_t)nb_in | (uintptr_t)nb_out
                      | (uintptr_t)suffix_rep | (uintptr_t)prefix_rep) % 16 == 0;
    const int grid = planes::resident_grid<scan_planes_qp_kernel>(n_tiles, THREADS);
    scan_planes_qp_kernel<<<(unsigned)grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)packed, (const uint8_t*)bad, w, aligned, (const ulonglong2*)slots, log_size,
        (const u64*)stash_k, (const u64*)stash_l, (const u64*)stash_r, n_stash, k, o, vec, n_tiles);
    return (int)cudaGetLastError();
}
