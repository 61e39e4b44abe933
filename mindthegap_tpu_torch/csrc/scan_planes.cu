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
// bytes of planes a position. A block claims a tile of 512 pairs from a
// counter, a thread K10's 2 pairs: both first-choice rows in flight, the
// second choice after a miss, then the planes of its 4 positions. The
// payload past a thread's run is its right neighbour's first: a shuffle in
// the warp, shared memory across warps. The tile's last position needs the
// next tile's first payload; rather than probe that pair twice, the tile
// publishes its own last payload and the next tile's first thread writes
// that position once it is there (plane_store.cuh; tiles are claimed in
// order, so the tile waited on runs or has run and never waits back).

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
constexpr int QP_CHUNKS = QP_TP / 32 + 3;  // the 2 TP bases of a tile, the 64 before them and the k - 1 past them
constexpr int WARPS = THREADS / 32;

__global__ void __launch_bounds__(THREADS) scan_planes_qp_kernel(
    const uint8_t* __restrict__ packed, const uint8_t* __restrict__ bad, int64_t w, bool aligned,
    const ulonglong2* __restrict__ slots, int log_size,
    const u64* __restrict__ stash_k, const u64* __restrict__ stash_l, const u64* __restrict__ stash_r,
    int n_stash, int k, PlaneOut o, bool vec, u64* states, unsigned* tile_counter)
{
    using namespace pair_map;
    __shared__ uint32_t s_code[4 * QP_CHUNKS], s_bad[2 * QP_CHUNKS];  // bases from 2 m0 - 64
    __shared__ u64 s_k[MAX_STASH], s_l[MAX_STASH], s_r[MAX_STASH];
    __shared__ unsigned s_head[WARPS];  // each warp's first payload
    __shared__ int64_t s_tile;

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    if (tid == 0) s_tile = atomicAdd(tile_counter, 1u);
    for (int s = tid; s < MAX_STASH; s += THREADS) {
        s_k[s] = s < n_stash ? stash_k[s] : ~0ull;  // the padding sorts last and equals no key
        s_l[s] = s < n_stash ? stash_l[s] : 0;
        s_r[s] = s < n_stash ? stash_r[s] : 0;
    }
    __syncthreads();
    const int64_t tile = s_tile, m0 = tile * QP_TP;
    stage(packed, bad, w, 2 * m0 - 64, QP_CHUNKS, aligned, s_code, s_bad);
    const bool sorted = !__syncthreads_or(tid + 1 < n_stash && s_k[tid] >= s_k[tid + 1]);

    const int64_t n_pos = w - k + 1, n_pairs = (n_pos + 2) / 2;  // payload entries 0 .. n_pos
    const int shift = 64 - log_size;
    const u64 rem_mask = (1ull << shift) - 1;

    // K10's probe of the thread's pairs: keys, then every first-choice row
    // in flight, then the second choice after a miss and the stash
    u64 key[QP_P], h1[QP_P], h2[QP_P], y[QP_P], x[QP_P];
    bool strand[QP_P], live[QP_P];
#pragma unroll
    for (int e = 0; e < QP_P; e++) {
        const int rel = 64 + 2 * (QP_P * tid + e);  // base 2m, staged
        live[e] = m0 + QP_P * tid + e < n_pairs;
        const u64 win = bits64(s_code, 2 * rel);    // bases 2m .. 2m+31
        y[e] = win & 3;
        x[e] = bits32(s_code, 2 * (rel + k - 1)) & 3;
        u64 fwd, rc;
        kmer_words(win >> 2, k - 2, fwd, rc);     // the (k-2)-mer at base 2m+1
        key[e] = fwd < rc ? fwd : rc;
        strand[e] = fwd == key[e];
        h1[e] = mix(key[e], H1);
        h2[e] = mix(key[e], H2);
    }
    ulonglong2 first[QP_P];
#pragma unroll
    for (int e = 0; e < QP_P; e++) first[e] = live[e] ? __ldg(&slots[h1[e] >> shift]) : make_ulonglong2(0, 0);
    unsigned opay[QP_R + 1];  // the payloads of the thread's positions, and the one past them
#pragma unroll
    for (int e = 0; e < QP_P; e++) {
        ulonglong2 row = first[e];
        bool hit = row_hit(row, h1[e], rem_mask, 0);
        if (!hit && live[e]) {
            row = __ldg(&slots[h2[e] >> shift]);
            hit = row_hit(row, h2[e], rem_mask, 1);
        }
        u64 l36, r36, pe = 0, po = 0;
        row_blocks(row, hit, l36, r36);
        stash_rows(s_k, s_l, s_r, n_stash, sorted, key[e], l36, r36);
        if (live[e]) pair_payloads(strand[e], l36, r36, y[e], x[e], pe, po);
        opay[2 * e] = (unsigned)pe;
        opay[2 * e + 1] = (unsigned)po;
    }

    // the tile's last payload, for the next tile's first position
    if (tid == THREADS - 1) planes::publish_last(&states[tile], opay[QP_R - 1]);
    // the payload past the thread's run is its right neighbour's first: a
    // shuffle in the warp, shared memory across warps
    const unsigned next = __shfl_down_sync(FULL, opay[0], 1);
    if (lane == 0) s_head[warp] = opay[0];
    __syncthreads();
    opay[QP_R] = lane < 31 ? next : warp + 1 < WARPS ? s_head[warp + 1] : 0u;
    const int64_t i0 = 2 * (m0 + QP_P * tid);
    const int64_t end = tid == THREADS - 1 && i0 + QP_R - 1 < n_pos ? i0 + QP_R - 1 : n_pos;
    write_planes<QP_R>(s_code, s_bad, 64 + QP_R * tid, i0, opay, k, end, o, vec);
    // the last position of the tile before, from the payload it published
    if (tid == 0 && tile > 0) {
        const unsigned one[2] = {planes::wait_last(&states[tile - 1]), opay[0]};
        write_planes<1>(s_code, s_bad, 63, i0 - 1, one, k, n_pos, o, false);
    }
}

// K8's blocks: as many as the card holds at once, at most one a tile
int q_grid(int64_t n_tiles) {
    static int per_sm = 0;
    if (!per_sm && cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, scan_planes_q_kernel, THREADS, 0)
                       != cudaSuccess)
        per_sm = 1;
    int dev = 0, sms = 1;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const int64_t most = (int64_t)(per_sm > 0 ? per_sm : 1) * sms;
    return (int)(n_tiles < most ? n_tiles : most);
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
        scan_planes_q_kernel<<<(unsigned)q_grid(n_tiles), THREADS, 0, st>>>(
            pk, bd, w, aligned, sl, log_size, sk, sv, n_stash, k, o, vec, n_tiles);
    }
    return (int)cudaGetLastError();
}

// K15: pairs a tile (the tile count sizes the look-back scratch)
extern "C" int scan_planes_qp_tile_pairs() { return QP_TP; }

// K15: packed and bad as above; slots: the QMapP's [2^log_size, 2] words;
// stash: n_stash keys and (L36, R36) blocks; the seven planes: P = w - k + 1
// entries each; states: n_tiles + 1 words of scratch (zeroed here), n_tiles
// = ceil(ceil((P + 1) / 2) / scan_planes_qp_tile_pairs()).
extern "C" int scan_planes_qp_launch(const void* packed, const void* bad, int64_t w, const void* slots, int log_size,
                                     const void* stash_k, const void* stash_l, const void* stash_r, int n_stash,
                                     int k, void* fwd, void* valid, void* contains, void* nb_in, void* nb_out,
                                     void* suffix_rep, void* prefix_rep, void* states, void* stream)
{
    const PlaneOut o = {(long long*)fwd, (uint8_t*)valid, (uint8_t*)contains, (int32_t*)nb_in, (int32_t*)nb_out,
                        (uint8_t*)suffix_rep, (uint8_t*)prefix_rep};
    cudaStream_t st = (cudaStream_t)stream;
    const int64_t n_pairs = (w - k + 3) / 2, n_tiles = (n_pairs + QP_TP - 1) / QP_TP;
    const bool aligned = (uintptr_t)packed % 16 == 0 && (uintptr_t)bad % 8 == 0;
    const bool vec = ((uintptr_t)fwd | (uintptr_t)valid | (uintptr_t)contains | (uintptr_t)nb_in | (uintptr_t)nb_out
                      | (uintptr_t)suffix_rep | (uintptr_t)prefix_rep) % 16 == 0;
    u64* s = (u64*)states;
    cudaError_t err = cudaMemsetAsync(s, 0, (n_tiles + 1) * sizeof(u64), st);
    if (err != cudaSuccess) return (int)err;
    scan_planes_qp_kernel<<<(unsigned)n_tiles, THREADS, 0, st>>>(
        (const uint8_t*)packed, (const uint8_t*)bad, w, aligned, (const ulonglong2*)slots, log_size,
        (const u64*)stash_k, (const u64*)stash_l, (const u64*)stash_r, n_stash, k, o, vec, s,
        (unsigned*)(s + n_tiles));
    return (int)cudaGetLastError();
}
