// K16: the plane pass of one window over the multi-word span map, 32 < k
// <= 256 (mindthegap_tpu_torch/find/scan_device.py
// _scan_planes_q_span_plain, which this kernel must equal bit for bit).
//
// Replaces: mindthegap_tpu/find/scan_device.py scan_planes_device_q_span,
// with mindthegap_tpu/ops/extmap.py lookup_q_span and planes_from_payload
// and the rolling and canonical arithmetic of
// mindthegap_tpu/ops/span_device.py, an XLA program on the TPU. On the card
// it takes the place of K6 (scan_span.cu) followed by planes_from_pay_span
// on the host.
//
// For each position i of the window (P = w - k + 1 of them; a bad base
// reads as A) the seven planes of find/scan.py Planes: the forward k-mer as
// Wk = ceil(k/32) words (fwd_words, a (Wk, P) row of words each, word 0
// most significant), its validity (no bad base among its k), and from the
// 9-bit payloads of the canonical (k-1)-mers q_i and q_{i+1}, each turned
// to the strand it is read on (planes_from_payload's flips):
//   contains = ext(q_i) has the k-mer's last base,
//   nb_in = popcount(pre(q_i)), nb_out = popcount(ext(q_{i+1})), both 0
//   where contains is false,
//   prefix_rep = the repeat bit of q_i, suffix_rep that of q_{i+1}.
//
// Bound on this card: K6's probe sectors (bounds.py span_scan_sectors: the
// first slot of each of the P + 1 (k-1)-mers, its satellites where it holds
// the digest, the second slot and its satellites after a miss) and the
// 8 Wk + 12 bytes of planes written a position.
//
// The design is K6's probe with K8's plane stores, in one launch of
// persistent blocks (G, as many as the card holds at once), each taking
// every G-th tile of 256 PER positions:
//   - the block stages the stash in shared memory once, and the bases of
//     three tiles in a ring (packed_window.cuh), each tile's with the
//     k - 1 past it;
//   - a thread builds its PER keys and probes them all in flight together
//     (span_map.cuh staged_keys, issue_lazy and resolve_lazy, K6's code),
//     then turns each payload to its strand;
//   - the thread writes the planes of its PER positions, one vector store a
//     plane (Wk for fwd_words, where the rows are 16-byte aligned); the
//     payload past its run, q_{j0+PER}, is its right neighbour's first: a
//     shuffle within the warp, shared memory across warps; past the tile,
//     the halo, the (k-1)-mer past the tile's end, which the tile's last
//     thread probes too (one key a 256 PER), so a tile writes all of its
//     positions and tiles run in any order. The halo is a probe of its
//     own, resolved after the thread's others: as a fifth key in every
//     thread's probe it lost 1.4% to the design before this one
//     (plane_trials.py);
//   - an iteration issues the first slot words of the next tile's keys,
//     writes the planes of the tile it resolved before while they are in
//     flight, then resolves them (the keys formed again from the staged
//     bases rather than kept in registers over the stores).
// PER is K6's: 4 up to WQ = 4 (k <= 129), then 2.
//   Measured on an H100 80GB HBM3 at 700 W (kernel_bench.py --only
//   plane_passes, k = 45, the 2^21 window): 0.1694-0.1716 ms in turns
//   against 0.1723-0.1741 for the design before it (a block a tile, each
//   tile's last position written by the next tile from the payload it
//   published, a scratch zeroed by a memset); in plane_trials.py
//   0.1666-0.1675 against 0.1692-0.1700, a grid of one block a tile
//   0.1721-0.1725. Its yardstick is K6, the same probe: without its stores
//   K16 takes 0.142-0.143 ms, and the stores add 0.025 ms, 1.4 times their
//   byte time, since the probes hold the card's rate of random sectors, a
//   rate of the memory, which the stores draw on too.

#include <cstdint>
#include <cuda_runtime.h>

#include "packed_window.cuh"
#include "plane_store.cuh"
#include "span_map.cuh"

namespace {

using packed_window::bits64;
using packed_window::rev2;
using planes::PlaneOut;
using planes::orient;
using planes::put;
using namespace span_map;

constexpr int THREADS = 256, WARPS = THREADS / 32;
constexpr unsigned FULL = 0xFFFFFFFFu;

// no bad base among the k from `rel` of a staged window
__device__ __forceinline__ bool window_ok(const uint32_t* s_bad, int rel, int k) {
    bool ok = true;
    for (int b = 0; b < k; b += 64) {
        const int nb = k - b < 64 ? k - b : 64;
        const u64 mask = nb == 64 ? ~0ull : (1ull << nb) - 1;
        ok = ok && (bits64(s_bad, rel + b) & mask) == 0;
    }
    return ok;
}

// the planes of the R positions from i0 that lie before `end` (bases
// staged so that position i0 + e starts at rel0 + e), from the oriented
// payloads of their R (k-1)-mers and the one past them; the window's n_pos
// positions are the length of each row of fwd_words
template <int WK, int R>
__device__ __forceinline__ void span_planes(const uint32_t* s_code, const uint32_t* s_bad, int rel0, int64_t i0,
                                            const unsigned (&opay)[R + 1], int k, int64_t end, int64_t n_pos,
                                            const PlaneOut& o, bool vec, bool vec_words) {
    const int64_t left = end - i0;
    if (left <= 0) return;
    const int n = left < R ? (int)left : R;
    uint8_t valid[R], contains[R], srep[R], prep[R];
    int32_t nbi[R], nbo[R];
#pragma unroll
    for (int e = 0; e < R; e++) {
        const int rel = rel0 + e, last = rel + k - 1;
        valid[e] = window_ok(s_bad, rel, k);
        const unsigned base = (s_code[last >> 4] >> (2 * (last & 15))) & 3;  // the k-mer's last
        const unsigned ext = opay[e] & 0xF, pre = (opay[e] >> 4) & 0xF;
        const bool c = (ext >> base) & 1;
        contains[e] = c;
        nbi[e] = c ? __popc(pre) : 0;
        nbo[e] = c ? __popc(opay[e + 1] & 0xF) : 0;
        prep[e] = (opay[e] >> 8) & 1;
        srep[e] = (opay[e + 1] >> 8) & 1;
    }
    const int tb = k - 32 * (WK - 1);  // bases in word 0, 1..32
#pragma unroll
    for (int i = 0; i < WK; i++) {
        u64 v[R];
#pragma unroll
        for (int e = 0; e < R; e++)
            v[e] = i == 0 ? rev2(bits64(s_code, 2 * (rel0 + e))) >> (64 - 2 * tb)
                          : rev2(bits64(s_code, 2 * (rel0 + e + tb + 32 * (i - 1))));
        put<R>(o.fwd + i * n_pos, i0, v, n, vec_words);
    }
    put<R>(o.valid, i0, valid, n, vec);
    put<R>(o.contains, i0, contains, n, vec);
    put<R>(o.nb_in, i0, nbi, n, vec);
    put<R>(o.nb_out, i0, nbo, n, vec);
    put<R>(o.suffix_rep, i0, srep, n, vec);
    put<R>(o.prefix_rep, i0, prep, n, vec);
}

// persistent blocks, each taking every G-th tile of TILE positions; an
// iteration waits on the barrier, issues the first slot words of the next
// tile's keys, writes the planes of the tile probed before while they are
// in flight, then resolves them
template <int WQ, int WK, int PER>
__global__ void __launch_bounds__(THREADS) scan_planes_span_kernel(
    const uint8_t* __restrict__ packed, const uint8_t* __restrict__ bad, int64_t w, bool aligned,
    Map m, int k, int64_t n_pos, PlaneOut o, bool vec, bool vec_words, int64_t n_tiles)
{
    constexpr int TILE = THREADS * PER;  // positions a tile, and their (k-1)-mers
    // from the tile's first base: its bases, the k - 1 <= 255 past them and
    // the words the last 64-bit reads touch, in chunks of 64 bases
    constexpr int N_CHUNKS = (TILE + 512) / 64;
    __shared__ uint32_t s_code[3][4 * N_CHUNKS], s_bad[3][2 * N_CHUNKS];  // a ring of three tiles' bases
    __shared__ u64 s_sk[MAX_STASH], s_ssat[MAX_STASH * (MAX_WQ - 1)], s_sv[MAX_STASH];
    __shared__ unsigned s_head[2][WARPS];  // each warp's first payload, of two tiles

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int o0 = tid * PER;         // the thread's first (k-1)-mer and position, staged
    const int64_t n_pay = n_pos + 1;  // (k-1)-mers
    const int64_t g = gridDim.x;
    stage_stash<WQ>(m, s_sk, s_ssat, s_sv);
    int64_t tp = blockIdx.x, tw = -1;  // the tile to probe, the tile to write
    packed_window::stage(packed, bad, w, tp * TILE, N_CHUNKS, aligned, s_code[0], s_bad[0]);

    // tile tp's first slot words in flight: the thread's PER keys, and the
    // halo, the key past the tile, in the last thread (a probe of its own,
    // resolved after the others, rather than a key more in every thread's)
    Lazy<WQ, PER> lazy;
    Lazy<WQ, 1> halo;
    unsigned opay[PER + 1], next = 0;  // oriented as read; and the one past the run
    for (int it = 0;; it++) {
        __syncthreads();  // tile tp staged (the first time, the stash too); tile tw's heads written
        // the payload past the thread's run: its right neighbour's first (a
        // shuffle in the warp, shared memory across warps), the halo's in the last thread
        if (tw >= 0) opay[PER] = lane < 31 ? next : warp + 1 < WARPS ? s_head[(it + 1) & 1][warp + 1] : opay[PER];
        const int64_t j0 = tp * TILE + o0;
        const int n = n_pay - j0 >= PER ? PER : n_pay > j0 ? (int)(n_pay - j0) : 0;
        const int nh = tid == THREADS - 1 && j0 + PER < n_pay;
        if (tp < n_tiles) {
            u64 cq[PER][WQ], dig[PER], hq[1][WQ], hdig[1];
            bool is_canon[PER], hc[1];
            staged_keys<WQ, PER>(m, s_code[it % 3], o0, k - 1, cq, is_canon, dig);
            staged_keys<WQ, 1>(m, s_code[it % 3], o0 + PER, k - 1, hq, hc, hdig);
            issue_lazy<WQ, PER>(m, dig, n, lazy);
            issue_lazy<WQ, 1>(m, hdig, nh, halo);
        }
        if (tw >= 0)
            span_planes<WK, PER>(s_code[(it + 2) % 3], s_bad[(it + 2) % 3], o0, tw * TILE + o0, opay, k, n_pos,
                                 n_pos, o, vec, vec_words);
        if (tp >= n_tiles) break;
        const int64_t tn = tp + g;
        if (tn < n_tiles)
            packed_window::stage(packed, bad, w, tn * TILE, N_CHUNKS, aligned, s_code[(it + 1) % 3],
                                 s_bad[(it + 1) % 3]);
        // the keys formed again from the staged bases, rather than kept in registers over the stores
        u64 cq[PER][WQ], dig[PER], hq[1][WQ], hdig[1];
        bool is_canon[PER], hc[1];
        staged_keys<WQ, PER>(m, s_code[it % 3], o0, k - 1, cq, is_canon, dig);
        staged_keys<WQ, 1>(m, s_code[it % 3], o0 + PER, k - 1, hq, hc, hdig);
        unsigned pay[PER], hpay[1];
        resolve_lazy<WQ, PER>(m, cq, dig, n, lazy, pay);
        resolve_lazy<WQ, 1>(m, hq, hdig, nh, halo, hpay);
#pragma unroll
        for (int p = 0; p < PER; p++) opay[p] = orient(pay[p], is_canon[p]);
        if (tid == THREADS - 1) opay[PER] = orient(hpay[0], hc[0]);
        next = __shfl_down_sync(FULL, opay[0], 1);
        if (lane == 0) s_head[it & 1][warp] = opay[0];
        tw = tp;
        tp = tn;
    }
}

template <int WQ, int WK>
cudaError_t launch(const uint8_t* packed, const uint8_t* bad, int64_t w, const Map& m, int k, const PlaneOut& o,
                   cudaStream_t st)
{
    constexpr int PER = WQ <= 4 ? 4 : 2;  // K6's (k-1)-mers a thread
    const int64_t n_pos = w - k + 1, n_tiles = (n_pos + THREADS * PER - 1) / (THREADS * PER);
    const bool aligned = (uintptr_t)packed % 16 == 0 && (uintptr_t)bad % 8 == 0;
    const bool vec = ((uintptr_t)o.fwd | (uintptr_t)o.valid | (uintptr_t)o.contains | (uintptr_t)o.nb_in
                      | (uintptr_t)o.nb_out | (uintptr_t)o.suffix_rep | (uintptr_t)o.prefix_rep) % 16 == 0;
    const int grid = planes::resident_grid<scan_planes_span_kernel<WQ, WK, PER>>(n_tiles, THREADS);
    scan_planes_span_kernel<WQ, WK, PER><<<(unsigned)grid, THREADS, 0, st>>>(
        packed, bad, w, aligned, m, k, n_pos, o, vec, vec && n_pos % 2 == 0, n_tiles);
    return cudaGetLastError();
}

}  // namespace

// packed: w / 4 bytes, bad: w / 8 bytes (pack_codes_host); the span map as
// for scan_pay_q_span_launch (scan_span.cu); fwd_words: Wk rows of P = w -
// k + 1 words; the other planes P entries each. 33 <= k <= 256, w >= k + 8,
// w % 8 == 0.
extern "C" int scan_planes_span_launch(
    const void* packed, const void* bad, int64_t w,
    const void* slots, const void* sat, int log_size, int64_t salt,
    const void* stash_k, const void* stash_sat, const void* stash_v, int n_stash, int k,
    void* fwd_words, void* valid, void* contains, void* nb_in, void* nb_out, void* suffix_rep, void* prefix_rep,
    void* stream)
{
    if (k < 33 || k > 256 || n_stash < 1 || n_stash > MAX_STASH || w < k + 8 || w % 8) return (int)cudaErrorInvalidValue;
    const Map m = make_map(slots, sat, log_size, salt, stash_k, stash_sat, stash_v, n_stash);
    const PlaneOut o = {(long long*)fwd_words, (uint8_t*)valid, (uint8_t*)contains, (int32_t*)nb_in,
                        (int32_t*)nb_out, (uint8_t*)suffix_rep, (uint8_t*)prefix_rep};
    const uint8_t *p = (const uint8_t*)packed, *b = (const uint8_t*)bad;
    cudaStream_t st = (cudaStream_t)stream;
    const int wq = (k - 1 + 31) / 32, wk = (k + 31) / 32;
    switch (wq * 16 + wk) {
        case 1 * 16 + 2: return (int)launch<1, 2>(p, b, w, m, k, o, st);
        case 2 * 16 + 2: return (int)launch<2, 2>(p, b, w, m, k, o, st);
        case 2 * 16 + 3: return (int)launch<2, 3>(p, b, w, m, k, o, st);
        case 3 * 16 + 3: return (int)launch<3, 3>(p, b, w, m, k, o, st);
        case 3 * 16 + 4: return (int)launch<3, 4>(p, b, w, m, k, o, st);
        case 4 * 16 + 4: return (int)launch<4, 4>(p, b, w, m, k, o, st);
        case 4 * 16 + 5: return (int)launch<4, 5>(p, b, w, m, k, o, st);
        case 5 * 16 + 5: return (int)launch<5, 5>(p, b, w, m, k, o, st);
        case 5 * 16 + 6: return (int)launch<5, 6>(p, b, w, m, k, o, st);
        case 6 * 16 + 6: return (int)launch<6, 6>(p, b, w, m, k, o, st);
        case 6 * 16 + 7: return (int)launch<6, 7>(p, b, w, m, k, o, st);
        case 7 * 16 + 7: return (int)launch<7, 7>(p, b, w, m, k, o, st);
        case 7 * 16 + 8: return (int)launch<7, 8>(p, b, w, m, k, o, st);
        case 8 * 16 + 8: return (int)launch<8, 8>(p, b, w, m, k, o, st);
    }
    return (int)cudaErrorInvalidValue;
}
