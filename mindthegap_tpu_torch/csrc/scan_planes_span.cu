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
// The design is K6's probe with K8's plane stores:
//   - a block of 256 threads claims a tile of 256 PER consecutive (k-1)-mers
//     from a counter, and stages their bases with 64 before them and the
//     k - 1 past them in shared memory (packed_window.cuh);
//   - a thread builds its PER keys and probes them all in flight together
//     (span_map.cuh staged_keys and probe_lazy, K6's code), then turns each
//     payload to its strand;
//   - the thread writes the planes of its PER positions, one vector store a
//     plane (Wk for fwd_words, where the rows are 16-byte aligned); the
//     payload past its run, q_{j0+PER}, is its right neighbour's first: a
//     shuffle within the warp, shared memory across warps;
//   - the block's last position needs the next tile's first payload. Rather
//     than probe that key twice, the block publishes its own last payload
//     and the next tile's first thread writes that position, once the
//     payload is there (plane_store.cuh publish_last and wait_last; tiles
//     are claimed in order, so the tile waited on runs or has run).
// PER is K6's: 4 up to WQ = 4 (k <= 129), then 2.

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

template <int WQ, int WK, int PER>
__global__ void __launch_bounds__(THREADS) scan_planes_span_kernel(
    const uint8_t* __restrict__ packed, const uint8_t* __restrict__ bad, int64_t w, bool aligned,
    Map m, int k, int64_t n_pos, PlaneOut o, bool vec, bool vec_words, u64* states, unsigned* tile_counter)
{
    constexpr int TILE = THREADS * PER;  // (k-1)-mers and positions a tile
    // from 64 bases before the tile: its bases, the k - 1 <= 255 past them
    // and the words the last 64-bit reads touch, in chunks of 64 bases
    constexpr int N_CHUNKS = (TILE + 512) / 64 + 1;
    __shared__ uint32_t s_code[4 * N_CHUNKS], s_bad[2 * N_CHUNKS];
    __shared__ u64 s_sk[MAX_STASH], s_ssat[MAX_STASH * (MAX_WQ - 1)], s_sv[MAX_STASH];
    __shared__ unsigned s_head[WARPS];  // each warp's first payload
    __shared__ int64_t s_tile;

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    if (tid == 0) s_tile = atomicAdd(tile_counter, 1u);
    stage_stash<WQ>(m, s_sk, s_ssat, s_sv);
    __syncthreads();
    const int64_t tile = s_tile, b0 = tile * TILE;
    packed_window::stage(packed, bad, w, b0 - 64, N_CHUNKS, aligned, s_code, s_bad);
    __syncthreads();

    const int o0 = 64 + tid * PER;     // the thread's first (k-1)-mer and position, staged
    const int64_t j0 = b0 + tid * PER;  // and in the window
    const int64_t n_pay = n_pos + 1;    // (k-1)-mers
    const int n = n_pay - j0 >= PER ? PER : n_pay > j0 ? (int)(n_pay - j0) : 0;
    u64 cq[PER][WQ], dig[PER];
    bool is_canon[PER];
    staged_keys<WQ, PER>(m, s_code, o0, k - 1, cq, is_canon, dig);
    unsigned pay[PER];
    probe_lazy<WQ, PER>(m, cq, dig, n, pay);
    unsigned opay[PER + 1];  // oriented as read; and the one past the run
#pragma unroll
    for (int p = 0; p < PER; p++) opay[p] = orient(pay[p], is_canon[p]);

    // the tile's last payload, for the next tile's first position
    if (tid == THREADS - 1) planes::publish_last(&states[tile], opay[PER - 1]);
    const unsigned next = __shfl_down_sync(FULL, opay[0], 1);
    if (lane == 0) s_head[warp] = opay[0];
    __syncthreads();
    opay[PER] = lane < 31 ? next : warp + 1 < WARPS ? s_head[warp + 1] : 0u;
    const int64_t end = tid == THREADS - 1 && j0 + PER - 1 < n_pos ? j0 + PER - 1 : n_pos;
    span_planes<WK, PER>(s_code, s_bad, o0, j0, opay, k, end, n_pos, o, vec, vec_words);
    // the last position of the tile before, from the payload it published
    if (tid == 0 && tile > 0) {
        const unsigned one[2] = {planes::wait_last(&states[tile - 1]), opay[0]};
        span_planes<WK, 1>(s_code, s_bad, o0 - 1, j0 - 1, one, k, n_pos, n_pos, o, false, false);
    }
}

template <int WQ, int WK>
cudaError_t launch(const uint8_t* packed, const uint8_t* bad, int64_t w, const Map& m, int k, const PlaneOut& o,
                   u64* states, cudaStream_t st)
{
    constexpr int PER = WQ <= 4 ? 4 : 2;  // K6's (k-1)-mers a thread
    const int64_t n_pos = w - k + 1, n_tiles = (n_pos + 1 + THREADS * PER - 1) / (THREADS * PER);
    const bool aligned = (uintptr_t)packed % 16 == 0 && (uintptr_t)bad % 8 == 0;
    const bool vec = ((uintptr_t)o.fwd | (uintptr_t)o.valid | (uintptr_t)o.contains | (uintptr_t)o.nb_in
                      | (uintptr_t)o.nb_out | (uintptr_t)o.suffix_rep | (uintptr_t)o.prefix_rep) % 16 == 0;
    cudaError_t err = cudaMemsetAsync(states, 0, (n_tiles + 1) * sizeof(u64), st);
    if (err != cudaSuccess) return err;
    scan_planes_span_kernel<WQ, WK, PER><<<(unsigned)n_tiles, THREADS, 0, st>>>(
        packed, bad, w, aligned, m, k, n_pos, o, vec, vec && n_pos % 2 == 0, states,
        (unsigned*)(states + n_tiles));
    return cudaGetLastError();
}

}  // namespace

// (k-1)-mers a tile at this k (the tile count sizes the look-back scratch)
extern "C" int scan_planes_span_tile_keys(int k) { return THREADS * ((k - 1 + 31) / 32 <= 4 ? 4 : 2); }

// packed: w / 4 bytes, bad: w / 8 bytes (pack_codes_host); the span map as
// for scan_pay_q_span_launch (scan_span.cu); fwd_words: Wk rows of P = w -
// k + 1 words; the other planes P entries each; states: n_tiles + 1 words
// of scratch (zeroed here), n_tiles = ceil((P + 1) / scan_planes_span_tile_keys(k)).
// 33 <= k <= 256, w >= k + 8, w % 8 == 0.
extern "C" int scan_planes_span_launch(
    const void* packed, const void* bad, int64_t w,
    const void* slots, const void* sat, int log_size, int64_t salt,
    const void* stash_k, const void* stash_sat, const void* stash_v, int n_stash, int k,
    void* fwd_words, void* valid, void* contains, void* nb_in, void* nb_out, void* suffix_rep, void* prefix_rep,
    void* states, void* stream)
{
    if (k < 33 || k > 256 || n_stash < 1 || n_stash > MAX_STASH || w < k + 8 || w % 8) return (int)cudaErrorInvalidValue;
    const Map m = make_map(slots, sat, log_size, salt, stash_k, stash_sat, stash_v, n_stash);
    const PlaneOut o = {(long long*)fwd_words, (uint8_t*)valid, (uint8_t*)contains, (int32_t*)nb_in,
                        (int32_t*)nb_out, (uint8_t*)suffix_rep, (uint8_t*)prefix_rep};
    const uint8_t *p = (const uint8_t*)packed, *b = (const uint8_t*)bad;
    u64* s = (u64*)states;
    cudaStream_t st = (cudaStream_t)stream;
    const int wq = (k - 1 + 31) / 32, wk = (k + 31) / 32;
    switch (wq * 16 + wk) {
        case 1 * 16 + 2: return (int)launch<1, 2>(p, b, w, m, k, o, s, st);
        case 2 * 16 + 2: return (int)launch<2, 2>(p, b, w, m, k, o, s, st);
        case 2 * 16 + 3: return (int)launch<2, 3>(p, b, w, m, k, o, s, st);
        case 3 * 16 + 3: return (int)launch<3, 3>(p, b, w, m, k, o, s, st);
        case 3 * 16 + 4: return (int)launch<3, 4>(p, b, w, m, k, o, s, st);
        case 4 * 16 + 4: return (int)launch<4, 4>(p, b, w, m, k, o, s, st);
        case 4 * 16 + 5: return (int)launch<4, 5>(p, b, w, m, k, o, s, st);
        case 5 * 16 + 5: return (int)launch<5, 5>(p, b, w, m, k, o, s, st);
        case 5 * 16 + 6: return (int)launch<5, 6>(p, b, w, m, k, o, s, st);
        case 6 * 16 + 6: return (int)launch<6, 6>(p, b, w, m, k, o, s, st);
        case 6 * 16 + 7: return (int)launch<6, 7>(p, b, w, m, k, o, s, st);
        case 7 * 16 + 7: return (int)launch<7, 7>(p, b, w, m, k, o, s, st);
        case 7 * 16 + 8: return (int)launch<7, 8>(p, b, w, m, k, o, s, st);
        case 8 * 16 + 8: return (int)launch<8, 8>(p, b, w, m, k, o, s, st);
    }
    return (int)cudaErrorInvalidValue;
}
