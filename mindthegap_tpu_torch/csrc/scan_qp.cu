// K1: the whole reference-delta scan of one window over the pair-coalesced
// quotient map (mindthegap_tpu_torch/ops/extmap.py QMapP): payloads, their
// 2-bit classes and the exception compaction
// (mindthegap_tpu_torch/find/scan_device.py _scan_cls_qp_plain, which this
// kernel must equal bit for bit).
//
// Replaces: mindthegap_tpu/find/scan_device.py scan_cls_device_qp, with its
// core _pair_pay_device, mindthegap_tpu/ops/extmap.py lookup_qp and the
// tuple sort that moves the EXC payloads first — an XLA program on the TPU.
//
// Per pair m of payload entries (2m, 2m+1): the canonical (k-2)-mer at base
// 2m+1 (bad bases and bases past the window read as A), two hashed 16-byte
// row probes of `slots` and the <= 64-entry stash give (L36, R36); each
// entry's 9-bit payload follows from the strand and its flanking base, and
// its class from the reference's own continuation (REF 0, ZERO 1, EXC 2,
// REP 3). Outputs: cls2 (4 classes per byte), exc16 (the EXC payloads in
// entry order, then the other payloads in order, out_len = min(exc_cap,
// n4) entries) and n_exc.
//
// Bound on this card: the row probes, random 32-byte sectors out of a table
// of 2^log_size * 16 bytes (256 MB for a bacterial solid set, above the 50
// MB L2): one per pair, and one more for each pair whose key is not in its
// first-choice row (mindthegap_tpu_torch/bounds.py scan_probe_sectors),
// against 3.5 MB of inputs and outputs per 2^22-base window.
//
// The design, one launch of the main kernel and one of a small finishing
// kernel:
//   - A block of 256 threads takes a tile of 256 * 2 pairs, claimed from an
//     atomic counter, and stages the tile's bases with a 128-base halo on
//     each side in shared memory (packed_window.cuh). Each pair's window is
//     64 bits read at base 2m-1 by funnel shifts: the flanking bases, the
//     (k-2)-mer (its reverse complement by complement and mask, its forward
//     word by one 2-bit-group reversal) and the four bad bits the classes
//     need, with one more 32-bit read for the bases at 2m+k-1 and 2m+k.
//   - Both of a thread's first-choice row loads (through the read-only
//     path) are issued before the first compare, and the second choice is
//     probed only where the first missed (exact: mix is a bijection, so a
//     row's (remainder, choice) names one key). On the card this beat
//     loading both choices together (a bacterial table holds ~86% of the
//     keys in their first row), and 2 pairs a thread beat 4.
//   - The stash is held in shared memory; a sorted stash of unique keys (as
//     QMapP keeps it) is searched in six steps, any other by a full scan.
//   - Compaction: a block scan counts the tile's EXC entries and a
//     decoupled look-back (Merrill and Garland's single-pass scan; each
//     tile's state and count in one 64-bit word) gives the EXC entries
//     before the tile. EXC entry i goes to exc16[e_i] when e_i < out_len,
//     e_i being the EXC entries before it; a non-EXC entry whose rank
//     i - e_i is below out_len goes to `tail` at that rank. The last tile
//     writes n_exc; the finishing kernel copies tail[0, out_len - n_exc) to
//     exc16[n_exc, out_len).
// Nothing but the outputs, `tail` and 8 bytes of look-back state per tile
// goes to device memory: no per-entry payload stream. The pair map's probe
// primitives are in pair_map.cuh, shared with K15 (scan_planes.cu).

#include <cstdint>
#include <cuda_runtime.h>

#include "packed_window.cuh"
#include "pair_map.cuh"

namespace {

using namespace packed_window;
using namespace pair_map;

constexpr int THREADS = 256, WARPS = THREADS / 32;
constexpr u64 STATE_AGGREGATE = 1, STATE_INCLUSIVE = 2;
constexpr unsigned FULL = 0xFFFFFFFFu;

// the class of payload `pay` whose flanking bases are b_hi and b_lo, both
// valid when ok
__device__ __forceinline__ int classify(u64 pay, bool ok, u64 b_hi, u64 b_lo) {
    if (ok && (pay & 0xFF) == ((1ull << b_hi) | (1ull << (b_lo + 4)))) return ((pay >> 8) & 1) ? 3 : 0;
    return pay == 0 ? 1 : 2;
}

__device__ __forceinline__ void publish(u64* state, u64 kind, unsigned count) {
    atomicExch(state, (kind << 32) | count);
}

constexpr int P = 2;              // pairs per thread
constexpr int TP = THREADS * P;   // pairs per tile

// at most 48 registers: five blocks per SM (a cap for six or eight spills,
// and was slower on the card)
__global__ void __launch_bounds__(THREADS, 5) scan_cls_qp_kernel(
    const uint8_t* __restrict__ packed, const uint8_t* __restrict__ bad, int64_t w, bool aligned,
    const ulonglong2* __restrict__ slots, int log_size,
    const u64* __restrict__ stash_k, const u64* __restrict__ stash_l, const u64* __restrict__ stash_r,
    int n_stash, int k,
    uint8_t* __restrict__ cls2, int16_t* __restrict__ exc16, long long* __restrict__ n_exc_out,
    int64_t out_len, int16_t* __restrict__ tail, u64* states, unsigned* tile_counter, int64_t n_tiles)
{
    constexpr int N_CHUNKS = TP / 32 + 4;   // 2 * TP bases and the halos, 64 a chunk
    constexpr int E = 2 * P;                // payload entries per thread
    __shared__ uint32_t s_code[4 * N_CHUNKS], s_bad[2 * N_CHUNKS];
    __shared__ u64 s_k[MAX_STASH], s_l[MAX_STASH], s_r[MAX_STASH];
    __shared__ int64_t s_tile;
    __shared__ unsigned s_warp[WARPS], s_prefix;

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    if (tid == 0) s_tile = atomicAdd(tile_counter, 1u);
    for (int s = tid; s < MAX_STASH; s += THREADS) {
        s_k[s] = s < n_stash ? stash_k[s] : ~0ull;  // the padding sorts last and equals no key
        s_l[s] = s < n_stash ? stash_l[s] : 0;
        s_r[s] = s < n_stash ? stash_r[s] : 0;
    }
    __syncthreads();
    const int64_t tile = s_tile;
    const int64_t m0 = tile * TP, b0 = 2 * m0 - 128;
    stage(packed, bad, w, b0, N_CHUNKS, aligned, s_code, s_bad);
    const bool sorted = !__syncthreads_or(tid + 1 < n_stash && s_k[tid] >= s_k[tid + 1]);

    const int64_t n_pay = w - k + 2, n_pairs = (n_pay + 1) / 2, n4 = (n_pay + 3) / 4 * 4;
    const int shift = 64 - log_size;
    const u64 rem_mask = (1ull << shift) - 1;
    const int km = k - 2;

    // the windows: key, strand and the flanking bases of each pair
    u64 key[P], h1[P], h2[P], win[P];
    uint32_t hi[P];
    u64 badw[P];
    bool strand[P], live[P];
#pragma unroll
    for (int e = 0; e < P; e++) {
        const int lm = P * tid + e;            // pair within the tile
        live[e] = m0 + lm < n_pairs;
        const int rel = 2 * lm + 127;          // base 2m-1, relative to b0
        win[e] = bits64(s_code, 2 * rel);      // bases 2m-1 .. 2m+30
        hi[e] = bits32(s_code, 2 * (rel + k)); // bases 2m+k-1, 2m+k
        badw[e] = bits64(s_bad, rel);          // bad bits of bases 2m-1 .. 2m+62
        u64 fwd, rc;
        kmer_words(win[e] >> 4, km, fwd, rc);  // the (k-2)-mer at base 2m+1
        key[e] = fwd < rc ? fwd : rc;
        strand[e] = fwd == key[e];
        h1[e] = mix(key[e], H1);
        h2[e] = mix(key[e], H2);
    }
    // first-choice row probes: every load in flight before the first compare
    ulonglong2 row0[P];
#pragma unroll
    for (int e = 0; e < P; e++) row0[e] = live[e] ? __ldg(&slots[h1[e] >> shift]) : make_ulonglong2(0, 0);
    u64 l36[P], r36[P];
#pragma unroll
    for (int e = 0; e < P; e++) {
        bool hit = row_hit(row0[e], h1[e], rem_mask, 0);
        ulonglong2 row = row0[e];
        if (!hit && live[e]) {  // the second choice, only after a miss
            row = __ldg(&slots[h2[e] >> shift]);
            hit = row_hit(row, h2[e], rem_mask, 1);
        }
        l36[e] = hit ? ((row.x & 0xFF) << 28) | (row.y >> 36) : 0;
        r36[e] = hit ? row.y & QP_L36 : 0;
        if (sorted) {  // lower bound over the 64 sorted slots, then one compare
            int i = 0;
#pragma unroll
            for (int step = MAX_STASH / 2; step >= 1; step >>= 1)
                if (s_k[i + step - 1] < key[e]) i += step;
            if (s_k[i] == key[e]) {
                l36[e] |= s_l[i];
                r36[e] |= s_r[i];
            }
        } else {
            for (int s = 0; s < n_stash; s++) {
                if (s_k[s] == key[e]) {
                    l36[e] |= s_l[s];
                    r36[e] |= s_r[s];
                }
            }
        }
    }

    // payloads and classes of the thread's E entries j = j0 .. j0 + E - 1
    const int64_t j0 = 2 * (m0 + P * tid);
    uint16_t pay[E];
    uint32_t cls_bits = 0, exc_mask = 0;
#pragma unroll
    for (int e = 0; e < P; e++) {
        const u64 b_lo = win[e] & 3, y = (win[e] >> 2) & 3;  // bases 2m-1, 2m
        const u64 x = hi[e] & 3, b_hi1 = (hi[e] >> 2) & 3;   // bases 2m+k-1, 2m+k
        u64 pe = 0, po = 0;
        if (live[e]) {
            pe = strand[e] ? sub9(l36[e], y) : flip9(sub9(r36[e], y ^ 2));
            po = strand[e] ? sub9(r36[e], x) : flip9(sub9(l36[e], x ^ 2));
        }
        const u64 bw = badw[e];
        const int ce = classify(pe, !(((bw >> k) | bw) & 1), x, b_lo);
        const int co = classify(po, !(((bw >> (k + 1)) | (bw >> 1)) & 1), b_hi1, y);
        pay[2 * e] = (uint16_t)pe;
        pay[2 * e + 1] = (uint16_t)po;
        cls_bits |= (uint32_t)(ce | (co << 2)) << (4 * e);
        if (j0 + 2 * e < n4 && ce == 2) exc_mask |= 1u << (2 * e);
        if (j0 + 2 * e + 1 < n4 && co == 2) exc_mask |= 1u << (2 * e + 1);
    }
#pragma unroll
    for (int b = 0; b < E / 4; b++)
        if (j0 + 4 * b < n4) cls2[j0 / 4 + b] = (uint8_t)(cls_bits >> (8 * b));

    // EXC entries before this thread in the tile, and the tile's count
    const unsigned mine = __popc(exc_mask);
    unsigned inc = mine;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const unsigned v = __shfl_up_sync(FULL, inc, o);
        if (lane >= o) inc += v;
    }
    if (lane == 31) s_warp[warp] = inc;
    __syncthreads();
    unsigned before = inc - mine, agg = 0;
#pragma unroll
    for (int v = 0; v < WARPS; v++) {
        if (v < warp) before += s_warp[v];
        agg += s_warp[v];
    }

    // decoupled look-back: EXC entries before the tile
    if (warp == 0) {
        unsigned prefix = 0;
        if (tile == 0) {
            if (lane == 0) publish(&states[0], STATE_INCLUSIVE, agg);
        } else {
            if (lane == 0) publish(&states[tile], STATE_AGGREGATE, agg);
            for (int64_t t = tile - 1;; t -= 32) {
                const int64_t ti = t - lane;  // lane 0 holds the latest tile of the window
                u64 st = STATE_INCLUSIVE << 32;
                if (ti >= 0) {
                    do {
                        st = *(volatile u64*)&states[ti];
                    } while ((st >> 32) == 0);
                }
                const unsigned incl = __ballot_sync(FULL, (st >> 32) == STATE_INCLUSIVE);
                const int stop = incl ? __ffs(incl) - 1 : 31;
                unsigned v = lane <= stop ? (unsigned)st : 0;
#pragma unroll
                for (int o = 16; o >= 1; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
                prefix += v;
                if (incl) break;
            }
            if (lane == 0) publish(&states[tile], STATE_INCLUSIVE, prefix + agg);
        }
        if (lane == 0) {
            s_prefix = prefix;
            if (tile == n_tiles - 1) *n_exc_out = (long long)(prefix + agg);
        }
    }
    __syncthreads();

    // place the entries: EXC ones by their EXC rank, the others by theirs
    int64_t e_i = (int64_t)s_prefix + before;
#pragma unroll
    for (int i = 0; i < E; i++) {
        const int64_t j = j0 + i;
        if ((exc_mask >> i) & 1) {
            if (e_i < out_len) exc16[e_i] = (int16_t)pay[i];
            e_i++;
        } else if (j < n4 && j - e_i < out_len) {
            tail[j - e_i] = (int16_t)pay[i];
        }
    }
}

// exc16[n_exc + i] = tail[i] for i < out_len - n_exc
__global__ void finish_kernel(int16_t* __restrict__ exc16, const int16_t* __restrict__ tail,
                              const long long* __restrict__ n_exc, int64_t out_len)
{
    const int64_t n = *n_exc, stride = (int64_t)gridDim.x * blockDim.x;
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; n + i < out_len; i += stride)
        exc16[n + i] = tail[i];
}

struct Args {
    const uint8_t* packed;
    const uint8_t* bad;
    int64_t w;
    bool aligned;
    const ulonglong2* slots;
    int log_size;
    const u64 *stash_k, *stash_l, *stash_r;
    int n_stash, k;
    uint8_t* cls2;
    int16_t* exc16;
    long long* n_exc;
    int64_t out_len;
    int16_t* tail;
    u64* states;
};

cudaError_t launch(const Args& a, cudaStream_t st)
{
    const int64_t n4 = (a.w - a.k + 2 + 3) / 4 * 4;
    const int64_t n_tiles = (n4 + 2 * TP - 1) / (2 * TP);
    cudaError_t err = cudaMemsetAsync(a.states, 0, (n_tiles + 1) * sizeof(u64), st);
    if (err != cudaSuccess) return err;
    scan_cls_qp_kernel<<<(unsigned)n_tiles, THREADS, 0, st>>>(
        a.packed, a.bad, a.w, a.aligned, a.slots, a.log_size, a.stash_k, a.stash_l, a.stash_r, a.n_stash, a.k,
        a.cls2, a.exc16, a.n_exc, a.out_len, a.tail, a.states, (unsigned*)(a.states + n_tiles), n_tiles);
    err = cudaGetLastError();
    if (err != cudaSuccess || a.out_len == 0) return err;
    const int64_t blocks = (a.out_len + 1023) / 1024;
    finish_kernel<<<(unsigned)(blocks < 264 ? blocks : 264), 1024, 0, st>>>(a.exc16, a.tail, a.n_exc, a.out_len);
    return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K10: the dense payload stream of one window over the same map
// (mindthegap_tpu_torch/find/scan_device.py _scan_pay_qp_plain, which it
// must equal bit for bit).
//
// Replaces: mindthegap_tpu/find/scan_device.py scan_pay_device_qp (with its
// core _pair_pay_device and lookup_qp), an XLA program on the TPU. The find
// feed sends it a window whose exceptions overflow K1's cap, and
// `find -automaton host` every window (the host turns the stream into
// planes, planes_from_pay).
//
// Per pair m, K1's probe: the canonical (k-2)-mer at base 2m+1 (bad bases
// and bases past the window read as A), its first-choice row, the second
// only after a miss, the stash in shared memory. Outputs: pay8, the low
// byte (ext | pre << 4, oriented as read) of entries 0 .. n_pay - 1, and
// rep8, the repeat bits of entries 0 .. 2 * n_pairs - 1 packed big-endian
// (np.packbits), zero past them. Bound on this card: K1's row sectors and
// the 1.125 bytes a position written. A thread takes K1's P pairs (four
// entries): one 4-byte store of pay8, and each even thread joins its odd
// neighbour's four repeat bits by a shuffle into one byte of rep8.

__global__ void __launch_bounds__(THREADS) scan_pay_qp_kernel(
    const uint8_t* __restrict__ packed, const uint8_t* __restrict__ bad, int64_t w, bool aligned,
    const ulonglong2* __restrict__ slots, int log_size,
    const u64* __restrict__ stash_k, const u64* __restrict__ stash_l, const u64* __restrict__ stash_r,
    int n_stash, int k, uint8_t* __restrict__ pay8, uint8_t* __restrict__ rep8, bool vec)
{
    constexpr int N_CHUNKS = TP / 32 + 2;   // 2 * TP bases from base 2 * m0, and the k - 1 past them
    constexpr int E = 2 * P;                // payload entries per thread
    __shared__ uint32_t s_code[4 * N_CHUNKS], s_bad[2 * N_CHUNKS];
    __shared__ u64 s_k[MAX_STASH], s_l[MAX_STASH], s_r[MAX_STASH];

    const int tid = threadIdx.x;
    for (int s = tid; s < MAX_STASH; s += THREADS) {
        s_k[s] = s < n_stash ? stash_k[s] : ~0ull;  // the padding sorts last and equals no key
        s_l[s] = s < n_stash ? stash_l[s] : 0;
        s_r[s] = s < n_stash ? stash_r[s] : 0;
    }
    const int64_t m0 = (int64_t)blockIdx.x * TP;
    stage(packed, bad, w, 2 * m0, N_CHUNKS, aligned, s_code, s_bad);
    __syncthreads();
    const bool sorted = !__syncthreads_or(tid + 1 < n_stash && s_k[tid] >= s_k[tid + 1]);

    const int64_t n_pay = w - k + 2, n_pairs = (n_pay + 1) / 2, n_rep8 = (n_pay + 7) / 8;
    const int shift = 64 - log_size;
    const u64 rem_mask = (1ull << shift) - 1;

    u64 key[P], h1[P], h2[P], y[P], x[P];
    bool strand[P], live[P];
#pragma unroll
    for (int e = 0; e < P; e++) {
        const int rel = 2 * (P * tid + e);     // base 2m, relative to 2 * m0
        live[e] = m0 + P * tid + e < n_pairs;
        const u64 win = bits64(s_code, 2 * rel);  // bases 2m .. 2m+31
        y[e] = win & 3;
        x[e] = bits32(s_code, 2 * (rel + k - 1)) & 3;
        u64 fwd, rc;
        kmer_words(win >> 2, k - 2, fwd, rc);   // the (k-2)-mer at base 2m+1
        key[e] = fwd < rc ? fwd : rc;
        strand[e] = fwd == key[e];
        h1[e] = mix(key[e], H1);
        h2[e] = mix(key[e], H2);
    }
    ulonglong2 row0[P];
#pragma unroll
    for (int e = 0; e < P; e++) row0[e] = live[e] ? __ldg(&slots[h1[e] >> shift]) : make_ulonglong2(0, 0);
    uint16_t pay[E];
#pragma unroll
    for (int e = 0; e < P; e++) {
        bool hit = row_hit(row0[e], h1[e], rem_mask, 0);
        ulonglong2 row = row0[e];
        if (!hit && live[e]) {  // the second choice, only after a miss
            row = __ldg(&slots[h2[e] >> shift]);
            hit = row_hit(row, h2[e], rem_mask, 1);
        }
        u64 l36 = hit ? ((row.x & 0xFF) << 28) | (row.y >> 36) : 0;
        u64 r36 = hit ? row.y & QP_L36 : 0;
        stash_rows(s_k, s_l, s_r, n_stash, sorted, key[e], l36, r36);
        u64 pe = 0, po = 0;
        if (live[e]) {
            pe = strand[e] ? sub9(l36, y[e]) : flip9(sub9(r36, y[e] ^ 2));
            po = strand[e] ? sub9(r36, x[e]) : flip9(sub9(l36, x[e] ^ 2));
        }
        pay[2 * e] = (uint16_t)pe;
        pay[2 * e + 1] = (uint16_t)po;
    }

    const int64_t j0 = 2 * (m0 + P * tid);  // the thread's first entry; j0 % 8 is 0 or 4
    if (vec && j0 + E <= n_pay) {
        uint32_t v = 0;
#pragma unroll
        for (int i = 0; i < E; i++) v |= (uint32_t)(pay[i] & 0xFF) << (8 * i);
        *reinterpret_cast<uint32_t*>(pay8 + j0) = v;
    } else {
#pragma unroll
        for (int i = 0; i < E; i++)
            if (j0 + i < n_pay) pay8[j0 + i] = (uint8_t)pay[i];
    }
    unsigned nib = 0;  // entry j0 + i at bit 3 - i: np.packbits order within the byte's half
#pragma unroll
    for (int i = 0; i < E; i++) nib |= (unsigned)((pay[i] >> 8) & 1) << (E - 1 - i);
    const unsigned low = __shfl_down_sync(FULL, nib, 1);
    if ((tid & 1) == 0 && j0 / 8 < n_rep8) rep8[j0 / 8] = (uint8_t)(nib << 4 | low);
}

cudaError_t launch_pay(const Args& a, uint8_t* pay8, uint8_t* rep8, cudaStream_t st)
{
    const int64_t n_pairs = (a.w - a.k + 3) / 2;
    const int64_t n_tiles = (n_pairs + TP - 1) / TP;
    scan_pay_qp_kernel<<<(unsigned)n_tiles, THREADS, 0, st>>>(
        a.packed, a.bad, a.w, a.aligned, a.slots, a.log_size, a.stash_k, a.stash_l, a.stash_r, a.n_stash, a.k,
        pay8, rep8, (uintptr_t)pay8 % 4 == 0);
    return cudaGetLastError();
}

}  // namespace

// pairs a block takes: the tile count sizes the look-back scratch
extern "C" int scan_cls_qp_tile_pairs() { return TP; }

// packed: w / 4 bytes, bad: w / 8 bytes; cls2: n4 / 4 bytes; exc16 and
// tail: out_len int16; n_exc: one int64; states: n_tiles + 1 words of
// scratch (zeroed here), n_tiles = ceil(n4 / (2 * scan_cls_qp_tile_pairs())).
extern "C" int scan_cls_qp_launch(
    const void* packed, const void* bad, int64_t w,
    const void* slots, int log_size,
    const void* stash_k, const void* stash_l, const void* stash_r, int n_stash, int k,
    void* cls2, void* exc16, void* n_exc, int64_t out_len, void* tail, void* states, void* stream)
{
    const Args a = {(const uint8_t*)packed, (const uint8_t*)bad, w,
                    (uintptr_t)packed % 16 == 0 && (uintptr_t)bad % 8 == 0,
                    (const ulonglong2*)slots, log_size,
                    (const u64*)stash_k, (const u64*)stash_l, (const u64*)stash_r, n_stash, k,
                    (uint8_t*)cls2, (int16_t*)exc16, (long long*)n_exc, out_len, (int16_t*)tail, (u64*)states};
    return (int)launch(a, (cudaStream_t)stream);
}

// K10: packed and bad as for K1; pay8: w - k + 2 bytes; rep8:
// ceil((w - k + 2) / 8) bytes.
extern "C" int scan_pay_qp_launch(
    const void* packed, const void* bad, int64_t w,
    const void* slots, int log_size,
    const void* stash_k, const void* stash_l, const void* stash_r, int n_stash, int k,
    void* pay8, void* rep8, void* stream)
{
    const Args a = {(const uint8_t*)packed, (const uint8_t*)bad, w,
                    (uintptr_t)packed % 16 == 0 && (uintptr_t)bad % 8 == 0,
                    (const ulonglong2*)slots, log_size,
                    (const u64*)stash_k, (const u64*)stash_l, (const u64*)stash_r, n_stash, k,
                    nullptr, nullptr, nullptr, 0, nullptr, nullptr};
    return (int)launch_pay(a, (uint8_t*)pay8, (uint8_t*)rep8, (cudaStream_t)stream);
}
