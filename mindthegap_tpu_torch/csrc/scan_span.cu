// K6: the span scan of one window, 32 < k <= 256, over the multi-word
// fused quotient map (mindthegap_tpu_torch/find/scan_device.py
// _scan_pay_q_span_plain, which this kernel must equal bit for bit).
//
// Replaces: mindthegap_tpu/find/scan_device.py scan_pay_device_q_span, with
// mindthegap_tpu/ops/extmap.py lookup_q_span and the rolling, canonical and
// digest arithmetic of mindthegap_tpu/ops/span_device.py, an XLA program on
// the TPU.
//
// For each of the n_pay = w - k + 2 (k-1)-mers of the window (bases read
// from the 2-bit packed codes, an invalid base as base 0): its WQ =
// ceil((k-1)/32) words, their canonical form, whose 9-bit payload comes
// from one probe of the span map (span_map.cuh lookup). Outputs: pay8, the
// payload's low byte per (k-1)-mer; rep8 and str8, its repeat bit and
// whether it was canonical as read, packed big-endian as np.packbits, the
// bits past n_pay 0.
//
// Bound on this card: the probes, random 32-byte sectors of a table of
// 2^log_size * 8 bytes and of its WQ-1 satellite planes (together ~100-300
// MB for a bacterial solid set, above the 50 MB L2): each (k-1)-mer reads
// its first slot, its satellite words where the slot's remainder matches,
// and its second slot (with its satellites) after a miss
// (mindthegap_tpu_torch/bounds.py span_scan_sectors), against 1.6 bytes of
// inputs and outputs per base.
//
// The design, simple first: a block of 256 threads takes 2,048 consecutive
// (k-1)-mers and stages their bases, with a halo of up to 255 bases, in
// shared memory (packed_window.cuh, as K1 and K3 do). Each thread owns 8
// consecutive (k-1)-mers: it builds the first from 64-bit reads of the
// staged stream, shifts in the next 7 bases one at a time, and writes its 8
// pay8 bytes and one byte each of rep8 and str8, so no cross-thread
// packing is needed. The stash sits in shared memory. The word count is a
// template parameter, so the words stay in registers.

#include <cstdint>
#include <cuda_runtime.h>

#include "packed_window.cuh"
#include "span_map.cuh"

namespace {

using packed_window::bits64;
using packed_window::rev2;
using namespace span_map;

constexpr int THREADS = 256;
constexpr int PER = 8;                  // (k-1)-mers per thread
constexpr int TILE = THREADS * PER;     // (k-1)-mers per block
// the tile's bases, its halo of up to 255 and the words the last 64-bit
// read touches, in chunks of 64 bases
constexpr int N_CHUNKS = (TILE + 255 + 64) / 64 + 1;

template <int WQ>
__global__ void __launch_bounds__(THREADS) scan_span_kernel(
    const uint8_t* __restrict__ packed, const uint8_t* __restrict__ bad, int64_t w, bool aligned,
    Map m, int k, int64_t n_pay,
    uint8_t* __restrict__ pay8, uint8_t* __restrict__ rep8, uint8_t* __restrict__ str8)
{
    __shared__ uint32_t s_code[4 * N_CHUNKS], s_bad[2 * N_CHUNKS];
    __shared__ u64 s_sk[MAX_STASH], s_ssat[MAX_STASH * (MAX_WQ - 1)], s_sv[MAX_STASH];
    stage_stash<WQ>(m, s_sk, s_ssat, s_sv);
    const int64_t b0 = (int64_t)blockIdx.x * TILE;
    packed_window::stage(packed, bad, w, b0, N_CHUNKS, aligned, s_code, s_bad);
    __syncthreads();

    const int o = threadIdx.x * PER;  // the thread's first (k-1)-mer, in the tile
    const int64_t j0 = b0 + o;
    if (j0 >= n_pay) return;
    const int nb = k - 1;                  // bases per key
    const int tb = nb - 32 * (WQ - 1);     // bases in word 0, 1..32
    const u64 top = top_mask(nb, WQ);
    u64 q[WQ];
    q[0] = rev2(bits64(s_code, 2 * o)) >> (64 - 2 * tb);
#pragma unroll
    for (int i = 1; i < WQ; i++) q[i] = rev2(bits64(s_code, 2 * (o + tb + 32 * (i - 1))));

    u64 pays = 0;
    unsigned rep = 0, str = 0;
    const int n = n_pay - j0 < PER ? (int)(n_pay - j0) : PER;
    for (int p = 0; p < n; p++) {
        if (p > 0) {  // shift in the key's last base
            const int ob = o + p + nb - 1;
            const u64 c = (s_code[ob >> 4] >> (2 * (ob & 15))) & 3;
#pragma unroll
            for (int i = 0; i < WQ - 1; i++) q[i] = (q[i] << 2) | (q[i + 1] >> 62);
            q[WQ - 1] = (q[WQ - 1] << 2) | c;
            q[0] &= top;
        }
        u64 cq[WQ];
        bool is_canon;
        canonical<WQ>(q, nb, cq, is_canon);
        const unsigned pay = lookup<WQ>(m, cq);
        pays |= (u64)(pay & 0xFF) << (8 * p);
        rep |= ((pay >> 8) & 1) << (7 - p);
        str |= (unsigned)is_canon << (7 - p);
    }
    if (n == PER && ((uintptr_t)(pay8 + j0) & 7) == 0) {
        *reinterpret_cast<u64*>(pay8 + j0) = pays;
    } else {
        for (int p = 0; p < n; p++) pay8[j0 + p] = (uint8_t)(pays >> (8 * p));
    }
    rep8[j0 / PER] = (uint8_t)rep;
    str8[j0 / PER] = (uint8_t)str;
}

template <int WQ>
cudaError_t launch(const uint8_t* packed, const uint8_t* bad, int64_t w, bool aligned, const Map& m, int k,
                   uint8_t* pay8, uint8_t* rep8, uint8_t* str8, cudaStream_t st)
{
    const int64_t n_pay = w - k + 2;
    const int64_t blocks = (n_pay + TILE - 1) / TILE;
    scan_span_kernel<WQ><<<(unsigned)blocks, THREADS, 0, st>>>(packed, bad, w, aligned, m, k, n_pay,
                                                               pay8, rep8, str8);
    return cudaGetLastError();
}

}  // namespace

// packed: w / 4 bytes, bad: w / 8 bytes (pack_codes_host); slots: 2^log_size
// words; sat: ceil((k-1)/32) - 1 planes of 2^log_size words (null when
// none); stash: n_stash salted digests, n_stash x (WQ-1) words (null when
// none) and payloads; pay8: w - k + 2 bytes; rep8, str8: ceil((w - k + 2) / 8)
// bytes each. 33 <= k <= 256, w >= k + 8, w % 8 == 0.
extern "C" int scan_pay_q_span_launch(
    const void* packed, const void* bad, int64_t w,
    const void* slots, const void* sat, int log_size, int64_t salt,
    const void* stash_k, const void* stash_sat, const void* stash_v, int n_stash, int k,
    void* pay8, void* rep8, void* str8, void* stream)
{
    if (k < 33 || k > 256 || n_stash < 1 || n_stash > MAX_STASH || w < k + 8 || w % 8) return (int)cudaErrorInvalidValue;
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
    const bool aligned = (uintptr_t)packed % 16 == 0 && (uintptr_t)bad % 8 == 0;
    const uint8_t *p = (const uint8_t*)packed, *b = (const uint8_t*)bad;
    uint8_t *o1 = (uint8_t*)pay8, *o2 = (uint8_t*)rep8, *o3 = (uint8_t*)str8;
    cudaStream_t st = (cudaStream_t)stream;
    switch ((k - 1 + 31) / 32) {
        case 1: return (int)launch<1>(p, b, w, aligned, m, k, o1, o2, o3, st);
        case 2: return (int)launch<2>(p, b, w, aligned, m, k, o1, o2, o3, st);
        case 3: return (int)launch<3>(p, b, w, aligned, m, k, o1, o2, o3, st);
        case 4: return (int)launch<4>(p, b, w, aligned, m, k, o1, o2, o3, st);
        case 5: return (int)launch<5>(p, b, w, aligned, m, k, o1, o2, o3, st);
        case 6: return (int)launch<6>(p, b, w, aligned, m, k, o1, o2, o3, st);
        case 7: return (int)launch<7>(p, b, w, aligned, m, k, o1, o2, o3, st);
        case 8: return (int)launch<8>(p, b, w, aligned, m, k, o1, o2, o3, st);
    }
    return (int)cudaErrorInvalidValue;
}
