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
// from one probe of the span map (span_map.cuh). Outputs: pay8, the
// payload's low byte per (k-1)-mer; rep8 and str8, its repeat bit and
// whether it was canonical as read, packed big-endian as np.packbits, the
// bits past n_pay 0.
//
// Bound on this card: the probes, random 32-byte sectors of a table of
// 2^log_size * 8 bytes and of its WQ-1 satellite planes (together ~100-300
// MB for a bacterial solid set, above the 50 MB L2): each (k-1)-mer needs
// its first slot, its satellite words where the slot's remainder matches,
// and its second slot (with its satellites) after a miss
// (mindthegap_tpu_torch/bounds.py span_scan_sectors), against 1.6 bytes of
// inputs and outputs per base.
//
// The design: a block of 256 threads takes 256 PER consecutive (k-1)-mers
// and stages their bases, with a halo of up to 255 bases, in shared memory
// (packed_window.cuh, as K1 and K3 do). Each thread owns PER consecutive
// (k-1)-mers and keeps all of their probes in flight together:
//   1. it builds every key (the first from 64-bit reads of the staged
//      stream, each next one by shifting in a base), its canonical words
//      and its digest;
//   2. it issues every key's first slot word at once;
//   3. it scans the stash (shared memory) for every key while those loads
//      are in flight;
//   4. round by round it tests what arrived and issues every key's next
//      load together: the satellite words of a slot that holds the key's
//      digest, the second slot after a miss, that slot's satellites;
//   5. it packs: PER pay8 bytes in one store, and its PER bits of rep8 and
//      str8, ORed with the other threads of their byte by shuffles (8 / PER
//      lanes a byte).
// A thread so waits two round trips for a key in its first slot, three in
// its second, where probing its keys one after another cost up to 3 PER,
// and it loads exactly the sectors bounds.span_scan_sectors counts. The
// keys' words and the loads in flight live in registers, so PER is fixed
// by WQ (launch, below): 4 up to WQ = 4, then 2. The stash sits in shared
// memory; the word count and PER are template parameters.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700.00 W (kernel_bench.py, one
// 2^21-base window over a 256 MB map, in turns with the earlier kernel,
// which probed a thread's 8 keys one after another): at k = 45 0.1413-
// 0.1414 ms against 0.1398-0.1409, at k = 128 0.2601-0.2628 against
// 0.2620-0.2628: equal. Both load the same 4.50 M (k = 45) and 8.66 M
// (k = 128) sectors, 32-33 G sectors a second whatever the probes in
// flight, against the ~38 G of K5 (walk.cu); what sets that rate was not
// measured. Tried and lost, with builds not kept: PER 2 / 4 / 8 at k = 45
// took 0.1407 / 0.1397 / 0.1426 ms, at k = 128 0.2702 / 0.2617 / 0.2696;
// loading the first slot's satellite words with it (one round trip less
// for a key in its first slot) read 7% (k = 45) and 11% (k = 128) more
// sectors and took 0.152-0.165 ms and 0.289-0.321 ms. nvcc -Xptxas -v
// (kernel_bench.py): 48-94 registers a thread, no spill but 4 bytes at
// WQ = 8.

#include <cstdint>
#include <cuda_runtime.h>

#include "packed_window.cuh"
#include "span_map.cuh"

namespace {

using namespace span_map;

constexpr int THREADS = 256;

// the unsigned type of PER bytes (one store of a thread's pay8 bytes)
template <int PER> struct Bytes;
template <> struct Bytes<2> { typedef uint16_t T; };
template <> struct Bytes<4> { typedef uint32_t T; };

template <int WQ, int PER>
__global__ void __launch_bounds__(THREADS) scan_span_kernel(
    const uint8_t* __restrict__ packed, const uint8_t* __restrict__ bad, int64_t w, bool aligned,
    Map m, int k, int64_t n_pay,
    uint8_t* __restrict__ pay8, uint8_t* __restrict__ rep8, uint8_t* __restrict__ str8)
{
    constexpr int TILE = THREADS * PER;  // (k-1)-mers per block
    // the tile's bases, its halo of up to 255 and the words the last 64-bit
    // read touches, in chunks of 64 bases
    constexpr int N_CHUNKS = (TILE + 255 + 64) / 64 + 1;
    static_assert(8 % PER == 0, "a thread's bits lie in one byte of rep8 and str8");
    __shared__ uint32_t s_code[4 * N_CHUNKS], s_bad[2 * N_CHUNKS];
    __shared__ u64 s_sk[MAX_STASH], s_ssat[MAX_STASH * (MAX_WQ - 1)], s_sv[MAX_STASH];
    stage_stash<WQ>(m, s_sk, s_ssat, s_sv);
    const int64_t b0 = (int64_t)blockIdx.x * TILE;
    packed_window::stage(packed, bad, w, b0, N_CHUNKS, aligned, s_code, s_bad);
    __syncthreads();

    const int o = threadIdx.x * PER;  // the thread's first (k-1)-mer, in the tile
    const int64_t j0 = b0 + o;
    // the thread's (k-1)-mers in the window, 0..PER; a thread past the end
    // still takes part in the shuffles below
    const int n = n_pay - j0 >= PER ? PER : n_pay > j0 ? (int)(n_pay - j0) : 0;
    const int nb = k - 1;               // bases per key
    const int bit0 = 7 - (o & 7);       // the first key's bit in its byte of rep8 / str8

    // 1. every key's canonical words, strand and salted digest
    u64 cq[PER][WQ], dig[PER];
    bool is_canon[PER];
    staged_keys<WQ, PER>(m, s_code, o, nb, cq, is_canon, dig);
    unsigned str = 0;
#pragma unroll
    for (int p = 0; p < PER; p++) str |= (unsigned)(is_canon[p] && p < n) << (bit0 - p);
    // 2-4. their probes, all in flight together
    unsigned pay[PER];
    probe_lazy<WQ, PER>(m, cq, dig, n, pay);

    typedef typename Bytes<PER>::T Word;
    Word pays = 0;
    unsigned rep = 0;
#pragma unroll
    for (int p = 0; p < PER; p++) {
        pays |= (Word)(pay[p] & 0xFF) << (8 * p);
        rep |= ((pay[p] >> 8) & 1) << (bit0 - p);
    }
    // the other threads of this byte of rep8 and str8 (aligned groups of 8 / PER lanes)
#pragma unroll
    for (int x = 1; x < 8 / PER; x *= 2) {
        rep |= __shfl_xor_sync(0xFFFFFFFFu, rep, x);
        str |= __shfl_xor_sync(0xFFFFFFFFu, str, x);
    }
    if (n == 0) return;
    if (n == PER && ((uintptr_t)(pay8 + j0) % PER) == 0) {
        *reinterpret_cast<Word*>(pay8 + j0) = pays;
    } else {
        for (int p = 0; p < n; p++) pay8[j0 + p] = (uint8_t)(pays >> (8 * p));
    }
    if ((o & 7) == 0) {
        rep8[j0 / 8] = (uint8_t)rep;
        str8[j0 / 8] = (uint8_t)str;
    }
}

// PER, the (k-1)-mers a thread, falls as WQ grows (registers; see above):
// 4 was the fastest of 2, 4 and 8 at WQ = 2 and 4, and past WQ = 4 it
// takes 108-184 registers a thread
template <int WQ>
cudaError_t launch(const uint8_t* packed, const uint8_t* bad, int64_t w, bool aligned, const Map& m, int k,
                   uint8_t* pay8, uint8_t* rep8, uint8_t* str8, cudaStream_t st)
{
    constexpr int PER = WQ <= 4 ? 4 : 2;
    const int64_t n_pay = w - k + 2;
    const int64_t blocks = (n_pay + THREADS * PER - 1) / (THREADS * PER);
    scan_span_kernel<WQ, PER><<<(unsigned)blocks, THREADS, 0, st>>>(packed, bad, w, aligned, m, k, n_pay,
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
    const Map m = make_map(slots, sat, log_size, salt, stash_k, stash_sat, stash_v, n_stash);
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
