// K8 and K9: the plane pass of one window over the fused quotient maps
// (mindthegap_tpu_torch/find/scan_device.py _scan_planes_q_plain and
// _scan_planes_qb_plain, which these kernels must equal bit for bit).
//
// Replaces: mindthegap_tpu/find/scan_device.py scan_planes_device_q (K8,
// over the 2-choice cuckoo QMap) and scan_planes_device_qb (K9, over the
// 16-slot bucket QMapB), with mindthegap_tpu/ops/extmap.py lookup_q,
// lookup_qb_chunked and planes_from_payload: XLA programs on the TPU.
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
// bounds.py plane_scan_sectors counts the sectors of a run's window.
//
// The design:
//   - A block of 256 threads takes 256 * R consecutive positions (R = 4 over
//     the cuckoo map, 2 over the bucket map, whose probe holds a whole line
//     in registers) and stages their bases in shared memory
//     (packed_window.cuh, as K1 and K3): each (k-1)-mer and k-mer is one
//     64-bit funnel-shifted read, its reverse complement a complement and a
//     mask.
//   - A thread takes R consecutive positions and probes their R (k-1)-mers;
//     the payload past its run, q_{i+R}, is its right neighbour's first,
//     taken by a shuffle. Only the warp's last lane probes it itself.
//   - K8 issues every first-choice slot load before the first compare and
//     probes the second choice only where the first missed (exact: mix is
//     a bijection, so a slot's remainder and choice name one key; K1's
//     finding on this card). K9 issues the R bucket lines as eight 16-byte
//     loads each before reducing any. The stash is searched in shared
//     memory, by bisection when sorted (as the maps keep it).
//   - Each plane is written as one vector store per thread (R bytes, 4R
//     bytes or 8R bytes), consecutive threads on consecutive addresses.

#include <cstdint>
#include <cuda_runtime.h>

#include "packed_window.cuh"
#include "qmap.cuh"

namespace {

using namespace packed_window;

constexpr int THREADS = 256;
constexpr unsigned FULL = 0xFFFFFFFFu;

// positions a thread takes, positions a block takes, 64-base chunks it stages
template <bool BUCKET>
struct Shape {
    static constexpr int R = BUCKET ? 2 : 4;
    static constexpr int TPOS = THREADS * R;
    static constexpr int N_CHUNKS = TPOS / 64 + 2;  // and the k - 1 bases past them
};

struct PlaneOut {
    long long* fwd;
    uint8_t* valid;
    uint8_t* contains;
    int32_t* nb_in;
    int32_t* nb_out;
    uint8_t* suffix_rep;
    uint8_t* prefix_rep;
};

// a thread's R outputs of one plane from position i0 (n of them in the
// window): one vector store where all R are and the plane is aligned
template <int R>
__device__ __forceinline__ void put(uint8_t* __restrict__ out, int64_t i0, const uint8_t (&v)[R], int n, bool vec) {
    if (vec && n == R) {
        uint32_t x = 0;
#pragma unroll
        for (int e = 0; e < R; e++) x |= (uint32_t)v[e] << (8 * e);
        if constexpr (R == 4) *reinterpret_cast<uint32_t*>(out + i0) = x;
        else *reinterpret_cast<uint16_t*>(out + i0) = (uint16_t)x;
    } else {
#pragma unroll
        for (int e = 0; e < R; e++)
            if (e < n) out[i0 + e] = v[e];
    }
}

template <int R>
__device__ __forceinline__ void put(int32_t* __restrict__ out, int64_t i0, const int32_t (&v)[R], int n, bool vec) {
    if (vec && n == R) {
        if constexpr (R == 4) *reinterpret_cast<int4*>(out + i0) = make_int4(v[0], v[1], v[2], v[3]);
        else *reinterpret_cast<int2*>(out + i0) = make_int2(v[0], v[1]);
    } else {
#pragma unroll
        for (int e = 0; e < R; e++)
            if (e < n) out[i0 + e] = v[e];
    }
}

template <int R>
__device__ __forceinline__ void put(long long* __restrict__ out, int64_t i0, const u64 (&v)[R], int n, bool vec) {
    if (vec && n == R) {
#pragma unroll
        for (int h = 0; h < R / 2; h++)
            reinterpret_cast<ulonglong2*>(out + i0)[h] = make_ulonglong2(v[2 * h], v[2 * h + 1]);
    } else {
#pragma unroll
        for (int e = 0; e < R; e++)
            if (e < n) out[i0 + e] = (long long)v[e];
    }
}

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

template <bool BUCKET>
__global__ void __launch_bounds__(THREADS) scan_planes_kernel(
    const uint8_t* __restrict__ packed, const uint8_t* __restrict__ bad, int64_t w, bool aligned,
    const u64* __restrict__ slots, int log_size,
    const u64* __restrict__ stash_k, const u64* __restrict__ stash_v, int n_stash, int k,
    PlaneOut o, bool vec)
{
    constexpr int R = Shape<BUCKET>::R, TPOS = Shape<BUCKET>::TPOS, N_CHUNKS = Shape<BUCKET>::N_CHUNKS;
    constexpr int NE = R + 1;  // the run's payload entries and the one past it
    __shared__ uint32_t s_code[4 * N_CHUNKS], s_bad[2 * N_CHUNKS];
    __shared__ u64 s_k[qmap::MAX_STASH];
    __shared__ unsigned s_v[qmap::MAX_STASH];

    const int tid = threadIdx.x, lane = tid & 31;
    for (int s = tid; s < qmap::MAX_STASH; s += THREADS) {
        s_k[s] = s < n_stash ? stash_k[s] : ~0ull;  // the padding sorts last and equals no key
        s_v[s] = s < n_stash ? (unsigned)stash_v[s] : 0u;
    }
    const int64_t p0 = (int64_t)blockIdx.x * TPOS;
    stage(packed, bad, w, p0, N_CHUNKS, aligned, s_code, s_bad);
    __syncthreads();
    const bool sorted = !__syncthreads_or(tid + 1 < n_stash && s_k[tid] >= s_k[tid + 1]);

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
        u64 f, r;
        kmer_words(bits64(s_code, 2 * (rel0 + e)), k - 1, f, r);
        key[e] = f < r ? f : r;
        strand[e] = f == key[e];
        h1[e] = qmap::mix(key[e], qmap::H1);
    }

    // their 9-bit payloads, the probes' loads issued before the first compare
    unsigned pay[NE];
    if constexpr (BUCKET) {
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
#pragma unroll
        for (int e = 0; e < NE; e++) pay[e] = qmap::qb_payload(line[e], h1[e] & rem_mask);
    } else {
        u64 v1[NE], v2[NE];
        bool hit1[NE], need[NE];
#pragma unroll
        for (int e = 0; e < NE; e++) v1[e] = live[e] ? __ldg(slots + (h1[e] >> shift)) : 0;
#pragma unroll
        for (int e = 0; e < NE; e++) {  // the second choice, only after a miss
            hit1[e] = qmap::q_slot_hit(v1[e], h1[e] & rem_mask, 0);
            need[e] = live[e] && !hit1[e];
            v2[e] = need[e] ? __ldg(slots + (qmap::mix(key[e], qmap::H2) >> shift)) : 0;
        }
#pragma unroll
        for (int e = 0; e < NE; e++) {
            const u64 h2 = qmap::mix(key[e], qmap::H2);
            pay[e] = hit1[e] ? (unsigned)(v1[e] & qmap::PAY_MASK)
                   : need[e] && qmap::q_slot_hit(v2[e], h2 & rem_mask, 1) ? (unsigned)(v2[e] & qmap::PAY_MASK)
                   : 0u;
        }
    }
    // each payload oriented to its strand: ext | pre << 4 | rep << 8
    unsigned opay[NE];
#pragma unroll
    for (int e = 0; e < NE; e++) {
        const unsigned p = pay[e] | (live[e] ? stash_payload(s_k, s_v, n_stash, sorted, key[e]) : 0u);
        const unsigned ext_c = p & 0xF, pre_c = (p >> 4) & 0xF;
        opay[e] = (strand[e] ? (ext_c | pre_c << 4) : (qmap::shuffle02(pre_c) | qmap::shuffle02(ext_c) << 4))
                | (p & 0x100);
    }
    // q_{i0+R} is the right neighbour's first (lane 31 probed it)
    const unsigned next = __shfl_down_sync(FULL, opay[0], 1);
    if (lane != 31) opay[R] = next;

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

template <bool BUCKET>
cudaError_t launch(const uint8_t* packed, const uint8_t* bad, int64_t w, const u64* slots, int log_size,
                   const u64* stash_k, const u64* stash_v, int n_stash, int k, const PlaneOut& o, cudaStream_t st)
{
    const int64_t n_pos = w - k + 1;
    const int64_t blocks = (n_pos + Shape<BUCKET>::TPOS - 1) / Shape<BUCKET>::TPOS;
    const bool aligned = (uintptr_t)packed % 16 == 0 && (uintptr_t)bad % 8 == 0;
    const bool vec = ((uintptr_t)o.fwd | (uintptr_t)o.valid | (uintptr_t)o.contains | (uintptr_t)o.nb_in
                      | (uintptr_t)o.nb_out | (uintptr_t)o.suffix_rep | (uintptr_t)o.prefix_rep) % 16 == 0;
    scan_planes_kernel<BUCKET><<<(unsigned)blocks, THREADS, 0, st>>>(
        packed, bad, w, aligned, slots, log_size, stash_k, stash_v, n_stash, k, o, vec);
    return cudaGetLastError();
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
    if (bucket) return (int)launch<true>(pk, bd, w, sl, log_size, sk, sv, n_stash, k, o, st);
    return (int)launch<false>(pk, bd, w, sl, log_size, sk, sv, n_stash, k, o, st);
}
