// K1: the fused core of the find scan's reference-delta pass over the
// pair-coalesced quotient map (mindthegap_tpu_torch/ops/extmap.py QMapP).
//
// Replaces: mindthegap_tpu/find/scan_device.py scan_cls_device_qp, with its
// core _pair_pay_device and mindthegap_tpu/ops/extmap.py lookup_qp — an XLA
// program on the TPU, about a hundred 64-bit elementwise ops per window in
// plain PyTorch (mindthegap_tpu_torch/find/scan_device.py _cls_core_plain,
// which this kernel must equal bit for bit).
//
// One thread per four payload entries j = 4t..4t+3 (two position pairs):
//   1. read the (k-2)-mer at position 2m+1 from the 2-bit packed codes and
//      the bad bits (invalid bases and bases past the window read as A);
//   2. canonicalize it, keeping the strand;
//   3. two hashed 16-byte row probes of `slots` (one ulonglong2 load each),
//      then the <= 64-entry stash, held in shared memory;
//   4. derive both 9-bit payloads of the pair;
//   5. classify each payload against the reference's own continuation;
//   6. write one byte of four 2-bit classes and four int16 payloads.
// The exception compaction stays in PyTorch (scan_cls_qp).
//
// Bound on this card: two random 16-byte row gathers per pair out of a
// table of 2^log_size * 16 bytes (256 MB for a bacterial solid set of 4.7 M
// k-mers, above the 50 MB L2), so the pass is limited by random DRAM
// transactions, not by arithmetic. The design issues each row as one
// 16-byte load and keeps everything else (codes, stash) in L1 or shared
// memory.

#include <cstdint>
#include <cuda_runtime.h>

typedef unsigned long long u64;

namespace {

constexpr u64 H1 = 0x9E3779B97F4A7C15ull;
constexpr u64 H2 = 0xC2B2AE3D27D4EB4Full;
constexpr u64 QP_REM_MASK = (1ull << 45) - 1;
constexpr u64 QP_CHOICE = 1ull << 8;
constexpr u64 QP_VALID = 1ull << 9;
constexpr u64 QP_L36 = (1ull << 36) - 1;
constexpr int INVALID = 255;
constexpr int MAX_STASH = 64;

__device__ __forceinline__ u64 mix(u64 key, u64 c) {
    u64 h = (key ^ (key >> 33)) * c;
    return h ^ (h >> 29);
}

__device__ __forceinline__ u64 revcomp(u64 x, int k) {
    x ^= 0xAAAAAAAAAAAAAAAAull;  // complement every base
    x = ((x >> 2) & 0x3333333333333333ull) | ((x & 0x3333333333333333ull) << 2);
    x = ((x >> 4) & 0x0F0F0F0F0F0F0F0Full) | ((x & 0x0F0F0F0F0F0F0F0Full) << 4);
    x = ((x >> 8) & 0x00FF00FF00FF00FFull) | ((x & 0x00FF00FF00FF00FFull) << 8);
    x = ((x >> 16) & 0x0000FFFF0000FFFFull) | ((x & 0x0000FFFF0000FFFFull) << 16);
    x = (x >> 32) | (x << 32);
    return x >> (64 - 2 * k);
}

__device__ __forceinline__ u64 shuffle02(u64 b) {
    return ((b >> 2) & 1) | (((b >> 3) & 1) << 1) | ((b & 1) << 2) | (((b >> 1) & 1) << 3);
}

__device__ __forceinline__ u64 flip9(u64 p) {
    return shuffle02((p >> 4) & 0xF) | (shuffle02(p & 0xF) << 4) | (p & 0x100);
}

// Raw code at position p: 0..3, or 255 when the base is bad or outside [0, w).
__device__ __forceinline__ int raw_code(const uint8_t* packed, const uint8_t* bad, int64_t w, int64_t p) {
    if (p < 0 || p >= w) return INVALID;
    if ((bad[p >> 3] >> (7 - (p & 7))) & 1) return INVALID;
    return (packed[p >> 2] >> (2 * (p & 3))) & 3;
}

__device__ __forceinline__ u64 clean_code(const uint8_t* packed, const uint8_t* bad, int64_t w, int64_t p) {
    int c = raw_code(packed, bad, w, p);
    return c == INVALID ? 0 : (u64)c;
}

__device__ __forceinline__ u64 sub9(u64 blk, u64 i4) { return (blk >> (9 * i4)) & 0x1FF; }

__device__ __forceinline__ int classify(u64 pay, int b_hi, int b_lo) {
    bool ok = b_hi < 4 && b_lo < 4;
    if (ok && (pay & 0xFF) == ((1ull << b_hi) | ((1ull << b_lo) << 4)))
        return ((pay >> 8) & 1) ? 3 : 0;
    return pay == 0 ? 1 : 2;
}

__global__ void scan_cls_qp_kernel(
    const uint8_t* __restrict__ packed, const uint8_t* __restrict__ bad, int64_t w,
    const ulonglong2* __restrict__ slots, int log_size,
    const u64* __restrict__ stash_k, const u64* __restrict__ stash_l,
    const u64* __restrict__ stash_r, int n_stash, int k,
    uint8_t* __restrict__ cls2, int16_t* __restrict__ pay16, int64_t n4)
{
    __shared__ u64 s_k[MAX_STASH], s_l[MAX_STASH], s_r[MAX_STASH];
    for (int s = threadIdx.x; s < n_stash; s += blockDim.x) {
        s_k[s] = stash_k[s];
        s_l[s] = stash_l[s];
        s_r[s] = stash_r[s];
    }
    __syncthreads();

    const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= n4 / 4) return;

    const int64_t n_pay = w - k + 2;
    const int64_t n_pairs = (n_pay + 1) / 2;
    const int shift = 64 - log_size;
    const u64 rem_mask = (1ull << shift) - 1;

    u64 pay[4];
    for (int e = 0; e < 2; e++) {
        const int64_t m = 2 * t + e;
        if (m >= n_pairs) {  // padding past the payload stream
            pay[2 * e] = 0;
            pay[2 * e + 1] = 0;
            continue;
        }
        u64 r = 0;
        for (int j = 0; j < k - 2; j++) r = (r << 2) | clean_code(packed, bad, w, 2 * m + 1 + j);
        const u64 rc = revcomp(r, k - 2);
        const u64 key = r < rc ? r : rc;
        const bool strand = r == key;

        u64 l36 = 0, r36 = 0;
        for (int i = 0; i < 2; i++) {
            const u64 h = mix(key, i ? H2 : H1);
            const ulonglong2 row = slots[h >> shift];
            const bool hit = (((row.x >> 10) & QP_REM_MASK) == (h & rem_mask))
                && (row.x & QP_VALID) && (((row.x & QP_CHOICE) != 0) == (i == 1));
            if (hit) {
                l36 = ((row.x & 0xFF) << 28) | (row.y >> 36);
                r36 = row.y & QP_L36;
            }
        }
        for (int s = 0; s < n_stash; s++) {
            if (s_k[s] == key) {
                l36 |= s_l[s];
                r36 |= s_r[s];
            }
        }
        const u64 y = clean_code(packed, bad, w, 2 * m);
        const u64 x = clean_code(packed, bad, w, 2 * m + k - 1);
        pay[2 * e] = strand ? sub9(l36, y) : flip9(sub9(r36, y ^ 2));
        pay[2 * e + 1] = strand ? sub9(r36, x) : flip9(sub9(l36, x ^ 2));
    }

    uint8_t byte = 0;
    u64 packed_pay = 0;
    for (int e = 0; e < 4; e++) {
        const int64_t j = 4 * t + e;
        const int cls = classify(pay[e], raw_code(packed, bad, w, j + k - 1), raw_code(packed, bad, w, j - 1));
        byte |= (uint8_t)(cls << (2 * e));
        packed_pay |= (pay[e] & 0xFFFF) << (16 * e);
    }
    cls2[t] = byte;
    reinterpret_cast<u64*>(pay16)[t] = packed_pay;
}

}  // namespace

extern "C" int scan_cls_qp_launch(
    const void* packed, const void* bad, int64_t w,
    const void* slots, int log_size,
    const void* stash_k, const void* stash_l, const void* stash_r, int n_stash,
    int k, void* cls2, void* pay16, int64_t n4, void* stream)
{
    const int block = 256;
    const int64_t n_threads = n4 / 4;
    const int64_t grid = (n_threads + block - 1) / block;
    scan_cls_qp_kernel<<<(unsigned)grid, block, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)packed, (const uint8_t*)bad, w,
        (const ulonglong2*)slots, log_size,
        (const u64*)stash_k, (const u64*)stash_l, (const u64*)stash_r, n_stash, k,
        (uint8_t*)cls2, (int16_t*)pay16, n4);
    return (int)cudaGetLastError();
}
