// K11: the key routing of sharded counting, one shard's chunk
// (mindthegap_tpu_torch/parallel/sharded_count.py _swizzle_keys_plain, which
// this kernel must equal bit for bit).
//
// Replaces: mindthegap_tpu/parallel/sharded_count.py
// ShardedStreamingCounter._build_flush_fn's shard_fn up to its sort
// (rolling_kmers_device, canonical_u64, the swizzle, the SENTINEL selects),
// and the same steps of mindthegap_tpu/parallel/mesh.py
// distributed_count_step: XLA programs on the TPU.
//
// For each window p of the chunk (P = n - k + 1 windows of n base codes,
// 1 <= k <= 32): its canonical k-mer c = min(fwd, revcomp) and the
// bijective swizzle s = mix(c), mix(x) = y ^ (y >> 29) with
// y = (x ^ (x >> 33)) * const mod 2^64, whose top log2(n_shards) bits name
// the owner shard. Out: swz[p] = s XOR 2^63 (so that torch.sort's signed
// order is unsigned order) and canon[p] = c, or INT64_MAX and all ones
// (the SENTINEL, sorting last) where the window holds an invalid base.
// Input contract: every code is 0, 1, 2, 3 or 255 (invalid), as the
// encoders write them; the kernel keeps two bits of a valid code.
//
// Bound on this card: bytes, 1 read and 16 written per window (about 134
// MB for a 2^23-base flush, 0.040 ms at 3.35 TB/s); a handful of integer
// operations per window, far below the card's rate.
//
// The design is K3's (count_kmers.cu): constant work per window. A block
// of 256 threads takes a tile of 2,048 windows and stages its 2,112 codes
// as 2-bit codes and bad bits in shared memory (packed_window.cuh
// stage_codes: 16 codes from one 16-byte load, byte by byte at the chunk's
// end and on a misaligned view). A window is 64 bits read at its first base
// by two funnel shifts: its reverse complement is that word complemented
// and masked, its forward word one reversal of the 2-bit groups, its bad
// test one 32-bit read of the bad bits, masked to k. Each thread writes
// two neighbouring windows' swizzles, then their k-mers, as one 16-byte
// store each, neighbouring threads at neighbouring addresses.
// Measured on an H100 80GB HBM3 at 700 W (kernel_bench.py, a 2^23-base
// flush): 0.054 ms, 79% of the bound.

#include <cstdint>
#include <cuda_runtime.h>

#include "packed_window.cuh"

namespace {

using namespace packed_window;

constexpr u64 SIGN = 1ull << 63;
constexpr long long BIASED_SENTINEL = 0x7FFFFFFFFFFFFFFFll;
constexpr int THREADS = 256, PER = 8, TILE = THREADS * PER;
constexpr int N_UNITS = TILE / 16 + 4;  // the tile's codes and a halo of up to 64, 16 a unit

// (swizzle XOR 2^63, canonical k-mer) of the window at local index lp
__device__ __forceinline__ longlong2 window_keys(const uint32_t* s_code, const uint32_t* s_bad, int lp, int k,
                                                 uint32_t bad_mask, u64 mult) {
    if (bits32(s_bad, lp) & bad_mask) return make_longlong2(BIASED_SENTINEL, -1);
    u64 fwd, rc;
    kmer_words(bits64(s_code, 2 * lp), k, fwd, rc);
    const u64 c = fwd < rc ? fwd : rc;
    u64 y = (c ^ (c >> 33)) * mult;
    y ^= y >> 29;
    return make_longlong2((long long)(y ^ SIGN), (long long)c);
}

__global__ void __launch_bounds__(THREADS) swizzle_keys_kernel(
    const uint8_t* __restrict__ codes, int64_t n, bool aligned, int k, u64 mult,
    long long* __restrict__ swz, long long* __restrict__ canon)
{
    __shared__ uint32_t s_code[N_UNITS], s_bad[N_UNITS / 2];
    const int64_t p0 = (int64_t)blockIdx.x * TILE;
    stage_codes(codes, n, p0, N_UNITS, aligned, s_code, s_bad);
    __syncthreads();
    const int64_t n_win = n - k + 1;
    const uint32_t bad_mask = k == 32 ? ~0u : (1u << k) - 1;
#pragma unroll
    for (int r = 0; r < PER / 2; r++) {
        const int lp = 2 * (r * THREADS + threadIdx.x);
        const int64_t p = p0 + lp;
        if (p >= n_win) break;
        const longlong2 a = window_keys(s_code, s_bad, lp, k, bad_mask, mult);
        if (p + 1 < n_win) {
            const longlong2 b = window_keys(s_code, s_bad, lp + 1, k, bad_mask, mult);
            *reinterpret_cast<longlong2*>(swz + p) = make_longlong2(a.x, b.x);
            *reinterpret_cast<longlong2*>(canon + p) = make_longlong2(a.y, b.y);
        } else {
            swz[p] = a.x;
            canon[p] = a.y;
        }
    }
}

}  // namespace

// codes: n bytes (any alignment); swz, canon: n - k + 1 int64 words each,
// 16-byte aligned (as torch allocates them)
extern "C" int swizzle_keys_launch(const void* codes, int64_t n, int k, uint64_t mult, void* swz, void* canon,
                                   void* stream)
{
    const int64_t n_win = n - k + 1;
    const int64_t grid = (n_win + TILE - 1) / TILE;
    const bool aligned = (uintptr_t)codes % 16 == 0;
    swizzle_keys_kernel<<<(unsigned)grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)codes, n, aligned, k, (u64)mult, (long long*)swz, (long long*)canon);
    return (int)cudaGetLastError();
}
