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
// 255 = invalid, 1 <= k <= 32): its canonical k-mer c = min(fwd, revcomp)
// and the bijective swizzle s = mix(c), mix(x) = y ^ (y >> 29) with
// y = (x ^ (x >> 33)) * const mod 2^64, whose top log2(n_shards) bits name
// the owner shard. Out: swz[p] = s XOR 2^63 (so that torch.sort's signed
// order is unsigned order) and canon[p] = c, or INT64_MAX and all ones
// (the SENTINEL, sorting last) where the window holds an invalid base.
//
// Bound on this card: bytes, 1 read and 16 written per window (about 134
// MB for a 2^23-base flush, 0.040 ms at 3.35 TB/s); a handful of integer
// operations per window, far below the card's rate.
//
// The design: a block of 256 threads takes 1,024 consecutive windows and
// stages their 1,024 + k - 1 codes in shared memory. A thread takes 4
// consecutive windows: it rolls the first over k codes and each next one by
// a base, forward and reverse complement together, tracking the last
// invalid base; consecutive threads write consecutive 32-byte runs.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

using u64 = unsigned long long;

constexpr u64 SIGN = 1ull << 63;
constexpr long long BIASED_SENTINEL = 0x7FFFFFFFFFFFFFFFll;
constexpr int THREADS = 256, PER = 4, TILE = THREADS * PER;

__global__ void __launch_bounds__(THREADS) swizzle_keys_kernel(
    const uint8_t* __restrict__ codes, int64_t n, int k, u64 mult,
    long long* __restrict__ swz, long long* __restrict__ canon)
{
    __shared__ uint8_t s_codes[TILE + 32];
    const int64_t p0 = (int64_t)blockIdx.x * TILE;
    const int64_t n_win = n - k + 1;
    for (int i = threadIdx.x; i < TILE + k - 1; i += THREADS)
        s_codes[i] = p0 + i < n ? codes[p0 + i] : 255;
    __syncthreads();

    const int lp = threadIdx.x * PER;
    if (p0 + lp >= n_win) return;
    const u64 mask = k == 32 ? ~0ull : (1ull << (2 * k)) - 1;
    const int top = 2 * (k - 1);
    u64 fwd = 0, rc = 0;
    int last_bad = -1;  // local index of the last invalid base read
    for (int j = 0; j < k - 1; j++) {
        const uint8_t c = s_codes[lp + j];
        const u64 b = c == 255 ? 0 : c;
        if (c == 255) last_bad = j;
        fwd = ((fwd << 2) | b) & mask;
        rc = (rc >> 2) | ((b ^ 2ull) << top);
    }
#pragma unroll
    for (int r = 0; r < PER; r++) {
        const int j = r + k - 1;
        const uint8_t c = s_codes[lp + j];
        const u64 b = c == 255 ? 0 : c;
        if (c == 255) last_bad = j;
        fwd = ((fwd << 2) | b) & mask;
        rc = (rc >> 2) | ((b ^ 2ull) << top);
        const int64_t p = p0 + lp + r;
        if (p >= n_win) break;
        if (last_bad >= r) {  // a bad base in [r, r + k)
            swz[p] = BIASED_SENTINEL;
            canon[p] = -1;
            continue;
        }
        const u64 c64 = fwd < rc ? fwd : rc;
        u64 y = (c64 ^ (c64 >> 33)) * mult;
        y ^= y >> 29;
        swz[p] = (long long)(y ^ SIGN);
        canon[p] = (long long)c64;
    }
}

}  // namespace

// codes: n bytes; swz, canon: n - k + 1 int64 words each
extern "C" int swizzle_keys_launch(const void* codes, int64_t n, int k, uint64_t mult, void* swz, void* canon,
                                   void* stream)
{
    const int64_t n_win = n - k + 1;
    const int64_t grid = (n_win + TILE - 1) / TILE;
    swizzle_keys_kernel<<<(unsigned)grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)codes, n, k, (u64)mult, (long long*)swz, (long long*)canon);
    return (int)cudaGetLastError();
}
