// K3: k-mer extraction and canonicalization for device counting, the
// per-base part of the counter's sort_batch
// (mindthegap_tpu_torch/ops/counting_device.py _kmer_keys_plain, which this
// kernel must equal bit for bit).
//
// Replaces: mindthegap_tpu/ops/counting_device.py sort_batch_device, up to
// its jnp.sort — an XLA program on the TPU (unpack_codes_device,
// rolling_kmers_device, canonical_u64, the SENTINEL select). The sort itself
// stays a library sort (torch.sort), as it was XLA's in the JAX package.
//
// Each window p of the batch (P = blen - k + 1 windows, 1 <= k <= 32) gives
// its canonical word min(fwd, revcomp) XOR 2^63 (so that a signed sort gives
// unsigned order), or INT64_MAX (SENTINEL XOR 2^63, sorting last) when one
// of its bases is bad.
//
// Bound on this card: bytes, 8 per window written (64 MB for a default
// batch of 2^23 bases) and 0.375 per base read, 0.021 ms at 3.35 TB/s.
//
// The design: constant work per window (packed_window.cuh). A block of 256
// threads takes a tile of 2,048 windows and stages its 2,112 bases (codes
// and bad bits) in shared memory, one 16-byte and one 8-byte load per 64
// bases. A window is then 64 bits read at its first base by two funnel
// shifts: its reverse complement is that word complemented and masked, its
// forward word one reversal of the 2-bit groups, and its bad test one
// 32-bit read of the bad bits, masked to k. Each thread writes two
// neighbouring windows per 16-byte store, neighbouring threads at
// neighbouring addresses, four stores a thread.

#include <cstdint>
#include <cuda_runtime.h>

#include "packed_window.cuh"

namespace {

using namespace packed_window;

constexpr u64 SIGN = 1ull << 63;
constexpr long long BIASED_SENTINEL = 0x7FFFFFFFFFFFFFFFll;
constexpr int THREADS = 256, PER = 8, TILE = THREADS * PER;
constexpr int N_CHUNKS = TILE / 64 + 1;  // the tile's bases and a k-base halo

__device__ __forceinline__ long long key_of(u64 fwd, u64 rc, uint32_t bad) {
    const u64 canon = fwd < rc ? fwd : rc;
    return bad ? BIASED_SENTINEL : (long long)(canon ^ SIGN);
}

// window at local index lp of the tile
__device__ __forceinline__ long long window_key(const uint32_t* s_code, const uint32_t* s_bad, int lp, int k,
                                                uint32_t bad_mask) {
    u64 fwd, rc;
    kmer_words(bits64(s_code, 2 * lp), k, fwd, rc);
    return key_of(fwd, rc, bits32(s_bad, lp) & bad_mask);
}

__global__ void __launch_bounds__(THREADS) kmer_keys_kernel(
    const uint8_t* __restrict__ packed, const uint8_t* __restrict__ bad, int64_t w, bool aligned,
    int64_t n_windows, int k, long long* __restrict__ out)
{
    __shared__ uint32_t s_code[4 * N_CHUNKS], s_bad[2 * N_CHUNKS];
    const int64_t p0 = (int64_t)blockIdx.x * TILE;
    stage(packed, bad, w, p0, N_CHUNKS, aligned, s_code, s_bad);
    __syncthreads();
    const uint32_t bad_mask = k == 32 ? ~0u : (1u << k) - 1;
    const int tid = threadIdx.x;
#pragma unroll
    for (int r = 0; r < PER / 2; r++) {
        const int lp = 2 * (r * THREADS + tid);
        const int64_t p = p0 + lp;
        if (p >= n_windows) break;
        const long long a = window_key(s_code, s_bad, lp, k, bad_mask);
        if (p + 1 < n_windows) {
            const long long b = window_key(s_code, s_bad, lp + 1, k, bad_mask);
            *reinterpret_cast<longlong2*>(out + p) = make_longlong2(a, b);
        } else {
            out[p] = a;
        }
    }
}

}  // namespace

// packed: w / 4 bytes, bad: w / 8 bytes, out: n_windows = w - k + 1 int64
// words (16-byte aligned, as torch allocates them)
extern "C" int kmer_keys_launch(const void* packed, const void* bad, int64_t w, int k, void* out, void* stream)
{
    const int64_t n_windows = w - k + 1;
    const int64_t grid = (n_windows + TILE - 1) / TILE;
    const bool aligned = (uintptr_t)packed % 16 == 0 && (uintptr_t)bad % 8 == 0;
    kmer_keys_kernel<<<(unsigned)grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)packed, (const uint8_t*)bad, w, aligned, n_windows, k, (long long*)out);
    return (int)cudaGetLastError();
}
