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
// One thread per window p of the batch (P = blen - k + 1 windows):
//   1. read bases p..p+k-1 (k <= 32, so at most 9 packed bytes) and their
//      bad bits (separators and Ns);
//   2. form the forward word, its reverse complement and the unsigned
//      minimum in native unsigned long long;
//   3. write the canonical word XOR 2^63 (so that a signed sort gives
//      unsigned order), or INT64_MAX (SENTINEL XOR 2^63, sorting last) when
//      the window touches a bad bit.
//
// Bound on this card: the output, 8 bytes per window (64 MB for a default
// batch of 2^23 bases), written once and coalesced; the inputs (0.375 B per
// base) are read by 32 neighbouring threads each and stay in L1. Nothing
// here is worth tiling: the sort that follows costs several times more.

#include <cstdint>
#include <cuda_runtime.h>

typedef unsigned long long u64;

namespace {

constexpr u64 SIGN = 1ull << 63;
constexpr long long BIASED_SENTINEL = 0x7FFFFFFFFFFFFFFFll;

__device__ __forceinline__ u64 revcomp(u64 x, int k) {
    x ^= 0xAAAAAAAAAAAAAAAAull;  // complement every base
    x = ((x >> 2) & 0x3333333333333333ull) | ((x & 0x3333333333333333ull) << 2);
    x = ((x >> 4) & 0x0F0F0F0F0F0F0F0Full) | ((x & 0x0F0F0F0F0F0F0F0Full) << 4);
    x = ((x >> 8) & 0x00FF00FF00FF00FFull) | ((x & 0x00FF00FF00FF00FFull) << 8);
    x = ((x >> 16) & 0x0000FFFF0000FFFFull) | ((x & 0x0000FFFF0000FFFFull) << 16);
    x = (x >> 32) | (x << 32);
    return x >> (64 - 2 * k);
}

__global__ void kmer_keys_kernel(const uint8_t* __restrict__ packed, const uint8_t* __restrict__ bad,
                                 int64_t n_windows, int k, long long* __restrict__ out)
{
    const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= n_windows) return;
    u64 fwd = 0;
    bool ok = true;
    for (int j = 0; j < k; j++) {
        const int64_t q = p + j;
        ok = ok && !((bad[q >> 3] >> (7 - (q & 7))) & 1);
        fwd = (fwd << 2) | ((packed[q >> 2] >> (2 * (q & 3))) & 3);
    }
    const u64 rc = revcomp(fwd, k);
    const u64 canon = fwd < rc ? fwd : rc;
    out[p] = ok ? (long long)(canon ^ SIGN) : BIASED_SENTINEL;
}

}  // namespace

extern "C" int kmer_keys_launch(const void* packed, const void* bad, int64_t n_windows, int k,
                                void* out, void* stream)
{
    const int block = 256;
    const int64_t grid = (n_windows + block - 1) / block;
    kmer_keys_kernel<<<(unsigned)grid, block, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)packed, (const uint8_t*)bad, n_windows, k, (long long*)out);
    return (int)cudaGetLastError();
}
