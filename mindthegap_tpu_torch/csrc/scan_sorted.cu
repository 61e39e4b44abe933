// K14: the plane pass of one window over sorted k-mer sets
// (mindthegap_tpu_torch/find/scan_device.py _scan_planes_sorted_plain, which
// this kernel must equal bit for bit).
//
// Replaces: mindthegap_tpu/find/scan_device.py scan_planes_device with
// _member, an XLA program on the TPU (the find scan of the graft entry point and
// of parallel/mesh.py sharded_scan).
//
// For each position i of a window of w base codes (P = w - k + 1 positions,
// 255 = invalid, read as A; 2 <= k <= 32), with the solid set and the
// (k-1)-mer repeat set as sorted u64 words in int64:
//   fwd = the forward k-mer, valid = no invalid base in it,
//   contains = canonical(fwd) is in the solid set,
//   nb_out = how many of the 4 successors ((fwd << 2) | x, masked) and
//   nb_in = how many of the 4 predecessors ((fwd >> 2) | x << 2(k-1)) have
//   their canonical form in the solid set, both 0 where contains is false,
//   suffix_rep / prefix_rep = the canonical (k-1)-mer suffix / prefix is in
//   the repeat set.
// Membership is a lower bound in unsigned order, then equality.
//
// Bound on this card: bytes, each input read once (the window, the two
// sets) and 20 bytes of planes written per position. The searches read far
// more: about log2(N) dependent sectors each, 1 + 8 (where contained) + 2
// searches per position, the first levels shared through L2.
//
// The design is the simple one: a block of 256 threads stages its 256 + k
// - 1 codes in shared memory; a thread takes one position, rolls its k-mer
// from shared memory and runs its searches one after another.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

using u64 = unsigned long long;

constexpr int THREADS = 256;

__device__ __forceinline__ u64 revcomp(u64 x, int k) {
    x ^= 0xAAAAAAAAAAAAAAAAull;
    x = ((x >> 2) & 0x3333333333333333ull) | ((x & 0x3333333333333333ull) << 2);
    x = ((x >> 4) & 0x0F0F0F0F0F0F0F0Full) | ((x & 0x0F0F0F0F0F0F0F0Full) << 4);
    x = ((x >> 8) & 0x00FF00FF00FF00FFull) | ((x & 0x00FF00FF00FF00FFull) << 8);
    x = ((x >> 16) & 0x0000FFFF0000FFFFull) | ((x & 0x0000FFFF0000FFFFull) << 16);
    x = (x >> 32) | (x << 32);
    return x >> (64 - 2 * k);
}

__device__ __forceinline__ u64 canonical(u64 x, int k) {
    const u64 rc = revcomp(x, k);
    return x < rc ? x : rc;
}

__device__ __forceinline__ bool member(const long long* __restrict__ a, int64_t n, u64 key) {
    if (n == 0) return false;
    int64_t lo = 0, hi = n;
    while (lo < hi) {
        const int64_t mid = (lo + hi) >> 1;
        if ((u64)__ldg(a + mid) < key) lo = mid + 1; else hi = mid;
    }
    return (u64)__ldg(a + (lo < n - 1 ? lo : n - 1)) == key;
}

__global__ void __launch_bounds__(THREADS) scan_sorted_kernel(
    const uint8_t* __restrict__ codes, int64_t w, int k, const long long* __restrict__ solid, int64_t n_solid,
    const long long* __restrict__ repeat, int64_t n_repeat, long long* __restrict__ fwd_out,
    bool* __restrict__ valid_out, bool* __restrict__ contains_out, int* __restrict__ nb_in_out,
    int* __restrict__ nb_out_out, bool* __restrict__ suffix_out, bool* __restrict__ prefix_out)
{
    __shared__ uint8_t s_codes[THREADS + 32];
    const int64_t p0 = (int64_t)blockIdx.x * THREADS;
    for (int i = threadIdx.x; i < THREADS + k - 1; i += THREADS)
        s_codes[i] = p0 + i < w ? codes[p0 + i] : 255;
    __syncthreads();
    const int64_t p = p0 + threadIdx.x;
    if (p >= w - k + 1) return;

    u64 fwd = 0;
    bool valid = true;
    for (int j = 0; j < k; j++) {
        const uint8_t c = s_codes[threadIdx.x + j];
        valid &= c != 255;
        fwd = (fwd << 2) | (c == 255 ? 0 : c);
    }
    const u64 mask = k == 32 ? ~0ull : (1ull << (2 * k)) - 1;
    const bool contains = member(solid, n_solid, canonical(fwd, k));
    int nb_in = 0, nb_out = 0;
    if (contains) {
        for (u64 x = 0; x < 4; x++) {
            nb_out += member(solid, n_solid, canonical(((fwd << 2) | x) & mask, k));
            nb_in += member(solid, n_solid, canonical((fwd >> 2) | (x << (2 * (k - 1))), k));
        }
    }
    const u64 km1 = (1ull << (2 * (k - 1))) - 1;
    fwd_out[p] = (long long)fwd;
    valid_out[p] = valid;
    contains_out[p] = contains;
    nb_in_out[p] = nb_in;
    nb_out_out[p] = nb_out;
    suffix_out[p] = member(repeat, n_repeat, canonical(fwd & km1, k - 1));
    prefix_out[p] = member(repeat, n_repeat, canonical((fwd >> 2) & km1, k - 1));
}

}  // namespace

// codes: w bytes; solid: n_solid and repeat: n_repeat sorted int64 words
// (either may be empty); the seven planes: w - k + 1 each (fwd int64, the
// counts int32, the rest bool)
extern "C" int scan_sorted_launch(const void* codes, int64_t w, int k, const void* solid, int64_t n_solid,
                                  const void* repeat, int64_t n_repeat, void* fwd, void* valid, void* contains,
                                  void* nb_in, void* nb_out, void* suffix_rep, void* prefix_rep, void* stream)
{
    const int64_t p = w - k + 1;
    scan_sorted_kernel<<<(unsigned)((p + THREADS - 1) / THREADS), THREADS, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)codes, w, k, (const long long*)solid, n_solid, (const long long*)repeat, n_repeat,
        (long long*)fwd, (bool*)valid, (bool*)contains, (int*)nb_in, (int*)nb_out, (bool*)suffix_rep,
        (bool*)prefix_rep);
    return (int)cudaGetLastError();
}
