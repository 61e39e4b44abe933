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
// Membership is what a lower bound in unsigned order, then equality, gives.
//
// Bound on this card: bytes, each input read once (the window, the two
// sets) and 20 bytes of planes written per position. The lookups read
// more: 1 + 8 (where contained) + 2 a position, each a random sector of a
// set's bucket index and one or two of its keys.
//
// The design: each set comes with its bucket index (sorted_index.cuh,
// built by sorted_index.cu once for a fixed set, or in the same stream
// just before), so a lookup is two dependent steps, its bucket's bounds
// and then the bucket's first sidx::LOOKUP_KEYS = 4 keys, where a binary
// search over the whole set took ~23. A
// block of 256 threads stages its 256 + k - 1 codes in shared memory; a
// thread takes one position, rolls its k-mer from shared memory and forms
// all eleven canonical words from one reverse complement. Round one
// issues the index loads of the k-mer and its two (k-1)-mers before any
// key load, then the keys of all three; the `contains` verdict gates
// round two, the eight neighbours, issued the same way.
// Measured on an H100 80GB HBM3 at 700 W (kernel_bench.py, a 2^22-base
// window over 4.67 M keys, 4.19 M positions contained): 0.74 ms with the
// indexes passed in, 0.79 with their builds (the first version, binary
// searches: 4.80); with the builds, 0.80 ms at about 1 key a bucket, 0.96
// at 2, 1.27 at 4. Loading 2 keys at once instead of 4 took 0.95 ms at 1
// key a bucket; issuing the neighbours' lookups with the k-mer's, before
// `contains` resolved, 0.79 (1.5% less, where nearly every position is
// contained, at the cost of eight needless lookups for every position that
// is not; the gate stays).

#include <cstdint>
#include <cuda_runtime.h>

#include "sorted_index.cuh"

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

__device__ __forceinline__ u64 umin(u64 a, u64 b) { return a < b ? a : b; }

__global__ void __launch_bounds__(THREADS) scan_sorted_kernel(
    const uint8_t* __restrict__ codes, int64_t w, int k, const long long* __restrict__ solid, int64_t n_solid,
    const int* __restrict__ solid_start, const long long* __restrict__ solid_head,
    const long long* __restrict__ repeat, int64_t n_repeat, const int* __restrict__ repeat_start,
    const long long* __restrict__ repeat_head, long long* __restrict__ fwd_out,
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
    const sidx::Index S = sidx::load_index(solid, n_solid, solid_start, solid_head);
    const sidx::Index R = sidx::load_index(repeat, n_repeat, repeat_start, repeat_head);
    const u64 mask = k == 32 ? ~0ull : (1ull << (2 * k)) - 1;
    const u64 km1 = (1ull << (2 * (k - 1))) - 1;
    const int top = 2 * (k - 1);
    // rc(succ x) = rc >> 2 | comp(x) << top; rc(pred x) = (rc << 2 & mask) | comp(x);
    // the suffix's reverse complement is rc >> 2, the prefix's rc & km1
    const u64 rc = revcomp(fwd, k);
    const u64 q[3] = {umin(fwd, rc), umin(fwd & km1, rc >> 2), umin((fwd >> 2) & km1, rc & km1)};

    int2 r[3];
    r[0] = sidx::bucket_range(S, q[0]);
    r[1] = sidx::bucket_range(R, q[1]);
    r[2] = sidx::bucket_range(R, q[2]);
    u64 kv[3][sidx::LOOKUP_KEYS];
    sidx::load_keys(S, r[0], kv[0]);
    sidx::load_keys(R, r[1], kv[1]);
    sidx::load_keys(R, r[2], kv[2]);
    const bool contains = sidx::resolve(S, r[0], kv[0], q[0]);
    int nb_in = 0, nb_out = 0;
    if (contains) {
        u64 nq[8], nkv[8][sidx::LOOKUP_KEYS];
        int2 nr[8];
#pragma unroll
        for (u64 x = 0; x < 4; x++) {
            nq[x] = umin(((fwd << 2) | x) & mask, (rc >> 2) | ((x ^ 2) << top));
            nq[4 + x] = umin((fwd >> 2) | (x << top), ((rc << 2) & mask) | (x ^ 2));
        }
#pragma unroll
        for (int x = 0; x < 8; x++) nr[x] = sidx::bucket_range(S, nq[x]);
#pragma unroll
        for (int x = 0; x < 8; x++) sidx::load_keys(S, nr[x], nkv[x]);
#pragma unroll
        for (int x = 0; x < 4; x++) {
            nb_out += sidx::resolve(S, nr[x], nkv[x], nq[x]);
            nb_in += sidx::resolve(S, nr[4 + x], nkv[4 + x], nq[4 + x]);
        }
    }
    fwd_out[p] = (long long)fwd;
    valid_out[p] = valid;
    contains_out[p] = contains;
    nb_in_out[p] = nb_in;
    nb_out_out[p] = nb_out;
    suffix_out[p] = sidx::resolve(R, r[1], kv[1], q[1]);
    prefix_out[p] = sidx::resolve(R, r[2], kv[2], q[2]);
}

}  // namespace

// codes: w bytes; solid: n_solid and repeat: n_repeat sorted int64 words
// (either may be empty), each with its bucket index (start, head) from
// sorted_index_launch; the seven planes: w - k + 1 each (fwd int64, the
// counts int32, the rest bool)
extern "C" int scan_sorted_launch(const void* codes, int64_t w, int k, const void* solid, int64_t n_solid,
                                  const void* solid_start, const void* solid_head, const void* repeat,
                                  int64_t n_repeat, const void* repeat_start, const void* repeat_head, void* fwd,
                                  void* valid, void* contains, void* nb_in, void* nb_out, void* suffix_rep,
                                  void* prefix_rep, void* stream)
{
    const int64_t p = w - k + 1;
    scan_sorted_kernel<<<(unsigned)((p + THREADS - 1) / THREADS), THREADS, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)codes, w, k, (const long long*)solid, n_solid, (const int*)solid_start,
        (const long long*)solid_head, (const long long*)repeat, n_repeat, (const int*)repeat_start,
        (const long long*)repeat_head, (long long*)fwd, (bool*)valid, (bool*)contains, (int*)nb_in, (int*)nb_out,
        (bool*)suffix_rep, (bool*)prefix_rep);
    return (int)cudaGetLastError();
}
