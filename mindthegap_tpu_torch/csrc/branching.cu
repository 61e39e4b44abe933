// K17: the branching nodes of a solid set (mindthegap_tpu_torch/ops/
// branching_device.py _count_plain, which this kernel must equal; both are
// held to the host function, graph/dbg.py Graph.nb_branching).
//
// Replaces no TPU kernel: the JAX package counts the branching nodes on the
// host (mindthegap_tpu/graph/dbg.py Graph.nb_branching, numpy's
// searchsorted over the sorted keys).
//
// Each key x of a sorted set of k-mers (u64 words in int64, 1 <= k <= 32),
// taken as a forward k-mer, is a branching node when its in-degree or its
// out-degree is not 1: of its 4 out-neighbours ((x << 2) | b) & mask and
// its 4 in-neighbours (x >> 2) | (b << 2(k-1)), each in its canonical form
// min(fwd, revcomp), how many are in the set. The output is their number,
// one u64 word.
//
// Bound on this card: random 32-byte sectors. The keys are read once (8
// bytes a key); each of the 8 lookups a key reads its bucket's two starts
// and the bucket's first keys through the set's bucket index
// (sorted_index.cuh; bounds.py branching_bytes counts the sectors). On the
// E. coli-size set (4.7 M keys at k = 31) the keys take 37 MB and the
// starts (2^22 + 1 int32) 17 MB: together just above the H100's 50 MB L2,
// which serves most lookups, so the least bytes from device memory are the
// keys and the index once (bounds.py).
//
// The design: one launch of persistent blocks, taking the keys grid-stride
// in their sorted order, a key a thread and a warp's lanes on 32
// consecutive keys. A key's reverse complement is computed once:
// rc(out_b x) = rc(x) >> 2 | comp(b) << 2(k-1) and rc(in_b x) = (rc(x) << 2
// & mask) | comp(b). The index's steps are split as its header asks: the
// starts of all 8 lookups are issued before any key load, then the keys of
// all 8, then the 8 are resolved. What the design does about the L2: where
// a neighbour's forward form is its canonical one (about half of them),
// the lookups of a warp's 32 keys fall in a few narrow runs of the set
// (x >> 2 | b << 2(k-1) spans a quarter of the warp's key range, (x << 2)
// & mask four times it), so they share their sectors in L1, and those runs
// move through the set in order as the grid does, a window that stays in
// L2; only the reverse-strand half is random over the whole 54 MB. A
// smaller index that fits the L2 does not pay: with 2^21 or 2^20 buckets
// (keys + starts 45 or 41 MB) the longer buckets cost more loads than the
// L2 saves. The counts: a warp's ballot of its branching keys and a
// popcount, summed by lane 0 over the warp's keys; a block's warps summed
// in shared memory; one 64-bit atomic a block.
// Measured on an H100 80GB HBM3 at 700 W (kernel_bench.py, a random
// genome's 4.64 M canonical 31-mers): 0.318 ms by launch at 2^22 buckets,
// 0.390 at 2^21, 0.513 at 2^20 (84.0 M lookup sectors, 264 G a second);
// 126 registers, no spills. The host function took 13.5 s on that set.

#include <cstdint>
#include <cuda_runtime.h>

#include "plane_store.cuh"
#include "qmap.cuh"
#include "sorted_index.cuh"

namespace {

using sidx::u64;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xFFFFFFFFu;

__device__ __forceinline__ u64 umin(u64 a, u64 b) { return a < b ? a : b; }

__global__ void __launch_bounds__(THREADS) branching_kernel(
    const long long* __restrict__ keys, int64_t n, int k, const int* __restrict__ start,
    const long long* __restrict__ head, unsigned long long* __restrict__ out)
{
    __shared__ unsigned long long s_warp[WARPS];
    const sidx::Index S = sidx::load_index(keys, n, start, head);
    const u64 mask = k == 32 ? ~0ull : (1ull << (2 * k)) - 1;
    const int top = 2 * (k - 1);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int64_t stride = (int64_t)gridDim.x * THREADS;
    unsigned long long branching = 0;  // lane 0's: the warp's branching keys
    // the bound is the warp's, so that every lane reaches the ballot
    for (int64_t base = (int64_t)blockIdx.x * THREADS + warp * 32; base < n; base += stride) {
        const int64_t i = base + lane;
        bool counted = false;
        if (i < n) {
            const u64 x = (u64)__ldg(keys + i);
            const u64 rc = qmap::revcomp(x, k);
            u64 q[8];
#pragma unroll
            for (u64 b = 0; b < 4; b++) {
                q[b] = umin(((x << 2) | b) & mask, (rc >> 2) | ((b ^ 2) << top));
                q[4 + b] = umin((x >> 2) | (b << top), ((rc << 2) & mask) | (b ^ 2));
            }
            int2 r[8];
            u64 kv[8][sidx::LOOKUP_KEYS];
#pragma unroll
            for (int t = 0; t < 8; t++) r[t] = sidx::bucket_range(S, q[t]);
#pragma unroll
            for (int t = 0; t < 8; t++) sidx::load_keys(S, r[t], kv[t]);
            int nb_out = 0, nb_in = 0;
#pragma unroll
            for (int b = 0; b < 4; b++) {
                nb_out += sidx::resolve(S, r[b], kv[b], q[b]);
                nb_in += sidx::resolve(S, r[4 + b], kv[4 + b], q[4 + b]);
            }
            counted = nb_in != 1 || nb_out != 1;
        }
        const unsigned ballot = __ballot_sync(FULL, counted);
        if (lane == 0) branching += __popc(ballot);
    }
    if (lane == 0) s_warp[warp] = branching;
    __syncthreads();
    if (threadIdx.x == 0) {
        unsigned long long sum = 0;
#pragma unroll
        for (int w = 0; w < WARPS; w++) sum += s_warp[w];
        if (sum) atomicAdd(out, sum);
    }
}

}  // namespace

// keys: n sorted int64 words (n < 2^31; any valid address when n = 0) with
// their bucket index (start, head) from sorted_index_launch; out: one
// 64-bit word, 0 on entry, which the kernel adds the count to
extern "C" int branching_launch(const void* keys, int64_t n, int k, const void* start, const void* head, void* out,
                                void* stream)
{
    if (n < 0 || n >= (1ll << 31) || k < 1 || k > 32) return (int)cudaErrorInvalidValue;
    const int64_t tiles = (n + THREADS - 1) / THREADS;
    const int blocks = planes::resident_grid<branching_kernel>(tiles > 0 ? tiles : 1, THREADS);
    branching_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const long long*)keys, n, k, (const int*)start, (const long long*)head, (unsigned long long*)out);
    return (int)cudaGetLastError();
}
