// The build of a sorted set's bucket index (layout in sorted_index.cuh;
// mindthegap_tpu_torch/ops/sorted_index.py _build_plain, which this kernel
// must equal bit for bit).
//
// Replaces nothing of the TPU's: the JAX package binary-searches the whole
// set for every lookup (mindthegap_tpu/find/scan_device.py _member and the
// owner's jnp.searchsorted in parallel/sharded_membership.py); this index
// is what lets K13's probe and K14 find a key in two dependent steps.
//
// Bound on this card: bytes, the keys read once (8 bytes a key) and the
// B + 1 starts written once (4 bytes each).
//
// One launch, no atomics and no sort. Each block's first thread finds the
// header: it loads the first and the last key together; where the last is
// SENTINEL, the block's first warp reads the last 32 keys, a lane each,
// which hold n_real and hi unless the tail is longer (a key shard's padding
// is shorter than its owner count), and a longer tail is searched by the
// whole block, 256 evenly spaced keys a round (three rounds for 2^24 keys),
// where one thread's bisection would take ~21 dependent loads while the
// block waits. Block 0 stores the header. Then the threads take the keys
// below SENTINEL grid-stride: key i writes start[j] = i for every j in
// (bucket(A[i-1]), bucket(A[i])], so a gap of empty buckets is one thread's
// (short where the keys spread evenly), and every j after hi's bucket,
// grid-stride, gets n_real: that tail is up to half the buckets when hi - lo
// is just above a power of two (a shard of 1.16 M keys took 1.1 ms with one
// thread writing it). Every entry is written once. (Tried on an H100 and not
// kept, PERF.md §6: warps over runs of keys with a gap of empty buckets
// finished by the warp, faster on sparse sets and slower on a dense key
// shard.)

#include <cstdint>
#include <cuda_runtime.h>

#include "sorted_index.cuh"

namespace {

using sidx::u64;

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 2048;
constexpr unsigned FULL = 0xFFFFFFFFu;

// the first SENTINEL of keys[0..b], keys[b] being SENTINEL: 256 evenly spaced
// keys of the range that holds it a round (every thread of the block calls)
__device__ int64_t first_sentinel(const long long* __restrict__ keys, int64_t b) {
    int64_t a = 0;  // the answer lies in [a, b]
    while (a < b) {
        const int64_t span = b - a;
        const bool below = (u64)keys[a + span * threadIdx.x / THREADS] < sidx::SENTINEL;
        const int c = __syncthreads_count(below);  // the tested keys below SENTINEL: threads 0 .. c - 1
        if (c == 0) {
            b = a;
        } else {
            const int64_t next = c < THREADS ? a + span * c / THREADS : b;
            a = a + span * (c - 1) / THREADS + 1;
            b = next;
        }
    }
    return a;
}

__global__ void __launch_bounds__(THREADS) build_kernel(const long long* __restrict__ keys, int64_t n, int log_b,
                                                         int* __restrict__ start, long long* __restrict__ head)
{
    __shared__ u64 s_lo, s_hi;
    __shared__ int s_shift;
    __shared__ int64_t s_real;
    // the header from n_real and its first and last key (thread 0)
    auto put_header = [&](u64 first, u64 last, int64_t real) {
        const u64 lo = real > 0 ? first : sidx::SENTINEL, hi = real > 0 ? last : 0;
        const int bits = real > 0 && hi != lo ? 64 - __clzll((long long)(hi - lo)) : 0;
        s_lo = lo;
        s_hi = hi;
        s_shift = bits > log_b ? bits - log_b : 0;
        s_real = real;
        if (blockIdx.x == 0) {
            head[0] = (long long)lo;
            head[1] = (long long)hi;
            head[2] = s_shift;
            head[3] = real;
        }
    };
    if (threadIdx.x == 0) {
        const u64 last = n > 0 ? (u64)keys[n - 1] : 0, first = n > 0 ? (u64)keys[0] : 0;  // both in flight
        if (n > 0 && last == sidx::SENTINEL) {
            s_real = -1;  // found below
        } else {
            put_header(first, last, n);
        }
    }
    __syncthreads();
    if (s_real < 0) {  // a SENTINEL tail: the last 32 keys, a lane of warp 0 each, hold n_real unless it is longer
        __shared__ int64_t s_found;
        if (threadIdx.x < 32) {
            const int lane = threadIdx.x;
            const int64_t i = n - 32 + lane;
            const u64 x = i >= 0 ? (u64)keys[i] : sidx::SENTINEL;
            const int below = __popc(__ballot_sync(FULL, i >= 0 && x < sidx::SENTINEL));
            if (lane == 0) s_found = below > 0 || n <= 32 ? (n < 32 ? 0 : n - 32) + below : -1;
        }
        __syncthreads();
        int64_t real = s_found;
        if (real < 0) real = first_sentinel(keys, n - 32);  // a longer tail: the block searches
        if (threadIdx.x == 0) put_header((u64)keys[0], real > 0 ? (u64)keys[real - 1] : 0, real);
        __syncthreads();
    }
    const u64 lo = s_lo, hi = s_hi;
    const int shift = s_shift;
    const int64_t real = s_real, n_buckets = 1ll << log_b;
    const int64_t stride = (int64_t)gridDim.x * THREADS;
    if (real == 0) {
        for (int64_t j = (int64_t)blockIdx.x * THREADS + threadIdx.x; j <= n_buckets; j += stride) start[j] = 0;
        return;
    }
    for (int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x; i < real; i += stride) {
        const int b = sidx::bucket_of((u64)keys[i], lo, hi, shift);
        const int before = i == 0 ? -1 : sidx::bucket_of((u64)keys[i - 1], lo, hi, shift);
        for (int j = before + 1; j <= b; j++) start[j] = (int)i;
    }
    // the buckets after hi's, up to half of them, grid-stride
    for (int64_t j = sidx::bucket_of(hi, lo, hi, shift) + 1 + (int64_t)blockIdx.x * THREADS + threadIdx.x;
         j <= n_buckets; j += stride)
        start[j] = (int)real;
}

}  // namespace

// keys: n sorted int64 words (n < 2^31; any valid address when n = 0);
// start: 2^log_b + 1 int32 (1 <= log_b <= 30); head: 4 int64
extern "C" int sorted_index_launch(const void* keys, int64_t n, int log_b, void* start, void* head, void* stream)
{
    if (n < 0 || n >= (1ll << 31) || log_b < 1 || log_b > 30) return (int)cudaErrorInvalidValue;
    const int64_t work = n > (1ll << log_b) ? n : (1ll << log_b) + 1;
    int64_t blocks = (work + THREADS - 1) / THREADS;
    if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
    build_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const long long*)keys, n, log_b, (int*)start, (long long*)head);
    return (int)cudaGetLastError();
}
