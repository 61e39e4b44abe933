// K12 and K13: sharded exact membership with a Bloom prefilter
// (mindthegap_tpu_torch/parallel/sharded_membership.py _route_plain,
// _probe_plain and _scatter_plain, which these kernels must equal bit for
// bit).
//
// Replaces: mindthegap_tpu/parallel/sharded_membership.py
// ShardedMembership._build_fn's shard_fn, an XLA program on the TPU: the
// Bloom probe and the owner routing into fixed-capacity send buffers (K12),
// and the owner's binary search with the verdicts scattered back into lane
// order (K13). The all_to_all exchanges between them are copies of the
// send buffers between the shards (the wrapper's caller).
//
// Keys are u64 words held in int64; every compare here is unsigned, and the
// SENTINEL (all ones) that pads the key shards sorts last.
//
// K12, on each shard's L query lanes, with n shards (n <= 64) and a
// capacity of cap queries per owner:
//   a query is Bloom-positive when all its n_hash bits are set (hash i:
//   h = (q ^ q >> 33) * C_i, h ^= h >> 29, bit h >> (64 - log_bits));
//   its owner is the last shard whose first key (bounds) is <= q, clipped
//   to [0, n); a negative has none. Out: per owner o, cap slots of
//   (query, lane), the owner's positives in ascending lane order, padded
//   with (SENTINEL, -1); overflow = 1 when an owner has more than cap.
//   Three launches: route_count (the owner of each lane and per-owner
//   counts of each 256-lane tile), route_scan (one block per owner: the
//   exclusive scan of its tile counts, its total against cap, its padding),
//   route_place (each positive's rank: its tile's offset, the counts of the
//   warps before it, its rank among its warp's peers by __match_any_sync).
// K13, on the owner: each received query's lower bound in the shard's
//   sorted keys, then equality (member_probe); on the source, the verdicts
//   that came back in slot order written to their lanes (member_scatter).
//
// Bound on this card: bytes. K12 reads 8 bytes a lane and the bitset
// (replicated, 12 bits a key), writes 12 bytes a slot; K13 reads the
// shard once (8 bytes a key) and 8 + 1 bytes a slot, writes a byte a lane.
// Each Bloom probe and each binary-search step is a random 32-byte sector
// when the bitset or the shard is above the 50 MB L2.
//
// The design is the simple one: a thread a lane or a slot; the owner's
// bounds and the tile's per-warp counts in shared memory; the search is
// a plain lower bound with its loads in order.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

using u64 = unsigned long long;

constexpr u64 SENTINEL = ~0ull;
constexpr int TILE = 256;  // route_count and route_place: a thread a lane
constexpr int WARPS = TILE / 32;
constexpr int MAX_SHARDS = 64;
constexpr int SCAN_THREADS = 1024;

__constant__ u64 BLOOM_CONSTS[8] = {
    0x9E3779B97F4A7C15ull, 0xC2B2AE3D27D4EB4Full, 0xD6E8FEB86659FD93ull, 0xA0761D6478BD642Full,
    0xE7037ED1A0B428DBull, 0x8EBC6AF09C88C6E3ull, 0x589965CC75374CC3ull, 0x1D8E4E27C47D124Full,
};

__device__ __forceinline__ bool bloom_positive(u64 q, const uint32_t* __restrict__ bits, int log_bits,
                                               int n_hash) {
    bool pos = true;
    for (int i = 0; i < n_hash; i++) {
        u64 h = (q ^ (q >> 33)) * BLOOM_CONSTS[i];
        h ^= h >> 29;
        const u64 p = h >> (64 - log_bits);
        pos &= (__ldg(bits + (p >> 5)) >> (p & 31)) & 1u;
    }
    return pos;
}

// the lane's owner, or n for a Bloom negative
__device__ __forceinline__ int owner_of(u64 q, const u64* s_bounds, int n, const uint32_t* bits, int log_bits,
                                        int n_hash) {
    if (!bloom_positive(q, bits, log_bits, n_hash)) return n;
    int lo = 0, hi = n;  // the count of bounds <= q
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (s_bounds[mid] <= q) lo = mid + 1; else hi = mid;
    }
    return lo == 0 ? 0 : lo - 1;
}

__global__ void __launch_bounds__(TILE) route_count_kernel(
    const long long* __restrict__ queries, int64_t lanes, const uint32_t* __restrict__ bits, int log_bits,
    int n_hash, const long long* __restrict__ bounds, int n, int* __restrict__ owners,
    int* __restrict__ tile_counts)
{
    __shared__ u64 s_bounds[MAX_SHARDS];
    __shared__ int s_cnt[MAX_SHARDS + 1];
    for (int i = threadIdx.x; i < n; i += TILE) s_bounds[i] = (u64)bounds[i];
    for (int i = threadIdx.x; i <= n; i += TILE) s_cnt[i] = 0;
    __syncthreads();
    const int64_t lane = (int64_t)blockIdx.x * TILE + threadIdx.x;
    if (lane < lanes) {
        const int o = owner_of((u64)queries[lane], s_bounds, n, bits, log_bits, n_hash);
        owners[lane] = o;
        atomicAdd(&s_cnt[o], 1);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += TILE) tile_counts[(int64_t)blockIdx.x * n + i] = s_cnt[i];
}

// one block per owner: exclusive scan of its tile counts (in place), its
// total against cap, and the padding of its slots past the total
__global__ void __launch_bounds__(SCAN_THREADS) route_scan_kernel(
    int* __restrict__ tile_counts, int64_t n_tiles, int n, int64_t cap, long long* __restrict__ send_q,
    int* __restrict__ send_lane, int* __restrict__ overflow)
{
    __shared__ int s_warp[SCAN_THREADS / 32];
    __shared__ int64_t s_carry;
    const int o = blockIdx.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (threadIdx.x == 0) s_carry = 0;
    __syncthreads();
    for (int64_t t0 = 0; t0 < n_tiles; t0 += SCAN_THREADS) {
        const int64_t t = t0 + threadIdx.x;
        const int v = t < n_tiles ? tile_counts[t * n + o] : 0;
        int x = v;  // inclusive warp scan
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const int y = __shfl_up_sync(0xFFFFFFFFu, x, d);
            if (lane >= d) x += y;
        }
        if (lane == 31) s_warp[warp] = x;
        __syncthreads();
        if (warp == 0) {
            int w = s_warp[lane];
#pragma unroll
            for (int d = 1; d < 32; d <<= 1) {
                const int y = __shfl_up_sync(0xFFFFFFFFu, w, d);
                if (lane >= d) w += y;
            }
            s_warp[lane] = w;  // inclusive over warps
        }
        __syncthreads();
        const int64_t carry = s_carry;
        const int before = (warp ? s_warp[warp - 1] : 0) + x - v;
        if (t < n_tiles) tile_counts[t * n + o] = (int)(carry + before);
        __syncthreads();
        if (threadIdx.x == 0) s_carry = carry + s_warp[SCAN_THREADS / 32 - 1];
        __syncthreads();
    }
    const int64_t total = s_carry;
    if (threadIdx.x == 0 && total > cap) atomicExch(overflow, 1);
    for (int64_t r = (total < cap ? total : cap) + threadIdx.x; r < cap; r += SCAN_THREADS) {
        send_q[o * cap + r] = (long long)SENTINEL;
        send_lane[o * cap + r] = -1;
    }
}

__global__ void __launch_bounds__(TILE) route_place_kernel(
    const long long* __restrict__ queries, int64_t lanes, const int* __restrict__ owners,
    const int* __restrict__ tile_offsets, int n, int64_t cap, long long* __restrict__ send_q,
    int* __restrict__ send_lane)
{
    __shared__ int s_wcnt[WARPS][MAX_SHARDS + 1];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int i = threadIdx.x; i < WARPS * (MAX_SHARDS + 1); i += TILE) (&s_wcnt[0][0])[i] = 0;
    __syncthreads();
    const int64_t q_lane = (int64_t)blockIdx.x * TILE + threadIdx.x;
    const int o = q_lane < lanes ? owners[q_lane] : n;
    const unsigned peers = __match_any_sync(0xFFFFFFFFu, o);
    const int rank_in_warp = __popc(peers & ((1u << lane) - 1));
    if (rank_in_warp == 0) s_wcnt[warp][o] = __popc(peers);
    __syncthreads();
    if (o >= n) return;
    int rank = tile_offsets[(int64_t)blockIdx.x * n + o] + rank_in_warp;
    for (int w = 0; w < warp; w++) rank += s_wcnt[w][o];
    if (rank < cap) {
        send_q[o * cap + rank] = queries[q_lane];
        send_lane[o * cap + rank] = (int)q_lane;
    }
}

__global__ void member_probe_kernel(const long long* __restrict__ recv, int64_t m,
                                    const long long* __restrict__ keys, int64_t n_keys,
                                    uint8_t* __restrict__ found)
{
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= m) return;
    const u64 q = (u64)recv[i];
    int64_t lo = 0, hi = n_keys;  // lower bound: the first key >= q
    while (lo < hi) {
        const int64_t mid = (lo + hi) >> 1;
        if ((u64)__ldg(keys + mid) < q) lo = mid + 1; else hi = mid;
    }
    const int64_t idx = lo < n_keys - 1 ? lo : n_keys - 1;
    found[i] = (u64)__ldg(keys + idx) == q;
}

__global__ void member_scatter_kernel(const uint8_t* __restrict__ back, const int* __restrict__ send_lane,
                                      int64_t m, bool* __restrict__ out)
{
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= m) return;
    const int lane = send_lane[i];
    if (lane >= 0) out[lane] = back[i] != 0;
}

}  // namespace

// K12. queries: lanes int64; bits: 2^(log_bits - 5) uint32; bounds: n int64;
// owners: lanes int32 and tile_counts: ceil(lanes / 256) * n int32 (scratch);
// send_q: n * cap int64, send_lane: n * cap int32; overflow: one int32, 0
// on entry
extern "C" int member_route_launch(const void* queries, int64_t lanes, const void* bits, int log_bits,
                                   int n_hash, const void* bounds, int n, int64_t cap, void* owners,
                                   void* tile_counts, void* send_q, void* send_lane, void* overflow,
                                   void* stream)
{
    if (n < 1 || n > MAX_SHARDS || n_hash < 1 || n_hash > 8) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    const int64_t n_tiles = (lanes + TILE - 1) / TILE;
    route_count_kernel<<<(unsigned)n_tiles, TILE, 0, s>>>(
        (const long long*)queries, lanes, (const uint32_t*)bits, log_bits, n_hash, (const long long*)bounds,
        n, (int*)owners, (int*)tile_counts);
    route_scan_kernel<<<n, SCAN_THREADS, 0, s>>>((int*)tile_counts, n_tiles, n, cap, (long long*)send_q,
                                                  (int*)send_lane, (int*)overflow);
    route_place_kernel<<<(unsigned)n_tiles, TILE, 0, s>>>(
        (const long long*)queries, lanes, (const int*)owners, (const int*)tile_counts, n, cap,
        (long long*)send_q, (int*)send_lane);
    return (int)cudaGetLastError();
}

// K13 on the owner. recv: m int64 queries; keys: the shard's n_keys >= 1
// sorted int64 keys; found: m bytes
extern "C" int member_probe_launch(const void* recv, int64_t m, const void* keys, int64_t n_keys, void* found,
                                   void* stream)
{
    const int threads = 256;
    member_probe_kernel<<<(unsigned)((m + threads - 1) / threads), threads, 0, (cudaStream_t)stream>>>(
        (const long long*)recv, m, (const long long*)keys, n_keys, (uint8_t*)found);
    return (int)cudaGetLastError();
}

// K13 on the source. back: m verdict bytes in slot order; send_lane: the m
// slots' lanes (-1: padding); out: the lanes' bools, false on entry
extern "C" int member_scatter_launch(const void* back, const void* send_lane, int64_t m, void* out, void* stream)
{
    const int threads = 256;
    member_scatter_kernel<<<(unsigned)((m + threads - 1) / threads), threads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)back, (const int*)send_lane, m, (bool*)out);
    return (int)cudaGetLastError();
}
