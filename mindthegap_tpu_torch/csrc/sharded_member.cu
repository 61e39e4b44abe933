// K12 and K13: sharded exact membership with a Bloom prefilter
// (mindthegap_tpu_torch/parallel/sharded_membership.py _route_plain,
// _probe_plain and _scatter_plain, which these kernels must equal bit for
// bit).
//
// Replaces: mindthegap_tpu/parallel/sharded_membership.py
// ShardedMembership._build_fn's shard_fn, an XLA program on the TPU: the
// Bloom probe and the owner routing into fixed-capacity send buffers (K12),
// and the owner's search (jnp.searchsorted) with the verdicts scattered
// back into lane order (K13). The all_to_all exchanges between them are copies of the
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
// K13, on the owner: each received query's lower bound in the shard's
//   sorted keys, then equality (member_probe); on the source, the verdicts
//   that came back in slot order written to their lanes (member_scatter).
//
// Bound on this card: bytes. K12 reads 8 bytes a lane and the bitset
// (replicated, 12 bits a key), writes 12 bytes a slot; K13 reads the
// shard once (8 bytes a key) and 8 + 1 bytes a slot, writes a byte a lane.
// Each Bloom probe and each step of the owner's lookup is a random 32-byte
// sector when the bitset or the shard is above the 50 MB L2.
//
// K12's design, one pass over the lanes:
//   - The padding is a fill: (SENTINEL, -1) is all-ones bytes in both
//     buffers, so two memsets write every slot before the pass, and the
//     pass writes only the positives.
//   - A block of 256 threads takes a tile of 2,048 lanes, its tile id from
//     an atomic counter in launch order; a thread takes 8 lanes, 256 apart,
//     so that the tile's 64 groups of 32 lanes (a warp's r-th lanes) run
//     in lane order.
//   - Probes in flight: a round issues one hash's Bloom load for each of a
//     thread's live lanes before it tests any, and drops a lane at its
//     first zero bit, so most absent queries stop after one or two rounds.
//     The loads are the pass's cost: they ran at 80-90 G a second on the
//     card whether a round issued one hash, four or all eight, and one a
//     round issues the fewest (18.8 M on the measured shard below, against
//     24.4 M and 33.6 M) and was the fastest (0.235 ms, against 0.295 and
//     0.374).
//   - Ranks by owner: a group counts its lanes per owner with
//     __match_any_sync (a lane's rank among its peers), a warp an owner
//     scans the 64 groups' counts into offsets in the tile, and a decoupled
//     look-back (Merrill and Garland's single-pass scan, as in K1 and K4;
//     each tile's state and count for an owner in one 64-bit word) gives
//     the owner's positives in the tiles before. So ranks ascend with the
//     lane, as the stable argsort's do; a tile whose prefix crosses cap
//     sets the overflow flag.
//   - Nothing but the outputs and 8 bytes of look-back state a tile and
//     owner goes to device memory; the queries are read once.
// Measured on an H100 80GB HBM3 at 700 W (kernel_bench.py, a shard of
// 2^22 lanes over 4 owners, 1.84 M positives): 0.235 ms, of which the
// memsets 0.021 and the pass 0.201.
// K13's probe looks up through the shard's bucket index (sorted_index.cuh,
// built once per owner when the shards are placed): its bucket's bounds,
// then the bucket's first keys, two dependent steps where a binary search
// over the shard took ~21. Most slots are the padding (SENTINEL), answered
// from the index's header with no load: found exactly on a shard whose
// keys end in SENTINEL. A thread takes 4 slots, 256 apart, and issues the
// loads of all of them before it resolves any.
// K13's scatter reads 4 bytes of lane a slot and writes one byte a real
// one. A block takes 1,024 consecutive slots: a thread loads a quad of
// them, its lanes in one 16-byte load and its four verdict bytes in one
// 4-byte load only where the quad holds a real lane; the block passes them
// through shared memory so that a warp's stores go to 32 consecutive
// slots' lanes (in a segment of an owner's real slots they ascend: a few
// sectors a store; stored straight from registers, a thread's quads would
// spread a warp's stores over 128 slots' lanes).
// Padding may stand anywhere (the plain version's contract). The lanes
// must be 16-byte aligned and the verdicts 4-byte aligned (the launcher
// refuses others; the last quad past m is read a slot at a time). The
// lanes are zeroed first by a memset on the same stream.

#include <cstdint>
#include <cuda_runtime.h>

#include "sorted_index.cuh"

namespace {

using u64 = unsigned long long;

constexpr u64 SENTINEL = ~0ull;
constexpr int THREADS = 256, WARPS = THREADS / 32, PER = 8, TILE = THREADS * PER;
constexpr int GROUPS = TILE / 32;  // a tile's groups of 32 lanes, in lane order: group r * WARPS + warp
constexpr int MAX_SHARDS = 64;
constexpr u64 STATE_AGGREGATE = 1, STATE_INCLUSIVE = 2;
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int PROBE_THREADS = 256, PROBE_PER = 4;
constexpr int SCATTER_THREADS = 256;

__constant__ u64 BLOOM_CONSTS[8] = {
    0x9E3779B97F4A7C15ull, 0xC2B2AE3D27D4EB4Full, 0xD6E8FEB86659FD93ull, 0xA0761D6478BD642Full,
    0xE7037ED1A0B428DBull, 0x8EBC6AF09C88C6E3ull, 0x589965CC75374CC3ull, 0x1D8E4E27C47D124Full,
};

// the bit of hash i of a query, from x = q ^ (q >> 33)
__device__ __forceinline__ u64 bloom_bit(u64 x, int i, int shift) {
    u64 h = x * BLOOM_CONSTS[i];
    h ^= h >> 29;
    return h >> shift;
}

// The lanes of `live` (a bit a lane) that are Bloom-positive: round i
// issues hash i of every live lane, then tests them.
__device__ __forceinline__ uint32_t bloom_live(const u64 (&q)[PER], uint32_t live, const uint32_t* __restrict__ bits,
                                               int log_bits, int n_hash) {
    const int shift = 64 - log_bits;
    u64 x[PER];
#pragma unroll
    for (int r = 0; r < PER; r++) x[r] = q[r] ^ (q[r] >> 33);
    for (int i = 0; i < n_hash && live; i++) {
        uint32_t w[PER];
#pragma unroll
        for (int r = 0; r < PER; r++) w[r] = live >> r & 1 ? __ldg(bits + (bloom_bit(x[r], i, shift) >> 5)) : ~0u;
#pragma unroll
        for (int r = 0; r < PER; r++)
            if (!(w[r] >> (bloom_bit(x[r], i, shift) & 31) & 1)) live &= ~(1u << r);
    }
    return live;
}

// the owner of a positive query: the last bound <= q, clipped to 0
__device__ __forceinline__ int owner_of(u64 q, const u64* s_bounds, int n) {
    int lo = 0, hi = n;  // the count of bounds <= q
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (s_bounds[mid] <= q) lo = mid + 1; else hi = mid;
    }
    return lo == 0 ? 0 : lo - 1;
}

__device__ __forceinline__ void publish(u64* state, u64 kind, unsigned count) {
    atomicExch(state, (kind << 32) | count);
}

// states: n_tiles * n words (tile t, owner o at t * n + o), then the tile
// counter; all 0 on entry. The send buffers hold all-ones bytes on entry.
__global__ void __launch_bounds__(THREADS) route_kernel(
    const long long* __restrict__ queries, int64_t lanes, const uint32_t* __restrict__ bits, int log_bits,
    int n_hash, const long long* __restrict__ bounds, int n, int64_t cap, long long* __restrict__ send_q,
    int* __restrict__ send_lane, int* __restrict__ overflow, u64* states, unsigned* tile_counter)
{
    __shared__ u64 s_bounds[MAX_SHARDS];
    // owner o, group g at o * GROUPS + g: the group's count, then its offset in the tile
    __shared__ __align__(16) int s_cnt[MAX_SHARDS * GROUPS];
    __shared__ unsigned s_agg[MAX_SHARDS];     // the owner's positives in the tile
    __shared__ int64_t s_before[MAX_SHARDS];   // the owner's positives in the tiles before
    __shared__ unsigned s_tile;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    if (tid == 0) s_tile = atomicAdd(tile_counter, 1u);
    for (int i = tid; i < n; i += THREADS) s_bounds[i] = (u64)bounds[i];
    for (int i = tid; i < n * GROUPS; i += THREADS) s_cnt[i] = 0;
    __syncthreads();
    const int64_t tile = s_tile, l0 = tile * TILE + tid;  // the thread's r-th lane: l0 + r * THREADS

    u64 q[PER];
    uint32_t live = 0;
#pragma unroll
    for (int r = 0; r < PER; r++) {
        const int64_t l = l0 + r * THREADS;
        q[r] = SENTINEL;
        if (l < lanes) {
            q[r] = (u64)queries[l];
            live |= 1u << r;
        }
    }
    live = bloom_live(q, live, bits, log_bits, n_hash);

    int own[PER];  // owner (n: none) in the low 8 bits, rank among the group's peers above
#pragma unroll
    for (int r = 0; r < PER; r++) {
        const int o = live >> r & 1 ? owner_of(q[r], s_bounds, n) : n;
        const unsigned peers = __match_any_sync(FULL, o);
        const int rank = __popc(peers & ((1u << lane) - 1));
        if (rank == 0 && o < n) s_cnt[o * GROUPS + r * WARPS + warp] = __popc(peers);
        own[r] = o | rank << 8;
    }
    __syncthreads();

    // a warp an owner: its groups' offsets in the tile (two groups a lane)
    // and its tile aggregate, published at once
    for (int o = warp; o < n; o += WARPS) {
        int2* c = reinterpret_cast<int2*>(s_cnt + o * GROUPS) + lane;
        const int2 v = *c;
        unsigned inc = v.x + v.y;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const unsigned y = __shfl_up_sync(FULL, inc, d);
            if (lane >= d) inc += y;
        }
        *c = make_int2(inc - v.x - v.y, inc - v.y);
        if (lane == 31) {
            s_agg[o] = inc;
            publish(&states[tile * n + o], tile == 0 ? STATE_INCLUSIVE : STATE_AGGREGATE, inc);
        }
    }
    __syncwarp();
    // then, by the same warps, each owner's positives before the tile
    for (int o = warp; o < n; o += WARPS) {
        const unsigned agg = s_agg[o];
        unsigned prefix = 0;
        if (tile > 0) {
            u64* st = states + o;  // tile t's word at st[t * n]
            for (int64_t t = tile - 1;; t -= 32) {
                const int64_t ti = t - lane;  // lane 0 holds the latest tile of the window
                u64 w = STATE_INCLUSIVE << 32;
                if (ti >= 0) {
                    do {
                        w = *(volatile u64*)&st[ti * n];
                    } while ((w >> 32) == 0);
                }
                const unsigned incl = __ballot_sync(FULL, (w >> 32) == STATE_INCLUSIVE);
                const int stop = incl ? __ffs(incl) - 1 : 31;
                unsigned x = lane <= stop ? (unsigned)w : 0;
#pragma unroll
                for (int d = 16; d >= 1; d >>= 1) x += __shfl_xor_sync(FULL, x, d);
                prefix += x;
                if (incl) break;
            }
            if (lane == 0) publish(&st[tile * n], STATE_INCLUSIVE, prefix + agg);
        }
        if (lane == 0) {
            s_before[o] = prefix;
            if (prefix <= cap && prefix + agg > cap) atomicExch(overflow, 1);  // the tile that crosses cap
        }
    }
    __syncthreads();

#pragma unroll
    for (int r = 0; r < PER; r++) {
        const int o = own[r] & 0xFF;
        if (o < n) {
            const int64_t rank = s_before[o] + s_cnt[o * GROUPS + r * WARPS + warp] + (own[r] >> 8);
            if (rank < cap) {
                send_q[o * cap + rank] = (long long)q[r];
                send_lane[o * cap + rank] = (int)(l0 + r * THREADS);
            }
        }
    }
}

// K13's probe: a thread takes PROBE_PER slots, PROBE_THREADS apart, and
// issues the loads of all of them before it resolves any
__global__ void __launch_bounds__(PROBE_THREADS) member_probe_kernel(
    const long long* __restrict__ recv, int64_t m, const long long* __restrict__ keys, int64_t n_keys,
    const int* __restrict__ start, const long long* __restrict__ head, uint8_t* __restrict__ found)
{
    const sidx::Index x = sidx::load_index(keys, n_keys, start, head);
    const int64_t i0 = (int64_t)blockIdx.x * PROBE_THREADS * PROBE_PER + threadIdx.x;
    u64 q[PROBE_PER];
    int2 r[PROBE_PER];
    u64 kv[PROBE_PER][sidx::LOOKUP_KEYS];
#pragma unroll
    for (int t = 0; t < PROBE_PER; t++) {
        const int64_t i = i0 + t * PROBE_THREADS;
        q[t] = i < m ? (u64)recv[i] : SENTINEL;  // padding (SENTINEL) needs no load
    }
#pragma unroll
    for (int t = 0; t < PROBE_PER; t++) r[t] = sidx::bucket_range(x, q[t]);
#pragma unroll
    for (int t = 0; t < PROBE_PER; t++) sidx::load_keys(x, r[t], kv[t]);
#pragma unroll
    for (int t = 0; t < PROBE_PER; t++) {
        const int64_t i = i0 + t * PROBE_THREADS;
        if (i < m) found[i] = sidx::resolve(x, r[t], kv[t], q[t]);
    }
}

// the lanes of slots 4q .. 4q + 3 (-1 past m): one 16-byte load where all
// four are in (send_lane is 16-byte aligned)
__device__ __forceinline__ int4 quad_lanes(const int* __restrict__ send_lane, int64_t q, int64_t m) {
    if (4 * q + 4 <= m) return __ldg(reinterpret_cast<const int4*>(send_lane) + q);
    int l[4];
#pragma unroll
    for (int j = 0; j < 4; j++) l[j] = 4 * q + j < m ? __ldg(send_lane + 4 * q + j) : -1;
    return make_int4(l[0], l[1], l[2], l[3]);
}

// the verdicts of slots 4q .. 4q + 3 (0 past m), a byte each (back is 4-byte aligned)
__device__ __forceinline__ uint32_t quad_verdicts(const uint8_t* __restrict__ back, int64_t q, int64_t m) {
    if (4 * q + 4 <= m) return __ldg(reinterpret_cast<const unsigned*>(back) + q);
    uint32_t v = 0;
#pragma unroll
    for (int j = 0; j < 4; j++) v |= 4 * q + j < m ? (uint32_t)__ldg(back + 4 * q + j) << (8 * j) : 0u;
    return v;
}

__global__ void __launch_bounds__(SCATTER_THREADS) member_scatter_kernel(
    const uint8_t* __restrict__ back, const int* __restrict__ send_lane, int64_t m, bool* __restrict__ out)
{
    __shared__ int4 s_lane[SCATTER_THREADS];
    __shared__ uint32_t s_verdict[SCATTER_THREADS];
    const int64_t q = (int64_t)blockIdx.x * SCATTER_THREADS + threadIdx.x;  // the thread's quad
    const int4 l = q < (m + 3) / 4 ? quad_lanes(send_lane, q, m) : make_int4(-1, -1, -1, -1);
    s_lane[threadIdx.x] = l;
    // all padding: every lane's sign bit set
    s_verdict[threadIdx.x] = (l.x & l.y & l.z & l.w) < 0 ? 0u : quad_verdicts(back, q, m);
    __syncthreads();
    const int* lanes = reinterpret_cast<const int*>(s_lane);
    const uint8_t* verdicts = reinterpret_cast<const uint8_t*>(s_verdict);
#pragma unroll
    for (int r = 0; r < 4; r++) {
        const int j = threadIdx.x + r * SCATTER_THREADS;  // the slot in the block's
        const int lane = lanes[j];
        if (lane >= 0) out[lane] = verdicts[j] != 0;
    }
}

}  // namespace

// K12's lanes a tile (the wrapper sizes the look-back scratch by it)
extern "C" int member_route_tile() { return TILE; }

// K12. queries: lanes int64; bits: 2^(log_bits - 5) uint32; bounds: n int64;
// send_q: n * cap int64, send_lane: n * cap int32; overflow: one int32, 0
// on entry; states: ceil(lanes / member_route_tile()) * n + 1 words of
// scratch
extern "C" int member_route_launch(const void* queries, int64_t lanes, const void* bits, int log_bits,
                                   int n_hash, const void* bounds, int n, int64_t cap, void* send_q,
                                   void* send_lane, void* overflow, void* states, void* stream)
{
    if (n < 1 || n > MAX_SHARDS || n_hash < 1 || n_hash > 8 || lanes < 1 || cap < 1)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    const int64_t n_tiles = (lanes + TILE - 1) / TILE;
    cudaError_t err = cudaMemsetAsync(send_q, 0xFF, n * cap * sizeof(long long), s);
    if (err == cudaSuccess) err = cudaMemsetAsync(send_lane, 0xFF, n * cap * sizeof(int), s);
    if (err == cudaSuccess) err = cudaMemsetAsync(states, 0, (n_tiles * n + 1) * sizeof(u64), s);
    if (err != cudaSuccess) return (int)err;
    u64* st = (u64*)states;
    route_kernel<<<(unsigned)n_tiles, THREADS, 0, s>>>(
        (const long long*)queries, lanes, (const uint32_t*)bits, log_bits, n_hash, (const long long*)bounds, n, cap,
        (long long*)send_q, (int*)send_lane, (int*)overflow, st, (unsigned*)(st + n_tiles * n));
    return (int)cudaGetLastError();
}

// K13 on the owner. recv: m int64 queries; keys: the shard's n_keys >= 1
// sorted int64 keys with their bucket index (start, head) from
// sorted_index_launch; found: m bytes
extern "C" int member_probe_launch(const void* recv, int64_t m, const void* keys, int64_t n_keys, const void* start,
                                   const void* head, void* found, void* stream)
{
    const int64_t per_block = (int64_t)PROBE_THREADS * PROBE_PER;
    member_probe_kernel<<<(unsigned)((m + per_block - 1) / per_block), PROBE_THREADS, 0, (cudaStream_t)stream>>>(
        (const long long*)recv, m, (const long long*)keys, n_keys, (const int*)start, (const long long*)head,
        (uint8_t*)found);
    return (int)cudaGetLastError();
}

// K13 on the source. back: m verdict bytes in slot order, 4-byte aligned;
// send_lane: the m slots' lanes (-1: padding), each in [0, lanes) or -1,
// 16-byte aligned; out: the lanes' bools, zeroed here first
extern "C" int member_scatter_launch(const void* back, const void* send_lane, int64_t m, void* out, int64_t lanes,
                                     void* stream)
{
    if ((uintptr_t)send_lane % 16 != 0 || (uintptr_t)back % 4 != 0) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t err = cudaMemsetAsync(out, 0, lanes, s);
    if (err != cudaSuccess) return (int)err;
    const int64_t per_block = 4 * SCATTER_THREADS;
    member_scatter_kernel<<<(unsigned)((m + per_block - 1) / per_block), SCATTER_THREADS, 0, s>>>(
        (const uint8_t*)back, (const int*)send_lane, m, (bool*)out);
    return (int)cudaGetLastError();
}
