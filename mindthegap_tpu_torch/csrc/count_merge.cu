// K4: merge + fold for device counting: the distinct accumulator (sorted
// biased keys with int64 counts, INT64_MAX-padded) merged with a raw sorted
// batch (duplicates allowed, each live key counting 1) into out_cap
// distinct keys with summed counts
// (mindthegap_tpu_torch/ops/counting_device.py _merge_sorted_plain, which
// this kernel must equal bit for bit, truncated case included).
//
// Replaces: mindthegap_tpu/ops/counting_device.py merge_sorted_device, an
// XLA program on the TPU (concatenate, a tuple sort, cumsum, and a second
// tuple sort that compacts the run starts). Both inputs are already
// sorted, so no sort is needed here.
//
// Keys are biased (u64 XOR 2^63 held in int64): signed compares are
// unsigned k-mer order and the padding (INT64_MAX) sorts last. A run start
// is a live key unlike the one before it in the merged stream; run j's
// count is the sum of the counts from its start up to the next start (the
// last run: to the end of the stream, padding included).
//
// Bound on this card: bytes. The inputs are read once (16 B per
// accumulator slot, 8 B per batch key) and the outputs written once (16 B
// per output slot); a flush of a 2^23 batch into a 2^23-slot accumulator
// moves ~335 MB, ~0.1 ms at 3.35 TB/s.
//
// The design: one pass over the merged stream in tiles of TILE elements,
// one block per tile, tiles taken in launch order from an atomic counter.
//   - A partition pass finds each tile boundary's split of the merge path
//     (accumulator first on ties), one warp per boundary by a 32-way search
//     (five rounds of 32 probes, not one binary search per element), and
//     zeroes the look-back flags.
//   - The block copies both input slices into shared memory (coalesced,
//     every load of a thread in flight before its first store), and each
//     thread merges ITEMS consecutive elements there, flagging the run
//     starts (the element before a thread's first one is the larger of the
//     two inputs' elements before its split); it merges them again, from
//     shared memory, to write, rather than hold them in registers.
//   - A segmented scan joins the threads: each carries (starts, count of
//     its open run), combined as (n1 + n2, n2 ? c2 : c1 + c2). Across tiles
//     the same pair goes by a decoupled look-back (Merrill and Garland's
//     single-pass scan): a tile publishes its aggregate at once and its
//     inclusive prefix after its look-back; warp 0 of the next tiles reads
//     32 predecessors at a time and stops at the first inclusive one.
//   - Each thread then writes its run starts' keys to keys_out, and at each
//     start closes the run before it (its total is the open count carried
//     to that point, from however many tiles back it began) into
//     counts_out; the last element closes the last run and writes
//     n_distinct. Slots at or past out_cap are not written, so a truncated
//     merge keeps the exact total of its last kept run and the exact
//     n_distinct.
//   - A last, small kernel pads keys_out/counts_out past n_distinct.
// Nothing but the two outputs, n_distinct and 28 bytes of split and
// look-back state per tile goes to device memory.
//
// Measured on an H100 80GB HBM3 at 700 W (kernel_bench.py): 0.34 ms for a
// 4.67 M-key accumulator in 2^23 slots plus a 2^23 batch (the earlier
// design, a merge path per element, two torch.cumsum scans and a
// compaction: 1.10 ms), ~30% of the byte
// bound. What did not help, in trials on the same card: staging each
// tile's output in shared memory for coalesced stores, cp.async copies
// into shared memory, 1,024-element tiles or 128-thread blocks (all
// slower); holding a thread's items in registers (96 registers, two
// blocks per SM: 0.48 ms).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

typedef long long i64;
typedef unsigned long long u64;

constexpr i64 BIASED_SENTINEL = 0x7FFFFFFFFFFFFFFFll;
constexpr int THREADS = 256, ITEMS = 8, TILE = THREADS * ITEMS;
constexpr int WARPS = THREADS / 32;
constexpr int FLAG_AGGREGATE = 1, FLAG_INCLUSIVE = 2;

struct Seg {
    i64 n;  // run starts
    u64 c;  // count of the run open at the end (all counts when n == 0)
};

__device__ __forceinline__ Seg seg(Seg a, Seg b) { return {a.n + b.n, b.n ? b.c : a.c + b.c}; }

__device__ __forceinline__ Seg shfl_seg(unsigned mask, Seg v, int src) {
    return {__shfl_sync(mask, v.n, src), __shfl_sync(mask, v.c, src)};
}

// number of accumulator elements among the first d of the stable merge,
// by one whole warp: each round probes 32 evenly spaced points of the
// remaining range and keeps the gap where the predicate turns false
__device__ i64 warp_split(const i64* __restrict__ a, i64 na, const i64* __restrict__ b, i64 nb, i64 d, int lane) {
    i64 lo = d > nb ? d - nb : 0, hi = d < na ? d : na;
    while (lo < hi) {
        const i64 step = (hi - lo + 31) / 32;
        const i64 m = lo + lane * step;
        const bool p = m < hi && a[m] <= b[d - 1 - m];
        const int cnt = __popc(__ballot_sync(0xFFFFFFFFu, p));
        if (cnt == 0) {
            hi = lo;
        } else {
            const i64 last = lo + (cnt - 1) * step;
            lo = last + 1;
            hi = hi < last + step ? hi : last + step;
        }
    }
    return lo;
}

// the merge path's split at every tile boundary, one warp each; also
// zeroes the tiles' look-back flags and the tile counter
__global__ void partition_kernel(const i64* __restrict__ a_keys, i64 na, const i64* __restrict__ b_keys, i64 nb,
                                 i64 n_tiles, i64* __restrict__ splits, int* __restrict__ flags)
{
    const i64 w = ((i64)blockIdx.x * blockDim.x + threadIdx.x) / 32;
    if (w > n_tiles) return;
    const i64 d = w * TILE < na + nb ? w * TILE : na + nb;
    const i64 s = warp_split(a_keys, na, b_keys, nb, d, threadIdx.x & 31);
    if ((threadIdx.x & 31) == 0) {
        splits[w] = s;
        flags[w] = 0;  // flags[n_tiles] is the tile counter
    }
}

// the stable merge of this thread's ITEMS elements of the tile, from its
// split (ai, bi) in shared memory; calls f(key, count) for each
template <class F>
__device__ __forceinline__ void merge_items(const i64* s_key, const i64* s_cnt, int n_a, int n_b, int ai, int bi,
                                            int count, F f)
{
#pragma unroll
    for (int i = 0; i < ITEMS; i++) {
        if (i < count) {
            if (ai < n_a && (bi >= n_b || s_key[ai] <= s_key[n_a + bi])) {
                f(s_key[ai], (u64)s_cnt[ai]);
                ai++;
            } else {
                const i64 key = s_key[n_a + bi];
                f(key, (u64)(key != BIASED_SENTINEL));
                bi++;
            }
        }
    }
}

// at most 51 registers a thread: five blocks per SM
__global__ void __launch_bounds__(THREADS, 5) merge_fold_kernel(
    const i64* __restrict__ a_keys, const i64* __restrict__ a_counts, i64 na,
    const i64* __restrict__ b_keys, i64 nb, const i64* __restrict__ splits,
    i64* __restrict__ keys_out, i64* __restrict__ counts_out, int32_t* __restrict__ n_distinct, i64 out_cap,
    i64* agg_n, u64* agg_c, i64* inc_n, u64* inc_c, int* flags, unsigned* tile_counter, i64 n_tiles)
{
    __shared__ i64 s_key[TILE];
    __shared__ i64 s_cnt[TILE];
    __shared__ i64 s_tile, s_pred;
    __shared__ bool s_has_pred;
    __shared__ Seg s_warp[WARPS], s_prefix;

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    if (tid == 0) s_tile = atomicAdd(tile_counter, 1u);
    __syncthreads();
    const i64 tile = s_tile;
    const i64 n = na + nb, lo = tile * TILE, hi = lo + TILE < n ? lo + TILE : n;
    const i64 a_lo = splits[tile], a_hi = splits[tile + 1], b_lo = lo - a_lo;
    const int n_a = (int)(a_hi - a_lo), tn = (int)(hi - lo);
    // copy both slices into shared memory: every load of a thread issued
    // before the first store (the accumulator slice, then the batch slice)
    {
        i64 kv[ITEMS], cv[ITEMS];
#pragma unroll
        for (int r = 0; r < ITEMS; r++) {
            const int i = r * THREADS + tid;
            kv[r] = cv[r] = 0;
            if (i < n_a) {
                kv[r] = a_keys[a_lo + i];
                cv[r] = a_counts[a_lo + i];
            } else if (i < tn) {
                kv[r] = b_keys[b_lo + i - n_a];
            }
        }
#pragma unroll
        for (int r = 0; r < ITEMS; r++) {
            const int i = r * THREADS + tid;
            if (i < tn) s_key[i] = kv[r];
            if (i < n_a) s_cnt[i] = cv[r];
        }
    }
    if (tid == 0) {  // the merged element before the tile: the larger of the two before the split
        s_has_pred = lo > 0;
        i64 p = a_lo > 0 ? a_keys[a_lo - 1] : 0;
        if (b_lo > 0 && (a_lo == 0 || b_keys[b_lo - 1] > p)) p = b_keys[b_lo - 1];
        s_pred = p;
    }
    __syncthreads();

    // this thread's ITEMS elements: split by binary search in shared memory
    const int n_b = tn - n_a;
    const int td = tid * ITEMS < tn ? tid * ITEMS : tn;
    const int count = tn - td < ITEMS ? tn - td : ITEMS;
    int l = td > n_b ? td - n_b : 0, h = td < n_a ? td : n_a;
    while (l < h) {
        const int mid = (l + h) >> 1;
        if (s_key[mid] <= s_key[n_a + td - 1 - mid]) l = mid + 1;
        else h = mid;
    }
    const int ai = l, bi = td - l;
    bool has_prev0;
    i64 prev0;
    if (td == 0) {
        has_prev0 = s_has_pred;
        prev0 = s_pred;
    } else {
        has_prev0 = true;
        prev0 = (ai > 0 && (bi == 0 || s_key[ai - 1] > s_key[n_a + bi - 1])) ? s_key[ai - 1] : s_key[n_a + bi - 1];
    }
    // first pass: this thread's (starts, open count)
    Seg mine = {0, 0};
    {
        bool has_prev = has_prev0;
        i64 prev = prev0;
        merge_items(s_key, s_cnt, n_a, n_b, ai, bi, count, [&](i64 key, u64 cnt) {
            const bool start = key != BIASED_SENTINEL && (!has_prev || key != prev);
            prev = key;
            has_prev = true;
            mine = seg(mine, Seg{start ? 1 : 0, cnt});
        });
    }

    // block-wide exclusive segmented scan of the threads' pairs
    Seg inc = mine;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const Seg other = shfl_seg(0xFFFFFFFFu, inc, lane >= o ? lane - o : lane);
        if (lane >= o) inc = seg(other, inc);
    }
    if (lane == 31) s_warp[warp] = inc;
    Seg ex = shfl_seg(0xFFFFFFFFu, inc, lane > 0 ? lane - 1 : 0);
    if (lane == 0) ex = Seg{0, 0};
    __syncthreads();
    Seg before = {0, 0}, agg = {0, 0};
#pragma unroll
    for (int w = 0; w < WARPS; w++) {
        if (w < warp) before = seg(before, s_warp[w]);
        agg = seg(agg, s_warp[w]);
    }
    ex = seg(before, ex);

    // decoupled look-back over the tiles before this one
    if (warp == 0) {
        Seg prefix = {0, 0};
        if (tile == 0) {
            if (lane == 0) {
                inc_n[0] = agg.n;
                inc_c[0] = agg.c;
                __threadfence();
                atomicExch(&flags[0], FLAG_INCLUSIVE);
            }
        } else {
            if (lane == 0) {
                agg_n[tile] = agg.n;
                agg_c[tile] = agg.c;
                __threadfence();
                atomicExch(&flags[tile], FLAG_AGGREGATE);
            }
            for (i64 t = tile - 1;; t -= 32) {
                const i64 ti = t - lane;  // lane 0 holds the latest tile of the window
                int f = FLAG_INCLUSIVE;
                Seg v = {0, 0};
                if (ti >= 0) {
                    do {
                        f = *(volatile int*)&flags[ti];
                    } while (f == 0);
                    __threadfence();
                    v = f == FLAG_INCLUSIVE ? Seg{__ldcg(&inc_n[ti]), __ldcg(&inc_c[ti])}
                                            : Seg{__ldcg(&agg_n[ti]), __ldcg(&agg_c[ti])};
                }
                const unsigned incl = __ballot_sync(0xFFFFFFFFu, f == FLAG_INCLUSIVE);
                const int stop = incl ? __ffs(incl) - 1 : 31;
                if (lane > stop) v = Seg{0, 0};
                // fold the window, earlier tiles (higher lanes) first
#pragma unroll
                for (int o = 1; o < 32; o <<= 1) {
                    const Seg other = shfl_seg(0xFFFFFFFFu, v, lane + o < 32 ? lane + o : lane);
                    if (lane + o < 32) v = seg(other, v);
                }
                prefix = seg(shfl_seg(0xFFFFFFFFu, v, 0), prefix);
                if (incl) break;
            }
            if (lane == 0) {
                const Seg total = seg(prefix, agg);
                inc_n[tile] = total.n;
                inc_c[tile] = total.c;
                __threadfence();
                atomicExch(&flags[tile], FLAG_INCLUSIVE);
            }
        }
        if (lane == 0) s_prefix = prefix;
    }
    __syncthreads();

    // second pass, the same merge: each start closes the run before it and
    // opens its own
    const Seg at = seg(s_prefix, ex);
    i64 nr = at.n;
    u64 open = at.c;
    {
        bool has_prev = has_prev0;
        i64 prev = prev0;
        merge_items(s_key, s_cnt, n_a, n_b, ai, bi, count, [&](i64 key, u64 cnt) {
            if (key != BIASED_SENTINEL && (!has_prev || key != prev)) {
                if (nr > 0 && nr - 1 < out_cap) counts_out[nr - 1] = (i64)open;
                if (nr < out_cap) keys_out[nr] = key;
                nr++;
                open = cnt;
            } else {
                open += cnt;
            }
            prev = key;
            has_prev = true;
        });
    }
    if (tile == n_tiles - 1 && td < tn && td + ITEMS >= tn) {  // this thread holds the stream's last element
        if (nr > 0 && nr - 1 < out_cap) counts_out[nr - 1] = (i64)open;
        *n_distinct = (int32_t)nr;
    }
}

__global__ void pad_kernel(i64* __restrict__ keys_out, i64* __restrict__ counts_out,
                           const int32_t* __restrict__ n_distinct, i64 out_cap)
{
    const i64 stride = (i64)gridDim.x * blockDim.x;
    for (i64 j = (i64)*n_distinct + (i64)blockIdx.x * blockDim.x + threadIdx.x; j < out_cap; j += stride) {
        keys_out[j] = BIASED_SENTINEL;
        counts_out[j] = 0;
    }
}

}  // namespace

extern "C" int merge_tile_size() { return TILE; }

// scratch: 5 * n_tiles + 1 int64 words (the look-back values and the
// tiles' splits), then n_tiles + 1 int32 words (the tiles' flags and the
// tile counter), zeroed by the partition pass
extern "C" int merge_fold_launch(const void* a_keys, const void* a_counts, int64_t na,
                                 const void* b_keys, int64_t nb,
                                 void* keys_out, void* counts_out, void* n_distinct, int64_t out_cap,
                                 void* scratch, void* stream)
{
    cudaStream_t st = (cudaStream_t)stream;
    const i64 n_tiles = (na + nb + TILE - 1) / TILE;
    i64* words = (i64*)scratch;
    i64* splits = words + 4 * n_tiles;
    int* flags = (int*)(splits + n_tiles + 1);
    partition_kernel<<<(unsigned)((n_tiles + 1 + 7) / 8), 256, 0, st>>>(
        (const i64*)a_keys, na, (const i64*)b_keys, nb, n_tiles, splits, flags);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    merge_fold_kernel<<<(unsigned)n_tiles, THREADS, 0, st>>>(
        (const i64*)a_keys, (const i64*)a_counts, na, (const i64*)b_keys, nb, splits,
        (i64*)keys_out, (i64*)counts_out, (int32_t*)n_distinct, out_cap,
        words, (u64*)(words + n_tiles), words + 2 * n_tiles, (u64*)(words + 3 * n_tiles),
        flags, (unsigned*)(flags + n_tiles), n_tiles);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const i64 pad_blocks = (out_cap + 255) / 256;
    pad_kernel<<<(unsigned)(pad_blocks < 1024 ? pad_blocks : 1024), 256, 0, st>>>(
        (i64*)keys_out, (i64*)counts_out, (const int32_t*)n_distinct, out_cap);
    return (int)cudaGetLastError();
}
