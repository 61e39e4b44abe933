// K7: the fill's batched simple-path walker for 32 < k <= 256, over the
// multi-word fused quotient map (mindthegap_tpu_torch/fill/walk_device.py
// _walk_batch_span_plain, which this kernel must equal bit for bit).
//
// Replaces: mindthegap_tpu/fill/walk_device.py walk_batch_device_span, with
// _mask_top_span and _shl2_span, an XLA program on the TPU (a lax.scan of
// `steps` steps over J job lanes, each step one span-map lookup per lane).
//
// Per lane and step, as K5 for k <= 32: the node's successor set `ext` and
// its successor's predecessor set `pre` are carried from the last lookup;
//   - stop "tip" when the node has no successor;
//   - stop "event" when the node forks, its unique successor has != 1
//     predecessors (merge), or the successor itself has != 1 successors
//     (branch2);
//   - stop when the lane's budget or the step count is spent (status stays
//     RUNNING);
//   - otherwise shift the successor's base into the node's Wk words, mask
//     the top word, append the base, and carry the (ext, pre) of the new
//     node from this step's lookup: that of its (k-1)-suffix, canonical,
//     oriented as read.
//
// Bound on this card: latency. Each step's probe depends on the last, in
// tables far above the 50 MB L2 (256 MB of slots and satellite words at k
// = 45 for a bacterial genome), so a lane that probes one node at a time
// pays at least one DRAM round trip a step whatever the bandwidth.
//
// The design is K5's team look-ahead (walk.cu) over multi-word nodes, with
// the eager probe of span_map.cuh. A team of T threads serves one lane and
// probes, in one round trip, every node the next D steps can reach: the
// successor n1 (its base fixed by the carried ext), its 4 children and
// their 16 grandchildren, P = 1, 5 or 21 candidates for D = 1, 2 or 3, T
// the smallest power of two that holds them (1, 8, 32). Candidate c at
// level L with offset o (the L bases after n1) sits at index (4^L - 1) / 3
// + o. Thread c holds the lane's Wk node words in registers, shifts in its
// L + 1 bases (x, then o), takes the (k-1)-suffix (the last Wq words, the
// top one masked), its canonical form and digest, and issues both cuckoo
// choices with all their satellite words at once (2 Wq loads); it scans the
// stash in shared memory while they are in flight, then tests the slots
// and orients the payload. The team resolves the round in registers, one
// shuffle a step, under the stop rules above, step by step; the speculated
// probes are pure reads, so they change no output. A lane with a budget of
// 0 probes nothing, end_out is the node where the walk stopped, and bases
// are written only for appended steps. The kernel is templated on (Wq, Wk)
// and D, so the words stay in registers; a thread holds one candidate
// whatever D is, so D adds no registers (48-126 a thread by word count, no
// spills). D comes from the wrapper (fill/walk_device.py
// lookahead_depth(lanes, "span", Wq)), by thresholds measured on the card:
// a probe reads 2 Wq sectors, so the rule holds lanes x Wq to 1,024 for D
// = 3 and 8,192 for D = 2. Blocks of one warp (two past 4,096 warps, four
// warps at D = 1) spread the fill's ~100 lanes over as many SMs.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700.00 W (kernel_bench.py, in
// turns with the earlier one-thread-per-lane kernel, which waited on the
// slot, then its satellites, every step; 2,048 steps, budget 10,000): at k
// = 45, 1 lane 0.527 ms (0.257 us a step) against 1.429 ms, 128 lanes (the
// fill's shape, D = 3) 0.82 ms (0.40 us a step) against 4.76 ms, 4,096
// lanes (D = 2) 2.47 ms against 4.95, 16,384 lanes (D = 1) 4.0 ms against
// 5.29; at k = 128, 128 lanes 1.02 ms against 9.21, 4,096 lanes (D = 1)
// 3.13 ms against 9.25. The rule took the fastest depth at all 17 shapes
// swept (k = 45: 1 to 16,384 lanes; k = 128: 1 to 4,096). A rule in lanes
// alone, as K5's, cannot: at 4,096 lanes D = 2 is the fastest at k = 45
// (2.46 against 2.60 ms at D = 1) and D = 1 at k = 128 (3.13 against 4.89).

#include <cstdint>
#include <cuda_runtime.h>

#include "span_map.cuh"

namespace {

using namespace span_map;

constexpr uint8_t STATUS_RUNNING = 0, STATUS_TIP = 1, STATUS_EVENT = 2;

constexpr int pow2_at_least(int x) { return x <= 1 ? 1 : 2 * pow2_at_least((x + 1) / 2); }

// compile-time shape of a round: P candidates, one per thread of a team of T
template <int D>
struct Round {
    static constexpr int P = ((1 << (2 * D)) - 1) / 3;  // 1 + 4 + ... + 4^(D-1)
    static constexpr int T = pow2_at_least(P);
    static_assert(T <= 32, "a round's candidates must fit one warp");
};

// (ext | pre << 4), oriented as read, of the (k-1)-suffix of `node` shifted
// left by s = 0..6 bits with `low` in the bits shifted in: the node itself
// (s = 0), or a candidate L + 1 bases on. Only the last WQ words of the
// shifted node hold the suffix.
template <int WQ, int WK>
__device__ __forceinline__ unsigned probe_ep(const Map& m, const u64 (&node)[WK], int s, u64 low, int k) {
    u64 q[WQ];
#pragma unroll
    for (int i = 0; i < WQ; i++) {
        const int w = WK - WQ + i;
        // the next word's top s bits ((x >> 1) >> (63 - s) is 0 at s = 0)
        const u64 in = w + 1 < WK ? (node[w + 1 < WK ? w + 1 : w] >> 1) >> (63 - s) : low;
        q[i] = (node[w] << s) | in;
    }
    q[0] &= top_mask(k - 1, WQ);
    u64 cq[WQ];
    bool is_canon;
    canonical<WQ>(q, k - 1, cq, is_canon);
    Eager<WQ> p;
    issue_eager<WQ>(m, cq, p);
    const unsigned pay = resolve_eager<WQ>(m, cq, p) & 0xFF;
    const unsigned ext_c = pay & 0xF, pre_c = pay >> 4;
    return is_canon ? (ext_c | pre_c << 4) : (shuffle02(pre_c) | shuffle02(ext_c) << 4);
}

template <int WQ, int WK, int D>
__global__ void walk_span_kernel(const u64* __restrict__ nodes, const int32_t* __restrict__ budgets, Map m,
                                 int k, int steps, int64_t lanes,
                                 uint8_t* __restrict__ bases, int32_t* __restrict__ n_app_out,
                                 u64* __restrict__ end_out, uint8_t* __restrict__ status_out)
{
    constexpr int T = Round<D>::T, P = Round<D>::P;
    __shared__ u64 s_sk[MAX_STASH], s_ssat[MAX_STASH * (MAX_WQ - 1)], s_sv[MAX_STASH];
    stage_stash<WQ>(m, s_sk, s_ssat, s_sv);
    __syncthreads();
    const int64_t j = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / T;  // this team's lane
    if (j >= lanes) return;  // whole teams only
    const int t = threadIdx.x % T;
    const unsigned mask = T == 32 ? 0xFFFFFFFFu : ((1u << T) - 1) << (threadIdx.x % 32 / T * T);
    // this thread's candidate: its level and its offset among the level's 4^level
    int my_level = 0, first = 0, span = 1;
    while (t >= first + span) {
        first += span;
        span *= 4;
        my_level++;
    }
    const u64 my_off = (u64)(t - first);

    u64 node[WK];
#pragma unroll
    for (int i = 0; i < WK; i++) node[i] = nodes[j * WK + i];
    const u64 top_k = top_mask(k, WK);
    const int budget = budgets[j];
    const int lim = budget < steps ? budget : steps;  // the walk appends at most lim bases
    int n_app = 0;
    uint8_t status = STATUS_RUNNING;
    uint8_t* row = bases + j * (int64_t)steps;
    if (lim > 0) {
        // (ext, pre) of the start node
        unsigned ep = __shfl_sync(mask, t == 0 ? probe_ep<WQ, WK>(m, node, 0, 0, k) : 0u, 0, T);
        bool go = true;
        while (go && n_app < lim) {
            unsigned ext = ep & 0xF, pre = ep >> 4;
            const int cnt_out = __popc(ext);
            if (cnt_out == 0) {
                status = STATUS_TIP;
                break;
            }
            if (cnt_out > 1 || __popc(pre) != 1) {  // fork, or merge at the successor
                status = STATUS_EVENT;
                break;
            }
            // candidate t: n1 = node << 2 | x, then my_level more bases, my_off
            const u64 x1 = (u64)(__ffs(ext) - 1);
            const unsigned mine =
                t < P ? probe_ep<WQ, WK>(m, node, 2 * (my_level + 1), (x1 << (2 * my_level)) | my_off, k) : 0u;
            int off = 0, base = 0, width = 1;
#pragma unroll
            for (int level = 0; level < D; level++) {
                if (level > 0) {
                    // ext has one bit here (the last step's branch2 check),
                    // so of this step's stop rules only merge can fire
                    if (n_app >= lim) {
                        go = false;
                        break;
                    }
                    ext = ep & 0xF;
                    pre = ep >> 4;
                    if (__popc(pre) != 1) {
                        status = STATUS_EVENT;
                        go = false;
                        break;
                    }
                    base += width;
                    width *= 4;
                    off = off * 4 + (__ffs(ext) - 1);
                }
                const unsigned e2 = __shfl_sync(mask, mine, base + off, T);
                if (__popc(e2 & 0xF) != 1) {  // the successor branches
                    status = STATUS_EVENT;
                    go = false;
                    break;
                }
                const unsigned x = __ffs(ext) - 1;
                if (t == 0) row[n_app] = (uint8_t)x;
                n_app++;
#pragma unroll
                for (int i = 0; i < WK - 1; i++) node[i] = (node[i] << 2) | (node[i + 1] >> 62);
                node[WK - 1] = (node[WK - 1] << 2) | x;
                node[0] &= top_k;
                ep = e2;
            }
        }
    }
    if (t == 0) {
        n_app_out[j] = n_app;
#pragma unroll
        for (int i = 0; i < WK; i++) end_out[j * WK + i] = node[i];
        status_out[j] = status;
    }
}

template <int WQ, int WK, int D>
cudaError_t launch(const void* nodes, const void* budgets, const Map& m, int k, int steps, int64_t lanes,
                   void* bases, void* n_app, void* end_nodes, void* status, cudaStream_t st)
{
    constexpr int T = Round<D>::T;
    const int64_t threads = lanes * T;
    // one warp per block spreads a few hundred lanes over as many SMs; a
    // thread per lane (D = 1) fills blocks of four warps
    const int block = T == 1 ? 128 : threads > 4096 * 32 ? 64 : 32;
    const int64_t grid = (threads + block - 1) / block;
    walk_span_kernel<WQ, WK, D><<<(unsigned)grid, block, 0, st>>>(
        (const u64*)nodes, (const int32_t*)budgets, m, k, steps, lanes,
        (uint8_t*)bases, (int32_t*)n_app, (u64*)end_nodes, (uint8_t*)status);
    return cudaGetLastError();
}

template <int WQ, int WK>
cudaError_t launch_depth(int depth, const void* nodes, const void* budgets, const Map& m, int k, int steps,
                         int64_t lanes, void* bases, void* n_app, void* end_nodes, void* status, cudaStream_t st)
{
    switch (depth) {
        case 1: return launch<WQ, WK, 1>(nodes, budgets, m, k, steps, lanes, bases, n_app, end_nodes, status, st);
        case 2: return launch<WQ, WK, 2>(nodes, budgets, m, k, steps, lanes, bases, n_app, end_nodes, status, st);
        case 3: return launch<WQ, WK, 3>(nodes, budgets, m, k, steps, lanes, bases, n_app, end_nodes, status, st);
    }
    return cudaErrorInvalidValue;
}

}  // namespace

// nodes, end_nodes: lanes x ceil(k/32) words; budgets, n_app: lanes int32;
// bases: lanes x steps bytes (NO_BASE-filled by the caller); status: lanes
// bytes; the map as in scan_pay_q_span_launch (scan_span.cu); depth: the
// look-ahead D, 1..3 (the wrapper's lookahead_depth). 33 <= k <= 256.
extern "C" int walk_span_launch(const void* nodes, const void* budgets,
                                const void* slots, const void* sat, int log_size, int64_t salt,
                                const void* stash_k, const void* stash_sat, const void* stash_v, int n_stash,
                                int k, int steps, int64_t lanes, int depth,
                                void* bases, void* n_app, void* end_nodes, void* status, void* stream)
{
    if (k < 33 || k > 256 || n_stash < 1 || n_stash > MAX_STASH || steps < 1 || lanes < 1)
        return (int)cudaErrorInvalidValue;
    const Map m = make_map(slots, sat, log_size, salt, stash_k, stash_sat, stash_v, n_stash);
    cudaStream_t st = (cudaStream_t)stream;
    const int wk = (k + 31) / 32, wq = (k - 1 + 31) / 32;
#define MTG_WALK_SPAN(Q, K)                                                                                     \
    if (wq == Q && wk == K)                                                                                     \
        return (int)launch_depth<Q, K>(depth, nodes, budgets, m, k, steps, lanes, bases, n_app, end_nodes, status, \
                                       st);
    MTG_WALK_SPAN(1, 2)
    MTG_WALK_SPAN(2, 2)
    MTG_WALK_SPAN(2, 3)
    MTG_WALK_SPAN(3, 3)
    MTG_WALK_SPAN(3, 4)
    MTG_WALK_SPAN(4, 4)
    MTG_WALK_SPAN(4, 5)
    MTG_WALK_SPAN(5, 5)
    MTG_WALK_SPAN(5, 6)
    MTG_WALK_SPAN(6, 6)
    MTG_WALK_SPAN(6, 7)
    MTG_WALK_SPAN(7, 7)
    MTG_WALK_SPAN(7, 8)
    MTG_WALK_SPAN(8, 8)
#undef MTG_WALK_SPAN
    return (int)cudaErrorInvalidValue;
}
