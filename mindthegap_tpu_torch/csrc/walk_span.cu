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
// Bound on this card: latency. Each step's lookup (a slot, then Wq-1
// satellite words, or the second slot after a miss; span_map.cuh) depends
// on the last, in tables far above the 50 MB L2, so a lane pays at least
// one DRAM round trip a step whatever the bandwidth.
//
// The design, simple first: one thread per lane, the node's words in
// registers (the word counts are template parameters), the stash in shared
// memory, blocks of one warp so that the fill's ~100 lanes spread over as
// many SMs. A lane with a budget of 0 probes nothing. K5's look-ahead (a
// team of threads probing the next steps' candidates at once) is not done
// here.

#include <cstdint>
#include <cuda_runtime.h>

#include "span_map.cuh"

namespace {

using namespace span_map;

constexpr uint8_t STATUS_RUNNING = 0, STATUS_TIP = 1, STATUS_EVENT = 2;

// (ext | pre << 4) of the node's (k-1)-suffix, oriented as read
template <int WQ, int WK>
__device__ __forceinline__ unsigned ext_pre(const Map& m, const u64 (&node)[WK], int k) {
    u64 q[WQ], cq[WQ];
#pragma unroll
    for (int i = 0; i < WQ; i++) q[i] = node[WK - WQ + i];
    q[0] &= top_mask(k - 1, WQ);
    bool is_canon;
    canonical<WQ>(q, k - 1, cq, is_canon);
    const unsigned pay = lookup<WQ>(m, cq) & 0xFF;
    const unsigned ext_c = pay & 0xF, pre_c = pay >> 4;
    return is_canon ? (ext_c | pre_c << 4) : (shuffle02(pre_c) | shuffle02(ext_c) << 4);
}

template <int WQ, int WK>
__global__ void walk_span_kernel(const u64* __restrict__ nodes, const int32_t* __restrict__ budgets, Map m,
                                 int k, int steps, int64_t lanes,
                                 uint8_t* __restrict__ bases, int32_t* __restrict__ n_app_out,
                                 u64* __restrict__ end_out, uint8_t* __restrict__ status_out)
{
    __shared__ u64 s_sk[MAX_STASH], s_ssat[MAX_STASH * (MAX_WQ - 1)], s_sv[MAX_STASH];
    stage_stash<WQ>(m, s_sk, s_ssat, s_sv);
    __syncthreads();
    const int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (j >= lanes) return;

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
        unsigned ep = ext_pre<WQ, WK>(m, node, k);
        while (n_app < lim) {
            const unsigned ext = ep & 0xF, pre = ep >> 4;
            const int cnt_out = __popc(ext);
            if (cnt_out == 0) {
                status = STATUS_TIP;
                break;
            }
            if (cnt_out > 1 || __popc(pre) != 1) {  // fork, or merge at the successor
                status = STATUS_EVENT;
                break;
            }
            const unsigned x = __ffs(ext) - 1;
            u64 nxt[WK];
#pragma unroll
            for (int i = 0; i < WK - 1; i++) nxt[i] = (node[i] << 2) | (node[i + 1] >> 62);
            nxt[WK - 1] = (node[WK - 1] << 2) | x;
            nxt[0] &= top_k;
            const unsigned ep2 = ext_pre<WQ, WK>(m, nxt, k);
            if (__popc(ep2 & 0xF) != 1) {  // the successor branches
                status = STATUS_EVENT;
                break;
            }
            row[n_app++] = (uint8_t)x;
#pragma unroll
            for (int i = 0; i < WK; i++) node[i] = nxt[i];
            ep = ep2;
        }
    }
    n_app_out[j] = n_app;
#pragma unroll
    for (int i = 0; i < WK; i++) end_out[j * WK + i] = node[i];
    status_out[j] = status;
}

template <int WQ, int WK>
cudaError_t launch(const void* nodes, const void* budgets, const Map& m, int k, int steps, int64_t lanes,
                   void* bases, void* n_app, void* end_nodes, void* status, cudaStream_t st)
{
    // blocks of one warp spread the fill's few hundred lanes over as many SMs
    const int block = lanes > 132 * 128 ? 128 : 32;
    const int64_t grid = (lanes + block - 1) / block;
    walk_span_kernel<WQ, WK><<<(unsigned)grid, block, 0, st>>>(
        (const u64*)nodes, (const int32_t*)budgets, m, k, steps, lanes,
        (uint8_t*)bases, (int32_t*)n_app, (u64*)end_nodes, (uint8_t*)status);
    return cudaGetLastError();
}

}  // namespace

// nodes, end_nodes: lanes x ceil(k/32) words; budgets, n_app: lanes int32;
// bases: lanes x steps bytes (NO_BASE-filled by the caller); status: lanes
// bytes; the map as in scan_pay_q_span_launch (scan_span.cu). 33 <= k <= 256.
extern "C" int walk_span_launch(const void* nodes, const void* budgets,
                                const void* slots, const void* sat, int log_size, int64_t salt,
                                const void* stash_k, const void* stash_sat, const void* stash_v, int n_stash,
                                int k, int steps, int64_t lanes,
                                void* bases, void* n_app, void* end_nodes, void* status, void* stream)
{
    if (k < 33 || k > 256 || n_stash < 1 || n_stash > MAX_STASH || steps < 1 || lanes < 1)
        return (int)cudaErrorInvalidValue;
    Map m;
    m.slots = (const u64*)slots;
    m.sat = (const u64*)sat;
    m.size = 1ll << log_size;
    m.shift = 64 - log_size;
    m.rem_mask = (1ull << m.shift) - 1;
    m.salt = (u64)salt;
    m.stash_k = (const u64*)stash_k;
    m.stash_sat = (const u64*)stash_sat;
    m.stash_v = (const u64*)stash_v;
    m.n_stash = n_stash;
    cudaStream_t st = (cudaStream_t)stream;
    const int wk = (k + 31) / 32, wq = (k - 1 + 31) / 32;
#define MTG_WALK_SPAN(Q, K)                                                                      \
    if (wq == Q && wk == K)                                                                      \
        return (int)launch<Q, K>(nodes, budgets, m, k, steps, lanes, bases, n_app, end_nodes, status, st);
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
