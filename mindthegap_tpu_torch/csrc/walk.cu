// K5: the fill's batched simple-path walker
// (mindthegap_tpu_torch/fill/walk_device.py _walk_batch_plain, which this
// kernel must equal bit for bit).
//
// Replaces: mindthegap_tpu/fill/walk_device.py walk_batch_device, an XLA
// program on the TPU (a lax.scan of `steps` steps over J job lanes, each
// step two fused quotient-map lookups per lane).
//
// The walk contract, per lane and step:
//   - stop "tip" when the node has no successor;
//   - stop "event" when the node forks, its unique successor has != 1
//     predecessors (merge), or the successor itself has != 1 successors
//     (branch2);
//   - stop when the lane's budget or the step count is spent (status stays
//     RUNNING);
//   - otherwise append the successor's base and move on, carrying the
//     (ext, pre) pair of the new node from this step's lookup.
//
// Bound on this card: latency. Each step's probe of the fused map (the two
// u64 slots of the 2-choice cuckoo QMap, or the one 128-byte, 16-slot bucket
// of QMapB) depends on the previous step's result, and the tables (128 MB
// and 256 MB at a bacterial genome) are far above the 50 MB L2, so a lane
// that probes one node at a time pays one DRAM round trip per step whatever
// the bandwidth. The fill hands the walker ~100 lanes at a time.
//
// The design: a team of threads per lane (a full warp at the fill's depth)
// probes D steps ahead in one round trip. Before the current node's
// successor is known to continue, the team already knows every node the
// next D steps can reach: the successor n1 (its base is fixed by the
// carried ext), its 4 children and their 16 grandchildren, 1 + 4 + ... +
// 4^(D-1) candidates. Candidate c sits at level L (its depth minus one)
// with offset o (the L bases after n1), at index (4^L - 1) / 3 + o, so 1 +
// x2 at depth 2 and 5 + 4 x2 + x3 at depth 3. Thread c of the team probes
// candidate c: it issues the probe's loads (the two cuckoo slots, or the
// bucket's line as eight 16-byte loads), scans the <= 64-entry stash in
// shared memory while they are in flight, and orients the payload. The
// team then resolves the path in registers, one shuffle per step, applying
// the stop rules above step by step; the speculated probes are pure reads,
// so they change no output. The team is the smallest power of two that
// holds the candidates (1, 8 or 32 threads for D = 1, 2, 3). The table
// loads go through the read-only data path (__ldg), which made D = 1 of
// the cuckoo map up to 17% faster and changed nothing else measured. D comes
// from the wrapper (fill/walk_device.py lookahead_depth), by thresholds
// measured on the card: 3 up to 1,024 live walks (cuckoo) or 1,536
// (bucket), 2 up to 6,144 or 10,240, 1 beyond: past those, a round's
// probes over all lanes exceed what the card serves in one round trip (it
// sustained about 19 G cuckoo and 24 G bucket probes a second). Blocks
// hold one warp (two past 4,096 warps), so even 128 lanes spread over 128
// SMs.
//
// Measured on an H100 80GB HBM3 at 700 W (kernel_bench.py, in turns with
// the one-thread-per-lane kernel this replaced), 2,048 steps, cuckoo /
// bucket: at the fill's 128 lanes 0.73 / 0.89 ms (0.36 / 0.43 us per
// step) against 1.90 / 3.71 ms; at 4,096 lanes (D = 2) 1.34 / 1.50 ms
// against 2.03 / 4.66 ms; at 16,384 lanes (D = 1) 2.26 / 2.90 ms against
// 2.41 / 4.43 ms; at 65,536 lanes 9.44 / 7.83 ms against 9.47 / 9.23 ms.
// In trials, splitting a probe over 2 or 8 threads (one slot or one
// 16-byte load each, joined by shuffles), D = 4 (85 candidates, three per
// thread) and carrying the reverse complement from step to step were all
// slower. The earlier one-thread kernel's bucket step cost two round trips
// even at one lane (2.15 ms against 1.03 ms cuckoo) with 42 registers and
// no spills; the likely cause, not checked in its machine code, is that
// its eight loads did not all issue before the first compare. Here they
// are issued first. The probe's table primitives (the hash, the slot test,
// the bucket line) live in qmap.cuh, shared with K8 and K9.

#include <cstdint>
#include <cuda_runtime.h>

#include "qmap.cuh"

namespace {

using namespace qmap;

constexpr uint8_t STATUS_RUNNING = 0, STATUS_TIP = 1, STATUS_EVENT = 2;

constexpr int pow2_at_least(int x) { return x <= 1 ? 1 : 2 * pow2_at_least((x + 1) / 2); }

// compile-time shape of a round: P candidates, one per thread of a team of T
template <int D>
struct Round {
    static constexpr int P = ((1 << (2 * D)) - 1) / 3;  // 1 + 4 + ... + 4^(D-1)
    static constexpr int T = pow2_at_least(P);
    static_assert(T <= 32, "a round's candidates must fit one warp");
};

struct Ctx {
    const u64* slots;
    int shift;  // 64 - log2 of the slot count (cuckoo) or of the bucket count
    u64 rem_mask;
    const u64* s_keys;  // stash, in shared memory
    const unsigned* s_pay;
    int n_stash;
    int k;
    u64 mask_k, mask_q;
};

// (ext | pre << 4) of candidate t below `root`, oriented as read (0 for a
// thread past the `nc` candidates). `nc` is P, or 1 for the walk's first
// node (root itself).
template <bool BUCKET>
__device__ __forceinline__ unsigned probe(const Ctx& cx, u64 root, int t, int nc) {
    if (t >= nc) return 0;
    int level = 0, base = 0, width = 1;
    while (t >= base + width) {
        base += width;
        width *= 4;
        level++;
    }
    const u64 node = ((root << (2 * level)) | (u64)(t - base)) & cx.mask_k;
    const u64 q = node & cx.mask_q;
    const u64 rc = revcomp(q, cx.k - 1);
    const u64 cq = q < rc ? q : rc;
    // issue the probe's loads before anything waits on one: the bucket's
    // line as eight 16-byte loads, or the two cuckoo slots
    constexpr int W = BUCKET ? QB_SLOTS : 2;
    u64 w[W], rem[BUCKET ? 1 : 2];
    if constexpr (BUCKET) {
        const u64 h = mix(cq, H1);
        rem[0] = h & cx.rem_mask;
        qb_line(cx.slots, h >> cx.shift, w);
    } else {
#pragma unroll
        for (int i = 0; i < 2; i++) {
            const u64 h = mix(cq, i ? H2 : H1);
            rem[i] = h & cx.rem_mask;
            w[i] = __ldg(cx.slots + (h >> cx.shift));
        }
    }
    // the stash while the loads are in flight: the sum of the payloads whose
    // key matches, as the plain version sums them (only the low 8 bits are read)
    unsigned pay = 0;
    for (int s = 0; s < cx.n_stash; s++) pay += cx.s_keys[s] == cq ? cx.s_pay[s] : 0u;
    unsigned tbl = 0;
    if constexpr (BUCKET) {  // the max over the 16 slots
        tbl = qb_payload(w, rem[0]);
    } else {  // the second choice's hit overrides the first's, as in the plain version
#pragma unroll
        for (int i = 0; i < 2; i++)
            if (q_slot_hit(w[i], rem[i], i)) tbl = (unsigned)(w[i] & PAY_MASK);
    }
    pay = (pay | tbl) & 0xFF;
    const unsigned ext_c = pay & 0xF, pre_c = pay >> 4;
    return q == cq ? (ext_c | pre_c << 4) : (shuffle02(pre_c) | shuffle02(ext_c) << 4);
}

template <bool BUCKET, int D>
__global__ void walk_kernel(const u64* __restrict__ nodes, const int32_t* __restrict__ budgets,
                            const u64* __restrict__ slots, int log_size,
                            const u64* __restrict__ stash_k, const u64* __restrict__ stash_v, int n_stash,
                            int k, int steps, int64_t lanes,
                            uint8_t* __restrict__ bases, int32_t* __restrict__ n_app_out,
                            u64* __restrict__ end_out, uint8_t* __restrict__ status_out)
{
    constexpr int T = Round<D>::T;
    __shared__ u64 s_keys[MAX_STASH];
    __shared__ unsigned s_pay[MAX_STASH];
    for (int s = threadIdx.x; s < n_stash; s += blockDim.x) {
        s_keys[s] = stash_k[s];
        s_pay[s] = (unsigned)stash_v[s];
    }
    __syncthreads();

    const int64_t j = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / T;  // this team's lane
    if (j >= lanes) return;  // whole teams only
    const int t = threadIdx.x % T;
    const unsigned mask = T == 32 ? 0xFFFFFFFFu : ((1u << T) - 1) << (threadIdx.x % 32 / T * T);
    Ctx cx;
    cx.slots = slots;
    cx.shift = 64 - log_size;
    cx.rem_mask = (1ull << cx.shift) - 1;
    cx.s_keys = s_keys;
    cx.s_pay = s_pay;
    cx.n_stash = n_stash;
    cx.k = k;
    cx.mask_k = k == 32 ? ~0ull : (1ull << (2 * k)) - 1;
    cx.mask_q = (1ull << (2 * (k - 1))) - 1;  // k <= 32

    const int budget = budgets[j];
    const int lim = budget < steps ? budget : steps;  // the walk appends at most lim bases
    u64 node = nodes[j];
    int n_app = 0;
    uint8_t status = STATUS_RUNNING;
    uint8_t* row = bases + j * (int64_t)steps;
    if (lim > 0) {
        // (ext, pre) of the start node
        unsigned ep = __shfl_sync(mask, probe<BUCKET>(cx, node, t, 1), 0, T);
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
            const u64 n1 = ((node << 2) | (u64)(__ffs(ext) - 1)) & cx.mask_k;
            const unsigned mine = probe<BUCKET>(cx, n1, t, Round<D>::P);
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
                node = ((node << 2) | x) & cx.mask_k;
                ep = e2;
            }
        }
    }
    if (t == 0) {
        n_app_out[j] = n_app;
        end_out[j] = node;
        status_out[j] = status;
    }
}

template <bool BUCKET, int D>
int launch(const void* nodes, const void* budgets, const void* slots, int log_size,
           const void* stash_k, const void* stash_v, int n_stash, int k, int steps,
           int64_t lanes, void* bases, void* n_app, void* end_nodes, void* status, cudaStream_t stream)
{
    constexpr int T = Round<D>::T;
    const int64_t threads = lanes * T;
    // one warp per block spreads a few hundred lanes over as many SMs; a
    // thread per lane (D = 1) fills blocks of four warps
    const int block = T == 1 ? 128 : threads > 4096 * 32 ? 64 : 32;
    const int64_t grid = (threads + block - 1) / block;
    walk_kernel<BUCKET, D><<<(unsigned)grid, block, 0, stream>>>(
        (const u64*)nodes, (const int32_t*)budgets, (const u64*)slots, log_size,
        (const u64*)stash_k, (const u64*)stash_v, n_stash, k, steps, lanes,
        (uint8_t*)bases, (int32_t*)n_app, (u64*)end_nodes, (uint8_t*)status);
    return (int)cudaGetLastError();
}

}  // namespace

// depth: the look-ahead D, 1..3 (the wrapper's lookahead_depth)
extern "C" int walk_launch(const void* nodes, const void* budgets, const void* slots, int log_size, int bucket,
                           const void* stash_k, const void* stash_v, int n_stash, int k, int steps,
                           int64_t lanes, int depth, void* bases, void* n_app, void* end_nodes, void* status,
                           void* stream)
{
    cudaStream_t st = (cudaStream_t)stream;
#define MTG_WALK(B, D)                                                                                    \
    if ((bucket != 0) == B && depth == D)                                                                 \
        return launch<B, D>(nodes, budgets, slots, log_size, stash_k, stash_v, n_stash, k, steps, lanes, \
                            bases, n_app, end_nodes, status, st);
    MTG_WALK(false, 1)
    MTG_WALK(false, 2)
    MTG_WALK(false, 3)
    MTG_WALK(true, 1)
    MTG_WALK(true, 2)
    MTG_WALK(true, 3)
#undef MTG_WALK
    return (int)cudaErrorInvalidValue;
}
