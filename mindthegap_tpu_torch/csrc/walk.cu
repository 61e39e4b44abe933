// K5: the fill's batched simple-path walker
// (mindthegap_tpu_torch/fill/walk_device.py _walk_batch_plain, which this
// kernel must equal bit for bit).
//
// Replaces: mindthegap_tpu/fill/walk_device.py walk_batch_device, an XLA
// program on the TPU (a lax.scan of `steps` steps over J job lanes, each
// step two fused quotient-map lookups per lane).
//
// One thread per job lane runs up to `steps` steps of the walk contract:
//   - stop "tip" when the node has no successor;
//   - stop "event" when the node forks, its unique successor has != 1
//     predecessors (merge), or the successor itself has != 1 successors
//     (branch2);
//   - stop when the lane's budget is spent (status stays RUNNING);
//   - otherwise append the successor's base and move on, carrying the
//     (ext, pre) pair of the new node from this step's second lookup.
// Each step probes the fused map once: the two u64 slots of the 2-choice
// cuckoo QMap, or the one 128-byte, 16-slot bucket of QMapB; the <= 64-entry
// stash is held in shared memory. A lane's thread exits when the lane stops;
// the wrapper pre-fills `bases` with NO_BASE, so the thread writes only the
// bases it appends.
//
// Bound on this card: latency. Each step's probe depends on the previous
// step's result, so a lane issues one dependent random DRAM read (cuckoo:
// two independent ones) per step out of a table far above the 50 MB L2;
// what hides it is the number of lanes in flight, not bandwidth. The design
// keeps every lane's state in registers and each bucket read as eight
// 16-byte loads of one 128-byte line.

#include <cstdint>
#include <cuda_runtime.h>

typedef unsigned long long u64;

namespace {

constexpr u64 H1 = 0x9E3779B97F4A7C15ull;
constexpr u64 H2 = 0xC2B2AE3D27D4EB4Full;
constexpr u64 PAY_MASK = 0x1FF;
constexpr u64 Q_VALID = 1ull << 10;
constexpr u64 Q_CHOICE = 1ull << 9;
constexpr int Q_SHIFT_PAY = 11;
constexpr u64 QB_VALID = 1ull << 9;
constexpr int QB_SHIFT_PAY = 10;
constexpr int MAX_STASH = 64;
constexpr uint8_t STATUS_RUNNING = 0, STATUS_TIP = 1, STATUS_EVENT = 2;

__device__ __forceinline__ u64 mix(u64 key, u64 c) {
    u64 h = (key ^ (key >> 33)) * c;
    return h ^ (h >> 29);
}

__device__ __forceinline__ u64 revcomp(u64 x, int k) {
    x ^= 0xAAAAAAAAAAAAAAAAull;  // complement every base
    x = ((x >> 2) & 0x3333333333333333ull) | ((x & 0x3333333333333333ull) << 2);
    x = ((x >> 4) & 0x0F0F0F0F0F0F0F0Full) | ((x & 0x0F0F0F0F0F0F0F0Full) << 4);
    x = ((x >> 8) & 0x00FF00FF00FF00FFull) | ((x & 0x00FF00FF00FF00FFull) << 8);
    x = ((x >> 16) & 0x0000FFFF0000FFFFull) | ((x & 0x0000FFFF0000FFFFull) << 16);
    x = (x >> 32) | (x << 32);
    return x >> (64 - 2 * k);
}

__device__ __forceinline__ u64 shuffle02(u64 b) {  // bitmap positions b -> b^2
    return ((b >> 2) & 3) | ((b & 3) << 2);
}

struct Table {
    const u64* slots;
    int log_size;  // log2 of the slot count (cuckoo) or of the bucket count
    bool bucket;
    const u64* s_keys;  // stash, in shared memory
    const u64* s_pay;
    int n_stash;
};

__device__ __forceinline__ u64 lookup(const Table& t, u64 key) {
    const int shift = 64 - t.log_size;
    const u64 rem_mask = (1ull << shift) - 1;
    u64 out = 0;
    if (t.bucket) {
        const u64 h = mix(key, H1);
        const u64 rem = h & rem_mask;
        const ulonglong2* row = reinterpret_cast<const ulonglong2*>(t.slots + (h >> shift) * 16);
        for (int s = 0; s < 8; s++) {
            const ulonglong2 v = row[s];
            const u64 px = (v.x & QB_VALID) && (v.x >> QB_SHIFT_PAY) == rem ? v.x & PAY_MASK : 0;
            const u64 py = (v.y & QB_VALID) && (v.y >> QB_SHIFT_PAY) == rem ? v.y & PAY_MASK : 0;
            out = out > px ? out : px;
            out = out > py ? out : py;
        }
    } else {
        for (int i = 0; i < 2; i++) {
            const u64 h = mix(key, i ? H2 : H1);
            const u64 v = t.slots[h >> shift];
            if ((v >> Q_SHIFT_PAY) == (h & rem_mask) && (v & Q_VALID) && (((v & Q_CHOICE) != 0) == (i == 1)))
                out = v & PAY_MASK;
        }
    }
    for (int s = 0; s < t.n_stash; s++)
        if (t.s_keys[s] == key) out |= t.s_pay[s];
    return out;
}

// (ext, pre) bitmaps of the (k-1)-suffix of `node`, as read: ext = the
// successor set of node, pre = the predecessor set of its unique successor
__device__ __forceinline__ void ext_pre_of(const Table& t, u64 node, int k, u64& ext, u64& pre) {
    const u64 mask_q = (1ull << (2 * (k - 1))) - 1;  // k <= 32
    const u64 q = node & mask_q;
    const u64 rc = revcomp(q, k - 1);
    const u64 cq = q < rc ? q : rc;
    const u64 pay = lookup(t, cq) & 0xFF;
    const u64 ext_c = pay & 0xF, pre_c = (pay >> 4) & 0xF;
    if (q == cq) {
        ext = ext_c;
        pre = pre_c;
    } else {
        ext = shuffle02(pre_c);
        pre = shuffle02(ext_c);
    }
}

__global__ void walk_kernel(const u64* __restrict__ nodes, const int32_t* __restrict__ budgets,
                            const u64* __restrict__ slots, int log_size, int bucket,
                            const u64* __restrict__ stash_k, const u64* __restrict__ stash_v, int n_stash,
                            int k, int steps, int64_t lanes,
                            uint8_t* __restrict__ bases, int32_t* __restrict__ n_app_out,
                            u64* __restrict__ end_out, uint8_t* __restrict__ status_out)
{
    __shared__ u64 s_keys[MAX_STASH], s_pay[MAX_STASH];
    for (int s = threadIdx.x; s < n_stash; s += blockDim.x) {
        s_keys[s] = stash_k[s];
        s_pay[s] = stash_v[s];
    }
    __syncthreads();

    const int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (j >= lanes) return;
    const Table t{slots, log_size, bucket != 0, s_keys, s_pay, n_stash};
    const u64 mask_k = k == 32 ? ~0ull : (1ull << (2 * k)) - 1;
    const int budget = budgets[j];
    u64 node = nodes[j];
    u64 ext, pre;
    ext_pre_of(t, node, k, ext, pre);
    int n_app = 0;
    uint8_t status = STATUS_RUNNING;
    uint8_t* row = bases + j * (int64_t)steps;
    for (int s = 0; s < steps && n_app < budget; s++) {
        const int cnt_out = __popcll(ext);
        if (cnt_out == 0) {
            status = STATUS_TIP;
            break;
        }
        if (cnt_out > 1 || __popcll(pre) != 1) {  // fork, or merge at the successor
            status = STATUS_EVENT;
            break;
        }
        const u64 x = (u64)(__ffsll((long long)ext) - 1);  // the single successor's base
        const u64 nxt = ((node << 2) | x) & mask_k;
        u64 ext2, pre2;
        ext_pre_of(t, nxt, k, ext2, pre2);
        if (__popcll(ext2) != 1) {  // the successor branches
            status = STATUS_EVENT;
            break;
        }
        row[n_app++] = (uint8_t)x;
        node = nxt;
        ext = ext2;
        pre = pre2;
    }
    n_app_out[j] = n_app;
    end_out[j] = node;
    status_out[j] = status;
}

}  // namespace

extern "C" int walk_launch(const void* nodes, const void* budgets, const void* slots, int log_size, int bucket,
                           const void* stash_k, const void* stash_v, int n_stash, int k, int steps,
                           int64_t lanes, void* bases, void* n_app, void* end_nodes, void* status,
                           void* stream)
{
    const int block = 128;
    const int64_t grid = (lanes + block - 1) / block;
    walk_kernel<<<(unsigned)grid, block, 0, (cudaStream_t)stream>>>(
        (const u64*)nodes, (const int32_t*)budgets, (const u64*)slots, log_size, bucket,
        (const u64*)stash_k, (const u64*)stash_v, n_stash, k, steps, lanes,
        (uint8_t*)bases, (int32_t*)n_app, (u64*)end_nodes, (uint8_t*)status);
    return (int)cudaGetLastError();
}
