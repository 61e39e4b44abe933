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
// sorted, so no sort is needed here: a merge path does it in one pass.
//
// Keys are biased (u64 XOR 2^63 held in int64): signed compares are
// unsigned k-mer order and the padding (INT64_MAX) sorts last.
//
// Two launches around torch.cumsum (the scans stay in PyTorch):
//   merge_path_launch   - thread d finds, by binary search on diagonal d of
//                         the merge path, the d-th element of the stable
//                         merge (accumulator first on ties) and writes its
//                         key, its count (accumulator count, or 1 for a live
//                         batch key, 0 for padding); a second kernel flags
//                         the run starts (live, and unlike the key before);
//   (torch)             - pos = cumsum(flags), s = cumsum(counts);
//   merge_fold_launch   - each run start i writes its key to slot pos[i]-1
//                         (when below out_cap) and its exclusive prefix
//                         s[i]-count[i]; then slot j's count is the next
//                         start's prefix (or the total) minus its own, and
//                         slots past n_distinct get padding. n_distinct =
//                         pos[n-1] is written to a 0-d int32 on the device.
//
// Bound on this card: bytes. Per merged element the passes move about 60
// bytes (keys and counts read and written, flags, two scans), with the
// binary searches' log2(n) probes mostly in L2; a default flush merges ~13 M
// elements, ~0.8 GB of traffic, well under a millisecond of bandwidth.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr long long BIASED_SENTINEL = 0x7FFFFFFFFFFFFFFFll;

__global__ void merge_path_kernel(const long long* __restrict__ a_keys, const long long* __restrict__ a_counts,
                                  int64_t na, const long long* __restrict__ b_keys, int64_t nb,
                                  long long* __restrict__ mk, long long* __restrict__ mc)
{
    const int64_t d = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (d >= na + nb) return;
    // a = number of accumulator elements among the first d of the merge
    int64_t lo = d > nb ? d - nb : 0;
    int64_t hi = d < na ? d : na;
    while (lo < hi) {
        const int64_t mid = (lo + hi) >> 1;
        if (a_keys[mid] <= b_keys[d - 1 - mid]) lo = mid + 1;
        else hi = mid;
    }
    const int64_t a = lo, b = d - lo;
    if (a < na && (b >= nb || a_keys[a] <= b_keys[b])) {
        mk[d] = a_keys[a];
        mc[d] = a_counts[a];
    } else {
        const long long key = b_keys[b];
        mk[d] = key;
        mc[d] = key != BIASED_SENTINEL ? 1 : 0;
    }
}

__global__ void run_flags_kernel(const long long* __restrict__ mk, int64_t n, uint8_t* __restrict__ flag)
{
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const long long key = mk[i];
    flag[i] = key != BIASED_SENTINEL && (i == 0 || mk[i - 1] != key);
}

__global__ void compact_kernel(const long long* __restrict__ mk, const long long* __restrict__ mc,
                               const uint8_t* __restrict__ flag, const long long* __restrict__ pos,
                               const long long* __restrict__ s, int64_t n,
                               long long* __restrict__ keys_out, long long* __restrict__ starts,
                               int64_t out_cap)
{
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n || !flag[i]) return;
    const int64_t j = pos[i] - 1;
    if (j <= out_cap) starts[j] = s[i] - mc[i];
    if (j < out_cap) keys_out[j] = mk[i];
}

__global__ void run_totals_kernel(const long long* __restrict__ pos, const long long* __restrict__ s, int64_t n,
                                  const long long* __restrict__ starts, long long* __restrict__ keys_out,
                                  long long* __restrict__ counts_out, int32_t* __restrict__ n_distinct,
                                  int64_t out_cap)
{
    const int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (j >= out_cap) return;
    const int64_t nd = pos[n - 1];
    if (j == 0) *n_distinct = (int32_t)nd;
    if (j < nd) {
        const long long next = j + 1 < nd ? starts[j + 1] : s[n - 1];
        counts_out[j] = next - starts[j];
    } else {
        keys_out[j] = BIASED_SENTINEL;
        counts_out[j] = 0;
    }
}

inline unsigned grid_for(int64_t n, int block) { return (unsigned)((n + block - 1) / block); }

}  // namespace

extern "C" int merge_path_launch(const void* a_keys, const void* a_counts, int64_t na,
                                 const void* b_keys, int64_t nb,
                                 void* mk, void* mc, void* flag, void* stream)
{
    const int block = 256;
    const int64_t n = na + nb;
    cudaStream_t st = (cudaStream_t)stream;
    merge_path_kernel<<<grid_for(n, block), block, 0, st>>>(
        (const long long*)a_keys, (const long long*)a_counts, na, (const long long*)b_keys, nb,
        (long long*)mk, (long long*)mc);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    run_flags_kernel<<<grid_for(n, block), block, 0, st>>>((const long long*)mk, n, (uint8_t*)flag);
    return (int)cudaGetLastError();
}

extern "C" int merge_fold_launch(const void* mk, const void* mc, const void* flag, const void* pos,
                                 const void* s, int64_t n, void* keys_out, void* counts_out,
                                 void* starts, void* n_distinct, int64_t out_cap, void* stream)
{
    const int block = 256;
    cudaStream_t st = (cudaStream_t)stream;
    compact_kernel<<<grid_for(n, block), block, 0, st>>>(
        (const long long*)mk, (const long long*)mc, (const uint8_t*)flag, (const long long*)pos,
        (const long long*)s, n, (long long*)keys_out, (long long*)starts, out_cap);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    run_totals_kernel<<<grid_for(out_cap, block), block, 0, st>>>(
        (const long long*)pos, (const long long*)s, n, (const long long*)starts,
        (long long*)keys_out, (long long*)counts_out, (int32_t*)n_distinct, out_cap);
    return (int)cudaGetLastError();
}
