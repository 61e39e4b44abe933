// K2: Needleman-Wunsch traceback match counts as an anti-diagonal
// wavefront, one thread block per pair.
//
// Replaces: mindthegap_tpu/ops/nw_device.py _kernel (the Pallas TPU kernel
// launched by nw_matches_batch). It computes the same thing — gap -5,
// mismatch -5, match +10; per cell, the match count along the path the
// reference's backward traceback takes, ties broken diagonal > up > left —
// but not in the TPU's layout: no 128-lane rolls, no sentinel lanes, no
// reversed-b buffer. Lane i of diagonal d is cell (i, d - i); only cells
// with 0 <= i <= n and 0 <= d - i <= m are computed, so interior cells only
// ever read valid neighbours.
//
// Three (score, match-count) diagonals stay live, indexed by i: 6 * (n+1)
// int32. They sit in dynamic shared memory while 24 * (n+1) bytes fit the
// per-block opt-in limit (227 KB on this card, n <= 9,684); longer pairs use
// a per-pair slice of a global scratch buffer that the wrapper allocates.
// Threads stride over the lanes of the current diagonal with one
// __syncthreads() per diagonal, so the pass is bound by the n + m - 1
// sequential barrier steps per pair, not by bytes or arithmetic.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int32_t GAP = -5;
constexpr int32_t MIS = -5;
constexpr int32_t MATCH = 10;

template <bool SHARED>
__global__ void nw_matches_kernel(const uint8_t* __restrict__ seq, const int64_t* __restrict__ off,
                                  const int32_t* __restrict__ pair_ids, int32_t* __restrict__ out,
                                  int32_t* __restrict__ scratch, int64_t scratch_stride)
{
    extern __shared__ int32_t smem[];
    const int p = pair_ids[blockIdx.x];
    const uint8_t* a = seq + off[2 * p];
    const uint8_t* b = seq + off[2 * p + 1];
    const int n = (int)(off[2 * p + 1] - off[2 * p]);
    const int m = (int)(off[2 * p + 2] - off[2 * p + 1]);
    if (n == 0 || m == 0) {
        if (threadIdx.x == 0) out[p] = 0;
        return;
    }
    const int len = n + 1;
    int32_t* base = SHARED ? smem : scratch + (int64_t)blockIdx.x * scratch_stride;
    int32_t* S[3] = {base, base + len, base + 2 * len};
    int32_t* F[3] = {base + 3 * len, base + 4 * len, base + 5 * len};

    if (threadIdx.x == 0) {
        S[0][0] = 0;  // d = 0: cell (0, 0)
        F[0][0] = 0;
        S[1][0] = GAP;  // d = 1: cells (0, 1) and (1, 0)
        F[1][0] = 0;
        S[1][1] = GAP;
        F[1][1] = 0;
    }
    __syncthreads();

    for (int d = 2; d <= n + m; d++) {
        int32_t* sc = S[d % 3];
        int32_t* fc = F[d % 3];
        const int32_t* s1 = S[(d - 1) % 3];
        const int32_t* f1 = F[(d - 1) % 3];
        const int32_t* s2 = S[(d - 2) % 3];
        const int32_t* f2 = F[(d - 2) % 3];
        const int i_lo = d - m > 0 ? d - m : 0;
        const int i_hi = d < n ? d : n;
        for (int i = i_lo + threadIdx.x; i <= i_hi; i += blockDim.x) {
            const int j = d - i;
            int32_t s, f;
            if (i == 0 || j == 0) {  // borders (0, d) and (d, 0)
                s = GAP * d;
                f = 0;
            } else {
                const bool eq = a[i - 1] == b[j - 1];
                const int32_t diag = s2[i - 1] + (eq ? MATCH : MIS);
                const int32_t up = s1[i - 1] + GAP;    // cell (i-1, j)
                const int32_t left = s1[i] + GAP;      // cell (i, j-1)
                s = max(diag, max(up, left));
                f = s == diag ? f2[i - 1] + (eq ? 1 : 0) : (s == up ? f1[i - 1] : f1[i]);
            }
            sc[i] = s;
            fc[i] = f;
        }
        __syncthreads();
    }
    if (threadIdx.x == 0) out[p] = F[(n + m) % 3][n];
}

}  // namespace

// Shared-memory variant for pairs with 24 * (n_max + 1) <= smem_bytes.
extern "C" int nw_matches_shared_launch(const void* seq, const void* off, const void* pair_ids,
                                        int n_pairs, void* out, int smem_bytes, void* stream)
{
    cudaError_t err = cudaFuncSetAttribute(nw_matches_kernel<true>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return (int)err;
    nw_matches_kernel<true><<<n_pairs, 256, smem_bytes, (cudaStream_t)stream>>>(
        (const uint8_t*)seq, (const int64_t*)off, (const int32_t*)pair_ids, (int32_t*)out, nullptr, 0);
    return (int)cudaGetLastError();
}

// Global-scratch variant: block b uses scratch[b * stride, (b + 1) * stride).
extern "C" int nw_matches_global_launch(const void* seq, const void* off, const void* pair_ids,
                                        int n_pairs, void* out, void* scratch,
                                        int64_t scratch_stride, void* stream)
{
    nw_matches_kernel<false><<<n_pairs, 256, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)seq, (const int64_t*)off, (const int32_t*)pair_ids, (int32_t*)out,
        (int32_t*)scratch, scratch_stride);
    return (int)cudaGetLastError();
}

// Largest dynamic shared memory a block may opt into on the current device.
extern "C" int nw_max_shared_bytes(int* bytes)
{
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
}
