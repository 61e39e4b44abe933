// K2: Needleman-Wunsch traceback match counts as a striped register DP.
//
// Replaces: mindthegap_tpu/ops/nw_device.py _kernel (the Pallas TPU kernel
// launched by nw_matches_batch). Same function: gap -5, mismatch -5, match
// +10; per cell, the match count along the path the reference's backward
// traceback takes, ties broken diagonal > up > left. Rows are a (i = 1..n),
// columns are b (j = 1..m); the result is the count at (n, m). A pair is
// never transposed: the tie rule is not symmetric in (a, b).
//
// Bound: int32 operations, nine per cell at the least with the shifted
// scores below (bounds.py NW_OPS_PER_CELL); a pair moves only its n + m
// bytes in and one int32 out.
//
// The barrier chain. The earlier kernel walked the n + m - 1 anti-diagonals
// of a pair with one __syncthreads() each and kept three diagonals in shared
// memory. Here no barrier orders the cells. A warp owns a stripe of
// 32 * ROWS rows, each lane ROWS consecutive rows (score, count and a's code)
// in registers. The warp sweeps the columns skewed by one column per lane:
// at step t lane l computes column t - l for its rows, and takes the row
// above its top row from lane l - 1 by a shuffle (what that lane produced at
// step t - 1). Each b code enters at lane 0 and goes down with the count.
// Lane 0 takes the row above from the boundary row that the stripe above
// wrote (the first stripe takes the row-0 border), 32 columns at a time and
// one such chunk ahead; lane 31 writes its bottom row into the boundary row.
// One boundary row per pair serves every stripe in place: a stripe reads
// column j (by step j - 32) before it overwrites it (step j + 31), and the
// stripe below reads it only after this one has published it.
//
// A block of WARPS warps works on one pair; warp w takes stripes w,
// w + WARPS, ... . Each warp publishes the columns its stripe has written to
// the boundary row in a shared progress word every PUBLISH steps (release,
// block scope); the stripe below waits (acquire) until the next chunk it
// reads is published. A stripe waits only on the one above it, so the
// pipeline cannot deadlock. There is one launch for any pair length. A
// block covers WARPS * 32 * ROWS = 10,240 rows in one wave of stripes, the
// fill's default -max-length of 10,000 bp; longer pairs take more waves.
//
// The cell. Scores are shifted: t(i, j) = s(i, j) + 5 (i + j), so the
// borders are 0, up and left add nothing and the diagonal adds 20 (match)
// or 5 (mismatch); the shift is the same for the three candidates of a
// cell, so the maxima and the ties are the reference's. The chain down a
// lane's rows is one DPX three-way max (__vimax3_s32) a row; the winner is
// decided off that chain, by equality with the result. A count travels with
// its b code in one word, count << 8 | code, so counts stay below 2^23 (the
// wrapper refuses longer sequences).

#include <cstdint>
#include <cuda/atomic>
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 16;    // warps per block; a block works on one pair
constexpr int ROWS = 20;     // rows a lane keeps in registers
constexpr int PUBLISH = 32;  // steps between progress publications
constexpr int STRIPE = 32 * ROWS;
constexpr unsigned FULL = 0xffffffffu;
constexpr int32_t DIAG_MATCH = 20;  // +10, shifted by 2 * 5
constexpr int32_t DIAG_MIS = 5;     // -5, shifted by 2 * 5

using Progress = cuda::atomic_ref<unsigned long long, cuda::thread_scope_block>;

__global__ void __launch_bounds__(32 * WARPS)
nw_matches_kernel(const uint8_t* __restrict__ seq, const int64_t* __restrict__ off,
                  const int32_t* __restrict__ order, int32_t* __restrict__ out, int2* bnd,
                  int64_t bnd_stride)
{
    __shared__ unsigned long long progress[WARPS];
    const int p = order[blockIdx.x];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const uint8_t* a = seq + off[2 * p];
    const uint8_t* b = seq + off[2 * p + 1];
    const int n = (int)(off[2 * p + 1] - off[2 * p]);
    const int m = (int)(off[2 * p + 2] - off[2 * p + 1]);
    if (n == 0 || m == 0) {
        if (threadIdx.x == 0) out[p] = 0;
        return;
    }
    int2* row = bnd + (int64_t)blockIdx.x * bnd_stride;  // column j at row[j - 1]
    if (WARPS > 1) {
        if (lane == 0) progress[warp] = 0;
        __syncthreads();
    }
    const int stripes = (n + STRIPE - 1) / STRIPE;
    // stripe s publishes (s + 1) * span + (columns written): monotone per warp
    const unsigned long long span = (unsigned long long)m + 1;

    for (int s = warp; s < stripes; s += WARPS) {
        const bool last = s == stripes - 1;
        const int row0 = s * STRIPE + lane * ROWS;  // a's index of this lane's first row
        int32_t A[ROWS], T[ROWS], F[ROWS];
#pragma unroll
        for (int k = 0; k < ROWS; k++) {
            A[k] = row0 + k < n ? (int32_t)a[row0 + k] : -1;  // rows past n match nothing
            T[k] = 0;  // column 0: the border
            F[k] = 0;
        }
        // chunk c holds columns 32c + 1 .. 32c + 32, lane l column 32c + l + 1
        auto fetch = [&](int c, int32_t& ct, int32_t& cfb) {
            if (WARPS > 1 && s > 0 && 32 * c < m) {
                const unsigned long long need = (unsigned long long)s * span + min(32 * c + 32, m);
                Progress above(progress[(s - 1) % WARPS]);
                while (above.load(cuda::memory_order_acquire) < need) __nanosleep(32);
            }
            const int j = 32 * c + lane + 1;
            if (j <= m) {
                if (s == 0) {
                    ct = 0;
                    cfb = b[j - 1];
                } else {
                    const int2 v = row[j - 1];
                    ct = v.x;
                    cfb = v.y;
                }
            }
        };
        auto publish = [&](int cols) {
            Progress(progress[warp]).store((unsigned long long)(s + 1) * span + cols, cuda::memory_order_release);
        };
        int32_t ct = 0, cfb = 0, nt = 0, nfb = 0;  // this chunk, the next one
        fetch(0, ct, cfb);
        fetch(1, nt, nfb);
        int32_t dt = 0, df = 0;          // the row above at column j - 1 (column 0: the border)
        int32_t bot_t = 0, bot_fb = 0;   // this lane's bottom row at its last column
        for (int t = 1; t <= m + 31; t++) {
            const int q = (t - 1) & 31;
            if (q == 0 && t > 1) {
                ct = nt;
                cfb = nfb;
                fetch(((t - 1) >> 5) + 1, nt, nfb);
            }
            int32_t ut = __shfl_up_sync(FULL, bot_t, 1);
            int32_t ufb = __shfl_up_sync(FULL, bot_fb, 1);
            const int32_t zt = __shfl_sync(FULL, ct, q);
            const int32_t zfb = __shfl_sync(FULL, cfb, q);
            if (lane == 0) {
                ut = zt;
                ufb = zfb;
            }
            const int j = t - lane;
            if (j >= 1 && j <= m) {
                const int32_t bj = ufb & 0xff;
                int32_t uf = ufb >> 8;
                int32_t ddt = dt, ddf = df;  // diagonal of the top row
                dt = ut;
                df = uf;
#pragma unroll
                for (int k = 0; k < ROWS; k++) {
                    const int32_t lt = T[k], lf = F[k];
                    const bool e = A[k] == bj;
                    const int32_t dd = ddt + (e ? DIAG_MATCH : DIAG_MIS);
                    const int32_t nx = __vimax3_s32(dd, lt, ut);
                    const bool pd = dd == nx, pu = !pd && ut == nx;
                    const int32_t nf = pu ? uf : (pd ? ddf + (int32_t)e : lf);
                    T[k] = nx;
                    F[k] = nf;
                    ddt = lt;
                    ddf = lf;
                    ut = nx;
                    uf = nf;
                }
                bot_t = T[ROWS - 1];
                bot_fb = (F[ROWS - 1] << 8) | bj;
                if (lane == 31 && !last) row[j - 1] = make_int2(bot_t, bot_fb);
            }
            if (WARPS > 1 && !last && lane == 31 && t % PUBLISH == 0 && t > 31) publish(min(t - 31, m));
        }
        if (WARPS > 1 && !last && lane == 31) publish(m);
        if (last && row0 < n && n <= row0 + ROWS) {
            int32_t r = F[0];
#pragma unroll
            for (int k = 1; k < ROWS; k++)
                if (row0 + k == n - 1) r = F[k];
            out[p] = r;
        }
        __syncwarp();  // one warp's next stripe reads what its lane 31 wrote
    }
}

}  // namespace

// One launch: block b works on pair order[b] with the boundary row
// bnd[b * bnd_stride, b * bnd_stride + m) of int2 (score, count << 8 | code).
extern "C" int nw_matches_launch(const void* seq, const void* off, const void* order, int n_pairs,
                                 void* out, void* bnd, int64_t bnd_stride, void* stream)
{
    nw_matches_kernel<<<n_pairs, 32 * WARPS, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)seq, (const int64_t*)off, (const int32_t*)order, (int32_t*)out, (int2*)bnd,
        bnd_stride);
    return (int)cudaGetLastError();
}

// The kernel's geometry: rows of a stripe and warps of a block.
extern "C" void nw_geometry(int* stripe_rows, int* warps)
{
    *stripe_rows = STRIPE;
    *warps = WARPS;
}
