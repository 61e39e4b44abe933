"""K8's design trials on one GPU, and the card's random-sector rate.

    python -m mindthegap_tpu_torch.plane_trials --prev DIR [--json FILE]

Copies of csrc/scan_planes.cu are made at run time from the committed
source by the text substitutions below (each must match the source once),
built with nvcc -Xptxas -v into `_build/trials/`, all at once, and timed in
turns with the committed K8 and DIR's (an earlier checkout, as for
kernel_bench's --prev) on kernel_bench's plane window (2^22 bases of a
seeded genome of E. coli's length over the cuckoo map of its k = 31 set),
each called through its C launcher into preallocated planes:

  - "cp.async staging": each tile's bases copied by cp.async an
    iteration before they are needed, where K8 loads them before the
    iteration's first barrier;
  - "no stores": the seven planes folded into one store that is never
    taken (timed only: what the stores cost);
  - "bulk stores": a whole tile's planes written to shared memory (where
    the planes are 16-byte aligned), then sent by seven TMA bulk copies
    (cp.async.bulk) that one thread issues;
  - "smem stores": the same tile in shared memory, sent by the block's
    threads in coalesced 16-byte stores.

The copies that write the planes must equal the plain version. Then the
random-sector yardstick: torch.index_select and a hand gather with 1, 2,
4 and 8 loads in flight a thread, of 2^22, K8's and 2^24 random rows of a
128 MB int64 table (a row a 32-byte sector), in sectors a second; and K8's
least time at the best of those rates: the larger of its probes at that
rate and its bytes (inputs and planes) at 3.35 TB/s. Prints the card, one
line a part and, last, one JSON object. Exits non-zero without a CUDA
device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

from ._build import BUILD_DIR, CSRC_DIR, CUDA_ARCH_FLAGS, BuildError, nvcc_path, parse_ptxas
from .bounds import PLANE_BYTES_PER_POSITION, SECTOR_BYTES, bytes_ms, plane_scan_sectors
from .device import cuda_ms, stage_ms
from .find import scan_device as S
from .kernel_bench import GENOME_LEN, _turns, plane_window
from .ops import extmap as X
from .ops import kmers as K

TRIAL_DIR = os.path.join(BUILD_DIR, "trials")

CP_ASYNC_STAGING = [
    ("__global__ void __launch_bounds__(THREADS) scan_planes_q_kernel(", """struct RawTile {
    uint4 code[Q_CHUNKS];
    uint2 bad[Q_CHUNKS];
};

__device__ __forceinline__ bool inside(int64_t q, int64_t w, bool aligned) {
    return aligned && q >= 0 && q + 64 <= w;
}

__device__ __forceinline__ void prefetch_tile(const uint8_t* __restrict__ packed, const uint8_t* __restrict__ bad,
                                              int64_t w, int64_t b0, bool aligned, RawTile& raw) {
    const int c = threadIdx.x;
    if (c >= Q_CHUNKS) return;
    const int64_t q = b0 + 64 * (int64_t)c;
    if (inside(q, w, aligned)) {
        const unsigned sc = (unsigned)__cvta_generic_to_shared(&raw.code[c]);
        const unsigned sb = (unsigned)__cvta_generic_to_shared(&raw.bad[c]);
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\\n" ::"r"(sc), "l"(packed + q / 4) : "memory");
        asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\\n" ::"r"(sb), "l"(bad + q / 8) : "memory");
    }
    asm volatile("cp.async.commit_group;\\n" ::: "memory");
}

__device__ __forceinline__ void land_tile(const uint8_t* __restrict__ packed, const uint8_t* __restrict__ bad,
                                          int64_t w, int64_t b0, bool aligned, const RawTile& raw,
                                          uint32_t* s_code, uint32_t* s_bad) {
    const int c = threadIdx.x;
    if (c >= Q_CHUNKS) return;
    asm volatile("cp.async.wait_group 0;\\n" ::: "memory");
    const int64_t q = b0 + 64 * (int64_t)c;
    uint32_t cw[4], bw[2];
    if (inside(q, w, aligned)) {
        const uint4 cv = raw.code[c];
        const uint2 bv = raw.bad[c];
        cw[0] = cv.x, cw[1] = cv.y, cw[2] = cv.z, cw[3] = cv.w;
        bw[0] = bv.x, bw[1] = bv.y;
    } else {
        for (int i = 0; i < 4; i++) {
            uint32_t v = 0;
            for (int j = 0; j < 4; j++) {
                const int64_t byte = q / 4 + 4 * i + j;
                v |= (uint32_t)(byte >= 0 && byte < w / 4 ? packed[byte] : 0) << (8 * j);
            }
            cw[i] = v;
        }
        for (int i = 0; i < 2; i++) {
            uint32_t v = 0;
            for (int j = 0; j < 4; j++) {
                const int64_t byte = q / 8 + 4 * i + j;
                v |= (uint32_t)(byte >= 0 && byte < w / 8 ? bad[byte] : 0xFF) << (8 * j);
            }
            bw[i] = v;
        }
    }
    for (int i = 0; i < 2; i++) bw[i] = __byte_perm(__brev(bw[i]), 0, 0x0123);
    for (int i = 0; i < 4; i++) {
        const uint32_t m = spread16((bw[i >> 1] >> (16 * (i & 1))) & 0xFFFFu);
        s_code[4 * c + i] = cw[i] & ~(m | (m << 1));
    }
    s_bad[2 * c] = bw[0];
    s_bad[2 * c + 1] = bw[1];
}

__global__ void __launch_bounds__(THREADS) scan_planes_q_kernel("""),
    ("""    __shared__ uint32_t s_code[3][4 * Q_CHUNKS], s_bad[3][2 * Q_CHUNKS];  // a ring of three tiles' bases
""", """    __shared__ uint32_t s_code[3][4 * Q_CHUNKS], s_bad[3][2 * Q_CHUNKS];  // a ring of three tiles' bases
    __shared__ __align__(16) RawTile s_raw[2];
"""),
    ("""    stage(packed, bad, w, t * Q_TPOS, Q_CHUNKS, aligned, s_code[0], s_bad[0]);
""", """    stage(packed, bad, w, t * Q_TPOS, Q_CHUNKS, aligned, s_code[0], s_bad[0]);
    if (t + g < n_tiles) prefetch_tile(packed, bad, w, (t + g) * Q_TPOS, aligned, s_raw[0]);
"""),
    ("""        if (more) stage(packed, bad, w, tn * Q_TPOS, Q_CHUNKS, aligned, s_code[rn], s_bad[rn]);
""", """        if (more) {
            land_tile(packed, bad, w, tn * Q_TPOS, aligned, s_raw[it & 1], s_code[rn], s_bad[rn]);
            if (tn + g < n_tiles) prefetch_tile(packed, bad, w, (tn + g) * Q_TPOS, aligned, s_raw[(it + 1) & 1]);
        }
"""),
]

NO_STORES = [("""    put<R>(o.fwd, i0, fwd, n, vec);
    put<R>(o.valid, i0, valid, n, vec);
    put<R>(o.contains, i0, contains, n, vec);
    put<R>(o.nb_in, i0, nbi, n, vec);
    put<R>(o.nb_out, i0, nbo, n, vec);
    put<R>(o.suffix_rep, i0, srep, n, vec);
    put<R>(o.prefix_rep, i0, prep, n, vec);
""", """    u64 x = 0;
#pragma unroll
    for (int e = 0; e < R; e++)
        x ^= fwd[e] ^ ((u64)valid[e] << 1) ^ ((u64)contains[e] << 2) ^ ((u64)srep[e] << 3) ^ ((u64)prep[e] << 4)
           ^ ((u64)(unsigned)nbi[e] << 8) ^ ((u64)(unsigned)nbo[e] << 16);
    if (x == 0x5A5A5A5A5A5A5A5Aull) o.fwd[i0] = (long long)n;
""")]

# a whole tile's planes staged in shared memory (PlaneTile), then sent by SEND
PLANE_TILE = [
    ("__global__ void __launch_bounds__(THREADS) scan_planes_q_kernel(", """struct PlaneTile {
    long long fwd[Q_TPOS];
    int32_t nb_in[Q_TPOS], nb_out[Q_TPOS];
    uint8_t bytes[4][Q_TPOS];  // valid, contains, suffix_rep, prefix_rep
};

__device__ __forceinline__ void bulk_store(void* g, const void* s, unsigned bytes) {
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\\n"
                 ::"l"(g), "r"((unsigned)__cvta_generic_to_shared(s)), "r"(bytes) : "memory");
}

__global__ void __launch_bounds__(THREADS) scan_planes_q_kernel("""),
    ("""    __shared__ unsigned s_v[qmap::MAX_STASH];

    const int tid = threadIdx.x, rel0 = Q_R * tid;""", """    __shared__ unsigned s_v[qmap::MAX_STASH];
    __shared__ __align__(128) PlaneTile s_pl;

    const int tid = threadIdx.x, rel0 = Q_R * tid;"""),
]


def _through_shared(send: str) -> list:
    return PLANE_TILE + [("""        write_planes<Q_R>(s_code[rb], s_bad[rb], rel0, t * Q_TPOS + rel0, opay, k, n_pos, o, vec);
""", """        if (vec && (t + 1) * Q_TPOS <= n_pos) {
            const PlaneOut so = {s_pl.fwd, s_pl.bytes[0], s_pl.bytes[1], s_pl.nb_in, s_pl.nb_out, s_pl.bytes[2],
                                 s_pl.bytes[3]};
            write_planes<Q_R>(s_code[rb], s_bad[rb], rel0, rel0, opay, k, Q_TPOS, so, true);
            const int64_t p0 = t * Q_TPOS;
            uint8_t* const bytes[4] = {o.valid, o.contains, o.suffix_rep, o.prefix_rep};
""" + send + """        } else {
            write_planes<Q_R>(s_code[rb], s_bad[rb], rel0, t * Q_TPOS + rel0, opay, k, n_pos, o, vec);
        }
""")]


BULK_STORES = _through_shared("""            asm volatile("fence.proxy.async.shared::cta;\\n" ::: "memory");
            __syncthreads();
            if (tid == 0) {
                bulk_store(o.fwd + p0, s_pl.fwd, 8 * Q_TPOS);
                bulk_store(o.nb_in + p0, s_pl.nb_in, 4 * Q_TPOS);
                bulk_store(o.nb_out + p0, s_pl.nb_out, 4 * Q_TPOS);
                for (int b = 0; b < 4; b++) bulk_store(bytes[b] + p0, s_pl.bytes[b], Q_TPOS);
                asm volatile("cp.async.bulk.commit_group;\\n" ::: "memory");
            }
""") + [("""        __syncthreads();  // this tile's payloads complete""",
         """        if (tid == 0) asm volatile("cp.async.bulk.wait_group.read 0;\\n" ::: "memory");
        __syncthreads();  // this tile's payloads complete"""),
        ("""                      &s_n[pn]);
    }
}
""", """                      &s_n[pn]);
    }
    if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;\\n" ::: "memory");
}
""")]

SMEM_STORES = _through_shared("""            __syncthreads();
            for (int j = tid; j < Q_TPOS / 2; j += THREADS)
                reinterpret_cast<uint4*>(o.fwd + p0)[j] = reinterpret_cast<const uint4*>(s_pl.fwd)[j];
            reinterpret_cast<uint4*>(o.nb_in + p0)[tid] = reinterpret_cast<const uint4*>(s_pl.nb_in)[tid];
            reinterpret_cast<uint4*>(o.nb_out + p0)[tid] = reinterpret_cast<const uint4*>(s_pl.nb_out)[tid];
            if (tid < 4 * Q_TPOS / 16)
                reinterpret_cast<uint4*>(bytes[tid / 64] + p0)[tid % 64] =
                    reinterpret_cast<const uint4*>(s_pl.bytes[tid / 64])[tid % 64];
""")

VARIANTS = {"cp.async staging": CP_ASYNC_STAGING, "no stores": NO_STORES, "bulk stores": BULK_STORES,
            "smem stores": SMEM_STORES}
TIMED_ONLY = ("no stores",)

# a gather of n random rows, L loads in flight a thread, one word out a thread
GATHER = r"""
#include <cstdint>
#include <cuda_runtime.h>
template <int L>
__global__ void gather(const unsigned long long* __restrict__ t, const long long* __restrict__ idx, long long n,
                       unsigned long long* __restrict__ out) {
    const long long stride = (long long)gridDim.x * blockDim.x;
    const long long i0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    unsigned long long v[L], acc = 0;
#pragma unroll
    for (int e = 0; e < L; e++) {
        const long long i = i0 + e * stride;
        v[e] = i < n ? __ldg(t + idx[i]) : 0;
    }
#pragma unroll
    for (int e = 0; e < L; e++) acc += v[e];
    out[i0] = acc;
}
template <int L>
void go(const void* t, const void* idx, long long n, void* out, cudaStream_t s) {
    const long long per = 256LL * L;
    gather<L><<<(unsigned)((n + per - 1) / per), 256, 0, s>>>(
        (const unsigned long long*)t, (const long long*)idx, n, (unsigned long long*)out);
}
extern "C" int gather_launch(const void* t, const void* idx, long long n, void* out, int L, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (L == 1) go<1>(t, idx, n, out, s);
    else if (L == 2) go<2>(t, idx, n, out, s);
    else if (L == 4) go<4>(t, idx, n, out, s);
    else if (L == 8) go<8>(t, idx, n, out, s);
    else return (int)cudaErrorInvalidValue;
    return (int)cudaGetLastError();
}
"""


def substituted(src: str, pairs) -> str:
    """src with each (old, new) of pairs replaced; old must occur once."""
    for old, new in pairs:
        if src.count(old) != 1:
            raise ValueError(f"a trial's text does not occur once in the source: {old[:70]!r}")
        src = src.replace(old, new)
    return src


def build_trials(prev_csrc: str) -> dict:
    """The committed K8, the earlier one (prev_csrc/scan_planes.cu), each
    copy of VARIANTS and the gather, built at once: {name: (library,
    [(kernel, registers, spill bytes)])}."""
    os.makedirs(TRIAL_DIR, exist_ok=True)
    with open(os.path.join(CSRC_DIR, "scan_planes.cu")) as f:
        src = f.read()
    with open(os.path.join(prev_csrc, "scan_planes.cu")) as f:
        prev = f.read()
    texts = {"K8": (src, CSRC_DIR), "earlier K8": (prev, prev_csrc),
             **{name: (substituted(src, pairs), CSRC_DIR) for name, pairs in VARIANTS.items()},
             "gather": (GATHER, CSRC_DIR)}
    procs = {}
    for i, (name, (text, include)) in enumerate(texts.items()):
        path, lib = os.path.join(TRIAL_DIR, f"trial{i}.cu"), os.path.join(TRIAL_DIR, f"libtrial{i}.so")
        with open(path, "w") as f:
            f.write(text)
        cmd = [nvcc_path(), *CUDA_ARCH_FLAGS, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
               "-I", include, "-o", lib, path]
        procs[name] = (cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    built = {}
    for name, (cmd, proc, lib) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise BuildError(f"build of {name} failed: {' '.join(cmd)}\n{log}")
        built[name] = (ctypes.CDLL(lib), parse_ptxas(log))
    return built


def _plane_launcher(lib):
    fn = lib.scan_planes_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, *[ctypes.c_void_p] * 7,
                   ctypes.c_void_p]
    return fn


def random_sector_rates(gather_lib, row_counts, seed: int, table_mb: int = 128) -> list[dict]:
    """torch.index_select and the hand gather at 1, 2, 4 and 8 loads in
    flight a thread, of each count of random rows of a table_mb MB int64
    table, three times each: [{"rows", "ms": {way: [ms a run]},
    "g_sectors_per_s": {way: at its best run}}]."""
    fn = gather_lib.gather_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    table = torch.randint(-(1 << 62), 1 << 62, (table_mb << 17,), dtype=torch.int64, device="cuda", generator=gen)
    stream = torch.cuda.current_stream().cuda_stream
    out = []
    for n in row_counts:
        idx = torch.randint(0, table.numel(), (n,), device="cuda", generator=gen)
        dst = torch.empty(n, dtype=torch.int64, device="cuda")

        def gather(loads):
            if fn(table.data_ptr(), idx.data_ptr(), n, dst.data_ptr(), loads, stream):
                raise RuntimeError("the gather did not launch")

        ways = {"index_select": lambda: torch.index_select(table, 0, idx),
                **{f"gather {loads}": (lambda loads=loads: gather(loads)) for loads in (1, 2, 4, 8)}}
        ms = {way: [cuda_ms(f, 20) for _ in range(3)] for way, f in ways.items()}
        out.append({"rows": n, "ms": ms, "g_sectors_per_s": {way: n / min(t) / 1e6 for way, t in ms.items()}})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--prev", required=True, help="directory of an earlier checkout (as kernel_bench's --prev)")
    ap.add_argument("--json", help="also write the JSON record to this file")
    ap.add_argument("--seed", type=int, default=20261016)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("plane_trials: no CUDA device is available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    built = build_trials(os.path.join(args.prev, "mindthegap_tpu_torch", "csrc"))
    registers = {name: [(kernel[-40:], regs, spill) for kernel, regs, spill in usage]
                 for name, (_, usage) in built.items()}
    print("registers (spill bytes): " + "; ".join(
        f"{name}: " + ", ".join(f"{kernel} {regs} ({spill})" for kernel, regs, spill in usage)
        for name, usage in registers.items()))

    # kernel_bench's plane window: the same draws as its planes stage
    rng = np.random.default_rng(args.seed)
    k = 31
    genome = rng.integers(0, 4, GENOME_LEN, dtype=np.uint8)
    fwd, _ = K.kmers_from_codes(genome, k)
    solid = np.unique(K.canonical_u64(fwd, k))
    packed, bad, repeat = plane_window(genome, k, args.seed + 2)
    window = packed.numel() * 4
    qm = X.build_fused(solid, k, repeat)
    tm = qm.to("cuda")
    want = S._scan_planes_q_plain(packed, bad, tm.slots, tm.stash_keys, tm.stash_payload, qm.log_size, k)
    planes = {key: torch.empty_like(want[key]) for key in S.PLANE_KEYS}
    stream = torch.cuda.current_stream().cuda_stream

    def runner(lib):
        fn = _plane_launcher(lib)

        def run():
            if fn(packed.data_ptr(), bad.data_ptr(), window, tm.slots.data_ptr(), qm.log_size, 0,
                  tm.stash_keys.data_ptr(), tm.stash_payload.data_ptr(), tm.stash_keys.numel(), k,
                  *(planes[key].data_ptr() for key in S.PLANE_KEYS), stream):
                raise RuntimeError("a K8 copy did not launch")
        return run

    runs = {name: runner(lib) for name, (lib, _) in built.items() if name != "gather"}
    for name, run in runs.items():
        for plane in planes.values():
            plane.zero_()
        run()
        torch.cuda.synchronize()
        if name not in TIMED_ONLY and not all(torch.equal(planes[key], want[key]) for key in S.PLANE_KEYS):
            raise AssertionError(f"{name} differs from the plain version")
    sectors = plane_scan_sectors(packed, bad, tm, k)
    n_pos = window - k + 1
    record = {"device": smi, "registers": registers, "window": window, "sectors": sectors,
              "ms": _turns(runs, 20, rounds=2),
              "stages_ms": {name: stage_ms(runs[name], 10) for name in ("earlier K8", "K8")}}
    print(f"K8 copies on kernel_bench's {window}-base window ({sectors} probe sectors), into preallocated planes, "
          f"in turns twice (ms): {record['ms']}; by launch (torch.profiler) {record['stages_ms']}")

    yard = random_sector_rates(built["gather"][0], (1 << 22, sectors, 1 << 24), args.seed)
    best = max(rate for row in yard for rate in row["g_sectors_per_s"].values())
    record["random_sectors"] = yard
    record["k8_least_ms"] = max(sectors / best / 1e6,
                                bytes_ms(packed.numel() + bad.numel() + PLANE_BYTES_PER_POSITION * n_pos))
    record["k8_probe_bytes_ms"] = bytes_ms(sectors * SECTOR_BYTES)
    for row in yard:
        print(f"random-sector yardstick, {row['rows']} random rows of a 128 MB int64 table (ms, G sectors/s): "
              + ", ".join(f"{way} {row['ms'][way]} {row['g_sectors_per_s'][way]:.2f}" for way in row["ms"]))
    print(f"best rate {best:.2f} G sectors/s: K8's least time at it {record['k8_least_ms']:.4f} ms (its probes "
          f"{sectors / best / 1e6:.4f} ms; its bytes at 3.35 TB/s "
          f"{bytes_ms(packed.numel() + bad.numel() + PLANE_BYTES_PER_POSITION * n_pos):.4f} ms)")
    line = json.dumps(record)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
