"""Times K5 (the fill walker) and K4 (the counting merge) on one GPU against
another checkout of this repository, and sweeps K5's look-ahead depth, in
one process on the same card and inputs.

    python -m mindthegap_tpu_torch.kernel_bench --prev DIR [--json FILE]

DIR holds an earlier checkout's `mindthegap_tpu_torch/` and `native/` (for
example `git archive <commit> mindthegap_tpu_torch native | tar -x -C DIR`
into the gitignored `mindthegap_tpu_torch/_build/`). That package is
imported under another name, builds its kernels into its own `_build/`, and
is called through its own wrappers, `walk_batch_cuda` and
`merge_sorted_cuda`, whose signatures this checkout keeps. Each pair of
versions is timed in turns (earlier, current, current, earlier) by CUDA
events, and their outputs must be equal.

The inputs: a seeded random genome of 4,641,652 bp (the length of E. coli
K-12 MG1655), k = 31, its canonical k-mers as the solid set. K5 walks from
random genome k-mers over the cuckoo and the bucket map of that set, 2,048
steps with a budget of 10,000, at 1 to 65,536 lanes, and on two mostly
dead rounds (lanes with a budget of 0 issue no probe), at every look-ahead
depth the kernel takes and at the depth `lookahead_depth` picks. K4 merges
2^23 sorted k-mers sampled from both strands into an accumulator of the
solid set in 2^23 slots. Prints the card, one line per shape and, last, one
JSON object of every time. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import torch

from .device import cuda_ms
from .fill import walk_device as W
from .ops import counting_device as C
from .ops import extmap as X
from .ops import kmers as K

GENOME_LEN = 4_641_652
STEPS = 2048
BUDGET = 10_000
# (lanes, live lanes): all live from one lane to 65,536, then two rounds
# whose other lanes are done
WALK_SHAPES = tuple((n, n) for n in (1, 128, 512, 1024, 1536, 2048, 4096, 6144, 8192, 10240, 12288, 16384, 65536)) \
    + ((4096, 128), (65536, 2048))


def load_checkout(root: str, alias: str = "prev_mindthegap_tpu_torch"):
    """(walk_device, counting_device) of the `mindthegap_tpu_torch` under
    `root`, imported as `alias`."""
    pkg = os.path.join(root, "mindthegap_tpu_torch")
    spec = importlib.util.spec_from_file_location(alias, os.path.join(pkg, "__init__.py"),
                                                  submodule_search_locations=[pkg])
    sys.modules[alias] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sys.modules[alias])
    return (importlib.import_module(f"{alias}.fill.walk_device"),
            importlib.import_module(f"{alias}.ops.counting_device"))


def _in_turns(old, new, iters: int) -> tuple[list[float], list[float]]:
    turns = [cuda_ms(f, iters) for f in (old, new, new, old)]
    return [turns[0], turns[3]], [turns[1], turns[2]]


def _equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def bench_walk(rng, fwd, solid, k, prev_w):
    out = {}
    picks = fwd[rng.integers(0, fwd.size, max(lanes for lanes, _ in WALK_SHAPES))]
    for layout, build in (("cuckoo", X.build_fused), ("bucket", X.build_fused_bucket)):
        host = build(solid, k, np.zeros(0, np.uint64))
        t = host.to("cuda")
        log = host.log_nb if layout == "bucket" else host.log_size
        for lanes, live in WALK_SHAPES:
            nodes = torch.from_numpy(K.as_i64(picks[:lanes])).cuda()
            budgets = torch.zeros(lanes, dtype=torch.int32, device="cuda")
            budgets[:live] = BUDGET
            args = (nodes, budgets, t.slots, t.stash_keys, t.stash_payload, log, k, STEPS, layout)
            want = prev_w.walk_batch_cuda(*args)
            walked = int(want[1].max())
            iters = 20 if lanes <= 128 else 5
            row = {"lanes": lanes, "live": live, "steps_walked": walked,
                   "rule_depth": W.lookahead_depth(live, layout)}
            for depth in W.DEPTHS:
                if not _equal(W.walk_batch_cuda(*args, depth=depth), want):
                    raise AssertionError(f"K5 at D = {depth} differs from the earlier kernel ({layout}, {lanes} lanes)")
                row[f"d{depth}_ms"] = cuda_ms(lambda: W.walk_batch_cuda(*args, depth=depth), iters)
            row["prev_ms"], row["rule_ms"] = _in_turns(lambda: prev_w.walk_batch_cuda(*args),
                                                       lambda: W.walk_batch_cuda(*args), iters)
            print(f"K5 {layout}, {lanes} lanes ({live} live) x {STEPS} steps ({walked} walked): "
                  + ", ".join(f"D = {d} {row[f'd{d}_ms']:.4f} ms ({row[f'd{d}_ms'] * 1e3 / walked:.4f} us/step)"
                              for d in W.DEPTHS)
                  + f"; in turns, earlier {row['prev_ms']} ms, current (D = {row['rule_depth']}) {row['rule_ms']} ms")
            out[f"{layout}_{lanes}_{live}"] = row
    return out


def bench_merge(rng, fwd, solid, k, prev_c):
    cap = 1 << 23
    acc_k = torch.full((cap,), C.BIASED_SENTINEL, dtype=torch.int64)
    acc_k[: solid.size] = torch.from_numpy(K.as_i64(solid) ^ K.SIGN_BIT)
    acc_c = torch.zeros(cap, dtype=torch.int64)
    acc_c[: solid.size] = torch.from_numpy(rng.integers(1, 60, solid.size))
    sample = K.canonical_u64(fwd[rng.integers(0, fwd.size, cap - 4096)], k)
    batch = np.sort(K.as_i64(sample) ^ K.SIGN_BIT)
    batch = np.concatenate([batch, np.full(4096, C.BIASED_SENTINEL, np.int64)])
    acc_k, acc_c, b = acc_k.cuda(), acc_c.cuda(), torch.from_numpy(batch).cuda()
    want = C._merge_sorted_plain(acc_k, acc_c, b, cap)
    old = lambda: prev_c.merge_sorted_cuda(acc_k, acc_c, b, cap)  # noqa: E731
    new = lambda: C.merge_sorted_cuda(acc_k, acc_c, b, cap)  # noqa: E731
    if not (_equal(old(), want) and _equal(new(), want)):
        raise AssertionError("K4 (earlier or current) differs from its plain version")
    row = {"na": cap, "nb": cap, "n_distinct": int(want[2])}
    row["prev_ms"], row["new_ms"] = _in_turns(old, new, 10)
    print(f"K4 merge 2^23 + 2^23 ({row['n_distinct']} distinct): in turns, earlier {row['prev_ms']} ms, "
          f"current {row['new_ms']} ms")
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--prev", required=True, help="directory of an earlier checkout (see above)")
    ap.add_argument("--json", help="also write the JSON record to this file")
    ap.add_argument("--seed", type=int, default=20261016)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_bench: no CUDA device is available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    prev_w, prev_c = load_checkout(args.prev)
    rng = np.random.default_rng(args.seed)
    k = 31
    fwd, _ = K.kmers_from_codes(rng.integers(0, 4, GENOME_LEN, dtype=np.uint8), k)
    solid = np.unique(K.canonical_u64(fwd, k))
    record = {"device": smi, "walk": bench_walk(rng, fwd, solid, k, prev_w),
              "merge": bench_merge(rng, fwd, solid, k, prev_c)}
    line = json.dumps(record)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
