"""Entry points of the port (the counterparts of the repository's
__graft_entry__.py, which drives the JAX package).

- entry(): one forward step of the find scan's plane pass (the |ref| x 11
  probe loop of the reference, src/FindBreakpoints.hpp:560-622) on a
  seeded window over sorted sets: the function and its tensors, on the
  card unless the caller asks for the CPU.
- dryrun_multichip(n): one full mesh step over n shards (distributed
  counting, the window-sharded scan, the job-sharded walk and sharded
  membership, parallel/mesh.py pipeline_step), with every output held to a
  single-shard or plain computation of the same values.

    python -m mindthegap_tpu_torch.graft_entry
"""

from __future__ import annotations

import numpy as np
import torch


def entry(device="cuda"):
    """(fn, (codes, solid, repeat)): fn is scan_planes_sorted at k = 31
    (kernel K14 on CUDA) over a 2^14-base window and sets of 2^16 and 2^10
    sorted keys, made from a seed; the tensors lie on `device`. The sets'
    bucket indexes are built here, once: fn passes them on while it is
    given these very sets, unmodified, and builds other sets' in the call."""
    from .find.scan_device import scan_planes_sorted, set_indexes
    from .ops import kmers as K

    k = 31
    rng = np.random.default_rng(0)
    window = 1 << 14
    codes = rng.integers(0, 4, size=window, dtype=np.uint8)
    solid = np.sort(rng.integers(0, 1 << 62, size=1 << 16, dtype=np.uint64))
    repeat = np.sort(rng.integers(0, 1 << 60, size=1 << 10, dtype=np.uint64))
    args = tuple(torch.from_numpy(a).to(device) for a in (codes, K.as_i64(solid), K.as_i64(repeat)))
    sets = args[1:]
    versions = tuple(t._version for t in sets)
    indexes = set_indexes(*sets)

    def fn(codes, solid, repeat):
        own = solid is sets[0] and repeat is sets[1] and (solid._version, repeat._version) == versions
        return scan_planes_sorted(codes, solid, repeat, k, indexes if own else None)

    return fn, args


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """pipeline_step on a mesh of n_devices (make_mesh of `device`; inside
    parallel/mesh.py logical_devices, logical shards), asserting values:
    the runs and histogram equal a count on one shard and a plain numpy
    count, pay8/rep8 equal one unsharded scan_pay_qp pass of each window,
    the walk equals walk_batch on one shard, and the membership
    (pipeline_step's own check) equals np.isin."""
    from .find.scan_device import pack_codes_host, scan_pay_qp
    from .fill.walk_device import walk_batch
    from .ops import extmap as X
    from .ops import kmers as K
    from .parallel import mesh as M

    k = 21
    rng = np.random.default_rng(0)
    mesh = M.make_mesh(device, n_devices)
    assert len(mesh) == n_devices, f"a mesh of {n_devices} shards needs as many devices, found {len(mesh)}"

    # tiny read batch, rows divisible across devices
    reads = rng.integers(0, 4, size=(n_devices * 4, 64), dtype=np.uint8)
    # tiny window set with halos
    windows = rng.integers(0, 4, size=(n_devices, 256), dtype=np.uint8)
    solid = np.sort(rng.integers(0, 1 << 40, size=1 << 12, dtype=np.uint64))
    repeat = np.sort(rng.integers(0, 1 << 38, size=1 << 8, dtype=np.uint64))

    runs, ghist, planes, walk = M.pipeline_step(mesh, reads, windows, solid, repeat, k)

    # counting: the owners' runs hold every k-mer of the reads once per
    # occurrence, and the histogram is the plain count's
    fwd = np.concatenate([K.kmers_from_codes(r, k)[0] for r in reads])
    canon = K.canonical_u64(fwd, k)
    _, counts = np.unique(canon, return_counts=True)
    want = np.bincount(np.minimum(counts, 10000), minlength=10001)
    want[0] = 0
    one_runs, one_hist = M.distributed_count_step(mesh[:1], reads, k)
    assert np.array_equal(ghist, want) and np.array_equal(one_hist, want), "histogram differs from the plain count"
    for r in (runs, one_runs):
        assert np.array_equal(np.sort(r[r != np.uint64(0xFFFFFFFFFFFFFFFF)]), np.sort(canon)), "runs differ"

    # the sharded scan: each window's stream equals one unsharded pass
    dev = mesh[0]
    t = X.build_fused_pair(solid, k, repeat).to(dev)
    for j in range(n_devices):
        packed, bad = (torch.from_numpy(a).to(dev) for a in pack_codes_host(windows[j]))
        one = scan_pay_qp(packed, bad, t.slots, t.stash_keys, t.stash_l, t.stash_r, t.log_size, k)
        for key in ("pay8", "rep8"):
            assert np.array_equal(planes[key][j], one[key].cpu().numpy()), f"{key} of window {j}"
    assert planes["pay8"].shape == (n_devices, 256 - k + 2)

    # the job-sharded walk equals the walk on one shard
    q = X.build_fused(solid, k, repeat).to(dev)
    nodes = solid[: 2 * n_devices]
    one = walk_batch(torch.from_numpy(K.as_i64(nodes)).to(dev),
                     torch.full((nodes.size,), 32, dtype=torch.int32, device=dev),
                     q.slots, q.stash_keys, q.stash_payload, q.log_size, k, 16)
    bases, n_app, end_nodes, status = walk
    assert bases.shape == (2 * n_devices, 16) and status.shape == (2 * n_devices,)
    for got, ref in zip((bases, n_app, K.as_i64(end_nodes), status), one):
        assert np.array_equal(got, ref.cpu().numpy()), "the sharded walk differs from one shard's"


if __name__ == "__main__":
    fn, args = entry()
    out = fn(*args)
    print("entry ok:", {key: tuple(v.shape) for key, v in out.items()})
    n = torch.cuda.device_count()
    dryrun_multichip(1 << (n.bit_length() - 1))
    print("dryrun_multichip ok")
