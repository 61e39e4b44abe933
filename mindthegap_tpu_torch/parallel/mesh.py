"""The device mesh: the window-sharded scan, distributed counting and the
job-sharded walk (the counterpart of mindthegap_tpu/parallel/mesh.py).

A mesh is a list of torch.devices, one per shard. The CLI lays it over
every visible CUDA device, or over the CPU under `-device cpu`; in a run
across processes (parallel/distributed.py) over the rank's own card, and
the sharded engines place that block in the global mesh (`GlobalMesh`):
each rank runs its block's shards and the results cross ranks on the
host (`_LazyAllgather`, the counter's exchange). A list may
repeat one device: N logical shards of it, as the JAX tests' virtual CPU
devices are. Tests and chip_smoke.py ask for that through
`logical_devices`, the counterpart of the process-wide device list that
the JAX package's meshes read: every mesh made inside that block is laid
over the given list.

The JAX package runs a shard_map program over a jax.sharding.Mesh and
moves data with all_to_all and psum. Here each shard's work is launched on
its own device (the window scans on a stream of their own), the exchanges
are copies of fixed-capacity send buffers between the shards, and the
reductions are sums on the host. Every device of the mesh holds its own
copy of a replicated table (logical shards of one device share it).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..ops import kmers as K
from . import distributed as D
from .distributed import GlobalMesh

_LOGICAL: list | None = None


@contextlib.contextmanager
def logical_devices(devices):
    """Lay every mesh made inside the block over `devices` (a list that may
    repeat one device: N logical shards of it)."""
    global _LOGICAL
    saved, _LOGICAL = _LOGICAL, [torch.device(d) for d in devices]
    try:
        yield
    finally:
        _LOGICAL = saved


def make_mesh(device, n_devices: int | None = None) -> list[torch.device]:
    """The first n_devices (default all) of the devices a run on `device`
    sees: every visible CUDA device, or, in a run across processes, the
    rank's own card (the current device, which init_distributed sets); or
    the CPU; inside logical_devices, its list. It is also the
    window-sharded scan's mesh (the JAX package's scan_mesh, which only
    clamps its virtual CPU devices to the cores)."""
    if _LOGICAL is not None:
        devs = list(_LOGICAL)
    elif torch.device(device).type == "cuda" and D.process_count() > 1:
        devs = [torch.device("cuda", torch.cuda.current_device())]
    elif torch.device(device).type == "cuda":
        devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        devs = [torch.device("cpu")]
    return devs[: n_devices or len(devs)]


def pow2_mesh(mesh: list) -> list:
    """The largest power-of-two prefix of a mesh (the counter's and the
    walker's owner routing needs a power of two)."""
    return mesh[: 1 << (len(mesh).bit_length() - 1)]


def per_device(mesh: list, make) -> list:
    """make(device) once per distinct device of the mesh, one entry a shard."""
    made = {}
    return [made[d] if d in made else made.setdefault(d, make(d)) for d in mesh]


class _LazyStack:
    """Per-shard results on their way to the host, presented as one stacked
    array: indexing waits for that shard's copy only, np.asarray for all.
    Until then every shard's work stays in flight (the caller materializes
    group g-1 while group g computes)."""

    def __init__(self, parts, events):
        self.parts = parts
        self.events = events

    def __getitem__(self, i):
        if self.events[i] is not None:
            self.events[i].synchronize()
        return self.parts[i].numpy()

    def __array__(self, dtype=None, copy=None):
        a = np.stack([self[i] for i in range(len(self.parts))])
        return a.astype(dtype) if dtype is not None else a


class _LazyAllgather:
    """The sibling of _LazyStack in a run across processes: this rank's
    shards stay in flight until the first index or np.asarray, which waits
    for them and gathers every rank's block, in rank order, into the global
    stack (so the gather of group g-1 overlaps group g's compute). A
    collective: every rank materializes the same keys in the same order,
    which the shared feed loop guarantees."""

    def __init__(self, local: _LazyStack):
        self.local = local
        self._all = None

    def __array__(self, dtype=None, copy=None):
        if self._all is None:
            local = torch.from_numpy(np.asarray(self.local))
            self._all = D.allgather_tensor(local).flatten(0, 1).numpy()
        return self._all.astype(dtype) if dtype is not None else self._all

    def __getitem__(self, i):
        return self.__array__()[i]


def as_global(mesh) -> GlobalMesh:
    """A mesh as a GlobalMesh: a list is the whole mesh of one process."""
    return mesh if isinstance(mesh, GlobalMesh) else GlobalMesh(list(mesh), 0, len(mesh))


def _perdev_group_dispatch(mesh, kernel, tables_on, window: int):
    """Group dispatcher of the window-sharded scans: each shard takes one
    window of a [n_shards, window] group, 2-bit packed, and runs
    kernel(packed, bad, *tables) on its device's copy of the tables
    (tables_on(device)) and on a stream of its own; returns (dispatch,
    n_shards), where dispatch(wins) returns {key: _LazyStack}. Over a
    GlobalMesh of several ranks a rank runs its block's rows and dispatch
    returns {key: _LazyAllgather}."""
    from ..find.scan_device import pack_codes_host

    gm = as_global(mesh)
    local = gm.local
    tabs = per_device(local, tables_on)
    streams = []
    for d in local:
        s = None
        if d.type == "cuda":
            s = torch.cuda.Stream(d)
            s.wait_stream(torch.cuda.current_stream(d))  # the tables' upload
        streams.append(s)

    def dispatch(wins: np.ndarray):
        assert wins.shape == (gm.size, window)
        packed, bad = pack_codes_host(wins[gm.offset : gm.offset + len(local)])
        outs, events = [], []
        for j, d in enumerate(local):
            with torch.cuda.stream(streams[j]) if streams[j] is not None else contextlib.nullcontext():
                res = kernel(torch.from_numpy(packed[j]).to(d), torch.from_numpy(bad[j]).to(d), *tabs[j])
                outs.append({key: v.to("cpu", non_blocking=d.type == "cuda") for key, v in res.items()})
                ev = None
                if streams[j] is not None:
                    ev = torch.cuda.Event()
                    ev.record(streams[j])
                events.append(ev)
        stacks = {key: _LazyStack([o[key] for o in outs], events) for key in outs[0]}
        if gm.size > len(local):
            return {key: _LazyAllgather(v) for key, v in stacks.items()}
        return stacks

    return dispatch, gm.size


def make_sharded_scan_group_qp(mesh, qp, k: int, window: int):
    """Window-sharded scanner over the pair map (k <= 32) on a mesh (a list,
    or a GlobalMesh): the map is placed once on every device; the returned
    dispatch takes a [n_shards, window] group and gives each window's dense
    payload stream (scan_pay_qp: kernel K10 on CUDA), pay8 and rep8, for
    planes_from_pay or the native automaton's payload feed."""
    from ..find.scan_device import scan_pay_qp

    def tables_on(d):
        t = qp.to(d)
        return t.slots, t.stash_keys, t.stash_l, t.stash_r

    return _perdev_group_dispatch(
        mesh, lambda packed, bad, *t: scan_pay_qp(packed, bad, *t, qp.log_size, k), tables_on, window)


def make_sharded_scan_group_span(mesh, qms, k: int, window: int):
    """Span (32 < k <= 256) sibling of make_sharded_scan_group_qp: the span
    map on every device, each window's payload bytes with packed repeat and
    strand bits (scan_pay_q_span: kernel K6 on CUDA), pay8, rep8 and str8."""
    from ..find.scan_device import scan_pay_q_span

    def tables_on(d):
        t = qms.to(d)
        return t.slots, t.sat, t.stash_key64, t.stash_sat, t.stash_payload

    return _perdev_group_dispatch(
        mesh, lambda packed, bad, *t: scan_pay_q_span(packed, bad, *t, qms.salt, qms.log_size, k),
        tables_on, window)


def _split(n_rows: int, mesh: list) -> int:
    if n_rows % len(mesh):
        raise ValueError(f"{n_rows} rows do not split over a mesh of {len(mesh)} shards")
    return n_rows // len(mesh)


def sharded_scan(mesh: list, windows: np.ndarray, solid_sorted, repeat_sorted, k: int) -> dict:
    """The find-scan plane pass over [n_windows, W] windows (each with its
    k-1 halo), the rows split over the mesh in contiguous blocks, the sorted
    sets and their bucket indexes placed once on every device
    (scan_planes_sorted: kernel K14 on CUDA). Returns the stacked planes on
    the host, fwd as uint64."""
    from ..find.scan_device import PLANE_KEYS, scan_planes_sorted, set_indexes

    per = _split(windows.shape[0], mesh)

    def place(d):
        solid, repeat = (torch.from_numpy(K.as_i64(a)).to(d) for a in (solid_sorted, repeat_sorted))
        return solid, repeat, set_indexes(solid, repeat)

    sets = per_device(mesh, place)
    outs = []
    for i, w in enumerate(windows):
        solid, repeat, indexes = sets[i // per]
        outs.append(scan_planes_sorted(torch.from_numpy(np.ascontiguousarray(w)).to(mesh[i // per]),
                                       solid, repeat, k, indexes))
    planes = {key: np.stack([o[key].cpu().numpy() for o in outs]) for key in PLANE_KEYS}
    planes["fwd"] = planes["fwd"].view(np.uint64)
    return planes


BIASED_SENTINEL = (1 << 63) - 1  # the all-ones SENTINEL XOR 2^63


def owner_segments(swz: torch.Tensor, vals, n: int, cap: int):
    """The fixed-capacity send buffers of one shard: `swz`, the sorted biased
    swizzles (kernel K11's XOR 2^63; the SENTINEL, INT64_MAX, last), names
    each key's owner by its top log2(n) bits. `vals` are (tensor in swz
    order, its padding value) pairs. Returns ([n, cap] buffers of each,
    padded; whether an owner has more than cap keys, as a 0-d tensor)."""
    log_n = n.bit_length() - 1
    dev = swz.device
    bounds = torch.tensor([K.i64((i << (64 - log_n)) ^ (1 << 63)) for i in range(1, n)], dtype=torch.int64,
                          device=dev)
    starts = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev), torch.searchsorted(swz, bounds)])
    end_valid = torch.searchsorted(swz, torch.full((1,), BIASED_SENTINEL, dtype=torch.int64, device=dev))
    ends = torch.maximum(torch.cat([starts[1:], end_valid]), starts)  # owner n-1 may start past end_valid
    overflow = (ends - starts).max() > cap
    idx = starts[:, None] + torch.arange(cap, device=dev)[None, :]
    mask = idx < ends[:, None]
    idx = idx.clamp(max=swz.shape[0] - 1)
    return [torch.where(mask, v[idx], pad) for v, pad in vals], overflow


def exchange(sends: list, mesh: list) -> list:
    """The all_to_all of [n, cap] send buffers, one a shard: owner o gets
    the rows o of every shard's buffer, in shard order, flat on its device."""
    return [torch.cat([s[o].to(d) for s in sends]) for o, d in enumerate(mesh)]


def distributed_count_step(mesh: list, read_codes: np.ndarray, k: int, histo_max: int = 10000):
    """One data-parallel counting step: the read rows split over the mesh in
    contiguous blocks; each shard computes its rows' canonical k-mers and
    their swizzles (kernel K11 on CUDA, rows joined by an invalid base),
    sorts them by swizzle, sends each k-mer to the owner its swizzle's top
    bits name, and each owner sorts what it received and counts its runs.
    Ownership makes the owners' counts complete, so the sum of their
    histograms is the exact global histogram. Returns (the owners' sorted
    k-mers, [n * n * cap] uint64 padded with the all-ones SENTINEL, the
    histogram int64[histo_max + 1])."""
    from .sharded_count import pick_swizzle_const, swizzle_keys

    n = len(mesh)
    assert n & (n - 1) == 0, "mesh size must be a power of two"
    const = pick_swizzle_const(k)
    rows, read_len = read_codes.shape
    per = _split(rows, mesh)
    per_dev = per * (read_len - k + 1)
    cap = per_dev // n + max(64, per_dev // (4 * n))
    sends = []
    for j, d in enumerate(mesh):
        block = np.full((per, read_len + 1), 255, np.uint8)
        block[:, :read_len] = read_codes[j * per : (j + 1) * per]
        swz, canon = swizzle_keys(torch.from_numpy(block.reshape(-1)).to(d), k, const)
        swz, order = torch.sort(swz)
        (send,), _ = owner_segments(swz, [(canon[order], -1)], n, cap)
        sends.append(send)
    runs, hist = [], np.zeros(histo_max + 1, np.int64)
    for owned in exchange(sends, mesh):
        owned = torch.sort(owned ^ K.SIGN_BIT).values ^ K.SIGN_BIT
        keys, counts = torch.unique_consecutive(owned, return_counts=True)
        counts = counts[keys != -1].clamp(max=histo_max)
        hist += torch.bincount(counts, minlength=histo_max + 1).cpu().numpy()
        runs.append(K.as_u64(owned))
    hist[0] = 0
    return np.concatenate(runs), hist


def walk_shards(mesh: list, tables: list, nodes: np.ndarray, budgets: np.ndarray, log_size: int, k: int,
                steps: int, layout: str = "cuckoo"):
    """The walker (walk_batch: kernel K5 on CUDA) with its lanes split over
    the mesh in contiguous blocks, each shard on its device's copy of the
    map (tables, one a shard, from QMap.to or QMapB.to). nodes: int64[J]
    u64 words, budgets: int32[J], J a multiple of the mesh size. Returns
    walk_batch's four outputs, joined in lane order on the host."""
    from ..fill.walk_device import walk_batch

    per = _split(nodes.shape[0], mesh)
    outs = [walk_batch(torch.from_numpy(nodes[j * per : (j + 1) * per]).to(d),
                       torch.from_numpy(budgets[j * per : (j + 1) * per]).to(d),
                       t.slots, t.stash_keys, t.stash_payload, log_size, k, steps, layout)
            for j, (d, t) in enumerate(zip(mesh, tables))]
    return tuple(torch.cat([o[i].cpu() for o in outs]) for i in range(4))


def walk_batch_sharded(mesh: list, nodes: np.ndarray, budgets: np.ndarray, qmap, k: int, steps: int = 64):
    """Job-sharded fill walking over the cuckoo map `qmap` (QMap, host),
    replicated on the mesh; lanes must divide the mesh size. Returns numpy
    (bases, n_appended, end_nodes uint64, status)."""
    bases, n_app, end_nodes, status = walk_shards(
        mesh, per_device(mesh, qmap.to), K.as_i64(nodes), np.asarray(budgets, np.int32), qmap.log_size, k, steps)
    return bases.numpy(), n_app.numpy(), K.as_u64(end_nodes), status.numpy()


def pipeline_step(mesh: list, read_codes: np.ndarray, windows: np.ndarray, solid_sorted, repeat_sorted, k: int):
    """A full mesh step, for the dryrun: distributed counting, the
    window-sharded scan over the pair map (one [n_shards, window] group
    through the CLI's group dispatcher), the job-sharded walk over the
    cuckoo map, and sharded membership, whose verdicts on present and
    absent keys must equal np.isin. Returns (runs, histogram, {pay8, rep8}
    stacked over the group, the walk's four outputs)."""
    from ..ops import extmap as X
    from .sharded_membership import ShardedMembership

    solid = np.asarray(solid_sorted, np.uint64)
    repeat = np.asarray(repeat_sorted, np.uint64)
    runs, ghist = distributed_count_step(mesh, read_codes, k)
    qp = X.build_fused_pair(solid, k, repeat)
    dispatch, nd = make_sharded_scan_group_qp(mesh, qp, k, windows.shape[1])
    group = np.full((nd, windows.shape[1]), 255, np.uint8)
    group[: min(nd, windows.shape[0])] = windows[:nd]
    planes = {key: np.asarray(v) for key, v in dispatch(group).items()}
    nodes = solid[: 2 * nd]
    walk = walk_batch_sharded(mesh, nodes, np.full(nodes.shape, 32, np.int32), X.build_fused(solid, k, repeat), k,
                              steps=16)
    sm = ShardedMembership(mesh, solid)
    probe = np.concatenate([solid[: 4 * nd], solid[: 4 * nd] ^ np.uint64(1)])
    assert np.array_equal(sm.contains(probe), np.isin(probe, solid)), "sharded membership disagrees with np.isin"
    return runs, ghist, planes, walk
