"""`find` module orchestration (the reference Finder tool, src/Finder.cpp).

Builds or loads the de Bruijn graph (counted on the host, or on the device
with -count-engine device: kernels K3 and K4), builds the
reference-repeat set and the scan map on the host, then scans every
reference sequence and replays it in an automaton, which writes
`<out>.breakpoints` + `<out>.othervariants.vcf`. Mode flags follow
src/Finder.cpp:320-398.

Two routes from the scan to the automaton, chosen as in the JAX package:
- the payload feed into the native automaton (native/automaton.cpp), with
  `-scan-engine auto|device-qp` (and `device` above k = 32): at k <= 32 the
  pair map and a class stream (kernel K1 on CUDA; a window with too many
  exceptions goes dense through K10); at 32 < k <= 256 the multi-word span
  map and payload bytes with strand bits (K6);
- the plane path: every window's planes (find/scan.py Planes) into the
  native automaton's scan_sequence or, under `-automaton host`, the Python
  automaton (find/automaton.py ScanContext and the observers). The planes
  come from the host oracle (`-scan-engine host`, compute_planes), from
  the cuckoo map (`device`, K8) or the bucket map (`device-qb`, K9) at
  k <= 32, from the pair map's dense stream (K10, then planes_from_pay on
  the host) for `auto|device-qp`, and at k > 32 from the span scan (K6,
  then planes_from_pay_span).
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from .. import MTG_COMPAT_VERSION, KSIZE_STRING
from ..device import resolve_device
from ..graph import dbg
from ..io.bank import Bank
from ..utils import dna
from ..utils.phases import PhaseTimer, count, span
from ..utils.progress import Progress
from ..utils.properties import Properties
from . import observers as O
from . import scan
from .automaton import FindStats, ScanContext


class FinderError(Exception):
    pass


class _StatsHolder:
    def __init__(self, stats):
        self.stats = stats


def default_output_prefix() -> str:
    return "MindTheGap_Expe-" + time.strftime("%Y-%m-%d.%I:%M")


def _stoi(s: str) -> int:
    """std::stoi semantics: parse the leading integer, ignore the rest."""
    s = s.lstrip()
    i = 0
    if i < len(s) and s[i] in "+-":
        i += 1
    j = i
    while j < len(s) and s[j].isdigit():
        j += 1
    if j == i:
        raise ValueError(f"stoi: no conversion: {s!r}")
    return int(s[:j])


def parse_bed_for_chrom(bed_path: str, chrom_name: str, k: int):
    """Collect this chromosome's intervals, in file order, keeping those
    longer than k (src/FindBreakpoints.hpp:461-490)."""
    intervals = []
    with open(bed_path) as f:
        for line in f:
            line = line.rstrip("\n")
            if len(line) == 0 or line[0] in "#@":
                continue
            v = line.split("\t")
            if v[0] == chrom_name:
                bed_begin, bed_end = _stoi(v[1]), _stoi(v[2])
                if bed_end - bed_begin > k:
                    intervals.append((bed_begin, bed_end))
    return intervals


def _scan_map_bytes_estimate(n_solid: int) -> int:
    """Projected footprint of the replicated pair-coalesced scan map: 16 B
    per slot row, power-of-two sizing at load factor 0.35 (extmap.py QMapP)."""
    import math

    n = max(int(n_solid), 1)
    return (1 << math.ceil(math.log2(n / 0.35))) * 16


# at k <= 32 `auto` and `device-qp` take the pair map, `device` the cuckoo
# map and `device-qb` the bucket map; at 32 < k <= 256 every device engine
# takes the span map, as in the JAX package; `sharded` lays the windows over
# the mesh (pair or span map), `sharded-mem` shards the solid set itself
_VALID_SCAN_ENGINES = ("auto", "host", "device", "device-qp", "device-qb", "sharded", "sharded-mem")


def _validate_scan_engine(engine: str):
    if engine not in _VALID_SCAN_ENGINES:
        raise FinderError(
            "ERROR: unknown -scan-engine %r (choose from %s)"
            % (engine, ", ".join(_VALID_SCAN_ENGINES))
        )


def _over_budget_mesh(graph, scan_memory_mb: int, mesh) -> bool:
    """True when the replicated k <= 32 scan map would exceed the per-device
    budget AND the mesh (a GlobalMesh) has more than one shard to shard
    membership over (the sharded-mem reroute). Budget: -scan-memory MB,
    else 3/4 of the smallest card of the rank's block; a mesh of the CPU
    has no default budget."""
    if scan_memory_mb > 0:
        budget = scan_memory_mb << 20
    else:
        cards = [torch.cuda.get_device_properties(d).total_memory for d in mesh.local if d.type == "cuda"]
        if not cards:
            return False
        budget = 3 * min(cards) // 4
    return _scan_map_bytes_estimate(len(graph.solid)) > budget and mesh.size > 1


def _check_table_fits(nbytes: int, devices):
    """A scan map is replicated on every device it runs on: refuse a table
    above a card's memory. A -scan-memory budget reroutes membership only on
    a mesh of more than one device (_over_budget_mesh); on one device it is
    ignored, as in the JAX package."""
    for device in devices:
        if device.type != "cuda":
            continue
        total = torch.cuda.get_device_properties(device).total_memory
        if nbytes > total:
            raise FinderError(
                f"ERROR: the scan map needs {nbytes >> 20} MB, above the {total >> 20} MB of one device "
                "(-scan-engine sharded-mem shards the solid set over a mesh of more than one device)"
            )


def _upload(part: np.ndarray, k: int, device: torch.device):
    """One window's bases, padded with invalid bases to a multiple of 8 (the
    bad-bit packing) and to at least k + 8: (packed, bad) 2-bit packed on
    `device`, and the padded row on the host."""
    from .scan_device import pack_codes_host

    wlen = max(-(-part.shape[0] // 8) * 8, -(-(k + 8) // 8) * 8)
    row = np.full(wlen, 255, np.uint8)
    row[: part.shape[0]] = part
    packed, bad = pack_codes_host(row)
    return torch.from_numpy(packed).to(device), torch.from_numpy(bad).to(device), row


def _to_host(res: dict, device: torch.device):
    """Queue the copies of a window's results behind its kernel: (the host
    tensors, the event the host waits on before reading them, or None on
    the CPU)."""
    on_cuda = device.type == "cuda"
    host = {key: v.to("cpu", non_blocking=on_cuda) for key, v in res.items()}
    done = None
    if on_cuda:
        done = torch.cuda.Event()
        done.record()
    return host, done


def _window_feed(k: int, window: int, dispatch, emit):
    """`codes -> iterator of chunks` over windows of `window` bases (halo
    k-1; the last one cut to the sequence). Window g is dispatched before
    window g-1 is emitted: CUDA launches and the device->host copies are
    asynchronous, so the device computes g while the host replays g-1.
    emit(pending, take, last) gets what dispatch returned, the window's
    number of positions of the sequence and whether it is the last one
    (whose take + 1 payload entries end the sequence's npos + 1)."""
    step = window - (k - 1)

    def feed(codes):
        npos = codes.shape[0] - k + 1
        if npos <= 0:
            return
        nwin = -(-npos // step)
        count("windows", nwin)
        pending = None
        for w in range(nwin):
            res = dispatch(codes[w * step : w * step + window])
            if pending is not None:
                yield from emit(*pending)
            pending = (res, min(step, npos - w * step), w == nwin - 1)
        yield from emit(*pending)

    return feed


def _pair_tables(graph, repeat_set, k: int, device: torch.device):
    """The pair map (k <= 32) on `device`: ((slots2, stash_keys, stash_l,
    stash_r), log_size); only the device copy lives on."""
    from ..ops import extmap as X

    with span("map build"):
        qp = X.build_fused_pair(graph.solid.kmers, k, repeat_set.kmers)
    _check_table_fits(qp.nbytes, [device])
    t = _upload_map(qp, device)
    return (t.slots, t.stash_keys, t.stash_l, t.stash_r), qp.log_size


def _upload_map(qm, device: torch.device):
    """`qm.to(device)` (a QMap, QMapB, QMapP or QMapSpan) under the span
    "upload", counting the bytes of the device tables."""
    with span("upload"):
        t = qm.to(device)
        count("bytes uploaded", sum(v.nbytes for v in vars(t).values() if isinstance(v, torch.Tensor)))
    return t


def _build_span_map(graph, repeat_set, k: int):
    """QMapSpan over the solid and repeat sets (32 < k <= 256)."""
    from ..ops import extmap as X
    from ..ops.span import Span

    with span("map build"):
        sp = Span(k)
        spm1 = Span(k - 1)
        solid_rows = sp.from_keys(graph.solid.keys)
        if repeat_set.span is None:  # k = 33: the (k-1)-mer set is plain u64
            rep_rows = np.asarray(repeat_set.keys, np.uint64).reshape(-1, 1)
        else:
            rep_rows = spm1.from_keys(repeat_set.keys)
        return X.build_fused_span(solid_rows, k, rep_rows)


def _span_tables(graph, repeat_set, k: int, device: torch.device):
    """The span map on `device`, as scan_pay_q_span takes it after the
    window: (slots, sat, stash_key64, stash_sat, stash_payload, salt,
    log_size)."""
    qms = _build_span_map(graph, repeat_set, k)
    _check_table_fits(qms.nbytes, [device])
    t = _upload_map(qms, device)
    return (t.slots, t.sat, t.stash_key64, t.stash_sat, t.stash_payload, qms.salt, qms.log_size)


def _feeds_payloads(engine: str, k: int) -> bool:
    """Whether `engine` streams payloads into the native automaton (else it
    takes the plane path): the pair map at k <= 32, the span map above
    (up to k = 256, where the native automaton ends), on one device or over
    the mesh (`sharded`), as the JAX package's _make_pay_feed_fn gates them."""
    return engine in (("auto", "device-qp", "sharded") if k <= 32 else ("auto", "device", "device-qp", "sharded"))


def _make_pay_feed_fn(graph, repeat_set, k: int, device: torch.device,
                      window: int = 1 << 22, exc_cap: int | None = None):
    """Class-stream scan feed for the native automaton (k <= 32): returns a
    factory `codes -> iterator of chunks` for NativeScanner.scan_sequence_pay.

    Windows of `window` bases go up 2-bit packed; the device returns the
    2-bit class stream plus the exception payloads (scan_cls_qp, K1). A
    window with more exceptions than its cap (default 12.5% of its payload
    entries) is re-dispatched dense (scan_pay_qp, K10). At 32 < k <= 256
    the span feed (_make_span_feed_fn) takes its place."""
    if k > 32:
        return _make_span_feed_fn(graph, repeat_set, k, device)
    from .scan_device import scan_cls_qp, scan_pay_qp

    targs, log_size = _pair_tables(graph, repeat_set, k, device)

    def dispatch(part):
        packed, bad, _row = _upload(part, k, device)
        cap = exc_cap if exc_cap is not None else (packed.shape[0] * 4 - k + 2 + 3) // 4 * 4 // 8
        res = scan_cls_qp(packed, bad, *targs, log_size, k, cap)
        return _to_host(res, device) + (packed, bad, cap)

    def emit(pending, take, last):
        host, done, packed, bad, cap = pending
        n_feed = take + last
        if done is not None:
            done.synchronize()
        n_exc = int(host["n_exc"])
        if n_exc > cap:
            # exception-heavy window: re-dispatch dense
            count("dense re-dispatches", 1)
            r = scan_pay_qp(packed, bad, *targs, log_size, k)
            yield ("pay", r["pay8"].cpu().numpy()[:n_feed], r["rep8"].cpu().numpy(), None, n_feed)
        else:
            exc16 = host["exc16"].numpy().view(np.uint16)
            yield ("cls", host["cls2"].numpy(), exc16, n_exc, n_feed)

    return _window_feed(k, window, dispatch, emit)


def _make_span_feed_fn(graph, repeat_set, k: int, device: torch.device, window: int = 1 << 21):
    """Payload scan feed for the native automaton at 32 < k <= 256: windows
    of `window` bases go up 2-bit packed; the device returns each (k-1)-mer's
    payload byte with its repeat and strand bits packed (scan_pay_q_span,
    kernel K6 on CUDA), and the automaton orients each payload by its
    strand bit."""
    from .scan_device import scan_pay_q_span

    targs = _span_tables(graph, repeat_set, k, device)

    def dispatch(part):
        packed, bad, _row = _upload(part, k, device)
        return _to_host(scan_pay_q_span(packed, bad, *targs, k), device)

    def emit(pending, take, last):
        host, done = pending
        n_feed = take + last
        if done is not None:
            done.synchronize()
        yield ("pay", host["pay8"].numpy()[:n_feed], host["rep8"].numpy(), host["str8"].numpy(), n_feed)

    return _window_feed(k, window, dispatch, emit)


def _group_feed(k: int, window: int, n: int, dispatch, emit):
    """_window_feed over groups of n windows, one a shard of the mesh: each
    group goes to dispatch as an [n, window] array (windows padded with
    invalid bases, a short last group with whole invalid windows), and
    group g is dispatched before group g-1 is emitted. emit(res, wins, j,
    take, last) gets window j of the group."""
    step = window - (k - 1)

    def feed(codes):
        npos = codes.shape[0] - k + 1
        if npos <= 0:
            return
        nwin = -(-npos // step)

        def emit_group(res, wins, g0, gn):
            for j in range(gn):
                yield from emit(res, wins, j, min(step, npos - (g0 + j) * step), g0 + j == nwin - 1)

        pending = None
        for g0 in range(0, nwin, n):
            gn = min(n, nwin - g0)
            wins = np.full((n, window), 255, np.uint8)
            for j in range(gn):
                part = codes[(g0 + j) * step : (g0 + j) * step + window]
                wins[j, : part.shape[0]] = part
            res = dispatch(wins)
            if pending is not None:
                yield from emit_group(*pending)
            pending = (res, wins, g0, gn)
        yield from emit_group(*pending)

    return feed


def _sharded_dispatch(graph, repeat_set, k: int, mesh):
    """The window-sharded scan over the mesh (a GlobalMesh): (dispatch,
    n_shards, window) of parallel/mesh.py's group dispatcher, over the pair
    map at k <= 32 (kernel K10 on each shard) or the span map above (K6),
    on every device of the rank."""
    from ..ops import extmap as X
    from ..parallel import mesh as M

    if k <= 32:
        with span("map build"):
            qm, window = X.build_fused_pair(graph.solid.kmers, k, repeat_set.kmers), 1 << 22
        make = M.make_sharded_scan_group_qp
    else:
        qm, window = _build_span_map(graph, repeat_set, k), 1 << 21
        make = M.make_sharded_scan_group_span
    _check_table_fits(qm.nbytes, mesh.local)
    dispatch, n = make(mesh, qm, k, window)
    return dispatch, n, window


def _make_sharded_pay_feed_fn(graph, repeat_set, k: int, mesh):
    """Payload feed of `-scan-engine sharded` for the native automaton:
    windows of a group go to the mesh's shards, each window's dense payload
    stream (pay8, rep8 and, above k = 32, str8) into the automaton in
    position order."""
    dispatch, n, window = _sharded_dispatch(graph, repeat_set, k, mesh)

    def emit(res, _wins, j, take, last):
        n_feed = take + last
        yield ("pay", res["pay8"][j][:n_feed], res["rep8"][j], res["str8"][j] if k > 32 else None, n_feed)

    return _group_feed(k, window, n, dispatch, emit)


def _stitched(k: int, feed, keys, host_fn):
    """`codes -> Planes` over windows (a _window_feed or _group_feed whose
    emit yields each window's planes as numpy arrays cut to its take),
    joined in position order. A sequence shorter than k has no position:
    host_fn gives its empty Planes."""
    from .scan import Planes

    def planes_fn(codes):
        if codes.shape[0] < k:
            return host_fn(codes)
        parts = list(feed(codes))
        return Planes(**{key: np.concatenate([part[key] for part in parts]) for key in keys})

    return planes_fn


def _make_sharded_mem_plane_fn(graph, repeat_set, k: int, mesh, host_fn, chunk: int = 1 << 20):
    """`codes -> Planes` of `-scan-engine sharded-mem` (k <= 32): the solid
    set sharded by key range over the mesh, every membership probe (the
    canonical k-mer and its 8 neighbours) routed to its owner shard through
    the Bloom prefilter (parallel/sharded_membership.py, kernels K12 and
    K13); the repeat planes from the replicated (k-1)-mer set on the host.
    A mesh of one device holds the whole set in its one shard and still
    routes every probe through the kernels (the JAX package takes the host
    scan there). It does not run across processes: the JAX package's
    verdicts of a global mesh cannot be read back in a process that does
    not hold every shard, so its run fails, and so does this one, before
    the scan."""
    from ..ops import kmers as K
    from ..parallel.sharded_membership import ShardedMembership
    from .scan import Planes, _member_sorted

    if mesh.size > len(mesh.local):
        raise FinderError("ERROR: -scan-engine sharded-mem does not run across processes "
                          "(its membership shards are not gathered to every rank)")
    sm = ShardedMembership(mesh.local, np.asarray(graph.solid.kmers, np.uint64))
    rep_kmers = repeat_set.kmers
    mask = K.kmer_mask(k)
    km1_mask = K.kmer_mask(k - 1)
    shift_hi = np.uint64(2 * (k - 1))

    def fn(codes):
        fwd_all, valid_all = K.kmers_from_codes(codes, k)
        p = fwd_all.shape[0]
        if p == 0:
            return host_fn(codes)
        outs = {key: [] for key in ("contains", "nb_in", "nb_out")}
        for lo in range(0, p, chunk):
            fwd = fwd_all[lo : lo + chunk]
            # 9 membership queries per position, one routed batch
            qs = [K.canonical_u64(fwd, k)]
            for x in range(4):
                qs.append(K.canonical_u64(((fwd << np.uint64(2)) | np.uint64(x)) & mask, k))
            for x in range(4):
                qs.append(K.canonical_u64((fwd >> np.uint64(2)) | (np.uint64(x) << shift_hi), k))
            res = sm.contains(np.concatenate(qs)).reshape(9, fwd.shape[0])
            contains = res[0]
            outs["contains"].append(contains)
            outs["nb_out"].append(np.where(contains, res[1:5].sum(axis=0), 0).astype(np.int32))
            outs["nb_in"].append(np.where(contains, res[5:9].sum(axis=0), 0).astype(np.int32))
        suffix = fwd_all & km1_mask
        prefix = (fwd_all >> np.uint64(2)) & km1_mask
        return Planes(
            valid=valid_all,
            fwd=fwd_all,
            contains=np.concatenate(outs["contains"]),
            nb_in=np.concatenate(outs["nb_in"]),
            nb_out=np.concatenate(outs["nb_out"]),
            suffix_rep=np.asarray(_member_sorted(rep_kmers, K.canonical_u64(suffix, k - 1))),
            prefix_rep=np.asarray(_member_sorted(rep_kmers, K.canonical_u64(prefix, k - 1))),
        )

    return fn


def _make_plane_fn(engine: str, graph, repeat_set, k: int, device: torch.device, mesh):
    """`codes -> Planes` for the plane path: the host oracle for
    `-scan-engine host` and above k = 256; at k <= 32 the cuckoo map's
    planes (`device`, K8 on CUDA), the bucket map's (`device-qb`, K9) or the
    pair map's dense payload stream (`auto`, `device-qp`: K10, then
    planes_from_pay on the host) over 2^22-base windows; at 32 < k <= 256
    the span scan (K6, then planes_from_pay_span) over 2^21-base windows;
    `sharded` the same payload streams over the mesh's shards, and
    `sharded-mem` (k <= 32) the membership routed over the mesh. The
    planes are identical whichever engine makes them."""
    from .scan_device import PLANE_KEYS

    def host_fn(codes):
        return scan.compute_planes(codes, k, graph.solid.kmers, repeat_set.kmers)

    if engine == "host" or k > 256:
        return host_fn
    if engine == "sharded":
        from .scan_device import planes_from_pay, planes_from_pay_span

        keys = PLANE_KEYS + (("fwd_rows",) if k > 32 else ())
        dispatch, n, window = _sharded_dispatch(graph, repeat_set, k, mesh)

        def emit(res, wins, j, take, _last):
            if k > 32:
                pw = planes_from_pay_span(res["pay8"][j], res["rep8"][j], res["str8"][j], wins[j], k)
            else:
                pw = planes_from_pay(res["pay8"][j], res["rep8"][j], wins[j], k)
            yield {key: getattr(pw, key)[:take] for key in keys}

        return _stitched(k, _group_feed(k, window, n, dispatch, emit), keys, host_fn)
    if engine == "sharded-mem" and k <= 32:
        return _make_sharded_mem_plane_fn(graph, repeat_set, k, mesh, host_fn)

    def payload_route(window: int, scan_fn, to_planes, keys):
        # the device's payload stream of each window, made into planes on
        # the host
        def dispatch(part):
            packed, bad, row = _upload(part, k, device)
            return _to_host(scan_fn(packed, bad), device) + (row,)

        def emit(pending, take, _last):
            host, done, row = pending
            if done is not None:
                done.synchronize()
            pw = to_planes({key: v.numpy() for key, v in host.items()}, row)
            yield {key: getattr(pw, key)[:take] for key in keys}

        return _stitched(k, _window_feed(k, window, dispatch, emit), keys, host_fn)

    if k > 32:
        from .scan_device import planes_from_pay_span, scan_pay_q_span

        targs = _span_tables(graph, repeat_set, k, device)
        return payload_route(1 << 21, lambda packed, bad: scan_pay_q_span(packed, bad, *targs, k),
                             lambda h, row: planes_from_pay_span(h["pay8"], h["rep8"], h["str8"], row, k),
                             PLANE_KEYS + ("fwd_rows",))
    if engine in ("auto", "device-qp"):
        from .scan_device import planes_from_pay, scan_pay_qp

        targs, log_size = _pair_tables(graph, repeat_set, k, device)
        return payload_route(1 << 22, lambda packed, bad: scan_pay_qp(packed, bad, *targs, log_size, k),
                             lambda h, row: planes_from_pay(h["pay8"], h["rep8"], row, k), PLANE_KEYS)

    from ..ops import extmap as X
    from .scan_device import scan_planes_q, scan_planes_qb

    with span("map build"):
        if engine == "device-qb":
            qm = X.build_fused_bucket(graph.solid.kmers, k, repeat_set.kmers)
            log, scan_fn = qm.log_nb, scan_planes_qb
        else:
            qm = X.build_fused(graph.solid.kmers, k, repeat_set.kmers)
            log, scan_fn = qm.log_size, scan_planes_q
    _check_table_fits(qm.nbytes, [device])
    t = _upload_map(qm, device)
    targs = (t.slots, t.stash_keys, t.stash_payload)
    del qm, t  # only the device copy is used from here

    def dispatch(part):
        packed, bad, _row = _upload(part, k, device)
        return _to_host(scan_fn(packed, bad, *targs, log, k), device)

    def emit(pending, take, _last):
        host, done = pending
        if done is not None:
            done.synchronize()
        out = {key: v.numpy()[:take] for key, v in host.items()}
        out["fwd"] = out["fwd"].view(np.uint64)
        yield out

    return _stitched(k, _window_feed(k, 1 << 22, dispatch, emit), PLANE_KEYS, host_fn)


def run_find(opts: dict, out=None) -> Properties:
    """Execute the find module. opts uses the reference option names
    (without leading dash)."""
    import sys

    out = out or sys.stdout

    has_graph = bool(opts.get("graph"))
    has_in = bool(opts.get("in"))
    if has_graph == has_in:
        raise FinderError(
            "ERROR: options -graph and -in are incompatible, but at least one of these is mandatory"
        )
    if not opts.get("ref"):
        raise FinderError("ERROR: option -ref is mandatory")

    if not opts.get("out"):
        opts["out"] = default_output_prefix()
    prefix = opts["out"]

    device = resolve_device(opts.get("device"))
    scan_engine = opts.get("scan-engine", "auto")
    _validate_scan_engine(scan_engine)

    phases = PhaseTimer()
    with phases.active(opts.get("profile-trace"), device):
        t0 = time.time()
        if has_in:
            with phases.phase("graph build"):
                graph = dbg.build_graph(
                    opts["in"],
                    int(opts.get("kmer-size", 31)),
                    opts.get("abundance-min", "auto"),
                    int(opts.get("abundance-max", 2147483647)),
                    count_engine=str(opts.get("count-engine", "auto")),
                    max_memory_mb=int(opts.get("max-memory", 2000)),
                    max_disk_mb=int(opts.get("max-disk", 0)),
                    tmp_prefix=str(opts.get("out-tmp", ".")) or None,
                    device=device,
                )
                k = int(opts.get("kmer-size", 31))
                with span("save"):
                    graph.save(prefix + ".h5")
                    count("bytes written", os.path.getsize(prefix + ".h5"))
        else:
            with phases.phase("graph load"):
                graph = dbg.Graph.load(opts["graph"])
                k = graph.k

        bed_file = opts.get("bed", "")

        # mode flags (src/Finder.cpp:320-398)
        homo_only = False
        homo_insert = True
        hete_insert = True
        snp = True
        backup = False
        deletion = True
        small_homo = True

        if opts.get("homo-only"):
            homo_only, homo_insert, hete_insert, snp, backup, deletion = True, True, False, True, False, True
        if opts.get("insert-only"):
            homo_only, homo_insert, hete_insert, snp, backup, deletion = False, True, True, False, False, False
        if opts.get("snp-only"):
            homo_only, homo_insert, hete_insert, snp, backup, deletion = True, False, False, True, False, False
        if opts.get("deletion-only"):
            homo_only, homo_insert, hete_insert, snp, backup, deletion = True, False, False, False, False, True
        if opts.get("hete-only"):
            homo_only, homo_insert, hete_insert, snp, backup, deletion = False, False, True, False, False, False
        if opts.get("backup"):
            backup = True
        if opts.get("no-snp"):
            snp = False
        if opts.get("no-insert"):
            homo_insert = False
        if opts.get("no-deletion"):
            deletion = False
        if opts.get("no-hetero"):
            hete_insert = False

        max_repeat = int(opts.get("max-rep", 5))
        het_max_occ = max(1, int(opts.get("het-max-occ", 1)))
        snp_min_val = int(opts.get("snp-min-val", 5))
        branching_threshold = int(opts.get("branching-filter", 15))

        breakpoint_name = prefix + ".breakpoints"
        vcf_name = prefix + ".othervariants.vcf"

        ref_uri = opts["ref"]
        with phases.phase("reference repeat set"):
            repeat_set = dbg.build_repeat_set(ref_uri, k - 1, het_max_occ + 1)

        from . import native_scan

        # the native automaton unless -automaton host (any other value, as in
        # the JAX package, takes the Python one too) or k > 256
        use_native = opts.get("automaton", "auto") in ("auto", "native") and k <= 256

        with open(breakpoint_name, "w") as bkpt_f, open(vcf_name, "w") as vcf_f:
            _write_vcf_header(vcf_f, opts)

            flags = dict(
                max_repeat=max_repeat, snp_min_val=snp_min_val,
                branching_threshold=branching_threshold, homo_only=homo_only,
            )
            if use_native:
                ctx = native_scan.NativeScanner(
                    graph, repeat_set, k, **flags,
                    snp=snp, deletion=deletion, small_homo=small_homo,
                    homo_insert=homo_insert, backup=backup, hete_insert=hete_insert,
                )
            else:
                ctx = ScanContext(graph, repeat_set, k, bkpt_f, vcf_f, **flags)
                # registration order = priority (src/Finder.cpp:548-582)
                if snp:
                    ctx.add_gap_observer(O.FindSoloSNP(ctx))
                    ctx.add_gap_observer(O.FindMultiSNP(ctx))
                    ctx.add_gap_observer(O.FindMultiSNPrev(ctx))
                if deletion:
                    ctx.add_gap_observer(O.FindDeletion(ctx))
                if small_homo:
                    ctx.add_gap_observer(O.FindSmallCleanInsertion(ctx))
                    ctx.add_gap_observer(O.FindSmallFuzzyInsertion(ctx))
                if homo_insert:
                    ctx.add_gap_observer(O.FindCleanInsertion(ctx))
                    ctx.add_gap_observer(O.FindFuzzyInsertion(ctx))
                if backup:
                    ctx.add_gap_observer(O.FindBackup(ctx))
                if hete_insert:
                    ctx.add_kmer_observer(O.FindHeteroInsertion(ctx))

            refbank = Bank.open(ref_uri)
            verbose = int(opts.get("verbose", 1))
            progress = Progress(
                refbank.estimate_sequences_size(), "Finding breakpoints", enabled=verbose > 0
            )
            with phases.phase("scan engine setup"):
                # native automaton + a payload engine: the payload stream feeds
                # the C scanner directly (no host plane expansion; replay
                # overlaps device compute); every other combination takes the
                # plane path. A replicated k <= 32 map over the budget on a
                # mesh of more than one device reroutes `auto` and `sharded` to
                # sharded-mem.
                from ..parallel import distributed as D
                from ..parallel import mesh as M

                # in a run across processes the rank's devices, placed in the
                # global mesh (a collective: every rank reaches it)
                mesh = D.global_mesh(M.make_mesh(device))
                engine = scan_engine
                if k <= 32 and engine in ("auto", "sharded") and _over_budget_mesh(
                        graph, int(opts.get("scan-memory", 0)), mesh):
                    engine = "sharded-mem"
                pay_feed = plane_fn = None
                if use_native and _feeds_payloads(engine, k):
                    if engine == "sharded":
                        pay_feed = _make_sharded_pay_feed_fn(graph, repeat_set, k, mesh)
                    else:
                        pay_feed = _make_pay_feed_fn(graph, repeat_set, k, device)
                else:
                    plane_fn = _make_plane_fn(engine, graph, repeat_set, k, device, mesh)
            for rec in refbank:
                codes = dna.seq_to_codes(rec.seq)
                bed_intervals = None
                if bed_file:
                    bed_intervals = parse_bed_for_chrom(bed_file, rec.comment_short, k)
                if pay_feed is not None:
                    with phases.phase("scan+replay (fused)"):
                        ctx.scan_sequence_pay(rec.comment_short, rec.seq, pay_feed(codes), bed_intervals)
                else:
                    with phases.phase("scan planes"):
                        planes = plane_fn(codes)
                    with phases.phase("automaton replay"):
                        ctx.scan_sequence(rec.comment_short, rec.seq, planes, bed_intervals)
                progress.inc(len(rec.seq))
            progress.finish()

            if use_native:
                bkpt_text, vcf_text, native_stats = ctx.results()
                bkpt_f.write(bkpt_text)
                vcf_f.write(vcf_text)
                ctx.close()
                ctx = _StatsHolder(FindStats(**native_stats))

        seconds = time.time() - t0
    info = _resume(opts, graph, ctx, k, device, seconds, breakpoint_name, vcf_name,
                   max_repeat, het_max_occ, branching_threshold,
                   homo_insert, hete_insert, snp, deletion, bed_file,
                   phases if opts.get("profile") else None)
    out.write(info.dump())
    return info


def _write_vcf_header(vcf_f, opts):
    sample = opts.get("in") or opts.get("graph") or ""
    vcf_f.write(
        "##fileformat=VCFv4.1\n"
        "##filedate=%s"
        "##source=MindTheGap find version %s\n"
        "##SAMPLE=file:%s\n"
        "##REF=file:%s\n"
        '##INFO=<ID=TYPE,Number=1,Type=String,Description="SNP, INS, DEL or .">\n'
        '##INFO=<ID=LEN,Number=1,Type=Integer,Description="variant size">\n'
        '##INFO=<ID=FUZZY,Number=1,Type=Integer,Description="repeat size at the breakpoint, only for INS and DEL">\n'
        '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">\n'
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tG1\n"
        % (time.ctime() + "\n", MTG_COMPAT_VERSION, sample, opts["ref"])
    )


def _resume(opts, graph, ctx, k, device, seconds, bkpt_name, vcf_name,
            max_repeat, het_max_occ, branching_threshold,
            homo_insert, hete_insert, snp, deletion, bed_file,
            phases=None) -> Properties:
    s = ctx.stats
    device_name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    info = Properties()
    info.add(0, "MindTheGap find")
    info.add(1, "version", MTG_COMPAT_VERSION)
    info.add(1, "gatb-core-library", "mindthegap_tpu_torch (%s)" % device_name)
    info.add(1, "supported_kmer_sizes", KSIZE_STRING)
    info.add(0, "Parameters")
    info.add(1, "Input data")
    if opts.get("in"):
        info.add(2, "Reads", opts["in"])
    if opts.get("graph"):
        info.add(2, "Graph", opts["graph"])
    info.add(2, "Reference", opts["ref"])
    if bed_file:
        info.add(2, "Bed file", bed_file)
    info.add(1, "Graph")
    info.add(2, "kmer-size", "%i", k)
    gi = graph.info
    if gi.get("cutoffs_auto.values"):
        info.add(2, "abundance_min (auto inferred)", gi["cutoffs_auto.values"])
    info.add(2, "abundance_min (used)", str(gi.get("thresholds", "")))
    if "abundance_max" in gi:
        info.add(2, "abundance_max", str(gi["abundance_max"]))
    info.add(2, "nb_solid_kmers", str(gi.get("kmers_nb_solid", "")))
    info.add(2, "nb_branching_nodes", str(gi.get("nb_branching", "")))
    info.add(1, "Breakpoint detection options")
    info.add(2, "max_repeat", "%i", max_repeat)
    info.add(2, "hetero_max_occ", "%i", het_max_occ)
    info.add(2, "branching filter value", "%i", branching_threshold)
    info.add(2, "homo_insertions", "yes" if homo_insert else "no")
    info.add(2, "hete_insertions", "yes" if hete_insert else "no")
    info.add(2, "snp", "yes" if snp else "no")
    info.add(2, "deletion", "yes" if deletion else "no")
    info.add(0, "Results")
    info.add(1, "Insertion breakpoints")
    info.add(2, "homozygous", "%i", s.homo_clean + s.homo_fuzzy)
    info.add(3, "clean", "%i", s.homo_clean)
    info.add(3, "fuzzy", "%i", s.homo_fuzzy)
    info.add(2, "heterozygous", "%i", s.hetero_clean + s.hetero_fuzzy)
    info.add(3, "clean", "%i", s.hetero_clean)
    info.add(3, "fuzzy", "%i", s.hetero_fuzzy)
    info.add(1, "Other variants")
    info.add(2, "deletions", "%i", s.clean_deletion + s.fuzzy_deletion)
    info.add(2, "Homozygous insertions 1-2 bp size", "%i", s.homo_clean_indel + s.homo_fuzzy_indel)
    info.add(2, "Heterozygous insertions 1-2 bp size", "%i", s.hetero_indel)
    info.add(2, "SNPs", "%i", s.solo_snp + s.multi_snp)
    info.add(1, "Time", "%.1f s", seconds)
    if phases is not None:
        phases.add_to_info(info, 1)
    info.add(1, "Output files")
    if opts.get("in"):
        info.add(2, "graph_file", "%s.h5", opts["out"])
    info.add(2, "breakpoint_file", bkpt_name)
    info.add(2, "othervariants_file", vcf_name)
    return info
