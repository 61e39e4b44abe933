"""The port's tools against the JAX package's on the CPU: `-profile-trace`
(a torch.profiler trace; the run's artifacts keep their bytes), the hidden
`-profile` report (the same phase names), `python -m
mindthegap_tpu_torch.dbginfo` (the same info tree as bin/dbginfo, and an
HDF5 export both packages load), and the pyGATB shim
mindthegap_tpu_torch.compat.gatb (the same answers as
mindthegap_tpu.compat.gatb)."""

import contextlib
import io
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke as CS
from mindthegap_tpu.compat import gatb as jax_gatb
from mindthegap_tpu.fill.runner import run_fill as jax_fill
from mindthegap_tpu.find.runner import run_find as jax_find
from mindthegap_tpu.graph.dbg import Graph as JaxGraph, SolidSet as JaxSolidSet
from mindthegap_tpu.ops.span import Span
from mindthegap_tpu_torch.compat import gatb as port_gatb
from mindthegap_tpu_torch.fill.runner import run_fill as port_fill
from mindthegap_tpu_torch.find.runner import run_find as port_find
from mindthegap_tpu_torch.graph.dbg import Graph

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@contextlib.contextmanager
def _cwd(path):
    old = os.getcwd()
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(old)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """A seeded 40 kb genome with planted variants and 30x reads; the JAX
    package's find (host scan) and fill on it, in jax/."""
    root = tmp_path_factory.mktemp("tools")
    ref, donor, _ = CS.make_case(40_000, n_ins=3, n_snp=2, n_del=2, seed=31)
    CS.write_fasta(str(root / "ref.fa"), CS.CHROM, ref)
    reads = CS.write_reads(str(root / "reads"), donor, 30.0, seed=32)
    (root / "jax").mkdir()
    with _cwd(root / "jax"):
        jax_find({"in": reads, "ref": str(root / "ref.fa"), "out": "t", "scan-engine": "host", "verbose": 0},
                 out=io.StringIO())
        jax_fill({"graph": "t.h5", "bkpt": "t.breakpoints", "out": "tf", "nb-cores": "1", "max-length": "500",
                  "verbose": 0}, out=io.StringIO())
    return root, reads


def _lines(path, drop=("##filedate", "##REF")):
    with open(path) as f:
        return [line for line in f if not line.startswith(drop)]


def _runs(root):
    """command -> (port runner, options, artifacts) on the JAX run's graph."""
    jax = root / "jax"
    return {
        "find": (port_find, {"graph": str(jax / "t.h5"), "ref": str(root / "ref.fa"), "out": "t", "device": "cpu"},
                 ("t.breakpoints", "t.othervariants.vcf")),
        "fill": (port_fill, {"graph": str(jax / "t.h5"), "bkpt": str(jax / "t.breakpoints"), "out": "tf",
                             "nb-cores": "1", "max-length": "500", "fill-engine": "device", "device": "cpu"},
                 ("tf.insertions.fasta", "tf.insertions.vcf", "tf.info.txt")),
    }


@pytest.mark.parametrize("cmd", ["find", "fill"])
def test_profile_trace_writes_a_trace(case, tmp_path, cmd):
    """-profile-trace DIR writes a non-empty Chrome trace of the run into
    DIR; the run's artifacts equal the same run's without the option and
    the JAX package's (the VCF headers apart from ##filedate, ##REF and
    ##SAMPLE, which name the run's inputs)."""
    root, _ = case
    run, opts, artifacts = _runs(root)[cmd]
    for name, extra in (("plain", {}), ("traced", {"profile-trace": str(tmp_path / "trace_dir")})):
        (tmp_path / name).mkdir()
        with _cwd(tmp_path / name):
            run(dict(opts, verbose="0", **extra), out=io.StringIO())
    trace = tmp_path / "trace_dir" / "trace.json"
    assert trace.stat().st_size > 0
    events = json.loads(trace.read_text())["traceEvents"]
    assert any(e.get("ph") == "X" for e in events)
    for fname in artifacts:
        got = _lines(tmp_path / "traced" / fname)
        assert got and got == _lines(tmp_path / "plain" / fname)
        # the JAX run's find read the reads, not the graph: ##SAMPLE names the input
        drop = ("##filedate", "##REF", "##SAMPLE")
        assert _lines(tmp_path / "traced" / fname, drop) == _lines(root / "jax" / fname, drop)


def _phase_names(report: str) -> list[str]:
    """The names of the "Per-phase timings" section of a result report."""
    lines = report.splitlines()
    head = next(i for i, line in enumerate(lines) if line.strip() == "Per-phase timings")
    indent = len(lines[head]) - len(lines[head].lstrip())
    names = []
    for line in lines[head + 1:]:
        if len(line) - len(line.lstrip()) <= indent:
            break
        names.append(re.match(r"\s*(.*?)\s*:", line).group(1))
    return names


PROFILE_RUNS = {  # case -> (JAX options, port options)
    "find host scan": ({"scan-engine": "host"}, {"scan-engine": "host"}),
    "find fused scan": ({"scan-engine": "device-qp"}, {}),
    "fill": ({}, {}),
}


@pytest.mark.parametrize("which", list(PROFILE_RUNS))
def test_profile_phase_names_match_jax(case, tmp_path, which):
    """-profile adds a "Per-phase timings" section whose phase names equal the
    JAX run's on the same input and engine; the default report has none."""
    root, reads = case
    jax_extra, port_extra = PROFILE_RUNS[which]
    if which == "fill":
        common = {"graph": str(root / "jax" / "t.h5"), "bkpt": str(root / "jax" / "t.breakpoints"), "nb-cores": "1"}
        runs = (jax_fill, port_fill)
    else:
        common = {"in": reads, "ref": str(root / "ref.fa")}
        runs = (jax_find, port_find)
    reports = {}
    for name, run, extra, profile in (("jax", runs[0], jax_extra, True),
                                      ("port", runs[1], dict(port_extra, device="cpu"), False),
                                      ("port", runs[1], dict(port_extra, device="cpu"), True)):
        out = io.StringIO()
        opts = dict(common, out=str(tmp_path / f"{name}{int(profile)}"), verbose="0", **extra)
        if profile:
            opts["profile"] = True
        run(opts, out=out)
        reports[name, profile] = out.getvalue()
    assert "Per-phase timings" not in reports["port", False]
    # the JAX run has no nested spans: its names are the port's top-level ones
    names = [name for name in _phase_names(reports["port", True]) if " / " not in name]
    assert names and names == _phase_names(reports["jax", True])


def _sections(report: str):
    """The "Per-phase timings" ({path: seconds}, in order) and "Per-phase
    counts" ({key: n}) of a report, and whether the counts follow the
    timings at once."""
    lines = report.splitlines()
    head = next(i for i, line in enumerate(lines) if line.strip() == "Per-phase timings")
    timings = {}
    i = head + 1
    while m := re.match(r"^ {8}(\S.*?)\s*: ([\d.]+) s$", lines[i]):
        timings[m.group(1)] = float(m.group(2))
        i += 1
    follows = lines[i].strip() == "Per-phase counts"
    counts = {}
    for line in lines[i + 1:]:
        m = re.match(r"^ {8}(\S.*?)\s*: (\d+)$", line)
        if not m:
            break
        counts[m.group(1)] = int(m.group(2))
    return timings, counts, follows


SPAN_ROWS = {  # k -> the span table's rows that a `find -in -count-engine device` run passes through
    31: ("graph build / parse", "graph build / flush", "graph build / flush / wait", "graph build / readback",
         "graph build / solid filter", "graph build / branching", "graph build / save",
         "scan engine setup / map build", "scan engine setup / map build / place", "scan engine setup / upload",
         "scan+replay (fused)"),
    # above k = 32 the reads are counted on the host: no flush, no readback
    45: ("graph build / parse", "graph build / solid filter", "graph build / branching", "graph build / save",
         "scan engine setup / map build", "scan engine setup / map build / keys",
         "scan engine setup / map build / place", "scan engine setup / upload", "scan+replay (fused)"),
}


@pytest.mark.parametrize("k", [31, 45])
def test_profile_span_tree(case, tmp_path, monkeypatch, k):
    """`find -in -count-engine device -profile`: every span the run passes
    through is in "Per-phase timings", each parent before its children and
    each child's seconds at most its parent's; "Per-phase counts" follows,
    each count under a span of the report (distinct k-mers >= solid ones;
    keys probed on device: the solid ones at k = 31, none at k = 45).
    With no profiler running no record_function range is entered."""
    import torch

    from mindthegap_tpu_torch.ops.counting_device import DeviceStreamingCounter

    root, reads = case
    # small staging buffers and accumulator: several flushes and a regrowth
    monkeypatch.setattr(DeviceStreamingCounter.__init__, "__defaults__", (1 << 18, 1 << 14))
    entered = []
    monkeypatch.setattr(torch.profiler, "record_function", lambda name: entered.append(name))
    out = io.StringIO()
    port_find({"in": reads, "ref": str(root / "ref.fa"), "out": str(tmp_path / "t"), "kmer-size": str(k),
               "count-engine": "device", "device": "cpu", "verbose": "0", "profile": True}, out=out)
    assert entered == []
    timings, counts, follows = _sections(out.getvalue())
    assert follows
    paths = list(timings)
    for row in SPAN_ROWS[k]:
        assert row in timings, row
    for i, path in enumerate(paths):
        if " / " in path:
            parent = path.rsplit(" / ", 1)[0]
            assert parent in paths[:i], path
            assert timings[path] <= timings[parent], path
    for key in counts:
        assert key.rsplit(" / ", 1)[0] in timings, key
    assert counts["graph build / parse / bases"] > 0
    assert counts["scan engine setup / upload / bytes uploaded"] > 0
    assert counts["scan+replay (fused) / windows"] >= 1
    # the branching count runs on the device at k <= 32, on the host above
    probed = counts["graph build / solid filter / solid k-mers"] if k == 31 else 0
    assert counts["graph build / branching / keys probed on device"] == probed
    if k == 31:
        assert counts["graph build / flush / flushes"] > 1
        assert counts["graph build / flush / merge regrowths"] >= 1
        assert counts["graph build / readback / distinct k-mers"] >= counts["graph build / solid filter / solid k-mers"]
    else:
        assert counts["scan engine setup / map build / keys / rows before dedup"] >= \
            counts["scan engine setup / map build / keys / rows after dedup"]


def test_phase_timer_nests_spans_and_counts():
    """PhaseTimer: a span is the child of the innermost open one, its path
    registered at first entry and its seconds summed over entries; each
    pass is a record on perf_counter's clock, inside its parent's; a count
    belongs to the innermost open span; span() and count() do nothing
    without a current timer."""
    from mindthegap_tpu_torch.utils import phases as P
    from mindthegap_tpu_torch.utils.properties import Properties

    with P.span("x"):
        P.count("n", 5)
    timer = P.PhaseTimer()
    with timer.active():
        with timer.phase("a"):
            for _ in range(2):
                with P.span("b"):
                    P.count("n", 3)
                    with P.span("c"):
                        pass
            P.count("m", 1)
        with timer.phase("d"):
            pass
    assert P._CURRENT.get() is None
    assert list(timer._acc) == ["a", "a / b", "a / b / c", "d"]
    assert timer._counts == {"a / b / n": 6, "a / m": 1}
    recs = {}
    for r in timer.records:
        recs.setdefault(r.path, []).append(r)
    assert [len(recs[p]) for p in timer._acc] == [1, 2, 2, 1]
    for r in timer.records:
        assert r.start <= r.end
        if r.parent is not None:
            assert r.path == r.parent + " / " + r.path.rsplit(" / ", 1)[1]
            assert any(p.start <= r.start and r.end <= p.end for p in recs[r.parent])
    assert timer._acc["a / b"] == pytest.approx(sum(r.end - r.start for r in recs["a / b"]))
    info = Properties()
    timer.add_to_info(info, 1)
    lines = info.dump().splitlines()
    assert [line.strip().split(" :")[0].strip() for line in lines] == [
        "Per-phase timings", "a", "a / b", "a / b / c", "d", "Per-phase counts", "a / b / n", "a / m"]
    assert lines[-2].endswith(": 6") and re.search(r": \d+\.\d{3} s$", lines[1])


def test_failed_job_leaves_no_timer_or_profiler(case, tmp_path, monkeypatch):
    """A job that raises inside a nested span, under -profile-trace, leaves
    no current timer and no running profiler; the next job's spans nest
    under its own phases only."""
    import torch

    from mindthegap_tpu_torch.ops import extmap
    from mindthegap_tpu_torch.utils import phases

    root, _ = case
    opts = {"graph": str(root / "jax" / "t.h5"), "ref": str(root / "ref.fa"), "device": "cpu", "verbose": "0",
            "profile": True}

    def broken(*args, **kwargs):
        raise RuntimeError("placement broke")

    with monkeypatch.context() as m:
        m.setattr(extmap, "_sorted_stash", broken)
        with pytest.raises(RuntimeError, match="placement broke"):
            port_find(dict(opts, out=str(tmp_path / "bad"), **{"profile-trace": str(tmp_path / "trace")}),
                      out=io.StringIO())
    assert phases._CURRENT.get() is None
    assert not torch.autograd._profiler_enabled()
    out = io.StringIO()
    port_find(dict(opts, out=str(tmp_path / "good")), out=out)
    timings, _counts, _ = _sections(out.getvalue())
    assert [p for p in timings if " / " not in p] == ["graph load", "reference repeat set", "scan engine setup",
                                                      "scan+replay (fused)"]
    assert "scan engine setup / map build / place" in timings


def test_profile_trace_holds_the_spans(case, tmp_path):
    """Under -profile-trace each span path of the report is a
    user_annotation range of the Chrome trace, and each child's range lies
    inside one of its parent's."""
    root, reads = case
    out = io.StringIO()
    port_find({"in": reads, "ref": str(root / "ref.fa"), "out": str(tmp_path / "t"), "count-engine": "device",
               "device": "cpu", "verbose": "0", "profile": True, "profile-trace": str(tmp_path / "trace")}, out=out)
    timings, _counts, _ = _sections(out.getvalue())
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())["traceEvents"]
    ranges = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation":
            ranges.setdefault(e["name"], []).append((float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    assert set(timings) <= set(ranges)
    for path in timings:
        if " / " not in path:
            continue
        parents = ranges[path.rsplit(" / ", 1)[0]]
        for s, e in ranges[path]:
            assert any(ps <= s and e <= pe for ps, pe in parents), path


def _graphs(tmp_path):
    """A k = 31 graph (u64 keys) and a k = 45 graph (multi-word keys), saved
    by the JAX package, as tests/test_tools.py builds them."""
    rng = np.random.default_rng(0)
    keys31 = np.unique(rng.integers(0, 1 << 61, size=5000, dtype=np.uint64))
    g31 = JaxGraph(JaxSolidSet(keys31, 31, np.full(keys31.size, 3, np.int64)),
                   {"thresholds": 3, "kmers_nb_solid": int(keys31.size), "nb_branching": 7})
    sp = Span(45)
    rows, valid = sp.from_codes(rng.integers(0, 4, size=4000, dtype=np.uint8))
    keys45 = np.unique(sp.keys(sp.canonical(rows[valid])))
    g45 = JaxGraph(JaxSolidSet(keys45, 45, np.arange(keys45.size, dtype=np.int64) % 9 + 2), {"thresholds": 2})
    return {31: g31, 45: g45}


@pytest.mark.parametrize("k", [31, 45])
def test_dbginfo_matches_bin_dbginfo(tmp_path, k):
    """python -m mindthegap_tpu_torch.dbginfo prints bin/dbginfo's info tree;
    its -export-h5 file is HDF5, and both packages load it to the graph's
    keys, counts and info."""
    import h5py

    g = _graphs(tmp_path)[k]
    npz = str(tmp_path / "g.h5")
    g.save(npz)
    outs = {}
    for name, cmd, env in (
        ("jax", [sys.executable, os.path.join(REPO, "bin", "dbginfo")], dict(os.environ, JAX_PLATFORMS="cpu")),
        ("port", [sys.executable, "-m", "mindthegap_tpu_torch.dbginfo"],
         dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))),
    ):
        export = str(tmp_path / f"{name}.export.h5")
        r = subprocess.run(cmd + ["-in", npz, "-export-h5", export], capture_output=True, text=True, env=env,
                           cwd=str(tmp_path), timeout=300)
        assert r.returncode == 0, r.stdout + r.stderr
        outs[name] = r.stdout.replace(export, "EXPORT")
    assert "kmer-size" in outs["port"] and outs["port"] == outs["jax"]
    export = str(tmp_path / "port.export.h5")
    assert h5py.is_hdf5(export) and not h5py.is_hdf5(npz)
    for loaded in (Graph.load(export), JaxGraph.load(export)):
        assert loaded.k == k and loaded.info == g.info
        np.testing.assert_array_equal(loaded.solid.keys, g.solid.keys)
        np.testing.assert_array_equal(loaded.solid.counts, g.solid.counts)


def test_gatb_node_matches_jax_shim(tmp_path):
    """The port's pyGATB Node answers in_degree, out_degree, reversed, str,
    membership and abundance as the JAX shim's, on k-mers of the graph and
    on k-mers absent from it."""
    from mindthegap_tpu.ops import kmers as K
    from mindthegap_tpu.utils import dna

    rng = np.random.default_rng(4)
    k = 21
    genome = "".join(rng.choice(list("ACGT"), size=3000))
    fwd, _ = K.kmers_from_codes(dna.seq_to_codes(genome), k)
    canon = np.unique(K.canonical_u64(fwd, k))
    JaxGraph(JaxSolidSet(canon, k, rng.integers(1, 50, canon.size)), {"kmers_nb_solid": canon.size,
                                                                       "thresholds": 1}).save(str(tmp_path / "g.h5"))
    jg, pg = (m.Graph("-in %s" % (tmp_path / "g.h5")) for m in (jax_gatb, port_gatb))
    assert pg.kmer_size == jg.kmer_size == k
    starts = rng.integers(0, len(genome) - k, 150)
    kmers = [genome[s : s + k] for s in starts] + ["".join(rng.choice(list("ACGT"), size=k)) for _ in range(50)]
    for kmer in kmers:
        jn, pn = jg[kmer], pg[kmer]
        assert (pn.in_degree, pn.out_degree, pn.abundance) == (jn.in_degree, jn.out_degree, jn.abundance)
        assert str(pn) == str(jn) == kmer and bytes(pn) == bytes(jn)
        assert str(pn.reversed) == str(jn.reversed) and pn.reversed == pn
        assert (kmer in pg) == (kmer in jg)
    assert any(kmer in pg for kmer in kmers) and not all(kmer in pg for kmer in kmers)
