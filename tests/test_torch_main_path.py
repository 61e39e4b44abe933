"""The slice as a whole on the CPU: the port's `find` (class-stream scan on
device=cpu, native automaton) and `fill -bkpt` against the JAX package's
(host scan + native automaton, which the JAX package's own tests hold equal
to its device-qp engine) on a seeded ~200 kb genome with planted
insertions, SNPs and deletions and 30x error-free reads; `fill -contig` on
donor contigs with gaps between them. The device engines on device=cpu:
`find -count-engine device` against the host-count runs, and `fill
-fill-engine device|device-qb` (both modes) against the JAX package's
`-fill-engine device` and native runs. Artifacts must be byte-identical
(the VCF headers apart from ##filedate, and ##REF where the output prefix
differs)."""

import contextlib
import io
import os

import numpy as np
import pytest

import chip_smoke as CS
from mindthegap_tpu.fill.runner import run_fill as jax_fill
from mindthegap_tpu.find.runner import run_find as jax_find
from mindthegap_tpu_torch import cli
from mindthegap_tpu_torch.fill.runner import run_fill as port_fill
from mindthegap_tpu_torch.find.runner import run_find as port_find


@contextlib.contextmanager
def _cwd(path):
    old = os.getcwd()
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(old)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("main_path")
    ref, donor, insertions = CS.make_case(200_000, n_ins=8, n_snp=4, n_del=4, seed=11)
    CS.write_fasta(str(root / "ref.fa"), CS.CHROM, ref)
    # a second sequence, with an N run in the reference, covers the per-record scan
    ref2, donor2, _ = CS.make_case(30_000, n_ins=1, n_snp=1, n_del=1, seed=13)
    ref2[27_000:27_050] = 255
    CS.write_fasta(str(root / "ref.fa"), "chr2", ref2, mode="ab")
    reads = CS.write_reads(str(root / "reads"), donor, 30.0, seed=12)
    reads += "," + CS.write_reads(str(root / "reads2"), donor2, 30.0, seed=14)
    common = {"in": reads, "ref": str(root / "ref.fa"), "out": "t", "verbose": "0"}
    fill_opts = {"graph": "t.h5", "bkpt": "t.breakpoints", "out": "tf", "nb-cores": "1", "verbose": "0"}
    for name, find, fill, extra in (
        ("jax", jax_find, jax_fill, {"scan-engine": "host", "automaton": "native"}),
        ("port", port_find, port_fill, {"device": "cpu"}),
    ):
        (root / name).mkdir()
        with _cwd(root / name):
            find(dict(common, **extra), out=io.StringIO())
            fill(dict(fill_opts), out=io.StringIO())
    # contig mode input: donor pieces with 150 bp removed between them
    cuts = [0, 60_000, 120_000, donor.size]
    contigs = [donor[a + (150 if a else 0):b] for a, b in zip(cuts[:-1], cuts[1:])]
    with open(root / "contigs.fa", "w") as f:
        for i, c in enumerate(contigs):
            f.write(f">ctg{i}\n{CS.NUC[c].tobytes().decode()}\n")
    for name, fill in (("jax", jax_fill), ("port", port_fill)):
        with _cwd(root / name):
            fill({"graph": "t.h5", "contig": str(root / "contigs.fa"), "out": "tc",
                  "nb-cores": "1", "verbose": "0"}, out=io.StringIO())
    return root, insertions


def _read(root, name, fname, drop=("##filedate",)):
    with open(root / name / fname) as f:
        return [line for line in f if not line.startswith(drop)]


@pytest.mark.parametrize("fname", ["t.breakpoints", "t.othervariants.vcf", "tf.insertions.fasta",
                                   "tf.insertions.vcf", "tf.info.txt", "tc.gfa", "tc.insertions.fasta",
                                   "tc.info.txt"])
def test_artifacts_identical(runs, fname):
    root, _ = runs
    port = _read(root, "port", fname)
    assert port == _read(root, "jax", fname)
    assert port, f"{fname} is empty"


def test_insertions_recalled(runs):
    root, insertions = runs
    filled = CS.filled_insertions(str(root / "port" / "tf.insertions.fasta"))
    assert {chrom for chrom, _p, _s in filled} == {CS.CHROM, "chr2"}
    assert CS.insertion_recall(insertions, [f for f in filled if f[0] == CS.CHROM]) == 1.0


def test_graph_files_are_interchangeable(runs, tmp_path):
    """A graph written by the JAX package loads in the port (same format)."""
    root, _ = runs
    with _cwd(tmp_path):
        port_find({"graph": str(root / "jax" / "t.h5"), "ref": str(root / "ref.fa"), "out": "g",
                   "device": "cpu", "verbose": "0"}, out=io.StringIO())
    assert (tmp_path / "g.breakpoints").read_text() == (root / "jax" / "t.breakpoints").read_text()


def test_scan_memory_budget_ignored_on_one_device(runs, tmp_path):
    """A -scan-memory budget below the pair map changes nothing on one
    device (the JAX package ignores it there too): the run writes the JAX
    run's artifacts."""
    root, _ = runs
    with _cwd(tmp_path):
        port_find({"in": _reads_arg(root), "ref": str(root / "ref.fa"), "out": "t", "verbose": "0",
                   "device": "cpu", "scan-memory": "1"}, out=io.StringIO())
    for fname in ("t.breakpoints", "t.othervariants.vcf"):
        got = _read(tmp_path.parent, tmp_path.name, fname)
        assert got and got == _read(root, "jax", fname)


@pytest.fixture(scope="module")
def device_runs(runs):
    """The device engines on device=cpu (each kernel's plain version): the
    port's find with device counting, and fill with the device walker in
    both layouts and both modes; the JAX package's -fill-engine device runs
    beside them."""
    root, _ = runs
    contigs = str(root / "contigs.fa")
    with _cwd(root / "port"):
        port_find({"in": _reads_arg(root), "ref": str(root / "ref.fa"), "out": "d", "verbose": "0",
                   "device": "cpu", "count-engine": "device"}, out=io.StringIO())
    for name, fill, extra in (("jax", jax_fill, {}), ("port", port_fill, {"device": "cpu"})):
        with _cwd(root / name):
            for out, engine, mode in (("tfd", "device", "bkpt"), ("tfq", "device-qb", "bkpt"),
                                      ("tcd", "device", "contig")):
                if name == "jax" and engine == "device-qb":
                    continue  # the JAX package's own tests hold device-qb to device
                src = {"bkpt": "t.breakpoints"} if mode == "bkpt" else {"contig": contigs}
                fill(dict({"graph": "t.h5", "out": out, "fill-engine": engine, "verbose": "0"}, **src, **extra),
                     out=io.StringIO())
    return root


def _reads_arg(root):
    return ",".join(str(root / f"{p}_{i}.fa") for p in ("reads", "reads2") for i in (1, 2))


def test_device_count_graph_identical(device_runs):
    """find -count-engine device builds the host-count graph, in the port and
    in the JAX package."""
    from mindthegap_tpu_torch.graph.dbg import Graph

    got = Graph.load(str(device_runs / "port" / "d.h5"))
    assert got.solid.keys.size > 100_000
    for name in ("port", "jax"):
        want = Graph.load(str(device_runs / name / "t.h5"))
        assert got.info == want.info
        np.testing.assert_array_equal(got.solid.keys, want.solid.keys)
        np.testing.assert_array_equal(got.solid.counts, want.solid.counts)


@pytest.mark.parametrize("ext", ["breakpoints", "othervariants.vcf"])
def test_device_count_find_artifacts(device_runs, ext):
    got = _read(device_runs, "port", "d." + ext)
    assert got and got == _read(device_runs, "jax", "t." + ext)


@pytest.mark.parametrize("fname", ["tfd.insertions.fasta", "tfd.insertions.vcf", "tfd.info.txt",
                                   "tfq.insertions.fasta", "tfq.insertions.vcf", "tfq.info.txt",
                                   "tcd.gfa", "tcd.insertions.fasta", "tcd.info.txt"])
def test_device_fill_artifacts(device_runs, fname):
    """The port's device walker writes the JAX device walker's artifacts
    (device-qb: the JAX device run's) and the JAX native engine's."""
    got = _read(device_runs, "port", fname, drop=("##filedate", "##REF"))
    assert got
    assert got == _read(device_runs, "jax", fname.replace("tfq", "tfd"), drop=("##filedate", "##REF"))
    native = fname.replace("tfd", "tf").replace("tfq", "tf").replace("tcd", "tc")
    assert got == _read(device_runs, "jax", native, drop=("##filedate", "##REF"))


def test_fill_device_engine_without_gpu_raises(runs, tmp_path, monkeypatch):
    """A device fill engine runs on CUDA; without a GPU and without -device
    cpu it fails instead of falling back, while the default fill (host
    engines) needs no GPU."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    root, _ = runs
    args = ["fill", "-graph", str(root / "port" / "t.h5"), "-bkpt", str(root / "port" / "t.breakpoints"),
            "-out", "u", "-nb-cores", "1", "-verbose", "0"]
    with _cwd(tmp_path):
        report = io.StringIO()
        with contextlib.redirect_stdout(report):
            assert cli.main(args + ["-fill-engine", "device"]) == 1
            assert "no CUDA device" in report.getvalue()
            assert cli.main(args) == 0


def test_find_without_gpu_raises(runs, tmp_path, monkeypatch):
    """The CLI default device is cuda; without one the run fails, it does not
    fall back to the CPU."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    root, _ = runs
    report = io.StringIO()
    with _cwd(tmp_path), contextlib.redirect_stdout(report):
        rc = cli.main(["find", "-graph", str(root / "port" / "t.h5"), "-ref", str(root / "ref.fa"), "-out", "u"])
    assert rc == 1 and "no CUDA device" in report.getvalue()


# the mesh engines: on the CPU the port's mesh is logical shards of the CPU
# (parallel/mesh.py logical_devices), the JAX package's its 8 virtual devices
MESH_CASES = {  # case: (logical shards, options)
    "s": (2, {"scan-engine": "sharded"}),
    "sh": (2, {"scan-engine": "sharded", "automaton": "host"}),
    "sm": (4, {"scan-engine": "sharded-mem"}),
    "sm1": (1, {"scan-engine": "sharded-mem"}),  # one shard: still routed, no host scan
    "sa": (4, {"scan-engine": "auto", "scan-memory": "1"}),  # the pair map (~4 MB) is over 1 MB: rerouted
    "c": (2, {"count-engine": "sharded"}),
}
JAX_MESH_CASES = {"s": {"scan-engine": "sharded"}, "sm": {"scan-engine": "sharded-mem"},
                  "c": {"count-engine": "sharded", "scan-engine": "host"}}


@pytest.fixture(scope="module")
def mesh_runs(runs):
    """The mesh engines of find on the main path's graph (the count engine on
    its reads) and `fill -fill-engine device` over the walker's mesh, in the
    port and in the JAX package; {case: the sharded-membership batches the
    port routed}."""
    import torch

    from mindthegap_tpu_torch.parallel import mesh as M
    from mindthegap_tpu_torch.parallel.sharded_membership import ShardedMembership

    root, _ = runs
    routed = {}
    orig = ShardedMembership.contains
    try:
        with _cwd(root / "port"):
            for case, (n, extra) in MESH_CASES.items():
                src = {"in": _reads_arg(root)} if case == "c" else {"graph": "t.h5"}
                routed[case] = []
                ShardedMembership.contains = (lambda self, keys, _r=routed[case]:
                                              _r.append(keys.size) or orig(self, keys))
                with M.logical_devices([torch.device("cpu")] * n):
                    port_find(dict({"ref": str(root / "ref.fa"), "out": case, "verbose": "0", "device": "cpu"},
                                   **src, **extra), out=io.StringIO())
            ShardedMembership.contains = orig
            with M.logical_devices([torch.device("cpu")] * 4):
                port_fill({"graph": "t.h5", "bkpt": "t.breakpoints", "out": "tfm", "fill-engine": "device",
                           "device": "cpu", "verbose": "0"}, out=io.StringIO())
    finally:
        ShardedMembership.contains = orig
    with _cwd(root / "jax"):
        for case, extra in JAX_MESH_CASES.items():
            src = {"in": _reads_arg(root)} if case == "c" else {"graph": "t.h5"}
            jax_find(dict({"ref": str(root / "ref.fa"), "out": case, "verbose": "0"}, **src, **extra),
                     out=io.StringIO())
    return root, routed


@pytest.mark.parametrize("ext", ["breakpoints", "othervariants.vcf"])
@pytest.mark.parametrize("case", list(MESH_CASES))
def test_mesh_engines_match_jax(mesh_runs, case, ext):
    """Each mesh engine writes the JAX run's artifacts (its own mesh engine's
    where the JAX package runs the same case, and its default run's) and the
    port's default run's, byte for byte (the VCF apart from ##filedate, and
    ##SAMPLE, which names the input)."""
    root, _ = mesh_runs
    drop = ("##filedate", "##SAMPLE")
    got = _read(root, "port", f"{case}.{ext}", drop)
    assert got and got == _read(root, "port", f"t.{ext}", drop) == _read(root, "jax", f"t.{ext}", drop)
    if case in JAX_MESH_CASES:
        assert got == _read(root, "jax", f"{case}.{ext}", drop)


def test_sharded_mem_routes_its_queries(mesh_runs):
    """sharded-mem (on 4 shards and on one), and auto over a tiny
    -scan-memory on a mesh of 4 shards, route their membership through
    ShardedMembership (a silent host scan would make the parity above
    vacuous); the sharded scan does not."""
    _, routed = mesh_runs
    for case in ("sm", "sm1", "sa"):
        assert len(routed[case]) > 0 and sum(routed[case]) > 0, case
    assert routed["s"] == []


def test_sharded_count_graph_identical(mesh_runs):
    """-count-engine sharded writes the host-count graph byte for byte, and
    the JAX sharded counter's keys and counts."""
    from mindthegap_tpu_torch.graph.dbg import Graph

    root, _ = mesh_runs
    assert (root / "port" / "c.h5").read_bytes() == (root / "port" / "t.h5").read_bytes()
    got, want = Graph.load(str(root / "port" / "c.h5")), Graph.load(str(root / "jax" / "c.h5"))
    assert got.info == want.info
    np.testing.assert_array_equal(got.solid.keys, want.solid.keys)
    np.testing.assert_array_equal(got.solid.counts, want.solid.counts)


@pytest.mark.parametrize("ext", ["insertions.fasta", "insertions.vcf", "info.txt"])
def test_mesh_fill_matches_jax(mesh_runs, ext):
    """fill -fill-engine device with the walker's lanes over a mesh of 4
    logical shards writes the JAX native fill's artifacts."""
    root, _ = mesh_runs
    drop = ("##filedate", "##REF")
    got = _read(root, "port", f"tfm.{ext}", drop)
    assert got and got == _read(root, "jax", f"tf.{ext}", drop)


def test_find_above_k256_matches_jax(tmp_path):
    """find at k = 257: the host scan into the Python automaton, as in the
    JAX package, on a small genome read by 600 bp reads; the artifacts equal
    the JAX run's."""
    ref, donor, _ = CS.make_case(12_000, n_ins=2, n_snp=1, n_del=1, seed=31)
    CS.write_fasta(str(tmp_path / "ref.fa"), CS.CHROM, ref)
    rng = np.random.default_rng(32)
    with open(tmp_path / "reads.fa", "wb") as f:
        for s in rng.integers(0, donor.size - 600, 30 * donor.size // 600):
            f.write(b">r\n" + CS.NUC[donor[s : s + 600]].tobytes() + b"\n")
    opts = {"in": str(tmp_path / "reads.fa"), "ref": str(tmp_path / "ref.fa"), "out": "t", "verbose": "0",
            "kmer-size": "257", "abundance-min": "3"}
    for name, find, extra in (("jax", jax_find, {}), ("port", port_find, {"device": "cpu"})):
        (tmp_path / name).mkdir()
        with _cwd(tmp_path / name):
            find(dict(opts, **extra), out=io.StringIO())
    for ext in ("breakpoints", "othervariants.vcf"):
        assert _read(tmp_path, "port", f"t.{ext}") == _read(tmp_path, "jax", f"t.{ext}")
    assert any(line.startswith(">") for line in _read(tmp_path, "port", "t.breakpoints"))
