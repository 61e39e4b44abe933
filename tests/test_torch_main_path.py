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
from mindthegap_tpu_torch import NotYetPorted, cli
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


@pytest.mark.parametrize("extra", [
    ["-scan-engine", "host"],
    ["-scan-engine", "sharded"],
    ["-automaton", "host"],
    ["-count-engine", "sharded"],
    ["-profile-trace", "trace_dir"],
    ["-kmer-size", "45"],
], ids=lambda e: e[0] + "=" + e[1])
def test_unported_find_options_raise(runs, tmp_path, extra):
    root, _ = runs
    with _cwd(tmp_path):
        with pytest.raises(NotYetPorted):
            port_find({"in": str(root / "reads_1.fa"), "ref": str(root / "ref.fa"), "out": "u",
                       "device": "cpu", extra[0].lstrip("-"): extra[1]}, out=io.StringIO())
        # through the CLI the same failure is reported, and the run fails
        report = io.StringIO()
        with contextlib.redirect_stdout(report):
            rc = cli.main(["find", "-in", str(root / "reads_1.fa"), "-ref", str(root / "ref.fa"),
                           "-out", "u", "-device", "cpu", *extra])
        assert rc == 1 and "not yet ported" in report.getvalue()


@pytest.mark.parametrize("engine", ["device", "device-qb"])
def test_unported_fill_engines_raise(runs, tmp_path, engine):
    """The device walker covers k <= 32: at k = 45 (the span walker) it
    raises before the graph is built."""
    root, _ = runs
    with _cwd(tmp_path), pytest.raises(NotYetPorted):
        port_fill({"in": str(root / "reads_1.fa"), "bkpt": str(root / "port" / "t.breakpoints"),
                   "out": "u", "fill-engine": engine, "kmer-size": "45", "device": "cpu"},
                  out=io.StringIO())


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
