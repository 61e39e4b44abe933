"""The k = 45 slice as a whole on the CPU: the port's `find -kmer-size 45`
(the span scan on device=cpu, K6's plain version, into the native
automaton) and `fill` (native; `-fill-engine device` and `device-qb`, K7's
plain version) against the JAX package's `find -scan-engine host
-automaton native` and its native and device fills, on a seeded 100 kb
genome with planted insertions, SNPs and deletions, a second record with an
N run, and 30x error-free reads; bkpt and contig modes. Artifacts must be
byte-identical (the VCF headers apart from ##filedate, and ##REF where the
output prefix differs)."""

import contextlib
import io
import os

import pytest

import chip_smoke as CS
from mindthegap_tpu.fill.runner import run_fill as jax_fill
from mindthegap_tpu.find.runner import run_find as jax_find
from mindthegap_tpu_torch.fill import walk_device as PW
from mindthegap_tpu_torch.fill.runner import run_fill as port_fill
from mindthegap_tpu_torch.find import scan_device as PS
from mindthegap_tpu_torch.find.runner import run_find as port_find

K = "45"


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
    root = tmp_path_factory.mktemp("span_path")
    ref, donor, insertions = CS.make_case(100_000, n_ins=4, n_snp=2, n_del=2, seed=21)
    CS.write_fasta(str(root / "ref.fa"), CS.CHROM, ref)
    ref2, donor2, _ = CS.make_case(20_000, n_ins=1, n_snp=1, n_del=1, seed=23)
    ref2[17_000:17_050] = 255
    CS.write_fasta(str(root / "ref.fa"), "chr2", ref2, mode="ab")
    reads = CS.write_reads(str(root / "reads"), donor, 30.0, seed=22)
    reads += "," + CS.write_reads(str(root / "reads2"), donor2, 30.0, seed=24)
    cuts = [0, 40_000, 80_000, donor.size]
    contigs = [donor[a + (150 if a else 0):b] for a, b in zip(cuts[:-1], cuts[1:])]
    with open(root / "contigs.fa", "w") as f:
        for i, c in enumerate(contigs):
            f.write(f">ctg{i}\n{CS.NUC[c].tobytes().decode()}\n")

    PS.scan_pay_q_span_cuda.launches = PW.walk_batch_span_cuda.launches = 0
    common = {"in": reads, "ref": str(root / "ref.fa"), "out": "t", "verbose": "0", "kmer-size": K}
    fills = {
        "jax": (jax_fill, {}, (("tf", "native", "bkpt"), ("tc", "native", "contig"),
                               ("tfd", "device", "bkpt"), ("tcd", "device", "contig"))),
        "port": (port_fill, {"device": "cpu"}, (("tf", "native", "bkpt"), ("tc", "native", "contig"),
                                                ("tfd", "device", "bkpt"), ("tfq", "device-qb", "bkpt"),
                                                ("tcd", "device", "contig"))),
    }
    for name, find, extra in (
        ("jax", jax_find, {"scan-engine": "host", "automaton": "native"}),
        ("port", port_find, {"device": "cpu"}),
    ):
        (root / name).mkdir()
        fill, fill_extra, runs_ = fills[name]
        with _cwd(root / name):
            find(dict(common, **extra), out=io.StringIO())
            for out, engine, mode in runs_:
                src = {"bkpt": "t.breakpoints"} if mode == "bkpt" else {"contig": str(root / "contigs.fa")}
                opts = {"graph": "t.h5", "out": out, "fill-engine": engine, "nb-cores": "1", "verbose": "0"}
                fill(dict(opts, **src, **(fill_extra if engine != "native" else {})), out=io.StringIO())
    return root, insertions


def _read(root, name, fname, drop=("##filedate",)):
    with open(root / name / fname) as f:
        return [line for line in f if not line.startswith(drop)]


@pytest.mark.parametrize("fname", ["t.breakpoints", "t.othervariants.vcf", "tf.insertions.fasta",
                                   "tf.insertions.vcf", "tf.info.txt", "tc.gfa", "tc.insertions.fasta",
                                   "tc.info.txt"])
def test_artifacts_identical(runs, fname):
    """find and the native fill at k = 45 write the JAX package's bytes."""
    root, _ = runs
    port = _read(root, "port", fname)
    assert port == _read(root, "jax", fname)
    assert port, f"{fname} is empty"


@pytest.mark.parametrize("fname", ["tfd.insertions.fasta", "tfd.insertions.vcf", "tfd.info.txt",
                                   "tfq.insertions.fasta", "tfq.insertions.vcf", "tfq.info.txt",
                                   "tcd.gfa", "tcd.insertions.fasta", "tcd.info.txt"])
def test_device_fill_artifacts(runs, fname):
    """The port's span walker (both device engines) writes the JAX span
    walker's artifacts and the JAX native fill's."""
    root, _ = runs
    drop = ("##filedate", "##REF")
    got = _read(root, "port", fname, drop=drop)
    assert got
    assert got == _read(root, "jax", fname.replace("tfq", "tfd"), drop=drop)
    native = fname.replace("tfd", "tf").replace("tfq", "tf").replace("tcd", "tc")
    assert got == _read(root, "jax", native, drop=drop)


def test_insertions_recalled(runs):
    root, insertions = runs
    filled = CS.filled_insertions(str(root / "port" / "tfd.insertions.fasta"))
    assert CS.insertion_recall(insertions, [f for f in filled if f[0] == CS.CHROM]) == 1.0
    assert {chrom for chrom, _p, _s in filled} == {CS.CHROM, "chr2"}


def test_no_kernel_launched_on_the_cpu(runs):
    """On device=cpu the path ran the kernels' plain versions only."""
    assert PS.scan_pay_q_span_cuda.launches == 0 and PW.walk_batch_span_cuda.launches == 0


@pytest.mark.parametrize("engine", [None, "device", "device-qp"], ids=["graph", "device", "device-qp"])
def test_find_from_the_jax_graph(runs, tmp_path, engine):
    """The port's find -graph on the JAX package's k = 45 graph writes the
    same bytes, by default and with -scan-engine device and device-qp (all
    three take the span scan at k > 32)."""
    root, _ = runs
    opts = {"graph": str(root / "jax" / "t.h5"), "ref": str(root / "ref.fa"), "out": "g", "device": "cpu",
            "verbose": "0"}
    if engine:
        opts["scan-engine"] = engine
    with _cwd(tmp_path):
        port_find(opts, out=io.StringIO())
    assert (tmp_path / "g.breakpoints").read_text() == (root / "jax" / "t.breakpoints").read_text()
    got = [line for line in (tmp_path / "g.othervariants.vcf").read_text().splitlines(True)
           if not line.startswith(("##filedate", "##SAMPLE"))]
    want = [line for line in _read(root, "jax", "t.othervariants.vcf") if not line.startswith("##SAMPLE")]
    assert got == want
