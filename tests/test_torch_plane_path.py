"""The plane path of the port's `find` against the JAX package, on the CPU:
every way a window's planes reach an automaton. One graph per package and
k is built from seeded reads (a genome with planted insertions, SNPs,
deletions and an N run in the reference); the port then runs `find -graph
... -device cpu` (each kernel's plain version) with the host oracle
(`-scan-engine host`), the cuckoo map (`device`, K8's plain version), the
bucket map (`device-qb`, K9's) and the Python automaton (`-automaton
host`: the pair map's dense stream, K10's plain version, then
planes_from_pay; at k = 45 the span scan, then planes_from_pay_span, on
one device and, `-scan-engine sharded`, over 2 logical shards), and
must write the JAX run's `.breakpoints` and VCF records byte for byte (the
VCF headers apart from ##filedate and ##SAMPLE, which names the input).
The JAX run is its host scan into its native automaton, which the JAX
package's own tests hold equal to its device engines and its Python
automaton."""

import contextlib
import io
import os

import pytest

import chip_smoke as CS
from mindthegap_tpu.find.runner import run_find as jax_find
from mindthegap_tpu_torch.find.runner import run_find as port_find
from mindthegap_tpu_torch.parallel import mesh as PM

CASES = {
    31: {"host": {"scan-engine": "host"}, "device": {"scan-engine": "device"},
         "device-qb": {"scan-engine": "device-qb"}, "automaton-host": {"automaton": "host"},
         "automaton-host-device-qb": {"automaton": "host", "scan-engine": "device-qb"}},
    45: {"host": {"scan-engine": "host"}, "device-qb": {"scan-engine": "device-qb"},
         "automaton-host": {"automaton": "host"},
         # the span map over a mesh of 2 logical CPU shards: K6's plain version on each shard
         "sharded": {"scan-engine": "sharded"},
         "sharded-automaton-host": {"scan-engine": "sharded", "automaton": "host"}},
}
GENOME = {31: 100_000, 45: 50_000}  # k = 45 counts on the host (~0.7 ms a read): a smaller case


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
    """{k: the case's directory}: the JAX run (jax/t.*), the port's graph
    (port/t.h5) and the port's plane-path runs (port/<case>.*)."""
    out = {}
    for k, cases in CASES.items():
        root = tmp_path_factory.mktemp(f"plane_path_k{k}")
        n = GENOME[k]
        ref, donor, _ = CS.make_case(n, n_ins=3, n_snp=2, n_del=2, seed=k)
        ref[n // 3 : n // 3 + 40] = 255
        CS.write_fasta(str(root / "ref.fa"), CS.CHROM, ref)
        reads = CS.write_reads(str(root / "reads"), donor, 30.0, seed=k + 1)
        common = {"in": reads, "ref": str(root / "ref.fa"), "out": "t", "verbose": "0", "kmer-size": str(k)}
        for name, find, extra in (("jax", jax_find, {"scan-engine": "host"}), ("port", port_find, {"device": "cpu"})):
            (root / name).mkdir()
            with _cwd(root / name):
                find(dict(common, **extra), out=io.StringIO())
        with _cwd(root / "port"):
            for case, extra in cases.items():
                mesh = PM.logical_devices(["cpu"] * 2) if case.startswith("sharded") else contextlib.nullcontext()
                with mesh:
                    port_find(dict({"graph": "t.h5", "ref": str(root / "ref.fa"), "out": case, "verbose": "0",
                                    "device": "cpu"}, **extra), out=io.StringIO())
        out[k] = root
    return out


def _read(path):
    with open(path) as f:
        return [line for line in f if not line.startswith(("##filedate", "##SAMPLE"))]


@pytest.mark.parametrize("ext", ["breakpoints", "othervariants.vcf"])
@pytest.mark.parametrize("k,case", [(k, case) for k, cases in CASES.items() for case in cases])
def test_plane_path_matches_jax(runs, k, case, ext):
    got = _read(runs[k] / "port" / f"{case}.{ext}")
    want = _read(runs[k] / "jax" / f"t.{ext}")
    assert got == want
    if ext == "breakpoints":
        assert sum(line.startswith(">") for line in got) >= 4  # the planted insertions are found
