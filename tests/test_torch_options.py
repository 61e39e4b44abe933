"""The port's `find` and `fill -bkpt` options held byte for byte to the JAX
package (the JAX package on its host scan into the native automaton, the
port on `-device cpu`), on one seeded ~60 kbp case built once: a genome
with 4 insertions, 3 SNPs and 3 deletions, 25x error-free reads. The
default `find` from the reads runs once in each package; the find options
that act on the scan rerun it on its graph, those that act on counting
rerun it from the reads, and every fill option fills the default run's
breakpoints over its graph. Outputs compared: .breakpoints and
.othervariants.vcf of a find, .insertions.fasta, .insertions.vcf and
.info.txt of a fill (the VCF's ##filedate apart)."""

import contextlib
import io
import os
import subprocess
import sys

import pytest

import chip_smoke as CS
from mindthegap_tpu.fill.runner import run_fill as jax_fill
from mindthegap_tpu.find.runner import run_find as jax_find
from mindthegap_tpu_torch.fill.runner import run_fill as port_fill
from mindthegap_tpu_torch.find.runner import run_find as port_find

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNS = {"jax": (jax_find, jax_fill, {"scan-engine": "host", "automaton": "native"}),
        "port": (port_find, port_fill, {"device": "cpu"})}

# find options over the default run's graph (they act on the scan)
FIND_GRAPH_OPTIONS = {"insert-only": {"insert-only": True}, "homo-only": {"homo-only": True},
                      "snp-only": {"snp-only": True}, "no-deletion": {"no-deletion": True},
                      "max-rep": {"max-rep": "2"}, "branching-filter": {"branching-filter": "1"},
                      "bed": {"bed": "regions.bed"}}
# find options from the reads (they act on counting)
FIND_READS_OPTIONS = {"abundance-max": {"abundance-max": "40"}, "abundance-min": {"abundance-min": "3"},
                      "count-engine-partitioned": {"count-engine": "partitioned"}}
FILL_OPTIONS = {"filter": {"filter": True}, "extend": {"extend": True}, "fwd-only": {"fwd-only": True},
                "overlap": {"overlap": "10"}, "max-nodes": {"max-nodes": "20"}, "max-length": {"max-length": "200"},
                "nb-cores": {"nb-cores": "3"}}


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
    """The case's files and each package's default find from the reads
    (t.h5, t.breakpoints) in a directory of its own."""
    root = tmp_path_factory.mktemp("options")
    ref, donor, insertions = CS.make_case(60_000, n_ins=4, n_snp=3, n_del=3, seed=17)
    CS.write_fasta(str(root / "ref.fa"), CS.CHROM, ref)
    reads = CS.write_reads(str(root / "reads"), donor, 25.0, seed=18)
    # two regions, each around some of the planted variants
    (root / "regions.bed").write_text(f"{CS.CHROM}\t100\t25000\n#a comment\n{CS.CHROM}\t40000\t59000\n")
    for name, (find, _fill, extra) in RUNS.items():
        (root / name).mkdir()
        with _cwd(root / name):
            find(dict({"in": reads, "ref": str(root / "ref.fa"), "out": "t", "verbose": "0"}, **extra),
                 out=io.StringIO())
    return root, reads


def _read(path, drop=("##filedate",)):
    with open(path) as f:
        return [line for line in f if not line.startswith(drop)]


def _same_outputs(root, names):
    for fname in names:
        port, jax = _read(root / "port" / fname), _read(root / "jax" / fname)
        assert port == jax, fname


def test_default_find_has_records(case):
    """The default runs that the grid starts from find the planted
    variants, and agree."""
    root, _ = case
    _same_outputs(root, ("t.breakpoints", "t.othervariants.vcf"))
    assert sum(line.startswith(">") for line in _read(root / "port" / "t.breakpoints")) >= 8
    assert len([line for line in _read(root / "port" / "t.othervariants.vcf") if not line.startswith("#")]) >= 3


@pytest.mark.parametrize("option", list(FIND_GRAPH_OPTIONS) + list(FIND_READS_OPTIONS))
def test_find_option_matches_jax(case, option):
    """`find` under one option writes the JAX package's .breakpoints and
    .othervariants.vcf."""
    root, reads = case
    out = f"f_{option}"
    for name, (find, _fill, extra) in RUNS.items():
        if option in FIND_GRAPH_OPTIONS:
            opts = dict({"graph": "t.h5"}, **FIND_GRAPH_OPTIONS[option])
        else:
            opts = dict({"in": reads}, **FIND_READS_OPTIONS[option])
        if option == "bed":
            opts["bed"] = str(root / "regions.bed")
        with _cwd(root / name):
            find(dict(opts, ref=str(root / "ref.fa"), out=out, verbose="0", **extra), out=io.StringIO())
    _same_outputs(root, (f"{out}.breakpoints", f"{out}.othervariants.vcf"))


def _fill_cli(name: str, cwd, args):
    """A fill through the package's CLI in a process of its own (a pool of
    forked workers must not start inside a process that runs JAX)."""
    cli = [os.path.join(REPO, "bin", "MindTheGap")] if name == "jax" else ["-m", "mindthegap_tpu_torch"]
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run([sys.executable, *cli, "fill", *args], cwd=cwd, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.parametrize("option", list(FILL_OPTIONS))
def test_fill_option_matches_jax(case, option):
    """`fill -bkpt` under one option, on the default find's breakpoints and
    graph, writes the JAX package's insertions, their VCF and the info
    file (-nb-cores 3 through each package's CLI)."""
    root, _ = case
    out = f"b_{option}"
    for name, (_find, fill, _extra) in RUNS.items():
        opts = dict({"graph": "t.h5", "bkpt": "t.breakpoints", "out": out, "verbose": "0", "nb-cores": "1"},
                    **FILL_OPTIONS[option])
        if option == "nb-cores":
            _fill_cli(name, root / name, [arg for key, v in opts.items() for arg in (f"-{key}", v)])
            continue
        with _cwd(root / name):
            fill(opts, out=io.StringIO())
    _same_outputs(root, (f"{out}.insertions.fasta", f"{out}.insertions.vcf", f"{out}.info.txt"))
    assert _read(root / "port" / f"{out}.insertions.fasta") or option in ("filter", "max-length", "max-nodes")
