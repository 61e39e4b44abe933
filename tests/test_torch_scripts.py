"""The port's analysis scripts (mindthegap_tpu_torch/scripts) against the
originals (scripts/python3/*.py, which run over the JAX package), byte for
byte, on the CPU: context_genome_wg at k = 31 and k = 45 (the filtered
.breakpoints file and its `kept N breakpoints, filtered M` line, with both
kept and filtered records) under `-device cpu`, and its device route
(the plane passes of K15 and K16 in find's windows, here their plain
versions) against the host plane pass over small windows;
insert_snp_in_ref's SNP-written FASTA. Each original runs as a
subprocess, as a user runs it, and so does the port's `python -m`."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from mindthegap_tpu_torch.find import scan
from mindthegap_tpu_torch.graph.dbg import Graph
from mindthegap_tpu_torch.scripts import context_genome_wg as C
from torch_tables import script_case

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ORIGINALS = os.path.join(REPO, "scripts", "python3")


def _run(args, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run([sys.executable, *args], cwd=cwd, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    return r.stdout


@pytest.fixture(scope="module", params=[31, 45])
def case(request, tmp_path_factory):
    root = tmp_path_factory.mktemp(f"scripts_k{request.param}")
    return request.param, str(root), script_case(str(root), request.param)


@pytest.mark.parametrize("threshold", [None, "0.9"])
def test_context_genome_wg_matches_original(case, threshold):
    """The port's context_genome_wg (`-device cpu`) writes the original's
    bytes and prints its line; the case keeps some breakpoints and filters
    some of those whose upstream window branches: at the default 0.8 those
    of the most branching windows, at 0.9 more."""
    k, root, c = case
    p = c["paths"]
    extra = [] if threshold is None else ["-m", threshold]
    tag = threshold or "default"
    args = ["-g", p["graph.h5"], "-p", p["ref.fa"], "-b", p["t.breakpoints"]]
    want = _run([os.path.join(ORIGINALS, "context_genome_wg.py"), *args, "-o", f"orig_{tag}.bkpt", *extra], root)
    got = _run(["-m", "mindthegap_tpu_torch.scripts.context_genome_wg", *args, "-o", f"port_{tag}.bkpt", *extra,
                "-device", "cpu"], root)
    assert got == want
    with open(os.path.join(root, f"port_{tag}.bkpt")) as a, open(os.path.join(root, f"orig_{tag}.bkpt")) as b:
        assert a.read() == b.read()
    kept, filtered = (int(x) for x in got.split()[1::3][:2])
    assert kept > 0 and 0 < filtered < len(c["planted"]), got
    assert filtered == (1 if threshold is None else 4), got


@pytest.mark.parametrize("window", [256, 4096])
def test_device_route_degrees_match_host_planes(case, window):
    """context_genome_wg's device route (find's windows with a halo of k -
    1 bases, the plane pass of K15 or K16 over a map built with no repeat
    set; on the CPU their plain versions) gives compute_planes' degrees
    nb_in + nb_out on every sequence, over many windows and one, and on a
    sequence shorter than k."""
    k, _root, c = case
    graph = Graph.load(c["paths"]["graph.h5"])
    degrees = C.device_degree_fn(graph, torch.device("cpu"), window=window)
    empty = np.zeros(0, np.uint64)
    for codes in (*c["seqs"].values(), c["seqs"]["ref"][: k - 1], c["seqs"]["ref"][:k]):
        planes = scan.compute_planes(codes, k, graph.solid.kmers, empty)
        want = planes.nb_in + planes.nb_out
        got = degrees(codes)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    assert (degrees(c["seqs"]["ref"]) > 2).sum() > 0


def test_insert_snp_in_ref_matches_original(tmp_path):
    """The port's insert_snp_in_ref writes the original's FASTA and prints
    its line: SNPs on two sequences, lowercase reference bases and
    alleles, and the records it skips (a reference base that differs,
    positions past the end, indels, multi-allelic and non-ACGT alleles, a
    sequence the reference does not hold, short lines, the header)."""
    rng = np.random.default_rng(7)
    letters = np.frombuffer(b"ACGTacgt", np.uint8)
    seqs = {"chr1": letters[rng.integers(0, 8, 3000)].tobytes().decode(),
            "chr2": letters[rng.integers(0, 4, 1500)].tobytes().decode() + "NNNN" + "acgt" * 50}
    with open(tmp_path / "ref.fa", "w") as f:
        for name, seq in seqs.items():
            f.write(f">{name} description here\n")
            for i in range(0, len(seq), 60):
                f.write(seq[i : i + 60] + "\n")
    rows = ["##fileformat=VCFv4.2", "#CHROM\tPOS\tID\tREF\tALT\tQUAL"]
    for name, seq in seqs.items():
        for pos in rng.choice(len(seq), 40, replace=False):
            ref = seq[pos]
            alt = "ACGT"[(("ACGT".find(ref.upper()) + 1) % 4)] if ref.upper() in "ACGT" else "A"
            rows.append(f"{name}\t{pos + 1}\t.\t{ref if pos % 3 else ref.lower()}\t{alt.lower() if pos % 5 == 0 else alt}\t50")
    rows += ["chr1\t5\t.\tG\tT\t50" if seqs["chr1"][4].upper() != "G" else "chr1\t5\t.\tA\tT\t50",
             "chr1\t99999\t.\tA\tC\t50", "chr1\t10\t.\tAC\tA\t50", "chr1\t11\t.\tA\tC,G\t50",
             "chr1\t12\t.\tA\tN\t50", "chr9\t3\t.\tA\tC\t50", "chr1\t13\t.\tA"]
    (tmp_path / "calls.vcf").write_text("\n".join(rows) + "\n")
    args = ["-s", "calls.vcf", "-g", "ref.fa"]
    want = _run([os.path.join(ORIGINALS, "insert_snp_in_ref.py"), *args, "-o", "orig.fa"], str(tmp_path))
    got = _run(["-m", "mindthegap_tpu_torch.scripts.insert_snp_in_ref", *args, "-o", "port.fa"], str(tmp_path))
    assert got == want
    applied, skipped = int(got.split()[1]), int(got.split()[4])
    assert applied > 40 and skipped == 2, got  # a differing reference base, a position past the end
    assert (tmp_path / "port.fa").read_bytes() == (tmp_path / "orig.fa").read_bytes()
