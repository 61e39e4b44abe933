"""The generator: the same seed gives the same inputs, another seed other
ones, and the abundance arithmetic of a graph made without counting equals
a count of the reads it stands for."""

import os

import numpy as np
import pytest

from tiny import cell  # first: it puts the benchmark on sys.path
from mtgbench import gen
from mtgbench.reference import count as RC
from mtgbench.reference import words as W

SEED = 2**31 + 12345  # larger than 32 signed bits hold


def _files(tmp, seed, cfg):
    ref, donor, ins = gen.case_from_config(cfg, seed)
    lay = gen.ReadLayout(donor.size, cfg, seed + 1)
    gen.write_fasta(os.path.join(tmp, "ref.fa"), gen.CHROM, ref)
    gen.write_fastq(os.path.join(tmp, "r"), lay, donor)
    gen.write_graph(os.path.join(tmp, "g.h5"), cfg["kmer_size"], *gen.donor_graph(donor, lay, cfg["kmer_size"], 3), 3)
    out = {}
    for name in sorted(os.listdir(tmp)):
        with open(os.path.join(tmp, name), "rb") as f:
            out[name] = f.read()
    return out, ins


@pytest.mark.parametrize("cell_name", ["ecoli_k31.find_reads", "ecoli_k45.find_graph"])
def test_same_seed_same_inputs(tmp_path, cell_name):
    cfg, _ = cell(cell_name)
    (tmp_path / "a").mkdir(), (tmp_path / "b").mkdir(), (tmp_path / "c").mkdir()
    a, ins_a = _files(str(tmp_path / "a"), SEED, cfg)
    b, ins_b = _files(str(tmp_path / "b"), SEED, cfg)
    c, _ = _files(str(tmp_path / "c"), SEED + 1, cfg)
    assert a == b
    assert [(p, s.tobytes()) for p, s in ins_a] == [(p, s.tobytes()) for p, s in ins_b]
    assert all(a[name] != c[name] for name in ("ref.fa", "r_1.fq", "r_2.fq"))


def test_sizes_fixed_across_seeds():
    """Every seed gets the same genome length, variant counts and number
    of reads: the work of a job does not move with the seed."""
    cfg, _ = cell("ecoli_k31.find_reads", genome=60_000)
    sizes = set()
    for seed in (1, 2**31 + 7, 2**33 + 5):
        ref, donor, ins = gen.case_from_config(cfg, seed)
        lay = gen.ReadLayout(donor.size, cfg, seed + 1)
        sizes.add((ref.size, len(ins), sum(s[0].size for s in gen.reads(lay, donor))))
    assert len({s[0] for s in sizes}) == 1 and len({s[1] for s in sizes}) == 1


def test_reads_are_fastq_of_the_donor(tmp_path):
    cfg, _ = cell("ecoli_k31.find_reads")
    ref, donor, _ = gen.case_from_config(cfg, SEED)
    lay = gen.ReadLayout(donor.size, cfg, SEED + 1)
    paths = gen.write_fastq(str(tmp_path / "r"), lay, donor).split(",")
    lines = open(paths[0]).read().splitlines()
    assert len(lines) == 4 * lay.n_frag
    assert lines[0] == "@r" and lines[2] == "+" and lines[3] == "I" * 150 and len(lines[1]) == 150
    # about 0.1% of the bases differ from the donor
    n_err = sum(e.size for chunk in lay.chunks() for e in (chunk[2], chunk[4]))
    assert 0.0005 < n_err / (2 * lay.n_frag * 150) < 0.002


@pytest.mark.parametrize("k", [31, 45])
def test_kmer_abundance_equals_a_count_of_the_reads(k):
    cfg, _ = cell("ecoli_k31.find_reads", genome=30_000)
    ref, donor, _ = gen.case_from_config(cfg, SEED)
    lay = gen.ReadLayout(donor.size, cfg, SEED + 1)
    hi, lo, counts = gen.donor_graph(donor, lay, k, 1)
    # count every k-mer of every read, then keep the donor's
    got: dict = {}
    for r1, r2 in gen.reads(lay, donor):
        for r in (r1, r2):
            for row in r:
                h, l = W.canonical(*W.forward(row, k), k)
                for key in zip(h.tolist(), l.tolist()):
                    got[key] = got.get(key, 0) + 1
    want = dict(zip(zip(hi.tolist(), lo.tolist()), counts.tolist()))
    assert {key: got.get(key, 0) for key in want} == want


def test_reference_count_matches_a_plain_count():
    cfg, _ = cell("ecoli_k31.find_reads", genome=20_000)
    ref, donor, _ = gen.case_from_config(cfg, SEED)
    lay = gen.ReadLayout(donor.size, cfg, SEED + 1)
    keys, counts = RC.count_reads(gen.reads(lay, donor), 31, "cpu")
    plain: dict = {}
    for r1, r2 in gen.reads(lay, donor):
        for r in (r1, r2):
            _h, l = W.canonical(*W.forward(r.reshape(-1), 31), 31)
            ok = np.ones(l.size, bool)  # k-mers across two reads are not read k-mers
            pos = np.arange(l.size) % 150
            ok &= pos <= 150 - 31
            for key in l[ok].tolist():
                plain[key] = plain.get(key, 0) + 1
    assert dict(zip(keys.tolist(), counts.tolist())) == plain
