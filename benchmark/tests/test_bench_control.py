"""The control (the reference with a Bloom filter in place of the exact
solid set) fails the cell's comparison, at a size a test run holds; the
chip run at each cell's own size is `benchmark/control.py`."""

import pytest

from tiny import cell  # first: it puts the benchmark on sys.path
from mtgbench import control


@pytest.mark.parametrize("name", ["ecoli_k31.find_graph", "ecoli_k45.find_graph", "ecoli_k31.find_reads"])
def test_control_fails_the_comparison(name):
    cfg, traffic = cell(name, genome=300_000)
    checks = control.control_checks(cfg, traffic, 2**31 + 3, "cpu")
    assert checks["bkpt_lines_off"] > 0, checks
    if "graph_kmers_off" in checks:  # the counts are the control's too, and exact
        assert checks["graph_kmers_off"] == checks["graph_counts_off"] == checks["graph_info_off"] == 0


def test_exact_reference_in_the_programs_place_passes():
    cfg, traffic = cell("ecoli_k31.find_graph", genome=60_000)
    checks = control.control_checks(cfg, traffic, 7, "cpu", member=lambda solid: solid)
    assert checks == {"bkpt_lines_off": 0, "vcf_lines_off": 0}
