"""A run with the timed path broken underneath comes out not correct: the
harness runs as on the chip (its look for a chip skipped, the kernels'
plain versions), with one fault planted in the program for each test.

The faults a find cell can have: an answer altered where it is produced,
half of the answers left out, a scan step that leaves the automaton's
state unchanged, and (with counting in the job) a count altered where it
is produced. A cell runs on one chip, so no exchange between chips can be
left out."""

import time

import pytest

from tiny import bench, cell  # first: it puts the benchmark on sys.path
from mindthegap_tpu_torch.find import native_scan as NS
from mindthegap_tpu_torch.ops import counting_device as CD
from mtgbench import harness

_results = NS.NativeScanner.results
_count = CD.DeviceStreamingCounter.result


def altered(self):
    bkpt, vcf, stats = _results(self)
    lines = bkpt.split("\n")
    lines[1] = ("C" if lines[1][0] != "C" else "A") + lines[1][1:]  # the first left k-mer
    return "\n".join(lines), vcf, stats


def half_left_out(self):
    bkpt, vcf, stats = _results(self)
    lines = bkpt.splitlines(keepends=True)
    keep = (len(lines) // 4 // 2) * 4  # whole records of four lines
    vl = vcf.splitlines(keepends=True)
    return "".join(lines[:keep]), "".join(vl[: len(vl) // 2]), stats


def state_unchanged(self, name, seq, chunks, bed_intervals=None):
    for _ in chunks:  # the scan runs, its results never reach the automaton
        pass


def count_altered(self):
    res = _count(self)
    res.counts[res.counts.argmax()] += 1  # a solid k-mer's
    return res


FAULTS = [
    ("ecoli_k31.find_graph", NS.NativeScanner, "results", altered, "bkpt_lines_off"),
    ("ecoli_k31.find_graph", NS.NativeScanner, "results", half_left_out, "bkpt_lines_off"),
    ("ecoli_k45.find_graph", NS.NativeScanner, "results", half_left_out, "vcf_lines_off"),
    ("ecoli_k45.find_graph", NS.NativeScanner, "scan_sequence_pay", state_unchanged, "bkpt_lines_off"),
    ("ecoli_k31.find_reads", NS.NativeScanner, "results", altered, "bkpt_lines_off"),
    ("ecoli_k31.find_reads", CD.DeviceStreamingCounter, "result", count_altered, "graph_counts_off"),
]


@pytest.mark.parametrize("name,owner,attr,fault,check", FAULTS,
                         ids=[f"{f[0]}-{f[3].__name__}" for f in FAULTS])
def test_fault_is_not_correct(monkeypatch, name, owner, attr, fault, check):
    monkeypatch.setattr(owner, attr, fault)
    cfg, traffic = cell(name)
    r = harness.run_cell(bench(), name, 2**31 + 91, 0.5, False, time.perf_counter(), device="cpu",
                         config=cfg, traffic=traffic)
    assert r["correct"] is False
    assert r["checks"][check]["value"] > r["checks"][check]["limit"], r["checks"]


def test_failed_job_is_not_correct(monkeypatch):
    """A job that raises counts as failed, and its missing outputs as off."""
    cfg, traffic = cell("ecoli_k31.find_graph")

    class Raising:
        calls = 0

        @classmethod
        def main(cls, args):
            from mindthegap_tpu_torch import cli

            cls.calls += 1
            if cls.calls > 1:  # the warm-up job runs
                raise RuntimeError("planted")
            return cli.main(args)

    r = harness.run_cell(bench(), "ecoli_k31.find_graph", 5, 0.5, False, time.perf_counter(), device="cpu",
                         config=cfg, traffic=traffic, program=Raising)
    assert r["correct"] is False and r["failed"] == r["attempted"] == 1
    assert "planted" in r["errors"][0]
