"""The readers of the program's nested -profile spans, on canned reports
read through harness.parse_phases: each reads its spans, the mean over a
window's jobs; none reads a report whose jobs lack its spans (the parent's
flat phases), and none raises there."""

import pytest

import tiny  # noqa: F401  (first: it puts the benchmark on sys.path)
from mtgbench import harness

REPORT = """Results
    Time                                     : 26.1 s
    Per-phase timings
        graph build                          : {gb:.3f} s
        graph build / parse                  : 1.250 s
        graph build / flush                  : 1.500 s
        graph build / flush / wait           : 0.300 s
        graph build / readback               : 0.200 s
        graph build / readback / wait        : 0.010 s
        graph build / solid filter           : 6.000 s
        graph build / branching              : 4.000 s
        graph build / save                   : 3.000 s
        reference repeat set                 : 0.300 s
        reference repeat set / parse         : 0.010 s
        scan engine setup                    : 5.200 s
        scan engine setup / map build        : 5.100 s
        scan engine setup / map build / keys    : 1.000 s
        scan engine setup / map build / place    : {place:.3f} s
        scan engine setup / upload           : 0.048 s
        scan+replay (fused)                  : 0.150 s
    Per-phase counts
        graph build / parse / bases          : 140000000
        graph build / flush / flushes        : 17
        scan engine setup / upload / bytes uploaded    : 268435456
    Output files
        breakpoint_file                      : p.breakpoints
"""

FLAT = """Results
    Per-phase timings
        graph build                          : 20.12 s
        reference repeat set                 : 0.30 s
        scan engine setup                    : 5.20 s
        scan+replay (fused)                  : 0.15 s
    Output files
"""

# (graph build, place) of each job; the other spans are the same in both
JOBS = ((20.0, 3.9), (22.0, 4.1))
# the children of "graph build" sum to 15.95 s in each job
WANT = {
    "find_reads.parse_s": 1.25,
    "find_reads.stage_s": 21.0 - 15.95,
    "find_reads.count_host_s": 1.7,
    "find_reads.graph_finish_s": 10.0,
    "find_reads.graph_save_s": 3.0,
    "find_graph.map_host_build_s": 5.1,
    "find_graph.map_place_s": 4.0,
    "find_graph.map_keys_s": 1.0,
    "find_graph.map_upload_s": 0.048,
}


def _run(reports):
    jobs = [harness.JobRecord(f"p{i}", 26.0, True, harness.parse_phases(r), {}) for i, r in enumerate(reports)]
    return harness.Run("c", {}, {}, "cpu", 10.0, jobs, 52.0, {}, None)


def test_nested_paths_parse_unchanged_and_stop_at_the_counts():
    phases = harness.parse_phases(REPORT.format(gb=20.0, place=3.9))
    assert phases["scan engine setup / map build / place"] == 3.9
    assert phases["graph build / flush / wait"] == 0.3
    assert len(phases) == 17 and not any("bases" in p or "bytes" in p for p in phases)


@pytest.mark.parametrize("name", list(WANT))
def test_span_readers(name):
    run = _run([REPORT.format(gb=gb, place=place) for gb, place in JOBS])
    assert harness.load("metrics", name).read(run) == pytest.approx(WANT[name], abs=1e-9)


def test_stage_is_graph_builds_self_time():
    """Self time: "graph build" less its direct children only (a wait
    inside a flush or a readback is not taken twice)."""
    run = _run([REPORT.format(gb=20.0, place=3.9)])
    phases = run.jobs[0].phases
    direct = [p for p in phases if p.startswith("graph build / ") and p.count(" / ") == 1]
    assert len(direct) == 6
    want = phases["graph build"] - sum(phases[p] for p in direct)
    assert harness.load("metrics", "find_reads.stage_s").read(run) == pytest.approx(want)


@pytest.mark.parametrize("name", list(WANT))
def test_span_readers_read_nothing_without_their_span(name):
    """A job with the flat phases only (as before the spans) gives None,
    whether alone or beside a job that has them."""
    assert harness.load("metrics", name).read(_run([FLAT])) is None
    assert harness.load("metrics", name).read(_run([REPORT.format(gb=20.0, place=3.9), FLAT])) is None
    assert harness.load("metrics", name).read(_run([])) is None
