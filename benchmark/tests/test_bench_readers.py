"""The metric readers, on a canned -profile report and a canned Chrome
trace; and what they return where there is nothing to read."""

import json

import pytest

import tiny  # noqa: F401  (first: it puts the benchmark on sys.path)
from mtgbench import harness
from mtgbench import trace as T

REPORT = """Results
    Time                                     : 6.1 s
    Per-phase timings                   
        graph load                           : 0.52 s
        reference repeat set                 : 0.18 s
        scan engine setup                    : 4.63 s
        scan+replay (fused)                  : 0.11 s
    Output files                        
        breakpoint_file                      : p.breakpoints
"""


def test_parse_phases():
    assert harness.parse_phases(REPORT) == {"graph load": 0.52, "reference repeat set": 0.18,
                                           "scan engine setup": 4.63, "scan+replay (fused)": 0.11}
    assert harness.parse_phases("no phases") == {}


def _trace(tmp_path, lost_k1=False):
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": T.WINDOW_SPAN, "ts": 1000.0, "dur": 10_000_000.0},
        {"ph": "X", "cat": "user_annotation", "name": T.JOB_SPAN + ".0", "ts": 1000.0, "dur": 5_000_000.0},
        {"ph": "X", "cat": "user_annotation", "name": T.JOB_SPAN + ".1", "ts": 5_001_000.0, "dur": 5_000_000.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pageable -> Device)", "ts": 2_000_000.0, "dur": 40_000.0},
        {"ph": "X", "cat": "kernel", "name": "scan_cls_qp_kernel(unsigned char const*, int)", "ts": 2_100_000.0, "dur": 100.0},
        {"ph": "X", "cat": "kernel", "name": "finish_kernel(short*)", "ts": 2_100_200.0, "dur": 10.0},
        {"ph": "X", "cat": "kernel", "name": "void scan_span_kernel<2, 4>(unsigned char const*)", "ts": 7_000_000.0, "dur": 200.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add_", "ts": 1500.0, "dur": 5.0},
    ]
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": ev}))
    tr = T.read_chrome_trace(str(p))
    if lost_k1:
        tr.lost = {"scan_cls_qp_kernel"}
    return tr


def _run(tr, phases, device="NVIDIA H100 80GB HBM3"):
    jobs = [harness.JobRecord(f"p{i}", 5.0, True, dict(phases), {"ref_bp": 4_641_652}) for i in range(2)]
    return harness.Run("c", {}, {}, device, 12.5, jobs, 10.0, {"ref_bp": 4_641_652, "k": 31}, tr)


def test_trace_busy_idle_and_breakdown(tmp_path):
    tr = _trace(tmp_path)
    assert tr.window_s == pytest.approx(10.0)
    assert tr.busy_s == pytest.approx((40_000 + 100 + 10 + 200) / 1e6)
    ops = dict(tr.device_ops())
    assert ops["scan_cls_qp_kernel"] == pytest.approx(1e-4) and ops["scan_span_kernel"] == pytest.approx(2e-4)
    gaps = tr.idle_gaps()
    assert gaps[0][0] == "jobs 0-1: after finish_kernel, before scan_span_kernel"
    assert sum(g for _n, g in tr.idle_gaps(100)) == pytest.approx(tr.window_s - tr.busy_s)


def test_readers_on_canned_inputs(tmp_path):
    run = _run(_trace(tmp_path), harness.parse_phases(REPORT))
    read = lambda name: harness.load("metrics", name).read(run)  # noqa: E731
    assert read("setup_s") == 12.5
    assert read("find_graph_mbp_per_s") == pytest.approx(2 * 4.641652 / 10.0)
    assert read("find_reads_mbp_per_s") is None  # no job reports read bases
    assert read("find_graph.map_build_s") == pytest.approx(4.63)
    assert read("find_graph.graph_prep_s") == pytest.approx(0.70)
    assert read("find_graph.scan_replay_s") == pytest.approx(0.11)
    assert read("find_reads.graph_build_s") is None
    assert read("device_idle_pct.find_graph") == pytest.approx(100 * (1 - run.trace.busy_s / 10.0))
    k1 = harness.load("roofline", "k1").least_seconds(run.kernel_inputs, {"bytes_per_s": 3.35e12,
                                                                          "int32_ops_per_s": 1.6727e13})
    assert read("k1_roofline") == pytest.approx(100 * 2 * k1 / 110e-6)
    assert read("find_reads.count_device_ms") is None  # no counting kernel ran


def test_device_readers_refuse_without_a_trace_or_peaks(tmp_path):
    run = _run(None, {})
    for name in ("k1_roofline", "k6_roofline", "device_idle_pct.find_graph", "find_reads.count_device_ms"):
        assert harness.load("metrics", name).read(run) is None
    assert harness.load("metrics", "find_graph.map_build_s").read(run) is None
    assert harness.load("metrics", "k1_roofline").read(_run(_trace(tmp_path), {}, device="cpu")) is None


def test_a_lost_kernel_is_not_read_as_zero(tmp_path):
    run = _run(_trace(tmp_path, lost_k1=True), {})
    assert harness.load("metrics", "k1_roofline").read(run) is None
    assert harness.load("metrics", "k6_roofline").read(run) is not None
