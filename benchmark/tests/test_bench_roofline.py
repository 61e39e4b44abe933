"""The kernels' yardsticks: the least time from the cell's inputs alone."""

import pytest

import tiny  # noqa: F401  (first: it puts the benchmark on sys.path)
from mtgbench import harness
from mtgbench.readers import peaks

H100 = peaks("NVIDIA H100 80GB HBM3")


@pytest.mark.parametrize("kernel", ["k1", "k6"])
def test_scan_bound_is_bytes_over_bandwidth(kernel):
    mod = harness.load("roofline", kernel)
    n, k = 4_641_652, 31 if kernel == "k1" else 45
    kmers = n - k + 1
    want = (n / 4 + 32 * kmers + n) / 3.35e12
    assert mod.least_seconds({"ref_bp": n, "k": k}, H100) == pytest.approx(want)
    # the operations' time is far under the bytes' time
    assert kmers * 12 / H100["int32_ops_per_s"] < want / 10


def test_same_work_same_bound():
    a = harness.load("roofline", "k1").least_seconds({"ref_bp": 1_000_000, "k": 31}, H100)
    b = harness.load("roofline", "k1").least_seconds({"ref_bp": 1_000_000, "k": 31}, H100)
    assert a == b and a == pytest.approx((250_000 + 32 * 999_970 + 1_000_000) / 3.35e12)


def test_peaks_table():
    assert H100["bytes_per_s"] == 3.35e12
    assert peaks("cpu") is None
