"""K6 (scan_pay_q_span, csrc/scan_span.cu): the span map's reference scan
at 32 < k <= 256."""

from mtgbench.yardsticks import scan_least_seconds as least_seconds  # noqa: F401

KERNELS = ("scan_span_kernel",)
