"""K1 (scan_cls_qp, csrc/scan_qp.cu): the pair map's reference scan at
k <= 32; its main kernel and the pass that places the exception tail."""

from mtgbench.yardsticks import scan_least_seconds as least_seconds  # noqa: F401

KERNELS = ("scan_cls_qp_kernel", "finish_kernel")
