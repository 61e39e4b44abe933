"""Device resolution for the port: one explicit choice per run.

The CLI runs on CUDA and raises when no CUDA device is present; `cpu` is a
hidden development option that runs every kernel's plain PyTorch version
(the tests use it). Plain functions take the resolved device explicitly:
there is no global device state.
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(name: str | torch.device | None = None) -> torch.device:
    if isinstance(name, torch.device):
        name = name.type
    name = (name or DEFAULT_DEVICE).lower()
    if name not in ("cuda", "cpu"):
        raise ValueError(f"unknown device {name!r} (choose cuda or cpu)")
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available (mindthegap_tpu_torch runs on an NVIDIA GPU)")
    return torch.device(name)


def check_kernel_tensor(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int | None = None):
    """Validate a tensor handed to a CUDA kernel wrapper."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if ndim is not None and t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dimensions, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of fn over `iters` calls after `warmup`, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters
