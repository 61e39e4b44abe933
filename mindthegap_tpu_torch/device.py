"""Device resolution for the port: one explicit choice per run.

The CLI runs on CUDA and raises when no CUDA device is present; `cpu` is a
hidden development option that runs every kernel's plain PyTorch version
(the tests use it). Plain functions take the resolved device explicitly:
there is no global device state.
"""

from __future__ import annotations

import time

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


def launch(what: str, launcher, *args, device: torch.device) -> None:
    """Call a kernel's C launcher with `device` current and that device's
    current stream as its last argument; raise on a CUDA error. The guard
    keeps a launch on its tensors' device: a default stream's handle is 0,
    the null stream of whichever device is current, so a mesh shard's
    launch on cuda:1 would otherwise go to cuda:0."""
    with torch.cuda.device(device):
        err = launcher(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


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


def stage_ms(fn, iters: int, warmup: int = 2, tries: int = 5) -> dict[str, float]:
    """Device ms per call of each kernel and memset that fn launches, by
    torch.profiler over `iters` calls after `warmup`: {short name: ms}, the
    name cut to the function's own (no namespace, template or arguments).
    Each window opens with a profiler step of one call whose records are
    dropped (the first launch after the profiler starts can go unrecorded).
    A window that still lost records (no device activity, a kernel seen
    fewer than `iters` times, or one missing a kernel that an earlier
    window held) is taken again, up to `tries` windows; RuntimeError when
    none was whole."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    names: set[str] = set()  # every kernel any window held
    for attempt in range(tries):
        if attempt:
            time.sleep(0.2)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA],
                                    schedule=torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            fn()
            torch.cuda.synchronize()
            prof.step()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            prof.step()
        out: dict[str, float] = {}
        seen: dict[str, int] = {}
        for evt in prof.key_averages():
            us = getattr(evt, "device_time_total", None) or getattr(evt, "cuda_time_total", 0)
            if us and not evt.key.startswith("ProfilerStep"):  # the step's span holds its kernels' time too
                head = evt.key.replace("(anonymous namespace)::", "").split("(")[0].split("<")[0].split("::")[-1].split()
                name = head[-1] if head else evt.key
                out[name] = out.get(name, 0.0) + us / 1e3 / iters
                seen[name] = seen.get(name, 0) + evt.count
        names |= set(seen)
        if names and all(seen.get(name, 0) >= iters for name in names):
            return out
    raise RuntimeError(f"torch.profiler lost records in {tries} windows of {iters} calls: the last counted {seen}, "
                       f"kernels seen {sorted(names)}")
