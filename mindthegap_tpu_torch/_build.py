"""Build-at-first-use for the port's native and CUDA libraries.

Host libraries compile from the repository's `native/*.cpp` with g++; GPU
kernels compile from `csrc/*.cu` with nvcc for Hopper (`sm_90a`) into a
shared library with a plain C interface, loaded with ctypes. Outputs go to
`mindthegap_tpu_torch/_build/` (never next to the sources, so this package
never races the JAX package's in-place `native/*.so` builds), written under
a temporary name and renamed into place, so concurrent processes never load
a half-written file. A failed build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import functools
import os
import re
import shutil
import subprocess

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NATIVE_DIR = os.path.join(os.path.dirname(_PKG_DIR), "native")
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")

CUDA_ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")


class BuildError(RuntimeError):
    pass


def _build_if_stale(sources: list[str], out: str, cmd_for) -> None:
    """Run `cmd_for(tmp_path)` when `out` is missing or older than a source."""
    if os.path.exists(out) and all(os.path.getmtime(out) >= os.path.getmtime(s) for s in sources):
        return
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = cmd_for(tmp)
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise BuildError(f"build failed: {' '.join(cmd)}\n{r.stdout}{r.stderr}")
    os.replace(tmp, out)


@functools.cache
def native_library(src_name: str, lib_name: str, flags: tuple = ("-O3",), libs: tuple = ()) -> ctypes.CDLL:
    """Compile `native/<src_name>` with g++ (once per process) and load it."""
    src = os.path.join(NATIVE_DIR, src_name)
    out = os.path.join(BUILD_DIR, lib_name)
    _build_if_stale(
        [src], out, lambda tmp: ["g++", *flags, "-shared", "-fPIC", "-o", tmp, src, *libs]
    )
    return ctypes.CDLL(out)


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise BuildError("nvcc not found: the CUDA toolkit is needed to build the GPU kernels")


def ptxas_usage(src_name: str) -> list[tuple[str, int, int]]:
    """(kernel, registers, spill store bytes) of every kernel that
    `csrc/<src_name>` instantiates, from nvcc -Xptxas -v (the object file
    is thrown away); kernel is the mangled name, template arguments
    included."""
    src = os.path.join(CSRC_DIR, src_name)
    os.makedirs(BUILD_DIR, exist_ok=True)
    obj = os.path.join(BUILD_DIR, f"ptxas_{src_name}.{os.getpid()}.o")
    cmd = [nvcc_path(), *CUDA_ARCH_FLAGS, "-std=c++17", "-O3", "-Xptxas", "-v", "-c", "-o", obj, src]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if os.path.exists(obj):
        os.remove(obj)
    if r.returncode != 0:
        raise BuildError(f"build failed: {' '.join(cmd)}\n{r.stdout}{r.stderr}")
    return parse_ptxas(r.stdout + r.stderr)


def parse_ptxas(log: str) -> list[tuple[str, int, int]]:
    """(kernel, registers, spill store bytes) of every entry function in
    the output of an nvcc -Xptxas -v build."""
    out, name, spill = [], None, 0
    for line in log.splitlines():
        if m := re.search(r"Compiling entry function '(\w+)'", line):
            name, spill = m.group(1), 0
        elif m := re.search(r"(\d+) bytes spill stores", line):
            spill = int(m.group(1))
        elif (m := re.search(r"Used (\d+) registers", line)) and name:
            out.append((name, int(m.group(1)), spill))
            name = None
    return out


@functools.cache
def cuda_library(src_name: str, lib_name: str) -> ctypes.CDLL:
    """Compile `csrc/<src_name>` with nvcc for sm_90a (once per process) and
    load it; it is rebuilt when it or any `csrc/*.cuh` header is newer."""
    src = os.path.join(CSRC_DIR, src_name)
    out = os.path.join(BUILD_DIR, lib_name)
    headers = [os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR) if f.endswith(".cuh")]
    _build_if_stale(
        [src, *headers], out,
        lambda tmp: [nvcc_path(), *CUDA_ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
                     "-Xcompiler", "-fPIC", "-o", tmp, src],
    )
    return ctypes.CDLL(out)
