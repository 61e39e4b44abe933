"""ctypes bridge to the native runtime helpers (native/stdcompat.cpp).

The library is compiled on demand (mindthegap_tpu_torch/_build.py). The
main entry point reproduces libstdc++ std::unordered_map iteration order,
which the reference relies on for its multi-target output ordering
(src/Filler.cpp:924-936)."""

from __future__ import annotations

import ctypes

from .._build import native_library

_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    _lib = native_library("stdcompat.cpp", "libmtgnative.so", ("-O2",))
    _lib.stdmap_iteration_order.restype = ctypes.c_int
    _lib.stdmap_iteration_order.argtypes = [
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_int),
    ]
    return _lib


def unordered_map_order(keys: list[str]) -> list[int]:
    """Indices of `keys` (insertion order) reordered as a libstdc++
    unordered_map<string, V> would iterate them. Duplicates keep their first
    index."""
    if not keys:
        return []
    # no insertion-order fallback: it would change GFA and VCF bytes, so a
    # failed build raises
    lib = _load()
    arr = (ctypes.c_char_p * len(keys))(*[k.encode("utf-8") for k in keys])
    out = (ctypes.c_int * len(keys))()
    n = lib.stdmap_iteration_order(arr, len(keys), out)
    return list(out[:n])
