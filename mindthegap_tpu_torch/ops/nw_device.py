"""Needleman-Wunsch identity as an anti-diagonal wavefront on the GPU.

Cells on diagonal d = i + j depend only on diagonals d-1 and d-2, so each
step updates a whole diagonal at once and only three diagonals stay live
(O(n) memory for an O(n*m) DP). Semantics are the reference's exactly
(src/Utils.cpp:87-189 via ops/nw.py): gap -5, mismatch -5, match +10,
identity = traceback matches / max(n, m) with diagonal > up > left
preference; the traceback is emulated forward by carrying, per cell, the
match count along the path the backward traceback would take.

`nw_matches` runs the hand kernel K2 (csrc/nw.cu) on CUDA tensors and its
plain PyTorch version on CPU tensors. `nwalign --device` is its caller.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..device import check_kernel_tensor, resolve_device

GAP = -5
MIS = -5
MATCH = 10
_NEG = -(1 << 28)


def pack_pairs(pairs) -> tuple[torch.Tensor, torch.Tensor]:
    """(a, b) string pairs -> (seq u8: a_0 b_0 a_1 b_1 ... concatenated,
    off int64[2B+1]: a_p = seq[off[2p]:off[2p+1]], b_p = seq[off[2p+1]:off[2p+2]])."""
    parts = [s.encode() for pair in pairs for s in pair]
    lens = np.array([len(s) for s in parts], np.int64)
    off = np.zeros(len(parts) + 1, np.int64)
    np.cumsum(lens, out=off[1:])
    seq = np.frombuffer(b"".join(parts), np.uint8).copy()
    return torch.from_numpy(seq), torch.from_numpy(off)


def _nw_matches_plain(seq: torch.Tensor, off: torch.Tensor) -> torch.Tensor:
    """Plain version of K2: all pairs' diagonals advance together as [B, n_max+1]
    tensors; lane i of diagonal d is cell (i, d - i)."""
    dev = seq.device
    o = off.tolist()
    nb = (len(o) - 1) // 2
    n = torch.tensor([o[2 * p + 1] - o[2 * p] for p in range(nb)], dtype=torch.int64, device=dev)
    m = torch.tensor([o[2 * p + 2] - o[2 * p + 1] for p in range(nb)], dtype=torch.int64, device=dev)
    out = torch.zeros(nb, dtype=torch.int32, device=dev)
    if nb == 0:
        return out
    n_max, m_max = int(n.max()), int(m.max())
    width = n_max + 1
    # a[p, i] = a_p[i-1] (lane 0 and lanes past n_p hold -1); b[p, j] = b_p[j-1]
    a = torch.full((nb, width), -1, dtype=torch.int32, device=dev)
    b = torch.full((nb, m_max + 2), -2, dtype=torch.int32, device=dev)
    s32 = seq.to(torch.int32)
    for p in range(nb):
        a[p, 1 : 1 + o[2 * p + 1] - o[2 * p]] = s32[o[2 * p] : o[2 * p + 1]]
        b[p, 1 : 1 + o[2 * p + 2] - o[2 * p + 1]] = s32[o[2 * p + 1] : o[2 * p + 2]]
    iota = torch.arange(width, device=dev)
    nc, mc = n[:, None], m[:, None]
    neg = torch.full((nb, 1), _NEG, dtype=torch.int32, device=dev)
    zero = torch.zeros((nb, 1), dtype=torch.int32, device=dev)

    def right1(x, fill):  # lane i <- lane i-1
        return torch.cat([fill, x[:, :-1]], dim=1)

    d2 = torch.where(iota == 0, 0, _NEG).to(torch.int32).expand(nb, width)
    d1 = torch.where(iota <= 1, GAP, _NEG).to(torch.int32).expand(nb, width)
    f2 = torch.zeros((nb, width), dtype=torch.int32, device=dev)
    f1 = torch.zeros((nb, width), dtype=torch.int32, device=dev)
    total = n + m
    for d in range(2, int(total.max()) + 1):
        j = (d - iota).clamp(0, m_max + 1)
        eq = a == b[:, j]
        diag = right1(d2, neg) + torch.where(eq, MATCH, MIS).to(torch.int32)
        up = right1(d1, neg) + GAP
        left = d1 + GAP
        s = torch.maximum(diag, torch.maximum(up, left))
        f = torch.where(s == diag, right1(f2, zero) + eq.to(torch.int32),
                        torch.where(s == up, right1(f1, zero), f1))
        border = ((iota == 0) & (d <= mc)) | ((iota == d) & (d <= nc))
        s = torch.where(border, GAP * d, s)
        f = torch.where(border, 0, f)
        s = torch.where((iota > d) | (d - iota > mc), _NEG, s).to(torch.int32)
        d2, f2, d1, f1 = d1, f1, s, f.to(torch.int32)
        done = total == d
        if bool(done.any()):
            out = torch.where(done, f1.gather(1, n[:, None])[:, 0], out)
    return out


_NW_LIB = None


def _nw_lib():
    global _NW_LIB
    if _NW_LIB is None:
        from .._build import cuda_library

        lib = cuda_library("nw.cu", "libmtg_nw.so")
        lib.nw_matches_shared_launch.restype = ctypes.c_int
        lib.nw_matches_shared_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.nw_matches_global_launch.restype = ctypes.c_int
        lib.nw_matches_global_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
        ]
        lib.nw_max_shared_bytes.restype = ctypes.c_int
        lib.nw_max_shared_bytes.argtypes = [ctypes.POINTER(ctypes.c_int)]
        _NW_LIB = lib
    return _NW_LIB


def _check(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what} failed: CUDA error {err}")


def nw_matches_cuda(seq: torch.Tensor, off: torch.Tensor) -> torch.Tensor:
    """K2 (csrc/nw.cu): traceback match counts, int32[B]. Pairs whose three
    diagonals fit the block's shared memory run in one launch, the rest in
    a second launch over a global scratch buffer. Counts its launches in
    `nw_matches_cuda.launches`."""
    check_kernel_tensor(seq, "seq", torch.uint8, 1)
    check_kernel_tensor(off, "off", torch.int64, 1)
    if off.shape[0] % 2 != 1:
        raise ValueError("off must hold 2B+1 offsets")
    lib = _nw_lib()
    nb = (off.shape[0] - 1) // 2
    out = torch.zeros(nb, dtype=torch.int32, device=seq.device)
    if nb == 0:
        return out
    o = off.cpu()
    n = o[1::2] - o[0:-1:2]
    if bool((o[1:] < o[:-1]).any()) or int(o[0]) != 0 or int(o[-1]) != seq.shape[0]:
        raise ValueError("off must be non-decreasing from 0 to len(seq)")
    max_smem = ctypes.c_int(0)
    _check(lib.nw_max_shared_bytes(ctypes.byref(max_smem)), "shared memory query")
    in_smem = 24 * (n + 1) <= max_smem.value
    stream = torch.cuda.current_stream(seq.device).cuda_stream
    for use_smem in (True, False):
        ids = torch.nonzero(in_smem == use_smem)[:, 0]
        if ids.numel() == 0:
            continue
        lens = n[ids]
        ids_dev = ids.to(torch.int32).to(seq.device)
        if use_smem:
            err = lib.nw_matches_shared_launch(
                seq.data_ptr(), off.data_ptr(), ids_dev.data_ptr(), ids.numel(),
                out.data_ptr(), 24 * (int(lens.max()) + 1), stream)
        else:
            stride = 6 * (int(lens.max()) + 1)
            scratch = torch.empty(ids.numel() * stride, dtype=torch.int32, device=seq.device)
            err = lib.nw_matches_global_launch(
                seq.data_ptr(), off.data_ptr(), ids_dev.data_ptr(), ids.numel(),
                out.data_ptr(), scratch.data_ptr(), stride, stream)
        _check(err, "nw_matches kernel launch")
        nw_matches_cuda.launches += 1
    return out


nw_matches_cuda.launches = 0


def nw_matches(seq: torch.Tensor, off: torch.Tensor) -> torch.Tensor:
    """Traceback match counts of the pairs packed by pack_pairs: the kernel
    K2 on CUDA tensors, its plain version on CPU tensors."""
    return nw_matches_cuda(seq, off) if seq.is_cuda else _nw_matches_plain(seq, off)


def nw_identity_device(pairs, device=None) -> np.ndarray:
    """Identities for a list of (a, b) string pairs, batched on `device`
    (default: the CUDA device; raises when there is none)."""
    pairs = list(pairs)
    if not pairs:
        return np.zeros(0, np.float64)
    lens = np.array([(len(a), len(b)) for a, b in pairs], np.int64)
    if lens[:, 0].max() == 0 or lens[:, 1].max() == 0:
        return np.array([0.0 for _ in pairs])
    dev = resolve_device(device)
    seq, off = pack_pairs(pairs)
    matches = nw_matches(seq.to(dev), off.to(dev)).cpu().numpy()
    return matches / np.maximum(lens[:, 0], lens[:, 1]).astype(np.float64)
