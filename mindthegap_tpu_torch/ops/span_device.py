"""Multi-word k-mer arithmetic on int64 tensors, for 32 < k <= 256 (the
counterpart of mindthegap_tpu/ops/span_device.py).

A batch of k-mers is a (W, P) int64 tensor holding u64 bit patterns, word 0
most significant, the value right-aligned: the layout of the host
ops/span.py rows, transposed. Right shifts are logical (kmers.shr), word
compares unsigned (kmers.ult) and multiplies wrap modulo 2^64, so the
results are the JAX package's u64 words bit for bit. These functions run
inside the span scan (find/scan_device.py scan_pay_q_span) and the span
walker (fill/walk_device.py walk_batch_span), whose CUDA kernels K6 and K7
repeat them in registers (csrc/span_map.cuh).
"""

from __future__ import annotations

import numpy as np
import torch

from . import kmers as K

INVALID = 255

_H3 = 0xD6E8FEB86659FD93


def span_width(k: int) -> int:
    """Words per k-mer: ceil(k / 32), at least 1."""
    return max(1, -(-k // 32))


def top_mask(k: int) -> int:
    """The int64 pattern of the mask of word 0's 2k - 64(W-1) bits."""
    top_bits = 2 * k - 64 * (span_width(k) - 1)
    return K.i64((1 << top_bits) - 1) if top_bits < 64 else -1


def rolling_span(codes: torch.Tensor, k: int):
    """Rolling multi-word forward k-mers over a padded window.

    codes: uint8[n] (255 = invalid or padding, read as base 0). Returns
    (words int64[Wk, P], valid bool[P]) with P = n - k + 1. Word j >= 1
    packs bases [i + k - 32 (Wk - j), +32); word 0 the leading k - 32 (Wk - 1)
    bases."""
    n = codes.shape[0]
    p = n - k + 1
    wk = span_width(k)
    bad = codes == INVALID
    c = torch.where(bad, 0, codes).to(torch.int64)

    def pack(offset: int, nb: int):
        acc = torch.zeros(p, dtype=torch.int64, device=codes.device)
        for j in range(nb):
            acc = (acc << 2) | c[offset + j : offset + j + p]
        return acc

    tb = k - 32 * (wk - 1)  # bases in word 0
    words = [pack(0, tb)] + [pack(tb + 32 * (j - 1), 32) for j in range(1, wk)]
    badc = torch.cat([torch.zeros(1, dtype=torch.int64, device=codes.device),
                      torch.cumsum(bad.to(torch.int64), 0)])
    valid = (badc[k:] - badc[:-k]) == 0
    return torch.stack(words), valid


def _rc_byte_table() -> np.ndarray:
    """The reverse complement of the 4 bases of each byte value."""
    b = np.arange(256)
    out = np.zeros(256, np.int64)
    for i in range(4):
        out |= (((b >> (2 * i)) & 3) ^ 2) << (2 * (3 - i))
    return out.astype(np.uint8)


_RC_BYTE = torch.from_numpy(_rc_byte_table())


def _revcomp_word_full(x: torch.Tensor) -> torch.Tensor:
    """Reverse and complement all 32 bases of each word: reverse its bytes
    and, by a table, the 4 bases of each byte."""
    table = _RC_BYTE.to(x.device)
    # flat first: a tensor with a dimension of size 1 may count as contiguous
    # with a last stride other than 1, which a view as bytes refuses
    b = x.reshape(-1).contiguous().view(torch.uint8).reshape(-1, 8)
    return table[b.long()].flip(-1).contiguous().view(torch.int64).reshape(x.shape)


def revcomp_span(words: torch.Tensor, k: int) -> torch.Tensor:
    """Reverse complement of (W, P) multi-word k-mers (same layout out)."""
    rev = _revcomp_word_full(words.flip(0))
    s = 64 * words.shape[0] - 2 * k
    if s:
        # each word takes its low bits from the word above it
        rev = K.shr(rev, s) | torch.cat([torch.zeros_like(rev[:1]), rev[:-1] << (64 - s)])
    return rev


def canonical_span(words: torch.Tensor, k: int):
    """(canonical words (W, P), is_canon bool[P]): min(fwd, revcomp) by an
    unsigned word-by-word compare from word 0."""
    rc = revcomp_span(words, k)
    lt = K.ult(words, rc)
    gt = K.ult(rc, words)
    # the first word where the two differ decides (word 0 when they are equal)
    first = (lt | gt).to(torch.int8).argmax(0)
    take_f = ~gt.gather(0, first[None])[0]
    return torch.where(take_f[None, :], words, rc), take_f


def digest64(words):
    """64-bit exact-residual digest of (W, P) multi-word keys: key64 = w0 ^
    G(w1..w_{W-1}). With a raw compare of words 1..W-1, equal digests mean
    equal keys (w0 is then pinned by the xor). Takes int64 tensors, or
    numpy uint64 arrays (the host builder, ops/extmap.py build_fused_span)."""
    w = words.shape[0]
    if isinstance(words, np.ndarray):
        g = None
        for i in range(1, w):
            x = words[i] if g is None else (g ^ words[i])
            h = (x ^ (x >> np.uint64(33))) * np.uint64(_H3)
            g = h ^ (h >> np.uint64(29))
        return words[0] if g is None else words[0] ^ g
    g = None
    for i in range(1, w):
        x = words[i] if g is None else (g ^ words[i])
        h = (x ^ K.shr(x, 33)) * K.i64(_H3)
        g = h ^ K.shr(h, 29)
    return words[0] if g is None else words[0] ^ g
