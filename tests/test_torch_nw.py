"""The port's plain NW wavefront (K2's plain version) against the JAX
package's Pallas kernel in interpret mode, its python DP oracle and the
native engine, exactly; nwalign's entry point."""

import io

import numpy as np
import pytest
import torch

from mindthegap_tpu.ops import nw as JN
from mindthegap_tpu.ops.nw_device import nw_identity_device as jax_identity
from mindthegap_tpu_torch import nwalign
from mindthegap_tpu_torch.ops import nw as PN
from mindthegap_tpu_torch.ops import nw_device as PND


@pytest.fixture(scope="module")
def pairs():
    """The pair mix of tests/test_nw_device.py plus empty, length-1 and very
    uneven pairs (all <= 200 bp, so interpret mode stays fast)."""
    rng = np.random.default_rng(3)

    def rand_seq(n):
        return "".join(rng.choice(list("ACGT"), size=n))

    out = []
    for _ in range(10):
        n = int(rng.integers(5, 180))
        a = rand_seq(n)
        if rng.random() < 0.5:
            b = list(a)
            for _ in range(int(rng.integers(0, 8))):
                p = int(rng.integers(0, len(b)))
                r = rng.random()
                if r < 0.4:
                    b[p] = rng.choice(list("ACGT"))
                elif r < 0.7:
                    b.insert(p, rng.choice(list("ACGT")))
                else:
                    del b[p]
            b = "".join(b)
        else:
            b = rand_seq(int(rng.integers(5, 180)))
        out.append((a, b))
    out += [("", "ACGT"), ("ACGT", ""), ("A", "A"), ("A", "C"), ("G", "GATTACA"),
            ("A" * 3, "A" * 170), ("ACGTTGCA" * 25, "T"), ("T", "ACGTTGCA" * 25)]
    return out


def _oracle(a, b):
    return JN.needleman_wunsch(a, b)[0] if a and b else 0.0


def _stripe_schedule(a: str, b: str, h: int) -> int:
    """K2's schedule (csrc/nw.cu) on the host: stripes of h rows, each sweeping
    the columns in order; its top row comes from the boundary row the stripe
    above left in place (the first stripe takes the row-0 border), column 0
    is the border, rows past n match nothing. Shifted scores t = s + 5(i + j)
    and counts carried as count << 8 | b code, as in the kernel."""
    a, b = a.encode(), b.encode()
    n, m = len(a), len(b)
    if not n or not m:
        return 0
    row = [(0, 0)] * m  # boundary row: (t, count << 8 | code) of column j at [j - 1]
    stripes = -(-n // h)
    for s in range(stripes):
        codes = [a[s * h + k] if s * h + k < n else -1 for k in range(h)]
        T, F = [0] * h, [0] * h
        dt = df = 0
        for j in range(1, m + 1):
            ut, ufb = (0, b[j - 1]) if s == 0 else row[j - 1]
            bj, uf = ufb & 0xFF, ufb >> 8
            ddt, ddf = dt, df
            dt, df = ut, uf
            for k in range(h):
                lt, lf = T[k], F[k]
                e = codes[k] == bj
                dd = ddt + (20 if e else 5)
                nx = max(dd, lt, ut)
                pd = dd == nx
                pu = not pd and ut == nx
                nf = uf if pu else (ddf + e if pd else lf)
                T[k], F[k] = nx, nf
                ddt, ddf, ut, uf = lt, lf, nx, nf
            row[j - 1] = (T[h - 1], F[h - 1] << 8 | bj)
    return F[n - 1 - (stripes - 1) * h]


STRIPE_HEIGHTS = (1, 2, 3, 8, 32)


@pytest.fixture(scope="module")
def seam_pairs():
    """For each stripe height h, pairs with n = h*s - 1, h*s and h*s + 1 rows
    (s = 1, 3) against a mutated copy, an unrelated b, and a two-letter pair
    (whose up and left candidates tie often enough to test that rule)."""
    rng = np.random.default_rng(7)
    out = {}
    for h in STRIPE_HEIGHTS:
        out[h] = []
        for n in sorted({h * s + d for s in (1, 3) for d in (-1, 0, 1)} - {0}):
            a = rng.choice(list("ACGT"), n)
            b = a.copy()
            b[rng.integers(0, n, max(1, n // 8))] = "A"
            out[h] += [("".join(a), "".join(b[: max(1, n - 2)])),
                       ("".join(a), "".join(rng.choice(list("ACGT"), int(rng.integers(1, 60))))),
                       ("".join(rng.choice(list("AC"), n)), "".join(rng.choice(list("AC"), n + 5)))]
    return out


@pytest.fixture(scope="module")
def reference_identities(pairs, seam_pairs):
    """The Pallas kernel (interpret mode) and the python oracle on every pair."""
    every = list(pairs) + [p for h in STRIPE_HEIGHTS for p in seam_pairs[h]]
    pallas = jax_identity(every, interpret=True)
    return {p: (x, _oracle(*p)) for p, x in zip(every, pallas)}


@pytest.mark.parametrize("h", STRIPE_HEIGHTS)
def test_stripe_schedule_matches_pallas_and_oracle(pairs, seam_pairs, reference_identities, h):
    for a, b in list(pairs) + seam_pairs[h]:
        got = _stripe_schedule(a, b, h) / max(len(a), len(b), 1)
        pallas, oracle = reference_identities[a, b]
        assert got == pallas == oracle, (len(a), len(b), got, pallas, oracle)


def test_plain_wavefront_matches_pallas_interpret(pairs):
    np.testing.assert_array_equal(PND.nw_identity_device(pairs, device="cpu"),
                                  jax_identity(pairs, interpret=True))


def test_plain_wavefront_matches_oracles(pairs):
    got = PND.nw_identity_device(pairs, device="cpu")
    np.testing.assert_array_equal(got, [_oracle(a, b) for a, b in pairs])
    np.testing.assert_array_equal(got, [PN.nw_identity(a, b) for a, b in pairs])


def test_matches_are_integer_counts(pairs):
    seq, off = PND.pack_pairs(pairs)
    m = PND.nw_matches(seq, off)
    assert m.dtype == torch.int32 and m.shape == (len(pairs),)
    lens = np.array([max(len(a), len(b)) for a, b in pairs])
    ident = [_oracle(a, b) for a, b in pairs]
    np.testing.assert_array_equal(m.numpy(), np.round(np.array(ident) * lens).astype(np.int32))


def test_empty_batches():
    assert PND.nw_identity_device([], device="cpu").size == 0
    np.testing.assert_array_equal(PND.nw_identity_device([("", "")], device="cpu"), [0.0])


def test_nwalign_native_engine():
    out = io.StringIO()
    import contextlib

    with contextlib.redirect_stdout(out):
        assert nwalign.main([], stdin=io.StringIO("GATTACA\nGATCACA\n")) == 0
    assert float(out.getvalue()) == JN.nw_identity("GATTACA", "GATCACA")


def test_nwalign_device_needs_a_gpu(monkeypatch):
    """--device runs the kernel or raises: no silent fallback to the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        nwalign.main(["--device"], stdin=io.StringIO("GATTACA\nGATCACA\n"))
