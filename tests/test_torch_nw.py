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
