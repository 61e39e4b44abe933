"""The device mesh of one process against the JAX package, exactly, on the
CPU: the Bloom filter, the plane pass over sorted sets (K14's plain
version) and its windowed wrapper, the window-sharded scan, distributed
counting (K11's), the job-sharded walk, a whole pipeline step and the
graft entry points. The JAX side runs on the 8 virtual CPU devices of
tests/conftest.py; the port on logical shards of the CPU (8, and 1 and 2)."""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mindthegap_tpu.find import scan_device as JS
from mindthegap_tpu.ops import bloom as JB
from mindthegap_tpu.ops import extmap as JX
from mindthegap_tpu.parallel import mesh as JM
from mindthegap_tpu_torch import graft_entry as G
from mindthegap_tpu_torch.find import scan as PSC
from mindthegap_tpu_torch.find import scan_device as PS
from mindthegap_tpu_torch.ops import bloom as PB
from mindthegap_tpu_torch.ops import extmap as PX
from mindthegap_tpu_torch.ops import kmers as PK
from mindthegap_tpu_torch.parallel import mesh as PM
from torch_tables import SORTED_EDGE_NAMES, sorted_edge_windows

CPU = torch.device("cpu")
SHARDS = (1, 2, 8)
PLANES = ("fwd", "valid", "contains", "nb_in", "nb_out", "suffix_rep", "prefix_rep")


def _logical(n):
    return [CPU] * n


@pytest.fixture(scope="module")
def graph():
    """k = 21 solid set of 900 reads of a 5 kb genome (count >= 3), an
    arbitrary repeat set, and the genome's codes."""
    from mindthegap_tpu_torch.ops import counting

    rng = np.random.default_rng(7)
    genome = rng.integers(0, 4, 5000, dtype=np.uint8)
    k = 21
    c = counting.StreamingCounter(k)
    for i in rng.integers(0, 5000 - 100, 900):
        c.add_codes(genome[i : i + 100])
    res = c.result()
    solid = res.kmers[res.counts >= 3]
    return genome, k, solid, np.sort(solid[:50])


def test_bloom_matches_jax():
    """The bitset and its verdicts (numpy and the plain torch probe) equal
    the JAX package's, at 12 and 24 bits a key."""
    rng = np.random.default_rng(1)
    keys = np.unique(rng.integers(0, 1 << 64, 3000, dtype=np.uint64))
    q = np.concatenate([keys[::3], rng.integers(0, 1 << 64, 3000, dtype=np.uint64)])
    for bits_per_key, n_hash in ((12, None), (24, 8)):
        want = JB.build(keys, bits_per_key, n_hash)
        got = PB.build(keys, bits_per_key, n_hash)
        assert (got.log_bits, got.n_hash) == (want.log_bits, want.n_hash)
        np.testing.assert_array_equal(got.bits, want.bits)
        verdict = np.asarray(JB.contains(want, q))
        np.testing.assert_array_equal(PB.contains(got, q), verdict)
        np.testing.assert_array_equal(np.asarray(JB.contains(want, jnp.asarray(q), jnp)), verdict)
        t = PB.contains_tensor(torch.from_numpy(got.bits.view(np.int32)), got.log_bits, got.n_hash,
                               torch.from_numpy(PK.as_i64(q)))
        np.testing.assert_array_equal(t.numpy(), verdict)
        assert verdict[: keys[::3].size].all()


@pytest.mark.parametrize("k", [2, 3, 21, 31, 32])
@pytest.mark.parametrize("name", SORTED_EDGE_NAMES)
def test_scan_planes_sorted_matches_jax(k, name):
    """K14's plain version against scan_planes_device on its edge windows
    (tests/torch_tables.py sorted_edge_windows)."""
    codes, solid, repeat = sorted_edge_windows(k)[name]
    want = JS.scan_planes_device(jnp.asarray(codes), jnp.asarray(solid), jnp.asarray(repeat), k)
    got = PS.scan_planes_sorted(torch.from_numpy(codes), *(torch.from_numpy(PK.as_i64(s)) for s in (solid, repeat)), k)
    for key in PLANES:
        w = np.asarray(want[key])
        g = got[key].numpy()
        np.testing.assert_array_equal(g.view(np.uint64) if key == "fwd" else g, w, err_msg=key)
    if name == "genome-ns" and k > 3:
        assert got["contains"].any() and (got["nb_in"] > 0).any() and got["suffix_rep"].any()


def test_compute_planes_device_matches_jax(graph):
    genome, k, solid, rep = graph
    codes = genome.copy()
    codes[1500] = 255
    want = JS.compute_planes_device(codes, k, solid, rep, window=512)
    got = PS.compute_planes_device(codes, k, solid, rep, CPU, window=512)
    host = PSC.compute_planes(codes, k, solid, rep)
    for key in PLANES:
        np.testing.assert_array_equal(getattr(got, key), getattr(want, key), err_msg=key)
        np.testing.assert_array_equal(getattr(got, key), getattr(host, key), err_msg=key)


def _windows(codes, k, n, w=256):
    step = w - (k - 1)
    out = np.full((n, w), 255, np.uint8)
    for i in range(n):
        part = codes[i * step : i * step + w]
        out[i, : part.size] = part
    return out


@pytest.mark.parametrize("n", SHARDS)
def test_sharded_scan_matches_jax(graph, n):
    genome, k, solid, rep = graph
    wins = _windows(genome, k, 8)
    want = JM.sharded_scan(JM.make_mesh(8), wins, solid, rep, k)
    got = PM.sharded_scan(_logical(n), wins, solid, rep, k)
    for key in PLANES:
        np.testing.assert_array_equal(got[key], np.asarray(want[key]), err_msg=key)


@pytest.mark.parametrize("n", SHARDS)
def test_distributed_count_step_matches_jax(graph, n):
    """The owners' runs (SENTINEL padding included) and the histogram equal
    the JAX step's on a mesh of as many devices."""
    genome, k, _, _ = graph
    rng = np.random.default_rng(0)
    reads = np.stack([genome[i : i + 64] for i in rng.integers(0, 4000, 64)])
    reads[3, 10] = 255
    want_runs, want_hist = JM.distributed_count_step(JM.make_mesh(n), reads, k, histo_max=100)
    got_runs, got_hist = PM.distributed_count_step(_logical(n), reads, k, histo_max=100)
    np.testing.assert_array_equal(got_runs, np.asarray(want_runs))
    np.testing.assert_array_equal(got_hist, np.asarray(want_hist))
    assert got_hist.sum() > 0


@pytest.mark.parametrize("n", SHARDS)
def test_walk_batch_sharded_matches_jax(graph, n):
    _, k, solid, rep = graph
    qm = JX.build_fused(solid, k, rep)
    nodes = solid[:: max(1, solid.size // 16)][:16]
    budgets = np.arange(16, dtype=np.int32) * 7
    want = JM.walk_batch_sharded(JM.make_mesh(8), nodes, budgets, qm, k, steps=32)
    got = PM.walk_batch_sharded(_logical(n), nodes, budgets, PX.build_fused(solid, k, rep), k, steps=32)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    assert got[1].sum() > 0


def _dryrun_inputs(n):
    """The inputs of __graft_entry__.dryrun_multichip at n devices."""
    rng = np.random.default_rng(0)
    reads = rng.integers(0, 4, size=(n * 4, 64), dtype=np.uint8)
    windows = rng.integers(0, 4, size=(n, 256), dtype=np.uint8)
    solid = np.sort(rng.integers(0, 1 << 40, size=1 << 12, dtype=np.uint64))
    repeat = np.sort(rng.integers(0, 1 << 38, size=1 << 8, dtype=np.uint64))
    return reads, windows, solid, repeat


@pytest.mark.parametrize("n", SHARDS)
def test_pipeline_step_matches_jax(n):
    reads, windows, solid, repeat = _dryrun_inputs(n)
    want = JM.pipeline_step(JM.make_mesh(n), reads, windows, solid, repeat, 21)
    got = PM.pipeline_step(_logical(n), reads, windows, solid, repeat, 21)
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    np.testing.assert_array_equal(got[1], np.asarray(want[1]))
    for key in ("pay8", "rep8"):
        np.testing.assert_array_equal(got[2][key], np.asarray(want[2][key]), err_msg=key)
    for g, w in zip(got[3], want[3]):
        np.testing.assert_array_equal(g, np.asarray(w))


@pytest.mark.parametrize("n", SHARDS)
def test_dryrun_multichip_on_logical_shards(n):
    """The port's dryrun, whose asserts hold every output to a plain or
    single-shard computation, passes on n logical CPU shards."""
    with PM.logical_devices(_logical(n)):
        G.dryrun_multichip(n, "cpu")


def test_entry_matches_jax():
    """The port's entry() (K14's plain version on the CPU) gives the JAX
    entry's planes on the same seeded window and sets."""
    spec = importlib.util.spec_from_file_location(
        "graft_entry", os.path.join(os.path.dirname(__file__), "..", "__graft_entry__.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    jfn, jargs = mod.entry()
    want = jfn(*jargs)
    fn, args = G.entry("cpu")
    assert all(a.device == CPU for a in args)
    got = fn(*args)
    for key in PLANES:
        g = got[key].numpy()
        np.testing.assert_array_equal(g.view(np.uint64) if key == "fwd" else g, np.asarray(want[key]), err_msg=key)
    assert got["contains"].sum() == 0 and got["valid"].all()  # random sets: no k-mer of the window is solid


def test_mesh_follows_logical_devices():
    """The CLI's mesh: the CPU alone under -device cpu; inside
    logical_devices, the given list, cut to a power of two where asked."""
    assert PM.make_mesh("cpu") == [CPU]
    with PM.logical_devices(_logical(6)):
        assert PM.make_mesh("cpu") == _logical(6)
        assert PM.make_mesh("cuda", 2) == _logical(2)
        assert PM.pow2_mesh(PM.make_mesh("cpu")) == _logical(4)
    assert PM.make_mesh("cpu") == [CPU]
