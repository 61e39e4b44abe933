"""The port's plane path against the JAX package, exactly (tolerance 0: every
output is an integer or a bit), on the CPU: planes_from_payload (numpy and
torch), the host oracle compute_planes and compute_planes_span, the host
side of the payload streams (planes_from_pay, planes_from_pay_span), and
the plain plane passes — the versions of K8 (scan_planes_q, cuckoo map), K9
(scan_planes_qb, bucket map), K10 (scan_pay_qp, pair map), K15
(scan_planes_qp, pair map) and K16 (scan_planes_q_span, span map) — against the JAX
package's XLA programs run on the CPU, on the kernels' edge windows
(tests/torch_tables.py). Inputs are seeded numpy; the same host maps feed
both packages."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mindthegap_tpu.find import scan as JSCAN
from mindthegap_tpu.find import scan_device as JS
from mindthegap_tpu.ops import extmap as JX
from mindthegap_tpu.ops import kmers as JK
from mindthegap_tpu_torch.find import scan as PSCAN
from mindthegap_tpu_torch.find import scan_device as PS
from mindthegap_tpu_torch.ops import extmap as PX
from mindthegap_tpu_torch.ops import kmers as PK
from mindthegap_tpu_torch.ops.span import Span
from torch_tables import (PAIR_PIPELINE_NAMES, PLANE_EDGE_NAMES, PLANE_PIPELINE_NAMES, SPAN_EDGE_NAMES,
                          pair_pipeline_case, plane_edge_windows, plane_pipeline_case, span_edge_windows)

PLANE_FIELDS = ("valid", "fwd", "contains", "nb_in", "nb_out", "suffix_rep", "prefix_rep", "fwd_rows")


def _same_planes(got, want):
    for name in PLANE_FIELDS:
        g, w = getattr(got, name), getattr(want, name)
        if w is None:
            assert g is None, name
            continue
        assert g.dtype == w.dtype, (name, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=name)


def _packed(codes):
    return tuple(torch.from_numpy(a) for a in PS.pack_codes_host(codes))


def _genome_sets(k: int, seed: int):
    """A 30 kb genome with N runs, its solid set (the k-mers of a donor with
    a 60 bp insertion at 15,000) and a repeat set of every 25th (k-1)-mer."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, 30_000, dtype=np.uint8)
    donor = np.concatenate([genome[:15_000], rng.integers(0, 4, 60, dtype=np.uint8), genome[15_000:]])
    genome[4000:4050] = 255
    genome[rng.integers(0, genome.size, 30)] = 255
    fwd, _ = JK.kmers_from_codes(donor, k)
    solid = np.unique(JK.canonical_u64(fwd, k))
    q, _ = JK.kmers_from_codes(np.where(genome == 255, 0, genome).astype(np.uint8), k - 1)
    return genome, solid, np.unique(JK.canonical_u64(q[::25], k - 1))


def _span_sets(k: int, seed: int):
    """As _genome_sets at k > 32: the genome, its solid void keys and its
    repeat keys ((k-1)-mer void keys, or u64 at k = 33)."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, 12_000, dtype=np.uint8)
    sp, spm1 = Span(k), Span(k - 1)
    arr, _ = sp.from_codes(genome[:9000])
    solid = np.unique(sp.keys(sp.canonical(arr)))
    if k - 1 <= 32:
        f, _ = PK.kmers_from_codes(genome[:2000], k - 1)
        repeat = np.unique(PK.canonical_u64(f, k - 1))
    else:
        q, _ = spm1.from_codes(genome[:2000])
        repeat = np.unique(spm1.keys(spm1.canonical(q)))
    genome[150] = 255
    genome[5000:5060] = 255
    return genome, solid, repeat


@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_planes_from_payload_matches_jax(backend):
    rng = np.random.default_rng(7)
    n = 5000
    pay_i, pay_i1 = rng.integers(0, 256, (2, n), dtype=np.uint8)
    st_i, st_i1 = rng.integers(0, 2, (2, n)).astype(bool)
    last = rng.integers(0, 4, n, dtype=np.uint8)
    want = JX.planes_from_payload(pay_i, pay_i1, st_i, st_i1, last, xp=np)
    if backend == "numpy":
        got = PX.planes_from_payload(pay_i, pay_i1, st_i, st_i1, last)
    else:
        t = [torch.from_numpy(a.astype(np.int64)) for a in (pay_i, pay_i1, last)]
        got = PX.planes_from_payload(t[0], t[1], torch.from_numpy(st_i), torch.from_numpy(st_i1), t[2])
        assert got[0].dtype == torch.bool and got[1].dtype == got[2].dtype == torch.int32
        got = [g.numpy() for g in got]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert want[0].any() and not want[0].all()


@pytest.mark.parametrize("k", [5, 21, 31, 32])
def test_compute_planes_matches_jax(k):
    genome, solid, repeat = _genome_sets(k, k)
    got = PSCAN.compute_planes(genome, k, solid, repeat)
    _same_planes(got, JSCAN.compute_planes(genome, k, solid, repeat))
    assert got.contains.mean() > 0.9 and got.suffix_rep.any() and not got.valid.all()
    _same_planes(PSCAN.compute_planes(genome[: k - 1], k, solid, repeat),
                 JSCAN.compute_planes(genome[: k - 1], k, solid, repeat))


@pytest.mark.parametrize("k", [33, 45, 128])
def test_compute_planes_span_matches_jax(k):
    genome, solid, repeat = _span_sets(k, k)
    got = PSCAN.compute_planes_span(genome, k, solid, repeat)
    _same_planes(got, JSCAN.compute_planes_span(genome, k, solid, repeat))
    assert got.contains.mean() > 0.5 and got.prefix_rep.any() and not got.valid.all()
    # compute_planes delegates above k = 32
    _same_planes(PSCAN.compute_planes(genome, k, solid, repeat), got)


def _jax_pair(qp):
    return (jnp.asarray(qp.slots), jnp.asarray(qp.stash_keys), jnp.asarray(qp.stash_l), jnp.asarray(qp.stash_r))


@pytest.mark.parametrize("k", [21, 31])
def test_planes_from_pay_matches_jax(k):
    """The host side of the pair map's plane path, on the JAX package's
    dense stream of a window: the port's planes equal the JAX package's,
    and the host oracle's."""
    genome, solid, repeat = _genome_sets(k, k)
    qp = PX.build_fused_pair(solid, k, repeat)
    codes = genome[:8192]
    res = JS.scan_pay_device_qp(jnp.asarray(codes), *_jax_pair(qp), qp.log_size, k)
    pay8, rep8 = np.asarray(res["pay8"]), np.asarray(res["rep8"])
    got = PS.planes_from_pay(pay8, rep8, codes, k)
    _same_planes(got, JS.planes_from_pay(pay8, rep8, codes, k))
    host = PSCAN.compute_planes(codes, k, solid, repeat)
    for name in ("contains", "nb_in", "nb_out", "suffix_rep", "prefix_rep"):
        np.testing.assert_array_equal(getattr(got, name)[host.valid], getattr(host, name)[host.valid])


@pytest.mark.parametrize("k", [33, 45])
def test_planes_from_pay_span_matches_jax(k):
    qms, cases = span_edge_windows(k)
    codes = cases["genome-ns-stash"]
    res = JS.scan_pay_device_q_span(jnp.asarray(codes), jnp.asarray(qms.slots), jnp.asarray(qms.sat),
                                    jnp.asarray(qms.stash_key64), jnp.asarray(qms.stash_sat),
                                    jnp.asarray(qms.stash_payload), qms.salt, qms.log_size, k)
    args = tuple(np.asarray(res[key]) for key in ("pay8", "rep8", "str8"))
    got = PS.planes_from_pay_span(*args, codes, k)
    _same_planes(got, JS.planes_from_pay_span(*args, codes, k))
    assert got.contains.mean() > 0.5


def _jax_plane_pass(layout: str, qm, codes, k: int):
    c = jnp.asarray(codes)
    if layout == "pair":
        return JS.scan_planes_device_qp(c, *_jax_pair(qm), qm.log_size, k)
    tables = (jnp.asarray(qm.slots), jnp.asarray(qm.stash_keys), jnp.asarray(qm.stash_payload))
    if layout == "bucket":
        return JS.scan_planes_device_qb(c, *tables, qm.log_nb, k)
    return JS.scan_planes_device_q(c, *tables, qm.log_size, k)


def _port_plane_pass(layout: str, qm, codes, k: int):
    t = qm.to("cpu")
    packed, bad = _packed(codes)
    if layout == "pair":
        return PS.scan_planes_qp(packed, bad, t.slots, t.stash_keys, t.stash_l, t.stash_r, qm.log_size, k)
    if layout == "bucket":
        return PS.scan_planes_qb(packed, bad, t.slots, t.stash_keys, t.stash_payload, qm.log_nb, k)
    return PS.scan_planes_q(packed, bad, t.slots, t.stash_keys, t.stash_payload, qm.log_size, k)


@pytest.mark.parametrize("layout,repeats", [pytest.param("cuckoo", True, id="cuckoo"),
                                             pytest.param("bucket", True, id="bucket"),
                                             pytest.param("pair", True, id="pair"),
                                             pytest.param("pair", False, id="pair-empty-repeat-set")])
@pytest.mark.parametrize("k", [5, 21, 31, 32])
@pytest.mark.parametrize("name", PLANE_EDGE_NAMES)
def test_plane_pass_matches_jax(name, k, layout, repeats):
    """The plain plane passes (K8's, K9's and K15's) equal the JAX
    package's scan_planes_device_q / _qb / _qp on the plane kernels' edge
    windows: N runs across block boundaries, stash hits, the window's first
    and last positions, a window shorter than 2k; the pair map's also with
    an empty repeat set (context_genome_wg's map: no repeat plane is set).
    fwd is the int64 bit pattern of the JAX package's u64."""
    qm, cases = plane_edge_windows(k, layout, repeats=repeats)
    codes = cases[name]
    got = _port_plane_pass(layout, qm, codes, k)
    want = _jax_plane_pass(layout, qm, codes, k)
    assert list(got) == list(PS.PLANE_KEYS)
    for key in PS.PLANE_KEYS:
        g = got[key].numpy()
        assert g.dtype == (np.int64 if key == "fwd" else np.int32 if key.startswith("nb_") else np.bool_), key
        np.testing.assert_array_equal(g.view(np.uint64) if key == "fwd" else g, np.asarray(want[key]), err_msg=key)
    if name == "genome-ns-stash":
        assert got["contains"].float().mean() > 0.8 and not got["valid"].all()
        assert bool(got["suffix_rep"].any()) == repeats


@pytest.mark.parametrize("k", [21, 31, 32])
@pytest.mark.parametrize("name", PLANE_PIPELINE_NAMES)
def test_plane_pass_pipeline_cases_match_jax(name, k):
    """The plain version of K8 equals scan_planes_device_q on the cases of
    K8's pipeline (tests/torch_tables.py plane_pipeline_case): a window of
    over 1,024 tiles with a ragged last one, a half-full map (many keys in
    their second slot), every key absent, a full unsorted stash."""
    qm, codes = plane_pipeline_case(k, name)
    got = _port_plane_pass("cuckoo", qm, codes, k)
    want = _jax_plane_pass("cuckoo", qm, codes, k)
    for key in PS.PLANE_KEYS:
        g = got[key].numpy()
        np.testing.assert_array_equal(g.view(np.uint64) if key == "fwd" else g, np.asarray(want[key]), err_msg=key)
    if name == "all-absent":
        assert not got["contains"].any()
    elif name != "long-ragged":
        assert got["contains"].float().mean() > 0.9


@pytest.mark.parametrize("k", [3, 21, 31, 32])
@pytest.mark.parametrize("name", PLANE_EDGE_NAMES)
def test_scan_pay_qp_plain_matches_jax(name, k):
    """The plain version of K10 equals scan_pay_device_qp: pay8 and rep8,
    whose last byte holds the repeat bit of entry P + 1 where P is even."""
    qp, cases = plane_edge_windows(k, "pair")
    codes = cases[name]
    t = qp.to("cpu")
    got = PS.scan_pay_qp(*_packed(codes), t.slots, t.stash_keys, t.stash_l, t.stash_r, qp.log_size, k)
    want = JS.scan_pay_device_qp(jnp.asarray(codes), *_jax_pair(qp), qp.log_size, k)
    for key in ("pay8", "rep8"):
        assert got[key].dtype == torch.uint8
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
    assert got["pay8"].shape[0] == codes.size - k + 2


@pytest.mark.parametrize("k", [3, 21, 31, 32])
@pytest.mark.parametrize("name", PAIR_PIPELINE_NAMES)
def test_scan_pay_qp_plain_matches_jax_on_pipeline_cases(name, k):
    """The plain version of K10 equals scan_pay_device_qp on K10's pipeline
    cases (tests/torch_tables.py pair_pipeline_case): a map near
    its highest load factor (many pairs in their second row), every pair
    absent, a full stash in descending order, and the first 2^16 bases of
    the long ragged window."""
    qp, codes = pair_pipeline_case(k, name, cut=1 << 16 if name == "long-ragged" else None)
    t = qp.to("cpu")
    got = PS.scan_pay_qp(*_packed(codes), t.slots, t.stash_keys, t.stash_l, t.stash_r, qp.log_size, k)
    want = JS.scan_pay_device_qp(jnp.asarray(codes), *_jax_pair(qp), qp.log_size, k)
    for key in ("pay8", "rep8"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
    if name == "all-absent":
        assert k < 13 or not (got["pay8"].any() or got["rep8"].any())  # short (k-2)-mers occur anywhere
    else:
        assert got["pay8"].bool().float().mean() > 0.5


@pytest.mark.parametrize("k,repeats", [pytest.param(33, True, id="33"), pytest.param(45, True, id="45"),
                                       pytest.param(128, True, id="128"),
                                       pytest.param(33, False, id="33-empty-repeat-set"),
                                       pytest.param(45, False, id="45-empty-repeat-set")])
@pytest.mark.parametrize("name", SPAN_EDGE_NAMES)
def test_plane_pass_span_matches_jax(name, k, repeats):
    """The plain span plane pass (K16's) equals scan_planes_device_q_span
    on K6's edge windows, also over a map with an empty repeat set
    (context_genome_wg's), fwd_words as int64 bit patterns."""
    qms, cases = span_edge_windows(k, repeats=repeats)
    codes = cases[name]
    t = qms.to("cpu")
    got = PS.scan_planes_q_span(*_packed(codes), t.slots, t.sat, t.stash_key64, t.stash_sat, t.stash_payload,
                                qms.salt, qms.log_size, k)
    want = JS.scan_planes_device_q_span(jnp.asarray(codes), jnp.asarray(qms.slots), jnp.asarray(qms.sat),
                                        jnp.asarray(qms.stash_key64), jnp.asarray(qms.stash_sat),
                                        jnp.asarray(qms.stash_payload), qms.salt, qms.log_size, k)
    assert set(got) == set(want)
    for key in want:
        g = got[key].numpy()
        np.testing.assert_array_equal(g.view(np.uint64) if key == "fwd_words" else g, np.asarray(want[key]),
                                      err_msg=key)
    if name == "genome-ns-stash":
        assert bool(got["prefix_rep"].any()) == repeats


@pytest.mark.parametrize("layout", ["cuckoo", "bucket"])
def test_plane_scan_sectors(layout):
    """bounds.plane_scan_sectors: one sector a probe and one more for each
    key not in its first slot (cuckoo), four a probe (bucket), over the P +
    1 canonical (k-1)-mers of the window."""
    from mindthegap_tpu_torch.bounds import plane_scan_sectors

    k = 31
    qm, cases = plane_edge_windows(k, layout)
    codes = cases["genome-ns-stash"]
    q, _ = JK.kmers_from_codes(np.where(codes == 255, 0, codes).astype(np.uint8), k - 1)
    keys = torch.from_numpy(PK.as_i64(JK.canonical_u64(q, k - 1)))
    t = qm.to("cpu")
    sectors = plane_scan_sectors(*_packed(codes), t, k)
    if layout == "bucket":
        assert sectors == 4 * keys.shape[0]
    else:
        first, _ = PX.q_probe(t, keys, 0)
        second, _ = PX.q_probe(t, keys, 1)
        assert not (first & second).any() and 0 < int(second.sum()) < int(first.sum())
        assert sectors == keys.shape[0] + int((~first).sum())


@pytest.mark.parametrize("name", ["cp.async staging", "no stores", "bulk stores", "smem stores",
                                  "K10 no probes", "K10 no second round", "K10 no stores"])
def test_plane_trials_apply_to_the_kernel_source(name):
    """Each of plane_trials' K8 copies applies to csrc/scan_planes.cu and
    each copy of K10's split to csrc/scan_qp.cu: every text it replaces
    occurs there once (the copies are built on the card only), and a text
    that does not occur is refused."""
    from mindthegap_tpu_torch import plane_trials as T
    from mindthegap_tpu_torch._build import CSRC_DIR

    split = name.startswith("K10 ")
    source, kernel = ("scan_qp.cu", "scan_pay_qp_kernel") if split else ("scan_planes.cu", "scan_planes_q_kernel")
    with open(f"{CSRC_DIR}/{source}") as f:
        src = f.read()
    copy = T.substituted(src, T.K10_SPLIT[name[4:]] if split else T.VARIANTS[name])
    assert copy != src and kernel in copy
    with pytest.raises(ValueError, match="once"):
        T.substituted(src, [("no such text in the kernel", "")])
