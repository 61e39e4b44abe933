"""The branching count on the CPU (ops/branching_device.py, the plain
version of K17) against the host function graph/dbg.py Graph.nb_branching:
on the sets of tests/torch_tables.py branching_edge_sets and on the graphs
of seeded reads (a reference and a donor with planted variants, both read,
so that every variant branches), at about 1, 2 and 4 keys a bucket of the
index; where the reference data of tests/test_counting.py is on disk, on
its two graphs too (36 and 46 branching nodes). Then build_graph's choice
of path, its "keys probed on device" count, and the bound's sector count
(bounds.py branching_bytes)."""

import os

import numpy as np
import pytest
import torch

import chip_smoke as CS
from conftest import REFERENCE
from mindthegap_tpu_torch import bounds as B
from mindthegap_tpu_torch.graph import dbg
from mindthegap_tpu_torch.ops import branching_device as BD
from mindthegap_tpu_torch.ops import kmers as K
from mindthegap_tpu_torch.ops import sorted_index as SI
from mindthegap_tpu_torch.utils.phases import PhaseTimer
from torch_tables import BRANCHING_EDGE_NAMES, branching_edge_sets

HALVINGS = (0, 1, 2)  # the index's bucket count halved 0, 1, 2 times
READS_GRAPHS = {"reads-k31": 31, "reads-k21": 21, "reads-k32": 32}
# tests/test_counting.py's graphs: (reads, abundance-min, branching nodes of the reference's gold files)
REFERENCE_GRAPHS = {"full-test": ("data/reads_r1.fastq,data/reads_r2.fastq", "auto", 36),
                    "contig": ("data/contig-reads.fasta.gz", 3, 46)}
ON_DISK = [name for name, (reads, _a, _n) in REFERENCE_GRAPHS.items()
           if all(os.path.exists(os.path.join(REFERENCE, p)) for p in reads.split(","))]

_EDGES = branching_edge_sets()


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    """The -in argument of a seeded 40 kb reference and its donor (3
    insertions, 2 SNPs, 2 deletions), 15x error-free reads of each."""
    root = tmp_path_factory.mktemp("branching")
    ref, donor, _ = CS.make_case(40_000, n_ins=3, n_snp=2, n_del=2, seed=41)
    return CS.write_reads(str(root / "ref"), ref, 15.0, seed=42) + "," + \
        CS.write_reads(str(root / "donor"), donor, 15.0, seed=43)


def _case(name, request):
    """(sorted u64 keys, k, the branching nodes expected or None)."""
    if name in _EDGES:
        return (*_EDGES[name], None)
    if name in READS_GRAPHS:
        k = READS_GRAPHS[name]
        return dbg.build_graph(request.getfixturevalue("reads"), k, 3).solid.keys, k, None
    uri, abundance_min, want = REFERENCE_GRAPHS[name]
    uri = ",".join(os.path.join(REFERENCE, p) for p in uri.split(","))
    return dbg.build_graph(uri, 31, abundance_min).solid.keys, 31, want


@pytest.mark.parametrize("name", BRANCHING_EDGE_NAMES + tuple(READS_GRAPHS) + tuple(ON_DISK))
def test_plain_branching_matches_host(name, request):
    """The plain version, through the index at 1, 2 and 4 keys a bucket,
    equals Graph.nb_branching (and the reference's gold count)."""
    keys, k, gold = _case(name, request)
    want = dbg.Graph(dbg.SolidSet(keys, k)).nb_branching()
    if gold is not None:
        assert want == gold
    t = torch.from_numpy(K.as_i64(keys))
    assert BD.nb_branching(t, k) == want
    for halve in HALVINGS[1:]:
        index = SI._build_plain(t, max(1, SI.log_buckets(t.shape[0]) - halve))
        assert int(BD._count_plain(t, index, k)) == want
    if name.startswith("reads"):
        assert 0 < want < keys.size  # the variants branch, the rest of the genome does not


def test_neighbours_match_host():
    """neighbours() gives the host's canonical out- and in-neighbours, in
    the host function's order, on a k = 32 set across 2^63."""
    keys, k = _EDGES["near-top-k32"]
    g = dbg.Graph(dbg.SolidSet(keys, k))
    want = np.concatenate([K.canonical_u64(g.out_neighbors_fwd(keys), k),
                           K.canonical_u64(g.in_neighbors_fwd(keys), k)], axis=1)
    got = K.as_u64(BD.neighbours(torch.from_numpy(K.as_i64(keys)), k))
    np.testing.assert_array_equal(got, want)


def _build(reads, k, device):
    """build_graph under a current timer: (graph, its counts)."""
    timer = PhaseTimer()
    with timer.active():
        g = dbg.build_graph(reads, k, 3, device=device)
    return g, timer._counts


@pytest.mark.parametrize("k", [31, 45])
def test_build_graph_branching_path(reads, k, monkeypatch):
    """build_graph with a device (here the CPU: the plain version) gives the
    info of build_graph without one, byte for byte; "keys probed on device"
    is the solid count on the device path (k <= 32), 0 on the host path (no
    device, k > 32, a set that does not fit)."""
    host, host_counts = _build(reads, k, None)
    dev, dev_counts = _build(reads, k, torch.device("cpu"))
    assert dev.info == host.info
    assert host_counts["branching / keys probed on device"] == 0
    probed = dev.info["kmers_nb_solid"] if k <= 32 else 0
    assert dev_counts["branching / keys probed on device"] == probed
    if k <= 32:
        monkeypatch.setattr(BD, "fits", lambda n, device: False)
        small, small_counts = _build(reads, k, torch.device("cpu"))
        assert small.info == host.info and small_counts["branching / keys probed on device"] == 0


def test_fits():
    """A set of 2^31 keys or more never fits (int32 starts); on the CPU any
    smaller one does."""
    cpu = torch.device("cpu")
    assert BD.fits(0, cpu) and BD.fits((1 << 31) - 1, cpu)
    assert not BD.fits(1 << 31, cpu)


@pytest.mark.parametrize("name", ["random-k31", "near-top-k32", "dense-k4", "empty"])
def test_branching_bytes(name):
    """bounds.branching_bytes: the bytes are the keys, starts and head
    read once and the count; the sectors each apart are
    sorted_lookup_sectors' over the 8 neighbours of every key; a warp's
    counted once are fewer, and a "warp" of one key (any chunk) lies
    between the two."""
    keys, k = _EDGES[name]
    t = torch.from_numpy(K.as_i64(keys))
    index = SI.build(t)
    nbytes, apart, distinct = B.branching_bytes(t, index, k)
    assert nbytes == 8 * keys.size + 4 * ((1 << SI.log_buckets(keys.size)) + 1) + 32 + 8
    assert apart == B.sorted_lookup_sectors(t, index, BD.neighbours(t, k).reshape(-1))
    one_bytes, one_apart, one = B.branching_bytes(t, index, k, warp=1, chunk=999)
    assert (one_bytes, one_apart) == (nbytes, apart)
    assert distinct <= one <= apart
    if keys.size > 1000:
        assert distinct < one < apart
