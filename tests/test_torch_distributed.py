"""The port's run across processes on the CPU: two gloo ranks
(tests/torch_distributed_worker.py), each with 2 logical CPU shards of a
global mesh of 4, run `find -scan-engine sharded -count-engine sharded
-automaton host` and `fill -bkpt` (-fill-engine auto and device) on a
seeded ~100 kb case, and the sharded counter over the global mesh. Every
rank's artifacts must equal the JAX package's one-process run byte for
byte (the VCF without its ## lines, as tests/test_distributed.py compares
the JAX package's own ranks), and the counters the JAX host counter's.
Each test's rendezvous is a file of its own, so that workers of a
parallel test run never share one."""

import io
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import chip_smoke as CS
from mindthegap_tpu.fill.runner import run_fill as jax_fill
from mindthegap_tpu.find.runner import run_find as jax_find
from mindthegap_tpu.graph.dbg import Graph as JaxGraph
from mindthegap_tpu.io.bank import iter_codes as jax_iter_codes
from mindthegap_tpu.ops.counting import StreamingCounter as JaxStreamingCounter
from mindthegap_tpu.parallel.distributed import shard_bounds as jax_shard_bounds
from mindthegap_tpu_torch.graph.dbg import Graph
from mindthegap_tpu_torch.parallel import distributed as D

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_distributed_worker.py")
RANKS = 2
FILL_OPTS = {"max-length": "1000", "verbose": "0"}  # the walks' budget, the same in both packages


def run_ranks(mode: str, case, out, timeout: float = 240.0) -> list[tuple[int, str]]:
    """Start the ranks and wait for all of them under one deadline; when one
    fails (or the deadline passes) kill the others. Returns (exit code,
    output) a rank."""
    logs = [open(out / f"rank{r}.log", "w+") for r in range(RANKS)]
    procs = [subprocess.Popen([sys.executable, WORKER, mode, str(r), str(RANKS), str(out / "rendezvous"),
                               str(case), str(out)], stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(RANKS)]
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if time.monotonic() > deadline or (mode == "run" and any(p.poll() not in (None, 0) for p in procs)):
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait(timeout=30)
    results = []
    for p, log in zip(procs, logs):
        log.seek(0)
        results.append((p.returncode, log.read()))
        log.close()
    return results


@pytest.fixture(scope="module")
def dist_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("distributed")
    case, out = root / "case", root / "out"
    case.mkdir()
    out.mkdir()
    ref, donor, _ = CS.make_case(100_000, n_ins=6, n_snp=2, n_del=2, seed=21)
    CS.write_fasta(str(case / "ref.fa"), CS.CHROM, ref)
    reads = CS.write_reads(str(case / "reads"), donor, 30.0, seed=22)
    # a flush of 4 x 1,024 positions whose last two chunks (rank 1's shards)
    # are one k-mer over and over: its owner's segments overflow there only
    rng = np.random.default_rng(23)
    over = [np.concatenate([rng.integers(0, 4, 2048, dtype=np.uint8), np.zeros(2048 + 20, np.uint8)]),
            rng.integers(0, 4, 3000, dtype=np.uint8)]
    np.savez(case / "overflow_reads.npz", *over)

    jax_find({"in": reads, "ref": str(case / "ref.fa"), "out": str(root / "solo"), "scan-engine": "host",
              "automaton": "host", "verbose": 0}, out=io.StringIO())
    jax_fill(dict(FILL_OPTS, graph=str(root / "solo.h5"), bkpt=str(root / "solo.breakpoints"),
                  out=str(root / "solofill")), out=io.StringIO())
    counters = {}
    host = JaxStreamingCounter(21)
    for n, (_h, codes) in enumerate(jax_iter_codes(str(case / "reads_1.fa"))):
        if n == 120:
            break
        host.add_codes(codes)
    counters["reads"] = host.result()
    host = JaxStreamingCounter(21)
    for codes in over:
        host.add_codes(codes)
    counters["over"] = host.result()

    results = run_ranks("run", case, out)
    for r, (rc, log) in enumerate(results):
        assert rc == 0 and f"WORKER_OK {r}" in log, f"rank {r} exited {rc}:\n{log[-4000:]}"
    reports = [json.loads((out / f"r{r}.json").read_text()) for r in range(RANKS)]
    return root, out, reports, counters


def _lines(path, drop=("##",)):
    with open(path) as f:
        return [line for line in f if not line.startswith(drop)]


@pytest.mark.parametrize("ext", ["breakpoints", "othervariants.vcf"])
@pytest.mark.parametrize("rank", range(RANKS))
def test_ranks_find_equals_jax(dist_runs, rank, ext):
    """Each rank's find records equal the JAX one-process run's."""
    root, out, _, _ = dist_runs
    got = _lines(out / f"r{rank}.{ext}")
    assert got and got == _lines(root / f"solo.{ext}")


def test_ranks_graph_equals_jax(dist_runs):
    """The graph counted over the global mesh (-count-engine sharded) loads
    to the JAX run's solid keys, counts and info on both ranks, and both
    ranks wrote the same bytes."""
    root, out, _, _ = dist_runs
    want = JaxGraph.load(str(root / "solo.h5"))
    for r in range(RANKS):
        got = Graph.load(str(out / f"r{r}.h5"))
        assert got.info == want.info
        np.testing.assert_array_equal(got.solid.keys, want.solid.keys)
        np.testing.assert_array_equal(got.solid.counts, want.solid.counts)
    assert (out / "r0.h5").read_bytes() == (out / "r1.h5").read_bytes()


def test_rank0_alone_is_writer(dist_runs):
    """Rank 0 alone is the writer; the ranks' blocks of the global mesh are
    contiguous, in rank order."""
    _, _, reports, _ = dist_runs
    assert [rep["writer"] for rep in reports] == [True, False]
    assert [rep["mesh"] for rep in reports] == [[0, 4], [2, 4]]


@pytest.mark.parametrize("fname", ["insertions.fasta", "insertions.vcf", "info.txt"])
@pytest.mark.parametrize("engine", ["auto", "device"])
def test_ranks_fill_equals_jax(dist_runs, engine, fname):
    """fill -bkpt across the ranks (jobs split by shard_bounds, results
    gathered and replayed in input order) writes the JAX one-process fill's
    artifacts on every rank, with the host engine and with the device
    walker on each rank's own device."""
    root, out, _, _ = dist_runs
    for r in range(RANKS):
        got = _lines(out / f"r{r}.{engine}.{fname}")
        assert got and got == _lines(root / f"solofill.{fname}"), r


@pytest.mark.parametrize("engine", ["auto", "device"])
def test_ranks_ran_a_shard_of_the_jobs(dist_runs, engine):
    """Each rank ran a strict, non-empty part of the jobs, and the parts add
    up to every breakpoint."""
    _, _, reports, _ = dist_runs
    parts = [rep[engine] for rep in reports]
    nb = parts[0][1]
    assert all(0 < n_local < nb and total == nb for n_local, total in parts), parts
    assert sum(n_local for n_local, _ in parts) == nb


@pytest.mark.parametrize("case", ["reads", "over"])
def test_sharded_counter_across_ranks(dist_runs, case):
    """ShardedStreamingCounter over 2 + 2 shards of two ranks equals the JAX
    host counter, on the reads and on a flush whose capacity overflows on
    rank 1's shards only: both ranks take the host route of that flush
    (and of no other), so their collectives stay in step."""
    _, out, reports, counters = dist_runs
    want = counters[case]
    for r in range(RANKS):
        got = np.load(out / f"r{r}.counts.npz")
        np.testing.assert_array_equal(got[f"{case}_kmers"], want.kmers)
        np.testing.assert_array_equal(got[f"{case}_counts"], want.counts)
        np.testing.assert_array_equal(got[f"{case}_hist"], want.histogram)
        assert reports[r][f"{case}_host_flushes"] == ([[2, 3]] if case == "over" else [])


def test_sharded_mem_fails_across_processes(dist_runs):
    """-scan-engine sharded-mem fails across processes before its scan, on
    every rank, as the JAX package's run fails there."""
    _, _, reports, _ = dist_runs
    for rep in reports:
        assert "does not run across processes" in rep["sharded_mem"]


def test_allgather_object_unequal_sizes(dist_runs):
    """allgather_object round-trips objects of unequal sizes, in rank order."""
    _, _, reports, _ = dist_runs
    for rep in reports:
        assert rep["gathered"] == ["x" * (1000 * r + 1) for r in range(RANKS)]


def test_failed_rank_fails_the_run(tmp_path):
    """A rank that exits makes the rank waiting in a collective fail (within
    the group's timeout), not hang."""
    t0 = time.monotonic()
    results = run_ranks("fail", tmp_path, tmp_path, timeout=150.0)
    assert results[1][0] == 3
    assert results[0][0] not in (0, None) and "GATHERED" not in results[0][1], results[0][1][-2000:]
    assert time.monotonic() - t0 < 150.0


@pytest.mark.parametrize("n_items", [0, 1, 5, 16, 17, 1000])
def test_shard_bounds_matches_jax(n_items):
    for n_shards in (1, 2, 3, 4, 7):
        bounds = [D.shard_bounds(n_items, n_shards, s) for s in range(n_shards)]
        assert bounds == [jax_shard_bounds(n_items, n_shards, s) for s in range(n_shards)]
        assert bounds[0][0] == 0 and bounds[-1][1] == n_items
        assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))


def test_init_distributed_without_coordinator_is_noop(monkeypatch):
    """No coordinator and no launcher's: one process, rank 0 the writer, a
    mesh of its own devices."""
    for name in ("MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(name, raising=False)
    D.init_distributed()
    assert not torch.distributed.is_initialized()
    assert (D.process_count(), D.process_index(), D.is_writer()) == (1, 0, True)
    cpus = [torch.device("cpu")] * 2
    assert D.global_mesh(cpus) == D.GlobalMesh(cpus, 0, 2)
    assert D.allgather_object({"a": 1}) == [{"a": 1}]
