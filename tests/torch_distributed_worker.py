"""One rank of the port's run across processes, for tests/test_torch_distributed.py.

Usage: torch_distributed_worker.py run|fail <rank> <world> <rendezvous file> <case dir> <out dir>

`fail`: rank 1 exits with code 3 after joining, and rank 0 waits in a
gather: the test holds that rank 0 then fails too, within the group's
timeout. `run`: the rank joins a gloo process group through the rendezvous file, lays 2
logical CPU shards in the global mesh, and runs on the case's reads and
reference (made by the test, from a seed):
  - allgather_object of objects of unequal sizes;
  - find -scan-engine sharded -count-engine sharded -automaton host;
  - fill -bkpt of that find's breakpoints with -fill-engine auto and device;
  - find -scan-engine sharded-mem, which must fail before its scan (the
    JAX package's fails across processes too);
  - ShardedStreamingCounter over the global mesh of 4 shards on the
    reads, and on the case's overflow reads (a flush whose segments
    overflow on rank 1's shards only).
It writes its artifacts as <out dir>/r<rank>.*, and what the test checks
besides as <out dir>/r<rank>.json and r<rank>.counts.npz; it prints
WORKER_OK <rank> last. It imports nothing of the JAX package.
"""

import io
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SHARDS = 2  # logical CPU shards a rank


def main():
    mode, rank, world, rendezvous, case, out = (sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                                                sys.argv[5], sys.argv[6])
    import numpy as np
    import torch

    from mindthegap_tpu_torch.fill.runner import Filler
    from mindthegap_tpu_torch.find.runner import FinderError, run_find
    from mindthegap_tpu_torch.io.bank import iter_codes
    from mindthegap_tpu_torch.parallel import distributed as D
    from mindthegap_tpu_torch.parallel import mesh as M
    from mindthegap_tpu_torch.parallel.sharded_count import ShardedStreamingCounter

    D.init_distributed(f"file://{rendezvous}", world, rank, timeout_s=120)
    assert D.process_count() == world and D.process_index() == rank
    if mode == "fail":
        if rank == 1:
            sys.exit(3)
        D.allgather_object(rank)
        print("GATHERED", rank, flush=True)
        return
    report = {"writer": D.is_writer(), "gathered": D.allgather_object("x" * (1000 * rank + 1))}

    reads = ",".join(os.path.join(case, f) for f in ("reads_1.fa", "reads_2.fa"))
    prefix = os.path.join(out, f"r{rank}")
    with M.logical_devices([torch.device("cpu")] * SHARDS):
        mesh = D.global_mesh(M.make_mesh("cpu"))
        report["mesh"] = [mesh.offset, mesh.size]
        run_find({"in": reads, "ref": os.path.join(case, "ref.fa"), "out": prefix, "scan-engine": "sharded",
                  "count-engine": "sharded", "automaton": "host", "device": "cpu", "verbose": "0"},
                 out=io.StringIO())
        for engine in ("auto", "device"):
            filler = Filler({"graph": prefix + ".h5", "bkpt": prefix + ".breakpoints", "out": f"{prefix}.{engine}",
                             "fill-engine": engine, "max-length": "1000", "device": "cpu", "verbose": "0"},
                            out=io.StringIO())
            filler.execute()
            report[engine] = [filler.n_local_jobs, filler.nb_breakpoints]
        try:
            run_find({"graph": prefix + ".h5", "ref": os.path.join(case, "ref.fa"), "out": prefix + ".sm",
                      "scan-engine": "sharded-mem", "device": "cpu", "verbose": "0"}, out=io.StringIO())
        except FinderError as e:
            report["sharded_mem"] = str(e)

        counts = {}
        counter = ShardedStreamingCounter(21, mesh, batch_bases=1 << 13)
        for n, (_h, codes) in enumerate(iter_codes(os.path.join(case, "reads_1.fa"))):
            if n == 120:
                break
            counter.add_codes(codes)
        res = counter.result()
        counts.update(reads_kmers=res.kmers, reads_counts=res.counts, reads_hist=res.histogram)
        report["reads_host_flushes"] = counter.host_flushes
        counter = ShardedStreamingCounter(21, mesh, batch_bases=1 << 12)
        for codes in np.load(os.path.join(case, "overflow_reads.npz")).values():
            counter.add_codes(codes)
        res = counter.result()
        counts.update(over_kmers=res.kmers, over_counts=res.counts, over_hist=res.histogram)
        report["over_host_flushes"] = counter.host_flushes
    np.savez(prefix + ".counts.npz", **counts)
    with open(prefix + ".json", "w") as f:
        json.dump(report, f)
    print("WORKER_OK", rank, flush=True)


if __name__ == "__main__":
    main()
