"""The port never imports jax: with jax blocked, every module of
mindthegap_tpu_torch imports (the plane path's find/scan.py, automaton.py
and observers.py among them, and the analysis scripts), and a small find +
fill, a find through the plane path into the Python automaton, finds with
the mesh engines (`-scan-engine sharded` and `sharded-mem` on 2 logical
shards) and the analysis scripts over the find's outputs run on the
CPU."""

import subprocess
import sys
import textwrap

REPO = __file__.rsplit("/tests/", 1)[0]

SCRIPT = textwrap.dedent("""
    import contextlib, importlib, io, os, pkgutil, sys
    sys.modules["jax"] = None  # any `import jax` now raises ImportError
    sys.path.insert(0, REPO)
    import chip_smoke as CS
    import mindthegap_tpu_torch as P

    names = [m.name for m in pkgutil.walk_packages(P.__path__, "mindthegap_tpu_torch.")
             if m.name != "mindthegap_tpu_torch.__main__"]
    for name in names:
        importlib.import_module(name)
    # the plane path's host modules are among them
    assert {"mindthegap_tpu_torch.find.scan", "mindthegap_tpu_torch.find.automaton",
            "mindthegap_tpu_torch.find.observers"} <= set(names)
    # and the run across processes and the tools
    assert {"mindthegap_tpu_torch.parallel.distributed", "mindthegap_tpu_torch.dbginfo",
            "mindthegap_tpu_torch.compat", "mindthegap_tpu_torch.compat.gatb"} <= set(names)
    # and the analysis scripts
    assert {"mindthegap_tpu_torch.scripts.context_genome_wg",
            "mindthegap_tpu_torch.scripts.insert_snp_in_ref"} <= set(names)
    assert not any(n == "mindthegap_tpu" or n.startswith("mindthegap_tpu.") for n in sys.modules)

    from mindthegap_tpu_torch import cli
    os.chdir(WORK)
    ref, donor, ins = CS.make_case(30_000, n_ins=2, n_snp=1, n_del=1, seed=5)
    CS.write_fasta("ref.fa", CS.CHROM, ref)
    reads = CS.write_reads("reads", donor, 30.0, seed=6)
    with contextlib.redirect_stdout(io.StringIO()):
        assert cli.main(["find", "-in", reads, "-ref", "ref.fa", "-out", "t", "-device", "cpu", "-verbose", "0"]) == 0
        assert cli.main(["fill", "-graph", "t.h5", "-bkpt", "t.breakpoints", "-out", "tf",
                         "-nb-cores", "1", "-verbose", "0"]) == 0
        # the plane path: the bucket map's planes into the Python automaton
        assert cli.main(["find", "-graph", "t.h5", "-ref", "ref.fa", "-out", "p", "-device", "cpu",
                         "-verbose", "0", "-scan-engine", "device-qb", "-automaton", "host"]) == 0
    assert open("p.breakpoints").read() == open("t.breakpoints").read()
    # the mesh engines on 2 logical CPU shards
    from mindthegap_tpu_torch.parallel import mesh as M
    with M.logical_devices(["cpu", "cpu"]), contextlib.redirect_stdout(io.StringIO()):
        for engine in ("sharded", "sharded-mem"):
            assert cli.main(["find", "-graph", "t.h5", "-ref", "ref.fa", "-out", engine, "-device", "cpu",
                             "-verbose", "0", "-scan-engine", engine]) == 0
            assert open(engine + ".breakpoints").read() == open("t.breakpoints").read(), engine
    # the analysis scripts over the find run: the host route, and the device
    # route's plain plane passes (K15's) in small windows
    from mindthegap_tpu_torch.graph.dbg import Graph
    from mindthegap_tpu_torch.scripts import context_genome_wg, insert_snp_in_ref
    with contextlib.redirect_stdout(io.StringIO()):
        assert context_genome_wg.main(["-g", "t.h5", "-p", "ref.fa", "-b", "t.breakpoints", "-o", "f.bkpt",
                                       "-device", "cpu"]) == 0
        snp = ["ref", "10", ".", "ACTGN"[min(ref[9], 4)], "A", "50"]
        open("snp.vcf", "w").write("\\t".join(snp) + "\\n")
        assert insert_snp_in_ref.main(["-s", "snp.vcf", "-g", "ref.fa", "-o", "alt.fa"]) == 0
    assert open("f.bkpt").read() == open("t.breakpoints").read()
    graph = Graph.load("t.h5")
    degrees = context_genome_wg.device_degree_fn(graph, "cpu", window=4096)(ref)
    assert degrees.shape == (ref.size - graph.k + 1,) and (degrees[5000:6000] == 2).all()
    filled = CS.filled_insertions("tf.insertions.fasta")
    assert CS.insertion_recall(ins, filled) == 1.0, filled
    print("imported", len(names), "modules; jax loaded:", sys.modules["jax"] is not None)
""")


def test_port_runs_with_jax_blocked(tmp_path):
    code = f"REPO = {REPO!r}\nWORK = {str(tmp_path)!r}\n" + SCRIPT
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "jax loaded: False" in r.stdout
