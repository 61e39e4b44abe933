"""The port never imports jax: with jax blocked, every module of
mindthegap_tpu_torch imports and a small find + fill runs on the CPU."""

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
    filled = CS.filled_insertions("tf.insertions.fasta")
    assert CS.insertion_recall(ins, filled) == 1.0, filled
    print("imported", len(names), "modules; jax loaded:", sys.modules["jax"] is not None)
""")


def test_port_runs_with_jax_blocked(tmp_path):
    code = f"REPO = {REPO!r}\nWORK = {str(tmp_path)!r}\n" + SCRIPT
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "jax loaded: False" in r.stdout
