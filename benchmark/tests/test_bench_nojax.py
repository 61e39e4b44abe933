"""Nothing the benchmark runs loads JAX or the JAX package: the check
compares whole top-level module names (the port's name begins with the
JAX package's), and the reference imports nothing of the program."""

import ast
import os
import subprocess
import sys

from tiny import BENCH, ROOT  # first: it puts the benchmark on sys.path
from mtgbench import harness


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "mindthegap_tpu_torch.fake", object())
    monkeypatch.setitem(sys.modules, "jaxtyping_like", object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "mindthegap_tpu.find", object())
    monkeypatch.setitem(sys.modules, "jax", object())
    assert harness.forbidden_modules() == ["jax", "mindthegap_tpu"]


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def _sources(*parts):
    for d, _dirs, files in os.walk(os.path.join(BENCH, *parts)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_source_imports_jax():
    for path in _sources():
        assert not set(_imports(path)) & set(harness.FORBIDDEN), path


def test_reference_imports_nothing_of_the_program():
    for path in list(_sources("mtgbench", "reference")) + [os.path.join(BENCH, "mtgbench", "gen.py")]:
        assert "mindthegap_tpu_torch" not in set(_imports(path)), path


def test_port_and_harness_load_no_jax():
    code = ("import sys; sys.path[:0] = [%r, %r]\n"
            "from mtgbench import harness, control\n"
            "import mindthegap_tpu_torch.cli, mindthegap_tpu_torch.find.runner, mindthegap_tpu_torch.fill.runner\n"
            "harness.Counters()\n"
            "print(harness.forbidden_modules())") % (BENCH, ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
                         env={k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
