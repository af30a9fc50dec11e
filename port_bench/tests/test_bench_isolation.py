"""Nothing the benchmark runs loads JAX or the JAX package: no file under
``port_bench/`` imports a forbidden top-level name (compared whole, so the
port's ``simple_vae_rs_tpu_torch`` passes), nothing under
``port_bench/reference/`` imports the port, and a CPU rehearsal of a run,
in a fresh process, leaves none of them in ``sys.modules``."""

import ast
import os
import subprocess
import sys

import pytest

from port_bench.harness import cell

from .conftest import ROOT


def _imports(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield node.args[0].value


def _files(sub=""):
    top = os.path.join(cell.HERE, sub)
    for d, _, names in os.walk(top):
        for n in names:
            if n.endswith(".py"):
                yield os.path.join(d, n)


@pytest.mark.parametrize("path", sorted(_files()), ids=lambda p: os.path.relpath(p, cell.HERE))
def test_no_file_imports_jax_or_the_jax_package(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in cell.FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_the_reference_imports_nothing_of_the_port():
    for path in _files("reference"):
        bad = [m for m in _imports(path)
               if m.split(".")[0] in ("simple_vae_rs_tpu_torch", "simple_vae_rs_tpu")
               or m.startswith("port_bench.harness")]
        assert not bad, f"{path} imports {bad}"


def test_the_names_are_compared_whole():
    assert "simple_vae_rs_tpu_torch".split(".")[0] not in cell.FORBIDDEN
    assert "simple_vae_rs_tpu.models".split(".")[0] in cell.FORBIDDEN


REHEARSAL = """
import sys
sys.path.insert(0, {root!r})
from port_bench.tests.conftest import tiny_parts
from port_bench.harness import cell
for name in ("cond_srvae.train_bf16", "cond_srvae.uq_bf16"):
    out = cell.run_cell(name, 3, 0.2, False, device="cpu", parts=tiny_parts(name))
    assert out["attempted"] > 0
print("FOUND", cell.forbidden_modules())
"""


def test_a_cpu_rehearsal_loads_no_jax():
    env = dict(os.environ, USE_FLAX="0")
    proc = subprocess.run([sys.executable, "-c", REHEARSAL.format(root=ROOT)], cwd=ROOT,
                          capture_output=True, text=True, timeout=600, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "FOUND []" in proc.stdout, proc.stdout[-2000:]
