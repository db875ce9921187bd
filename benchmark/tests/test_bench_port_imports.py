"""Nothing under ``benchmark/`` imports JAX or the JAX package, by the
top-level name of each imported module compared whole (the port's name
begins with the JAX package's), and the reference imports nothing of the
port."""

import ast
import subprocess
import sys

import pytest

import bench_helpers as bh

BENCH = bh.ROOT / "benchmark"
FORBIDDEN = {"jax", "jaxlib", "flax", "tce_rvos_tpu"}


def imported(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "id", "") == "__import__":
            yield from (a.value for a in node.args[:1] if isinstance(a, ast.Constant))


FILES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_anywhere(path):
    tops = {m.split(".")[0] for m in imported(path)}
    assert not tops & FORBIDDEN, f"{path} imports {tops & FORBIDDEN}"


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_port(path):
    tops = {m.split(".")[0] for m in imported(path)}
    assert "tce_rvos_tpu_torch" not in tops


def test_a_run_loads_no_jax():
    """Importing the harness, the reference and the port's modules a run
    drives leaves no forbidden top-level module in ``sys.modules``."""
    code = (
        "import sys; sys.path[:0] = [{b!r}, {r!r}]\n"
        "import run; run.environment()\n"
        "import harness.core, harness.serve, harness.train, harness.check, reference\n"
        "import tce_rvos_tpu_torch.infer, tce_rvos_tpu_torch.engine\n"
        "import tce_rvos_tpu_torch.parallel.train_step\n"
        "print(sorted({{k.split('.')[0] for k in sys.modules}} & {f!r}))\n"
    ).format(b=str(BENCH), r=str(bh.ROOT), f=FORBIDDEN)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=str(bh.ROOT), timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
