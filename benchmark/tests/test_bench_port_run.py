"""``benchmark/run.py`` refuses to run without a CUDA device, and in a
checkout that holds only the benchmark, printing no result."""

import os
import shutil
import subprocess
import sys

import pytest

import bench_helpers as bh


def run(cwd, extra_env=None):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", **(extra_env or {}))
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                           "tce_r50_ftf8_iqt.clip_e1", "--seed", "3", "--seconds", "1",
                           "--trace", "0"], cwd=str(cwd), capture_output=True, text=True,
                          env=env, timeout=300)


def test_no_card_no_result():
    out = run(bh.ROOT)
    assert out.returncode != 0
    assert not [l for l in out.stdout.splitlines() if l.startswith("{")]
    assert "CUDA" in out.stderr


def test_only_the_benchmark_no_result(tmp_path):
    shutil.copy(bh.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(bh.ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = run(tmp_path)
    assert out.returncode != 0
    assert not [l for l in out.stdout.splitlines() if l.startswith("{")]


@pytest.mark.parametrize("name", bh.CELLS)
def test_every_cell_is_found_by_name(name):
    from harness import core

    cell = core.load_cell(name)
    assert cell.limits and cell.end_to_end and cell.per_layer
    assert any(m["name"] == "setup_s" for m in cell.end_to_end)
    for m in cell.per_layer:
        assert (bh.ROOT / "benchmark" / "metrics" / f"{m['name']}.py").is_file()
        assert any(e["name"] == m["moves"] for e in cell.end_to_end)
