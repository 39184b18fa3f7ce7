"""No module under ``bench/`` imports JAX or the JAX package ``repro``, and a
run's process holds none of them; top-level names (before the first dot)
are compared whole, since the port's name, ``repro_torch``, begins with
``repro``.  Without a card, or without the port, the command prints no
result and exits non-zero."""
import ast
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from bench import harness

ROOT = Path(__file__).resolve().parents[2]
SOURCES = sorted(p for p in (ROOT / "bench").rglob("*.py")
                 if "__pycache__" not in p.parts)


def _imported(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_no_source_imports_jax_or_the_jax_package(path):
    assert not _imported(path) & set(harness.FORBIDDEN)


def test_top_level_names_compared_whole():
    loaded = ["repro_torch", "repro_torch.models", "jaxtyping", "reprox",
              "repro", "repro.core.energy", "jax.numpy", "jaxlib", "flax.nn"]
    assert harness.forbidden_modules(loaded) == [
        "flax.nn", "jax.numpy", "jaxlib", "repro", "repro.core.energy"]


RUN = """
import sys, time, json
sys.path[0:0] = [{root!r}, {src!r}]
from bench import harness
from bench.tests.test_bench_runs import _smoke
for cell in ("yi-6b-stage.train", "rwkv6-3b.score"):
    harness.run(cell, 12, 0.1, True, t_start=time.perf_counter(),
                device="cpu", overrides=_smoke(cell))
print(json.dumps(harness.forbidden_modules()))
"""


def test_a_run_loads_neither():
    out = subprocess.run(
        [sys.executable, "-c", RUN.format(root=str(ROOT),
                                          src=str(ROOT / "src"))],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.splitlines()[-1]) == []


def _command(cwd: Path):
    return subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "yi-6b.score",
         "--seed", "3000000019", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=cwd,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})


def test_no_card_no_result():
    out = _command(ROOT)
    assert out.returncode != 0 and out.stdout == ""


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _command(tmp_path)
    assert out.returncode != 0 and out.stdout == ""
