"""What the harness may not do: run without the card, fall back to the
CPU, run from a tree that holds only the benchmark, or load JAX or the JAX
package the port was made from."""

import os
import shutil
import subprocess
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
ARGS = ["--workload", "steckler_72k.chunk20", "--seed", "3000000001", "--seconds", "1",
        "--trace", "0"]


def _no_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")


def test_without_a_card_it_fails_and_prints_no_result():
    _no_card()
    out = subprocess.run([sys.executable, "benchmark/run.py"] + ARGS, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_the_measurement_path_does_not_fall_back_to_the_cpu():
    _no_card()
    from fbench.harness import main

    assert main(ARGS, 0.0) != 0


def test_a_tree_of_the_benchmark_alone_fails(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "benchmark/run.py"] + ARGS, cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_no_jax_in_the_harness_the_reference_or_the_port():
    """In a fresh interpreter: every module of the harness, the reference,
    every metric reader and the port's step; then no top-level module named
    jax, jaxlib, flax or firefoam_tpu (whole names: the port's own name
    begins with the JAX package's)."""
    code = f"""
import importlib, os, pkgutil, runpy, sys
sys.path[:0] = [{BENCH!r}, {ROOT!r}]
import fbench, plainfire, firefoam_torch
for pkg in (fbench, plainfire):
    for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):
        importlib.import_module(m.name)
import firefoam_torch.models.firefoam, firefoam_torch.solvers.dia_krylov
from fbench.harness import reader, FORBIDDEN, forbidden_modules
for f in os.listdir(os.path.join({BENCH!r}, 'metrics')):
    reader(f[:-3])
runpy.run_path(os.path.join({BENCH!r}, 'run.py'), run_name='fbench_run')
runpy.run_path(os.path.join({BENCH!r}, 'readings.py'), run_name='fbench_readings')
assert set(FORBIDDEN) == {{'jax', 'jaxlib', 'flax', 'firefoam_tpu'}}
bad = forbidden_modules()
assert not bad, bad
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr


def test_forbidden_names_are_compared_whole(monkeypatch):
    from fbench.harness import forbidden_modules

    monkeypatch.setitem(sys.modules, "firefoam_tpu_like", sys)
    monkeypatch.setitem(sys.modules, "jaxish.sub", sys)
    assert forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert forbidden_modules() == ["jax"]


@pytest.mark.gpu
def test_a_short_run_on_the_card_prints_its_result():
    import json

    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    out = subprocess.run([sys.executable, "benchmark/run.py"] + ARGS, cwd=ROOT,
                         capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(line)[-1] == "checks" and line["device"]["platform"] == "gpu"
    assert {"step_ms", "peak_mem_gib", "setup_s"} <= set(line["metrics"])
