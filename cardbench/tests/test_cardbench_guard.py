"""No process of a run may hold JAX, its libraries or the JAX package:
modules are compared by their whole top-level name, so the port
(``repro_torch``) passes and ``repro`` does not. A tiny run in a fresh
process loads none of them; ``run.py`` refuses to run without a card, and
in a directory that holds only the benchmark."""
import os
import shutil
import subprocess
import sys
from pathlib import Path

from cardbench.lib.guard import forbidden_modules

ROOT = Path(__file__).resolve().parents[2]
ENV = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}{os.pathsep}{ROOT}")


def test_whole_top_level_names():
    names = ["repro_torch", "repro_torch.serve.engine", "numpy", "reprox",
             "jaxtyping", "jax.numpy", "jaxlib.xla_client", "flax.linen",
             "repro", "repro.serve", "benchmarks.common"]
    assert forbidden_modules(names) == ["benchmarks", "flax", "jax", "jaxlib",
                                        "repro"]
    assert forbidden_modules(["repro_torch", "reprolib"]) == []


def test_a_run_loads_none_of_them():
    code = ("from cardbench.tests import tiny\n"
            "from cardbench.lib.guard import forbidden_modules\n"
            "out = tiny.run(tiny.spec('olmoe-batch'))\n"
            "assert out['correct'], out\n"
            "print(forbidden_modules())\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=ENV,
                       capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().splitlines()[-1] == "[]"


def test_run_refuses_without_a_card():
    r = subprocess.run([sys.executable, "cardbench/run.py", "--workload",
                        "yi6b-batch", "--seed", "1", "--seconds", "1"],
                       cwd=ROOT, env=dict(ENV, CUDA_VISIBLE_DEVICES=""),
                       capture_output=True, text=True, timeout=240)
    assert r.returncode != 0 and r.stdout == ""


def test_run_refuses_in_a_bare_benchmark_directory(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "cardbench", tmp_path / "cardbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = subprocess.run([sys.executable, "cardbench/run.py", "--workload",
                        "yi6b-batch", "--seed", "1", "--seconds", "1"],
                       cwd=tmp_path, env=dict(os.environ, PYTHONPATH=""),
                       capture_output=True, text=True, timeout=240)
    assert r.returncode != 0 and r.stdout == ""
