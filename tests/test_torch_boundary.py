"""The port's boundary: it imports neither JAX nor the JAX package, its entry
points default to the CUDA card, and its kernel wrappers never fall back."""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import jax  # noqa: F401  (each port test file runs beside JAX)
import pytest
import torch

from repro_torch.apps import run_hotspot, run_qsim, run_srad
from repro_torch.kernels import common
from repro_torch.kernels.qv_gate import apply_two_qubit_gate
from repro_torch.kernels.stencil5 import stencil5

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _banned(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "repro")


def test_import_leaves_jax_and_repro_out():
    code = ("import sys, json; import repro_torch, repro_torch.apps, "
            "repro_torch.core, repro_torch.kernels.stencil5, "
            "repro_torch.kernels.qv_gate; print(json.dumps(sorted(sys.modules)))")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, check=True,
                         capture_output=True, text=True).stdout
    mods = json.loads(out)
    assert "repro_torch.apps.qsim" in mods
    assert [m for m in mods if _banned(m)] == []


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_source_imports_no_jax_or_repro(path):
    tree = ast.parse(path.read_text())
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found += [a.name for a in node.names if _banned(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.module:
            if node.level == 0 and _banned(node.module):
                found.append(node.module)
    assert found == []


@pytest.mark.parametrize("run", [run_hotspot, run_srad, run_qsim])
def test_entry_points_default_to_the_card(run, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run("system")


def test_wrappers_refuse_non_cpu_non_cuda_tensors():
    before = (stencil5.launches, apply_two_qubit_gate.launches)
    with pytest.raises(ValueError, match="CUDA"):
        stencil5(torch.empty((4, 4), device="meta"), 0.1)
    with pytest.raises(ValueError, match="CUDA"):
        apply_two_qubit_gate(torch.empty(16, dtype=torch.complex64,
                                         device="meta"),
                             torch.eye(4, dtype=torch.complex64), 0, 1, 4)
    assert (stencil5.launches, apply_two_qubit_gate.launches) == before


@pytest.mark.parametrize("q1,q2", [(0, 0), (4, 1), (-1, 2)])
def test_qv_gate_rejects_bad_qubit_pairs(q1, q2):
    st = torch.zeros(16, dtype=torch.complex64)
    with pytest.raises(ValueError, match="qubit pair"):
        apply_two_qubit_gate(st, torch.eye(4, dtype=torch.complex64), q1, q2, 4)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(common.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        common._nvcc()
