"""The port's boundary: it imports neither JAX nor the JAX package, its entry
points default to the CUDA card, and its kernel wrappers never fall back."""
import ast
import importlib
import json
import os
import subprocess
import sys
from pathlib import Path

import jax  # noqa: F401  (each port test file runs beside JAX)
import pytest
import torch

from repro_torch.apps import (
    run_bfs,
    run_hotspot,
    run_needle,
    run_pathfinder,
    run_qsim,
    run_srad,
)
from repro_torch.bench.run import MODULES as BENCH_MODULES
from repro_torch.configs import get_config
from repro_torch.kernels import common
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.kernels.qv_gate import apply_two_qubit_gate
from repro_torch.kernels.stencil5 import stencil5
from repro_torch.launch import serve as launch_serve
from repro_torch.models import init_params
from repro_torch.serve import ServeEngine, TrafficSim, get_scenario

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _banned(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "repro", "benchmarks")


def _no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_import_leaves_jax_and_repro_out():
    code = ("import sys, json; import repro_torch, repro_torch.apps, "
            "repro_torch.core, repro_torch.kernels.stencil5, "
            "repro_torch.kernels.qv_gate, repro_torch.configs, "
            "repro_torch.models, repro_torch.serve, "
            "repro_torch.kernels.paged_attention, repro_torch.launch.serve, "
            "repro_torch.kernels.flash_attention, repro_torch.bench.run, "
            "repro_torch.runtime, repro_torch.cluster, "
            "repro_torch.bench.fault_serve, repro_torch.bench.cluster_scaling; "
            "[__import__(m) for m in repro_torch.bench.run.MODULES]; "
            "print(json.dumps(sorted(sys.modules)))")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, check=True,
                         capture_output=True, text=True).stdout
    mods = json.loads(out)
    assert "repro_torch.apps.qsim" in mods
    assert "repro_torch.serve.engine" in mods
    assert "repro_torch.apps.bfs" in mods
    assert "repro_torch.bench.kernels_micro" in mods
    assert "repro_torch.serve.traffic" in mods
    assert "repro_torch.models.moe" in mods
    assert "repro_torch.cluster.policy" in mods
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


@pytest.mark.parametrize("run", [run_hotspot, run_srad, run_qsim,
                                 run_pathfinder, run_needle, run_bfs])
def test_entry_points_default_to_the_card(run, monkeypatch):
    _no_card(monkeypatch)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run("system")


@pytest.mark.parametrize("entry", [
    lambda cfg: init_params(cfg),
    lambda cfg: ServeEngine(cfg, init_params(cfg, device="cpu")),
    lambda cfg: launch_serve.main(["--arch", "yi-6b", "--reduced"]),
], ids=["init_params", "ServeEngine", "launch.serve"])
def test_serve_entry_points_default_to_the_card(entry, monkeypatch):
    _no_card(monkeypatch)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry(get_config("yi-6b").reduced())


def _micro_sim(**kw):
    """A TrafficSim of the steady preset served by one micro model on the
    CPU, under the cluster pool with TP over two superchips."""
    from repro_torch.configs.base import ArchConfig

    cfg = ArchConfig(name="micro", family="dense", source="test",
                     num_layers=1, d_model=32, num_heads=2, num_kv_heads=2,
                     head_dim=16, d_ff=64, vocab_size=64)
    models = {arch: (cfg, init_params(cfg, device="cpu"))
              for arch in ("yi-6b", "qwen2.5-32b", "olmoe-1b-7b")}
    return TrafficSim(get_scenario("steady", 0.25), models=models,
                      policy="cluster_system", hw="gh200_x2", tp=2, **kw)


@pytest.mark.parametrize("make", [
    lambda: TrafficSim(get_scenario("steady", 0.25)),
    lambda: _micro_sim(),
], ids=["TrafficSim", "TrafficSim-cluster"])
def test_traffic_sim_defaults_to_the_card(make, monkeypatch):
    """Without ``device`` the sim targets the card: it raises where there is
    none, and where there is one it refuses models that live elsewhere."""
    _no_card(monkeypatch)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="the engine runs on cuda"):
        _micro_sim()
    assert _micro_sim(device="cpu").run().metrics["completed"] == 6


@pytest.mark.parametrize("module", BENCH_MODULES + [
    "repro_torch.bench.fault_serve", "repro_torch.bench.cluster_scaling"])
def test_bench_modules_default_to_the_card(module, monkeypatch):
    _no_card(monkeypatch)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        importlib.import_module(module).run()


def test_wrappers_refuse_non_cpu_non_cuda_tensors():
    counters = (stencil5, apply_two_qubit_gate, paged_attention,
                flash_attention)
    before = [fn.launches for fn in counters]
    with pytest.raises(ValueError, match="CUDA"):
        stencil5(torch.empty((4, 4), device="meta"), 0.1)
    with pytest.raises(ValueError, match="CUDA"):
        apply_two_qubit_gate(torch.empty(16, dtype=torch.complex64,
                                         device="meta"),
                             torch.eye(4, dtype=torch.complex64), 0, 1, 4)
    with pytest.raises(ValueError, match="CUDA"):
        paged_attention(torch.empty((2, 8, 16), device="meta"),
                        torch.empty((4, 8, 2, 16), device="meta"),
                        torch.empty((4, 8, 2, 16), device="meta"),
                        torch.empty((2, 3), dtype=torch.int32, device="meta"),
                        torch.empty(2, dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(torch.empty((1, 8, 4, 32), device="meta"),
                        torch.empty((1, 8, 2, 32), device="meta"),
                        torch.empty((1, 8, 2, 32), device="meta"))
    assert [fn.launches for fn in counters] == before


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
