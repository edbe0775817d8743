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
from repro_torch.launch import train as launch_train
from repro_torch.data import DataLoader, SyntheticLM
from repro_torch.examples import (
    buffer_api,
    qv_oversubscription,
    quickstart,
    serve_batched,
    trace_replay,
    train_100m,
)
from repro_torch.models import init_cache, init_params, numpy_params
from repro_torch.models.convert import load_jax_train_state
from repro_torch.runtime import reshard_tree
from repro_torch.serve import ServeEngine, TrafficSim, get_scenario
from repro_torch.train import UMTrainer

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
            "repro_torch.bench.fault_serve, repro_torch.bench.cluster_scaling, "
            "repro_torch.core.trace, repro_torch.examples.trace_replay, "
            "repro_torch.examples.buffer_api, "
            "repro_torch.examples.qv_oversubscription, "
            "repro_torch.examples.serve_batched, repro_torch.optim, "
            "repro_torch.data, repro_torch.checkpoint, repro_torch.train, "
            "repro_torch.runtime.straggler, repro_torch.runtime.elastic, "
            "repro_torch.bench.train_oversub, repro_torch.examples.train_100m, "
            "repro_torch.examples.quickstart, repro_torch.launch.mesh, "
            "repro_torch.launch.sharding, repro_torch.launch.steps, "
            "repro_torch.launch.train, repro_torch.launch.dryrun, "
            "repro_torch.launch.roofline, repro_torch.launch.analysis, "
            "repro_torch.core.h100, repro_torch.models.qcomm, "
            "repro_torch.models.parallel, repro_torch.bench.lm_roofline; "
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
    assert "repro_torch.models.rwkv" in mods
    assert "repro_torch.models.rglru" in mods
    for m in ("optim.adamw", "optim.compression", "optim.schedule",
              "data.pipeline", "checkpoint.manager", "train.trainer",
              "train.offload", "train.umtrain", "runtime.straggler",
              "runtime.elastic", "bench.train_oversub", "launch.mesh",
              "launch.sharding", "launch.steps", "launch.train",
              "launch.dryrun", "launch.roofline", "launch.analysis",
              "core.h100", "models.qcomm", "models.parallel",
              "bench.lm_roofline"):
        assert f"repro_torch.{m}" in mods
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
    lambda cfg: init_cache(cfg, 1, 8),
    lambda cfg: ServeEngine(cfg, init_params(cfg, device="cpu")),
    lambda cfg: launch_serve.main(["--arch", "yi-6b", "--reduced"]),
    lambda cfg: launch_train.main(["--arch", "yi-6b", "--reduced", "--steps", "1"]),
    lambda cfg: launch_train.main(["--arch", "yi-6b", "--reduced", "--data", "2",
                                   "--model", "2"]),
], ids=["init_params", "init_cache", "ServeEngine", "launch.serve",
        "launch.train", "launch.train-2x2"])
def test_serve_entry_points_default_to_the_card(entry, monkeypatch):
    _no_card(monkeypatch)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry(get_config("yi-6b").reduced())


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "recurrentgemma-2b"])
def test_recurrent_entry_points_default_to_the_card(arch, monkeypatch):
    cfg = get_config(arch).reduced()
    _no_card(monkeypatch)
    for entry in (lambda: init_params(cfg), lambda: init_cache(cfg, 1, 8)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry()


@pytest.mark.parametrize("example", [trace_replay, buffer_api,
                                     qv_oversubscription, serve_batched,
                                     quickstart, train_100m],
                         ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_examples_default_to_the_card(example, monkeypatch, tmp_path):
    _no_card(monkeypatch)
    argv = ["--trace", str(tmp_path / "t.trace")] if example is trace_replay else []
    with pytest.raises(RuntimeError, match="no CUDA device"):
        example.main(argv)


@pytest.mark.parametrize("entry", [
    lambda: DataLoader(SyntheticLM(256, 8, 2)),
    lambda: UMTrainer("train_tiny"),
    lambda: reshard_tree({"w": torch.zeros(2)}),
    lambda: load_jax_train_state(
        get_config("yi-6b").reduced(),
        {"params": numpy_params(get_config("yi-6b").reduced(), 0)}),
], ids=["DataLoader", "UMTrainer", "reshard_tree", "load_jax_train_state"])
def test_training_entry_points_default_to_the_card(entry, monkeypatch):
    _no_card(monkeypatch)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry()


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
