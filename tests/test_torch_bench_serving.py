"""The port's serving benchmarks (repro_torch.bench.lm_serve_paged,
fault_serve, cluster_scaling) against the JAX package's benchmarks/ modules
at their smoke sizes: the same CSV rows but the ``wall_s`` field (their
numbers are modeled charges and counts, which the weights' values do not
move), and the same JSON snapshots but ``wall_s``. Each grid is cut to one
scenario and policy (the modules' own ``run`` arguments, or their grid
constants) to keep the JAX side's compile time down. The port's JSON lands
in BENCH_JSON_DIR or build/bench_json/, never at the repo root."""
import contextlib
import hashlib
import importlib
import io
import json
import re
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.bench import common
from repro_torch.bench import run as bench_run

ROOT = Path(__file__).resolve().parent.parent
# the JAX package's benchmarks/ lives at the root of the checkout
sys.path.append(str(ROOT))
WALL = re.compile(r";?wall_s=[0-9.]+")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The models here are tiny: one intra-op thread per process keeps
    parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _root_snapshots() -> dict:
    return {p.name: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(ROOT.glob("BENCH_*.json"))}


def _rows(fn, *args, **kw) -> list:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args, **kw)
    return [WALL.sub("", ln) for ln in buf.getvalue().splitlines()
            if ln != "name,us_per_call,derived"]


def _drop_wall(tree):
    if isinstance(tree, dict):
        return {k: _drop_wall(v) for k, v in tree.items() if k != "wall_s"}
    if isinstance(tree, list):
        return [_drop_wall(v) for v in tree]
    return tree


def _both(name, monkeypatch, tmp_path, env, grid=None):
    """Import benchmarks.<name> and repro_torch.bench.<name>, point their
    JSON at tmp_path/jax and tmp_path/port, set ``env`` and cut ``grid``
    (module constants) in both. Returns (jax module, port module)."""
    jmod = importlib.import_module(f"benchmarks.{name}")
    mod = importlib.import_module(f"repro_torch.bench.{name}")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    for k, v in (grid or {}).items():
        monkeypatch.setattr(jmod, k, v)
        monkeypatch.setattr(mod, k, v)
    return jmod, mod


def _json(d: Path, module: str):
    return _drop_wall(json.loads((d / f"BENCH_{module}.json").read_text()))


@pytest.fixture
def roots_untouched():
    before = _root_snapshots()
    yield
    assert _root_snapshots() == before


def test_lm_serve_paged_rows_match_jax(monkeypatch, tmp_path, roots_untouched):
    jmod, mod = _both("lm_serve_paged", monkeypatch, tmp_path,
                      {"LM_SERVE_SMOKE": "1"})
    monkeypatch.setenv("BENCH_JSON_DIR", str(tmp_path / "jax"))
    (tmp_path / "jax").mkdir()
    want = _rows(jmod.run, ["steady"], ["system"])
    monkeypatch.setenv("BENCH_JSON_DIR", str(tmp_path / "port"))
    got = _rows(mod.run, ["steady"], ["system"], device="cpu")
    assert got == want and len(got) == 4  # the cell and its three tenants
    assert _json(tmp_path / "port", "lmserve") == \
        _json(tmp_path / "jax", "lmserve")


def test_fault_serve_rows_match_jax(monkeypatch, tmp_path, roots_untouched):
    jmod, mod = _both("fault_serve", monkeypatch, tmp_path,
                      {"FAULT_SMOKE": "1"},
                      grid={"SCENARIOS": ("steady",),
                            "POLICIES": ("cluster_system",)})
    monkeypatch.setenv("BENCH_JSON_DIR", str(tmp_path / "jax"))
    (tmp_path / "jax").mkdir()
    want = _rows(jmod.main)
    monkeypatch.setenv("BENCH_JSON_DIR", str(tmp_path / "port"))
    got = _rows(mod.run, device="cpu")
    assert got == want and len(got) == 3
    rows = _json(tmp_path / "port", "fault")
    assert rows == _json(tmp_path / "jax", "fault")
    assert sum(r["replayed_tokens"] for r in rows["rows"]) > 0


def test_cluster_scaling_rows_match_jax(monkeypatch, tmp_path,
                                        roots_untouched):
    jmod, mod = _both("cluster_scaling", monkeypatch, tmp_path,
                      {"CLUSTER_SMOKE": "1"},
                      grid={"POLICIES": ("cluster_striped",)})
    monkeypatch.setenv("BENCH_JSON_DIR", str(tmp_path / "jax"))
    (tmp_path / "jax").mkdir()
    want = _rows(jmod.main, ["--apps", "srad"])
    monkeypatch.setenv("BENCH_JSON_DIR", str(tmp_path / "port"))
    got = _rows(mod.run, "srad", device="cpu")
    # srad at 1, 2 and 4 superchips, then TP-2 serving
    assert got == want and len(got) == 4
    assert _json(tmp_path / "port", "cluster") == \
        _json(tmp_path / "jax", "cluster")


def test_json_dir_defaults_under_build(monkeypatch):
    monkeypatch.delenv("BENCH_JSON_DIR", raising=False)
    assert common.json_dir() == ROOT / "build" / "bench_json"
    monkeypatch.setenv("BENCH_JSON_DIR", "/elsewhere")
    assert common.json_dir() == Path("/elsewhere")


def test_write_json_lands_in_bench_json_dir(monkeypatch, tmp_path,
                                            roots_untouched):
    monkeypatch.setenv("BENCH_JSON_DIR", str(tmp_path / "new"))
    path = common.write_json("lmserve", {"a/b": {"x": 1}}, hardware="hw",
                             policies=("system", "managed", "system"))
    assert path == tmp_path / "new" / "BENCH_lmserve.json"
    assert json.loads(path.read_text()) == {
        "a/b": {"x": 1}, "_meta": {"hardware": "hw",
                                   "policies": ["managed", "system"]}}


@pytest.mark.parametrize("argv,want", [
    (["--json"], None),
    (["--json", "DIR"], "DIR"),
    (["--json", "repro_torch.bench.fig45_timeline"], None),
])
def test_runner_json_flag(monkeypatch, tmp_path, capsys, argv, want):
    """``--json DIR`` points BENCH_JSON_DIR at DIR; a bare ``--json`` keeps
    the default (build/bench_json/), never the repo root."""
    # recorded, so the runner's own setting is undone after the test
    monkeypatch.setenv("BENCH_JSON_DIR", "unset")
    monkeypatch.delenv("BENCH_JSON_DIR")
    argv = [str(tmp_path) if a == "DIR" else a for a in argv]
    assert bench_run.main(argv + ["--device", "cpu",
                                  "repro_torch.bench.fig45_timeline"]) == 0
    assert capsys.readouterr().out.startswith("name,us_per_call,derived")
    got = common.json_dir()
    assert got == (tmp_path if want else ROOT / "build" / "bench_json")


def test_lm_serve_paged_in_the_runner():
    names = bench_run.MODULES
    assert names[names.index("repro_torch.bench.kernels_micro") + 1] == \
        "repro_torch.bench.lm_serve_paged"
    for m in ("fault_serve", "cluster_scaling"):
        assert f"repro_torch.bench.{m}" not in names
        assert callable(importlib.import_module(f"repro_torch.bench.{m}").run)
