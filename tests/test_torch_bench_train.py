"""The port's training benchmark (repro_torch.bench.train_oversub) against
the JAX package's benchmarks/train_oversub.py at smoke size on train_tiny:
the CSV rows and the JSON snapshot's modeled columns are equal; the losses
(torch here, numpy there) agree to 1e-6 and ``wall_s`` is each run's own.
The port's JSON lands in BENCH_JSON_DIR, never at the repo root."""
import contextlib
import hashlib
import importlib
import io
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.append(str(ROOT))  # the JAX package's benchmarks/
LOSS_RTOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _root_snapshots() -> dict:
    return {p.name: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(ROOT.glob("BENCH_*.json"))}


def _csv(fn, **kw) -> list:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert fn(**kw) == 0
    return buf.getvalue().splitlines()


def test_train_oversub_rows_match_jax(monkeypatch, tmp_path):
    before = _root_snapshots()
    jmod = importlib.import_module("benchmarks.train_oversub")
    mod = importlib.import_module("repro_torch.bench.train_oversub")
    monkeypatch.setenv("TRAIN_SMOKE", "1")
    monkeypatch.setenv("TRAIN_MODEL", "train_tiny")
    out = {}
    for name, fn, kw in (("jax", jmod.run, {}),
                         ("port", mod.run, {"device": "cpu"})):
        (tmp_path / name).mkdir()
        monkeypatch.setenv("BENCH_JSON_DIR", str(tmp_path / name))
        csv = _csv(fn, **kw)
        snap = json.loads((tmp_path / name / "BENCH_train.json").read_text())
        out[name] = (csv, snap)
    (jcsv, jsnap), (csv, snap) = out["jax"], out["port"]
    # the JAX run() prints the CSV header itself; the port's harness prints
    # it once, before every module's rows
    assert jcsv[0] == "name,us_per_call,derived"
    assert csv == jcsv[1:] and len(csv) == 6 * 2  # 6 policies x 2 ratios
    assert snap["_meta"] == jsnap["_meta"]
    assert len(snap["rows"]) == len(jsnap["rows"]) == 12
    for row, jrow in zip(snap["rows"], jsnap["rows"]):
        np.testing.assert_allclose(row.pop("losses"), jrow.pop("losses"),
                                   rtol=LOSS_RTOL)
        row.pop("wall_s"), jrow.pop("wall_s")
        assert row == jrow
    # within the port the grid's losses are bit-identical (the module
    # asserts it too)
    assert len({tuple(r["losses"]) for r in json.loads(
        (tmp_path / "port" / "BENCH_train.json").read_text())["rows"]}) == 1
    assert _root_snapshots() == before


def test_train_floor_fails_the_run(monkeypatch, tmp_path):
    mod = importlib.import_module("repro_torch.bench.train_oversub")
    monkeypatch.setenv("TRAIN_SMOKE", "1")
    monkeypatch.setenv("TRAIN_MODEL", "train_tiny")
    monkeypatch.setenv("TRAIN_FLOOR", "system/1.0=1e12")
    monkeypatch.setenv("BENCH_JSON_DIR", str(tmp_path))
    with pytest.raises(SystemExit, match="TRAIN_FLOOR violated"):
        _csv(mod.run, device="cpu")
