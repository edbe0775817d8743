"""``BENCHMARK.json`` against the benchmark's format: its keys, names,
units and limits of size, and every file a cell is found by (configuration,
traffic mix, limits, metric readers)."""
import json
import re
from pathlib import Path

import pytest

from cardbench.lib import model

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTH = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|proj|head|expan|experts_per")


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and ".." not in p
        assert (ROOT / p).is_dir() and not p.endswith("_torch")
    assert len(BENCH["command"]) <= 32 and all(_line(w) for w in BENCH["command"])


def test_configs():
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("cardbench/") and (ROOT / c["file"]).is_file()
        body = json.loads((ROOT / c["file"]).read_text())
        assert body["name"] == c["name"] and body["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16
        assert not any(WIDTH.search(k) for k in c["reduced"])
        # its model module, where it names one, lies with the benchmark
        assert body.get("model", "cardbench/models/").startswith("cardbench/models/")
        assert callable(model.load(body).walk)
    assert len({c["file"] for c in BENCH["configs"]}) == len(BENCH["configs"])


def test_workloads():
    cfgs = {c["name"] for c in BENCH["configs"]}
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in cfgs and w["chips"] in (1, 4) and _line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert (ROOT / "cardbench" / "traffic" / f"{w['traffic']}.json").is_file()
        lim = json.loads((ROOT / "cardbench" / "limits" / f"{w['name']}.json").read_text())
        for k in ("served_logit_gap", "wrong_length", "counter_mismatch"):
            assert isinstance(lim[k], (int, float))
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(
        1, len(BENCH["workloads"]) // 4)


@pytest.mark.parametrize("group", ["end_to_end", "per_layer"])
def test_metrics(group):
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH[group]:
        keys = {"name", "unit", "better", "source"} | (
            {"bound"} if group == "end_to_end" else {"layer", "moves"})
        assert set(m) - {"workloads"} == keys
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
        assert (ROOT / "cardbench" / "metrics" / f"{m['name']}.py").is_file()
        if group == "end_to_end":
            assert m["source"] in ("host_clock", "device_trace")
            assert 0.01 <= m["bound"] <= 0.25
        else:
            assert m["source"] in ("device_trace", "program_span",
                                   "program_counter", "host_clock")
            assert _line(m["layer"]) and m["moves"] in e2e
            if m["unit"] == "%" and ("roofline" in m["name"] or "mfu" in m["name"]):
                assert m["name"].endswith("_roofline") or "mfu" in m["name"]
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names)) and "setup_s" in e2e
