"""Metrics by name: each is a small reader of its own,
``cardbench/metrics/<name>.py``, with ``read(run) -> float | None``. A
reader that finds nothing to read returns None and the metric is left out
of the result line. ``RunView`` is what a reader gets."""
from __future__ import annotations

import importlib.util
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional

from cardbench.lib import model

HERE = Path(__file__).resolve().parent.parent


@dataclass
class RunView:
    cell: dict
    cfg_file: dict
    traffic: dict
    sess: object                 # serve.Session
    setup_s: float
    memory_peak_bytes: int
    trace: Optional[object] = None   # trace.TraceSummary of a traced run

    @property
    def cfg(self) -> dict:
        return self.cfg_file["arch"]

    @property
    def model(self):
        """The configuration's model module (its counts)."""
        return model.load(self.cfg_file)

    @property
    def window_s(self) -> float:
        return self.sess.t_end - self.sess.t_open

    @property
    def quiet(self) -> tuple:
        """(start, end) of the window without any tracing: the whole window
        of an untraced run; of a traced run, the part before stretch A (the
        host-clock per-layer metrics are read there)."""
        end = self.sess.t_end
        if self.trace is not None:
            end = self.sess.steps[self.trace.a.steps[0]].t0
        return self.sess.t_open, end

    def steps_of(self, stretch):
        """The engine steps a traced stretch holds."""
        i0, i1 = stretch.steps
        return self.sess.steps[i0:i1]


def reader(name: str, root: Path = HERE):
    path = root / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "cardbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def for_cell(bench: dict, cell: str, traced: bool) -> List[dict]:
    """The metrics a run of ``cell`` reports: its end-to-end metrics, or,
    traced, its per-layer metrics."""
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]]
    if not traced:
        return e2e
    moves = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in moves)]


def compute(entries: List[dict], run: RunView) -> Dict[str, dict]:
    out = {}
    for m in entries:
        v = reader(m["name"])(run)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out
