"""The control on the card: the reference in TF32, put in the program's
place, reads above a cell's limits, at a size a test run holds (a short
window of the cell's own load and sizes). Needs a CUDA card: run with
``python -m pytest cardbench/tests -m card`` on the card's machine."""
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.card
@pytest.mark.parametrize("cell", ["yi6b-batch", "olmoe-batch"])
def test_control_fails_the_limits(cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    r = subprocess.run([sys.executable, "cardbench/control.py", "--workload",
                        cell, "--seeds", "2147483990", "--seconds", "10"],
                       cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-3000:]
    row = json.loads(r.stdout.strip().splitlines()[0])
    lim = json.loads((ROOT / "cardbench" / "limits" / f"{cell}.json").read_text())
    assert row["correct"], row  # the program itself passes
    control = {k: row[k.replace("served_logit", "control_logit").replace(
        "final_hidden", "control_hidden")] for k in lim
        if k.startswith(("served_", "final_"))}
    assert any(control[k] > lim[k] for k in control), (control, lim)
