"""Ours: per-(arch x shape x mesh) roofline terms from the port's dry-run
records (the port of ``benchmarks/lm_roofline.py``; run
``python -m repro_torch.launch.dryrun --all`` first). The terms are modeled
from one rank's traced counts over H100 constants (``launch/roofline.py``),
the same on any device; ``device=None`` is the CUDA card, as for every
module of the harness."""
import os

from repro_torch.bench.common import emit
from repro_torch.kernels.common import resolve_device
from repro_torch.launch.roofline import load


def run(device=None):
    resolve_device(device)
    dir_ = os.environ.get("DRYRUN_DIR", "experiments/dryrun_torch")
    tag = os.environ.get("DRYRUN_TAG", "baseline")
    if not os.path.isdir(os.path.join(dir_, tag)):
        emit("lm_roofline/missing", 0.0, f"run launch.dryrun first ({dir_}/{tag})")
        return
    for r in load(dir_, tag):
        if "skipped" in r:
            emit(f"roofline/{r['arch']}/{r['shape']}/{r['mesh']}", 0.0,
                 "skipped=" + r["skipped"].replace(",", ";"))
            continue
        bound = max(r["t_compute"], r["t_memory"], r["t_collective"])
        emit(f"roofline/{r['arch']}/{r['shape']}/{r['mesh']}", bound * 1e6,
             f"dominant={r['dominant']};roofline_frac={r['roofline_fraction']:.2f};"
             f"mfu_bound={r['mfu_bound']:.3f};fits={r['fits']}")
