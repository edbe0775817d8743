"""The paper's six applications (Table 2) on the port, each in
explicit/managed/system versions behind one buffer-centric code path.

``APPS`` is the AppSpec registry in the paper's Table 2 order: the uniform
runners and the canonical per-figure size presets that
``repro_torch.bench`` and the tests consume. ``run_app`` is the uniform
entry point; ``APP_RUNNERS`` is the name -> runner mapping.
"""
from repro_torch.apps import bfs as _bfs
from repro_torch.apps import hotspot as _hotspot
from repro_torch.apps import needle as _needle
from repro_torch.apps import pathfinder as _pathfinder
from repro_torch.apps import qsim as _qsim
from repro_torch.apps import srad as _srad
from repro_torch.apps.bfs import run_bfs  # noqa: F401
from repro_torch.apps.common import AppResult, AppSpec, charge_snapshot  # noqa: F401
from repro_torch.apps.hotspot import run_hotspot  # noqa: F401
from repro_torch.apps.needle import run_needle  # noqa: F401
from repro_torch.apps.pathfinder import run_pathfinder  # noqa: F401
from repro_torch.apps.qsim import run_qsim  # noqa: F401
from repro_torch.apps.srad import run_srad  # noqa: F401

# canonical (paper Table 2) ordering — benchmarks emit rows in this order
APPS = {spec.name: spec for spec in (
    _qsim.SPEC, _needle.SPEC, _pathfinder.SPEC,
    _bfs.SPEC, _hotspot.SPEC, _srad.SPEC)}

APP_RUNNERS = {name: spec.run for name, spec in APPS.items()}


def run_app(name: str, policy_kind: str = "system", *,
            preset: str = None, **overrides) -> AppResult:
    """Uniform runner: look up the app's spec, apply a named size preset
    ("fig3" | "fig11" | "small") if given, then any keyword overrides
    (``device=`` among them)."""
    spec = APPS[name]
    kw = dict(spec.sizes[preset]) if preset is not None else {}
    kw.update(overrides)
    return spec.run(policy_kind, **kw)
