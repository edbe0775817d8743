"""The paper's apps on the port, each in explicit/managed/system versions
behind one buffer-centric code path: hotspot, srad and qiskit so far.

``APPS`` is the AppSpec registry in the paper's Table 2 order (of the apps
ported).
"""
from repro_torch.apps import hotspot as _hotspot
from repro_torch.apps import qsim as _qsim
from repro_torch.apps import srad as _srad
from repro_torch.apps.common import AppResult, AppSpec, charge_snapshot  # noqa: F401
from repro_torch.apps.hotspot import run_hotspot  # noqa: F401
from repro_torch.apps.qsim import run_qsim  # noqa: F401
from repro_torch.apps.srad import run_srad  # noqa: F401

APPS = {spec.name: spec for spec in (_qsim.SPEC, _hotspot.SPEC, _srad.SPEC)}

