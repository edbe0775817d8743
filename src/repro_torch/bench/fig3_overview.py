"""Fig. 3: relative performance of system/managed vs explicit, six apps.

Sizes come from each app's AppSpec "fig3" preset — the configurations the
parity fixture pins bit for bit.

``run(policy=..., hw=...)`` swaps the whole suite onto one registered
memory-policy backend / hardware model (``--policy``/``--hw`` of
``repro_torch.bench.run``): every app runs end-to-end under that backend and
raw times are emitted (no explicit-baseline speedup — the baseline belongs
to the paper's three-way Grace Hopper comparison, not to an arbitrary
backend). ``device=None`` runs the apps on the CUDA card.
"""
from repro_torch.apps import APPS
from repro_torch.bench.common import emit
from repro_torch.core import get_hardware


def run(policy=None, hw=None, device=None):
    hw_name = get_hardware(hw).name
    pols = ("managed", "system") if policy is None else (policy,)
    for app, spec in APPS.items():
        kw = dict(spec.sizes["fig3"], hw=hw, device=device)
        base = (spec.run("explicit", **kw).time_excluding_cpu_init()
                if policy is None else None)
        for pol in pols:
            t = spec.run(pol, **kw).time_excluding_cpu_init()
            derived = (f"speedup_vs_explicit={base / t:.3f}"
                       if base is not None else "")
            if hw is not None:  # overridden hardware must label its rows
                derived += (";" if derived else "") + f"hw={hw_name}"
            emit(f"fig3/{app}/{pol}", t * 1e6, derived)
