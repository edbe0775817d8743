"""Fig. 11: system-vs-managed speedup at increasing memory oversubscription.

Sizes come from each app's AppSpec "fig11" preset — the configurations the
parity fixture pins bit for bit. ``device=None`` is the CUDA card."""
from repro_torch.apps import APPS
from repro_torch.bench.common import emit

KB = 1024


def run(device=None):
    for app, spec in APPS.items():
        kw = dict(spec.sizes["fig11"], page_size=4 * KB, device=device)
        for ratio in (1.2, 1.5, 2.0, 3.0):
            ts = spec.run("system", oversub_ratio=ratio,
                          **kw).time_excluding_cpu_init()
            tm = spec.run("managed", oversub_ratio=ratio,
                          **kw).time_excluding_cpu_init()
            emit(f"fig11/{app}/oversub{ratio}", ts * 1e6,
                 f"system_over_managed_speedup={tm/ts:.2f}")
