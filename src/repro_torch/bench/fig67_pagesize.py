"""Fig. 6/7: system page size (4KB vs 64KB): alloc/dealloc and compute time.

Sizes come from the AppSpec "fig3" presets (qiskit has its own page-size
study in fig89_qiskit and is skipped here, as in the paper).
``device=None`` is the CUDA card."""
from repro_torch.apps import APPS
from repro_torch.bench.common import emit

KB = 1024


def run(device=None):
    for app, spec in APPS.items():
        if app == "qiskit":
            continue
        kw = spec.sizes["fig3"]
        res = {}
        for ps in (4 * KB, 64 * KB):
            r = spec.run("system", page_size=ps, device=device, **kw)
            res[ps] = r
            ad = r.phase_times.get("alloc", 0) + r.phase_times.get("dealloc", 0)
            emit(f"fig6/{app}/page{ps//KB}K", ad * 1e6,
                 f"compute_us={r.phase_times.get('compute',0)*1e6:.1f}")
        ad4 = res[4 * KB].phase_times["alloc"] + res[4 * KB].phase_times["dealloc"]
        ad64 = res[64 * KB].phase_times["alloc"] + res[64 * KB].phase_times["dealloc"]
        c4 = res[4 * KB].phase_times["compute"]
        c64 = res[64 * KB].phase_times["compute"]
        emit(f"fig67/{app}/ratios", 0.0,
             f"allocdealloc_4k_over_64k={ad4/ad64:.1f};compute_4k_over_64k={c4/c64:.2f}")
