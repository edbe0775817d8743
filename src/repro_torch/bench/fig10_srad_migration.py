"""Fig. 10: SRAD per-iteration time + memory traffic (access-counter
migration warm-up vs managed's first-iteration migration).
``device=None`` is the CUDA card."""
from repro_torch.apps import run_srad
from repro_torch.bench.common import emit


def run(device=None):
    rs = run_srad("system", rows=512, cols=512, iters=12, device=device)
    rm = run_srad("managed", rows=512, cols=512, iters=12, device=device)
    for r, pol in ((rs, "system"), (rm, "managed")):
        for d in r.extra["per_iter"]:
            emit(f"fig10/srad/{pol}/iter{d['iter']}", d["seconds"] * 1e6,
                 f"h2d_MB={d['link_h2d']/2**20:.1f};hbm_MB={d['device_local']/2**20:.1f}")
    s = [d["seconds"] for d in rs.extra["per_iter"]]
    m = [d["seconds"] for d in rm.extra["per_iter"]]
    cross = next((i for i in range(len(s)) if s[i] <= m[i]), -1)
    emit("fig10/srad/crossover_iter", 0.0, f"iter={cross}")
