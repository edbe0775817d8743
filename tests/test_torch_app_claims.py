"""The paper's claims of tests/test_apps.py, held on the port: all six apps
run under the three memory-management versions through one code path, and
the modeled Grace Hopper shows the paper's Fig. 3 classes, Fig. 6, Fig. 10,
Fig. 11 and Fig. 12/13 behaviour. The apps run their plain versions on the
CPU; the charges do not depend on the device. Sizes come from each
AppSpec's "small" preset."""
import jax  # noqa: F401  (each port test file runs beside JAX)
import pytest

from repro_torch.apps import APPS, run_app, run_hotspot, run_qsim, run_srad

SMALL = {name: dict(spec.sizes["small"]) for name, spec in APPS.items()}
CPU = dict(device="cpu")


@pytest.mark.parametrize("app", sorted(APPS))
@pytest.mark.parametrize("policy", ["explicit", "managed", "system"])
def test_app_runs_all_policies(app, policy):
    r = run_app(app, policy, preset="small", **CPU)
    assert r.total > 0
    # same math regardless of memory policy
    assert r.checksum == run_app(app, "explicit", preset="small",
                                 **CPU).checksum


@pytest.mark.parametrize(
    "app", [n for n, s in APPS.items() if s.init_actor == "cpu"])
def test_cpu_init_apps_prefer_system_memory(app):
    """Paper Fig. 3 class 1: system >= managed for CPU-initialized apps."""
    t = {p: run_app(app, p, preset="small", **CPU).time_excluding_cpu_init()
         for p in ("managed", "system")}
    assert t["system"] < t["managed"]


def test_gpu_init_apps_prefer_managed_memory():
    """Paper Fig. 3 class 2 / §5.1.2: GPU-side init (srad) favors managed."""
    kw = dict(SMALL["srad"], iters=2, **CPU)  # init-dominated regime
    t = {p: run_srad(p, **kw).time_excluding_cpu_init()
         for p in ("managed", "system")}
    assert t["managed"] < t["system"]


def test_srad_migration_warmup_crossover():
    """Paper Fig. 10: system-memory iteration time decreases as access-counter
    migrations move the working set to HBM; late iterations beat managed."""
    kw = dict(rows=512, cols=512, iters=12, **CPU)
    rs = run_srad("system", **kw)
    rm = run_srad("managed", **kw)
    per_s = [d["seconds"] for d in rs.extra["per_iter"]]
    per_m = [d["seconds"] for d in rm.extra["per_iter"]]
    assert per_s[0] > per_s[-1]  # warm-up
    assert per_s[-1] <= per_m[0]  # late system beats managed's fault iteration
    # remote traffic decays to ~zero once the working set is resident
    h2d = [d["link_h2d"] for d in rs.extra["per_iter"]]
    assert h2d[-1] < h2d[1] / 10 or h2d[-1] == 0


def test_oversubscription_system_graceful_managed_thrashes():
    """Paper Fig. 11: at >1x oversubscription system memory degrades
    gracefully while managed pays eviction+migration storms."""
    kw = dict(rows=512, cols=512, iters=4, **CPU)
    speedups = {}
    for ratio in (1.5, 3.0):
        ts = run_hotspot("system", oversub_ratio=ratio,
                         **kw).time_excluding_cpu_init()
        tm = run_hotspot("managed", oversub_ratio=ratio,
                         **kw).time_excluding_cpu_init()
        speedups[ratio] = tm / ts
    assert speedups[1.5] > 1.0
    assert speedups[3.0] >= speedups[1.5] * 0.9  # non-collapsing with pressure


def test_qiskit_prefetch_rescues_managed_oversubscription():
    """Paper Fig. 12/13: explicit prefetch restores managed-memory throughput
    under (simulated) oversubscription."""
    kw = dict(n_qubits=14, depth=2, oversub_ratio=1.3, **CPU)
    slow = run_qsim("managed", **kw).phase_times["compute"]
    fast = run_qsim("managed", use_prefetch=True, **kw).phase_times["compute"]
    assert fast < slow


def test_page_size_alloc_dealloc():
    """Paper Fig. 6: 64KB pages cut alloc+dealloc cost vs 4KB by >4.6x."""
    KB = 1024
    t = {}
    for ps in (4 * KB, 64 * KB):
        r = run_hotspot("system", page_size=ps, **SMALL["hotspot"], **CPU)
        t[ps] = r.phase_times["alloc"] + r.phase_times["dealloc"]
    assert t[4 * KB] / t[64 * KB] > 4.6
