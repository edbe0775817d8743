"""Fig. 12/13: explicit prefetch rescues managed memory under
oversubscription (the paper's 34-qubit natural-oversubscription case).
``device=None`` is the CUDA card."""
from repro_torch.apps import run_qsim
from repro_torch.bench.common import emit

KB = 1024


def run(device=None):
    for ps in (4 * KB, 64 * KB):
        base = run_qsim("managed", n_qubits=16, depth=2, oversub_ratio=1.3,
                        page_size=ps, device=device)
        pf = run_qsim("managed", n_qubits=16, depth=2, oversub_ratio=1.3,
                      page_size=ps, use_prefetch=True, device=device)
        emit(f"fig12/qv16/managed/page{ps//KB}K", base.phase_times["compute"] * 1e6,
             f"prefetch_speedup={base.phase_times['compute']/pf.phase_times['compute']:.2f}")
    # fig13: init/compute breakdown at small vs big page under oversub
    for n, ratio in ((14, 1.0), (16, 1.3)):
        for ps in (4 * KB, 64 * KB):
            r = run_qsim("managed", n_qubits=n, depth=2,
                         oversub_ratio=ratio, page_size=ps, device=device)
            emit(f"fig13/qv{n}/managed/page{ps//KB}K", r.total * 1e6,
                 f"init_us={r.phase_times.get('gpu_init',0)*1e6:.1f};"
                 f"compute_us={r.phase_times['compute']*1e6:.1f}")
