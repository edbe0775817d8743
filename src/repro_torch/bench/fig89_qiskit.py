"""Fig. 8/9: Quantum Volume x system page size, system vs managed, with the
init/compute breakdown for the largest in-memory case. ``device=None`` is
the CUDA card."""
from repro_torch.apps import run_qsim
from repro_torch.bench.common import emit

KB = 1024


def run(device=None):
    for n in (14, 16, 18):
        for pol in ("system", "managed"):
            t = {}
            for ps in (4 * KB, 64 * KB):
                r = run_qsim(pol, n_qubits=n, depth=2, page_size=ps,
                             device=device)
                t[ps] = r.total
            emit(f"fig8/qv{n}/{pol}", t[64 * KB] * 1e6,
                 f"speedup_64k_over_4k={t[4*KB]/t[64*KB]:.2f}")
    # fig9 breakdown (largest case)
    for pol in ("system", "managed"):
        for ps in (4 * KB, 64 * KB):
            r = run_qsim(pol, n_qubits=18, depth=2, page_size=ps, device=device)
            emit(f"fig9/qv18/{pol}/page{ps//KB}K", r.total * 1e6,
                 f"init_us={r.phase_times.get('gpu_init',0)*1e6:.1f};"
                 f"compute_us={r.phase_times.get('compute',0)*1e6:.1f}")
