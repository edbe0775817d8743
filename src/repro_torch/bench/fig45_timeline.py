"""Fig. 4/5: memory-usage-over-time shapes (hotspot CPU-init, qiskit
GPU-init). ``device=None`` is the CUDA card."""
from repro_torch.apps import run_hotspot, run_qsim
from repro_torch.bench.common import emit


def run(device=None):
    # hotspot: system keeps data host-resident (flat GPU curve); managed
    # migrates at compute start (step up in GPU usage)
    for pol in ("system", "managed"):
        r = run_hotspot(pol, rows=1024, cols=1024, iters=8, device=device)
        peak_dev = r.report["peak_device_bytes"]
        peak_host = r.report["peak_host_bytes"]
        emit(f"fig4/hotspot/{pol}", r.total * 1e6,
             f"peak_dev_MB={peak_dev/2**20:.0f};peak_host_MB={peak_host/2**20:.0f}")
    for pol in ("system", "managed"):
        r = run_qsim(pol, n_qubits=16, depth=2, device=device)
        emit(f"fig5/qsim/{pol}", r.total * 1e6,
             f"init_s={r.phase_times.get('gpu_init',0):.4f};"
             f"compute_s={r.phase_times.get('compute',0):.4f}")
