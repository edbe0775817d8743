"""The paper's flagship scenario: Quantum Volume statevector simulation under
memory oversubscription, across all three memory-management policies
(+ the Fig. 12 prefetch rescue), with modeled Grace Hopper timings. The
statevector math runs on ``--device`` (the CUDA card by default, through
the ``qv_gate`` kernel); the printed times are the charge model's.

    PYTHONPATH=src python -m repro_torch.examples.qv_oversubscription
        [n_qubits] [--device cpu]
"""
import argparse

from repro_torch.apps import run_qsim
from repro_torch.core import OutOfDeviceMemory
from repro_torch.kernels.common import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("n_qubits", type=int, nargs="?", default=16)
    ap.add_argument("--device", default=None,
                    help="torch device of the statevector; default: the CUDA card")
    args = ap.parse_args(argv)
    n, dev = args.n_qubits, resolve_device(args.device)
    print(f"== QV simulation, {n} qubits ({8*(1<<n)/2**20:.1f} MiB statevector), "
          f"depth {max(2, n//4)} ==")
    print("\n-- in-memory --")
    for pol in ("explicit", "managed", "system"):
        r = run_qsim(pol, n_qubits=n, device=dev)
        pt = r.phase_times
        print(f"  {pol:9s} total={r.total*1e3:8.3f} ms  "
              f"init={pt.get('gpu_init',0)*1e3:7.3f}  compute={pt.get('compute',0)*1e3:7.3f}")

    print("\n-- 1.3x oversubscribed (paper's 34-qubit analogue) --")
    for pol, kw in [("explicit", {}), ("managed", {}), ("system", {}),
                    ("managed+prefetch", {"use_prefetch": True})]:
        base = pol.split("+")[0]
        try:
            r = run_qsim(base, n_qubits=n, oversub_ratio=1.3, device=dev, **kw)
            tr = r.report["traffic_total"]
            print(f"  {pol:17s} total={r.total*1e3:8.3f} ms  "
                  f"c2c={tr['link_h2d']/2**20:7.1f} MiB  "
                  f"migrated={tr['migrated_in']/2**20:7.1f} MiB")
        except OutOfDeviceMemory as e:
            print(f"  {pol:17s} OOM (cudaMalloc cannot oversubscribe): {e}")

    print("\npage-size sensitivity (system memory, §5.2):")
    for ps in (4 * 1024, 64 * 1024):
        r = run_qsim("system", n_qubits=n, page_size=ps, device=dev)
        print(f"  {ps//1024:3d} KiB pages: init={r.phase_times.get('gpu_init',0)*1e3:8.3f} ms "
              f"total={r.total*1e3:8.3f} ms")


if __name__ == "__main__":
    main()
