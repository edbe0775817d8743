"""Quantum Volume statevector simulation (Qiskit-Aer style). Mixed, GPU-init.

The paper's flagship app: statevector of 8 * 2^n bytes; each QV layer applies
floor(n/2) random SU(4) gates to disjoint qubit pairs (kernels/qv_gate). The
in-memory cases reproduce Fig. 5/8/9 (page-size x policy); n beyond device
capacity is the natural-oversubscription case of Fig. 12/13, where explicit
chunk prefetching rescues managed memory.
"""
from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.apps.common import (
    KB,
    MB,
    AppResult,
    AppSpec,
    DeviceTimer,
    finish,
    make_um,
)
from repro_torch.core import Actor, KernelBatch
from repro_torch.kernels.common import resolve_device
from repro_torch.kernels.qv_gate import apply_two_qubit_gate


def _random_su4(rng: np.random.Generator) -> torch.Tensor:
    z = rng.normal(size=(4, 4)) + 1j * rng.normal(size=(4, 4))
    q, r = np.linalg.qr(z)
    q = q * (np.diagonal(r) / np.abs(np.diagonal(r)))
    return torch.from_numpy(q.astype(np.complex64))


def qv_layer(rng: np.random.Generator,
             n_qubits: int) -> Iterator[Tuple[int, int, torch.Tensor]]:
    """One QV layer's gates (q1, q2, gate), drawn from ``rng`` in the JAX
    app's order: a qubit permutation, then one SU(4) per disjoint pair."""
    perm = rng.permutation(n_qubits)
    for g in range(n_qubits // 2):
        yield int(perm[2 * g]), int(perm[2 * g + 1]), _random_su4(rng)


def run_qsim(policy_kind: str = "system", *, n_qubits: int = 16,
             depth: Optional[int] = None, page_size: int = 64 * KB,
             oversub_ratio: float = 0.0, use_prefetch: bool = False,
             auto_migrate: bool = True, seed: int = 0,
             hw=None, device=None) -> AppResult:
    """``device=None`` is the CUDA card. The statevector is updated in place."""
    device = resolve_device(device)
    depth = depth if depth is not None else max(2, n_qubits // 4)
    n_amps = 1 << n_qubits  # statevector amplitudes, 8 B each (complex64)
    um, pol = make_um(policy_kind, page_size=page_size, hw=hw,
                      oversub_ratio=oversub_ratio,
                      app_peak_bytes=8 * n_amps, auto_migrate=auto_migrate)

    with um.phase("alloc"):
        sv = um.array("statevector", (n_amps,), np.complex64, pol)

    # GPU-side init: the simulator zeroes the statevector on device (|0...0>)
    with um.phase("gpu_init"):
        state = torch.zeros((n_amps,), dtype=torch.complex64, device=device)
        state[0] = 1.0
        um.launch("zero_state", writes=[sv[:]], actor=Actor.GPU)
        um.sync()

    rng = np.random.default_rng(seed)
    timer = DeviceTimer(device)
    with um.phase("compute"):
        timer.start()
        for layer in range(depth):
            batch = KernelBatch()
            for q1, q2, gate in qv_layer(rng, n_qubits):
                state = apply_two_qubit_gate(state, gate, q1, q2, n_qubits)
                if use_prefetch:
                    # cudaMemPrefetchAsync chunking (Fig. 12): stream chunks
                    # device-side ahead of each partial gate sweep, so reads
                    # come from HBM instead of thrash-mode remote access
                    chunk = min(n_amps, 64 * MB // sv.itemsize)
                    for lo in range(0, n_amps, chunk):
                        band = sv[lo:lo + chunk]
                        um.prefetch(band, overlap=True)
                        um.launch(f"gate_l{layer}_{q1}_{q2}_c{lo * sv.itemsize}",
                                  reads=[band], writes=[band],
                                  flops=32.0 * band.nbytes / 16, actor=Actor.GPU)
                else:
                    # gates of one layer act on disjoint qubit pairs: defer
                    # them into one batched engine step per layer
                    batch.launch(f"gate_l{layer}_{q1}_{q2}",
                                 reads=[sv[:]], writes=[sv[:]],
                                 flops=32.0 * n_amps, actor=Actor.GPU)
            if len(batch):
                um.launch_batch(batch)
            um.sync()
        timer.stop()

    with um.phase("dealloc"):
        um.free_live()

    # |<psi|psi>| (the JAX app's |vdot|) as the squared 2-norm
    norm = float(torch.linalg.vector_norm(state)) ** 2
    return finish(um, "qsim", policy_kind, page_size, norm,
                  n_qubits=n_qubits, depth=depth, prefetch=use_prefetch,
                  device=str(device), compute_ms=timer.ms())


SPEC = AppSpec(
    name="qiskit", run=run_qsim, init_actor="gpu",
    sizes={"fig3": dict(n_qubits=16, depth=3),
           "fig11": dict(n_qubits=16, depth=2),
           "small": dict(n_qubits=12, depth=3)})
