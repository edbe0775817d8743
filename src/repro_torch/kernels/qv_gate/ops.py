"""Two-qubit gate on a statevector: CUDA kernel (csrc/qv_gate.cu) on the
card, plain PyTorch on the CPU."""
from __future__ import annotations

import torch

from repro_torch.kernels.common import (
    check_launch,
    library,
    require_cuda_tensor,
    stream_of,
)
from repro_torch.kernels.qv_gate.ref import apply_two_qubit_gate_ref


def apply_two_qubit_gate(state: torch.Tensor, gate: torch.Tensor, q1: int,
                         q2: int, n_qubits: int) -> torch.Tensor:
    """Apply ``gate`` to qubits (q1, q2) of ``state`` IN PLACE; return it.

    state: (2**n,) complex64; gate: (4,4) complex64, read on the host. The
    update is in place on both devices, so the statevector is held once. A
    CPU state runs :func:`apply_two_qubit_gate_ref`. A CUDA state must be
    contiguous complex64; the kernel runs on the current stream, without
    synchronizing, and ``apply_two_qubit_gate.launches`` counts the launch."""
    if not (0 <= q1 < n_qubits and 0 <= q2 < n_qubits and q1 != q2):
        raise ValueError(f"bad qubit pair ({q1}, {q2}) for n={n_qubits}")
    if tuple(state.shape) != (1 << n_qubits,):
        raise ValueError(f"state must be ({1 << n_qubits},), "
                         f"got {tuple(state.shape)}")
    if tuple(gate.shape) != (4, 4):
        raise ValueError(f"gate must be (4, 4), got {tuple(gate.shape)}")
    if state.device.type == "cpu":
        return state.copy_(
            apply_two_qubit_gate_ref(state, gate, q1, q2, n_qubits))
    require_cuda_tensor(state, "state", torch.complex64, ndim=1)
    g = gate.detach().to("cpu", torch.complex64).contiguous()
    with torch.cuda.device(state.device):
        err = library().fns["qv_gate_c64"](
            state.data_ptr(), n_qubits, q1, q2, g.data_ptr(),
            stream_of(state))
    check_launch("qv_gate", err)
    apply_two_qubit_gate.launches += 1
    return state


apply_two_qubit_gate.launches = 0
