"""Plain PyTorch version: apply a 4x4 unitary to qubits (q1, q2) of a
statevector."""
from __future__ import annotations

import torch


def apply_two_qubit_gate_ref(state: torch.Tensor, gate: torch.Tensor,
                             q1: int, q2: int, n_qubits: int) -> torch.Tensor:
    """state: (2**n,) complex64; gate: (4,4) complex64; q1 != q2. Qubit q is
    bit q of the flat index and gate row r = 2*bit(q1) + bit(q2). Returns a
    new state.

    The statevector is viewed as (A, 2, B, 2, C) with the two size-2 axes the
    bits of max(q1, q2) and min(q1, q2); five axes work at any n, where a
    (2,)*n reshape would pass the dimension limits of some kernels."""
    assert q1 != q2
    lo, hi = min(q1, q2), max(q1, q2)
    psi = state.reshape(1 << (n_qubits - 1 - hi), 2, 1 << (hi - lo - 1), 2,
                        1 << lo)
    # g[i1, i2, j1, j2] = gate[2*i1 + i2, 2*j1 + j2]; index 1 is qubit q1
    g = gate.to(state.device, state.dtype).reshape(2, 2, 2, 2)
    spec = "ijkl,akblc->aibjc" if q1 == hi else "jilk,akblc->aibjc"
    return torch.einsum(spec, g, psi).reshape(-1)
