from repro_torch.kernels.qv_gate.ops import apply_two_qubit_gate  # noqa: F401
from repro_torch.kernels.qv_gate.ref import apply_two_qubit_gate_ref  # noqa: F401
