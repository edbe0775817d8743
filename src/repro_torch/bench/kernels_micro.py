"""Kernel micro-benches: each of the port's four kernels once at a small
shape, as microseconds per call. On the CUDA card (``device=None``) the
kernels run and are timed with CUDA events; with ``device="cpu"`` the
wrappers run their plain versions, timed with the host clock (a CPU number,
not a device one). Rows, shapes and derived strings are those of the JAX
package's ``benchmarks/kernels_micro.py``."""
import time

import torch

from repro_torch.bench.common import emit
from repro_torch.kernels.common import resolve_device
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.kernels.qv_gate import apply_two_qubit_gate
from repro_torch.kernels.stencil5 import stencil5

REPS = 20


def _bench(device: torch.device, fn, *args, n: int = REPS, **kw) -> float:
    """Microseconds per call of ``fn`` over ``n`` calls, after one warm-up
    call (which also builds the kernels at first use)."""
    fn(*args, **kw)
    if device.type == "cuda":
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(n):
            fn(*args, **kw)
        t1.record()
        t1.synchronize()
        return t0.elapsed_time(t1) / n * 1e3
    t0 = time.perf_counter()
    for _ in range(n):
        fn(*args, **kw)
    return (time.perf_counter() - t0) / n * 1e6


def run(device=None):
    device = resolve_device(device)
    gen = torch.Generator(device).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device)

    q, k, v = randn(1, 256, 8, 64), randn(1, 256, 2, 64), randn(1, 256, 2, 64)
    emit("kernel/flash_attention_256",
         _bench(device, flash_attention, q, k, v), "B1_S256_H8_D64")
    qd, kp = randn(2, 8, 64), randn(16, 16, 2, 64)
    pt = torch.arange(8, dtype=torch.int32, device=device).reshape(2, 4)
    ln = torch.tensor([60, 33], dtype=torch.int32, device=device)
    emit("kernel/paged_attention",
         _bench(device, paged_attention, qd, kp, kp, pt, ln), "B2_NP4_PS16")
    st = torch.zeros(2 ** 14, dtype=torch.complex64, device=device)
    st[0] = 1.0
    g = torch.eye(4, dtype=torch.complex64)
    # the identity gate, in place on the card: the state stays |0...0>
    emit("kernel/qv_gate_14q",
         _bench(device, apply_two_qubit_gate, st, g, 3, 9, 14), "n14")
    emit("kernel/stencil5_512x256",
         _bench(device, stencil5, randn(512, 256), 0.1), "")
