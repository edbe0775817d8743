"""The port's plain kernels (the CPU path of each wrapper) against the JAX
kernels in interpret mode and their jnp oracles, on shared numpy inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.qv_gate import apply_two_qubit_gate as jax_gate
from repro.kernels.qv_gate import apply_two_qubit_gate_ref as jax_gate_ref
from repro.kernels.stencil5 import stencil5 as jax_stencil5
from repro.kernels.stencil5 import stencil5_ref as jax_stencil5_ref
from repro_torch.kernels.qv_gate import apply_two_qubit_gate
from repro_torch.kernels.stencil5 import stencil5

STENCIL_ATOL = 1e-6  # fp32, same operation order as the oracle
GATE_ATOL = 1e-5     # unit-norm complex64 state, as tests/test_kernels.py


@pytest.mark.parametrize("H,W,th", [(256, 128, 64), (128, 256, 128), (512, 128, 256)])
def test_stencil5_matches_jax(H, W, th):
    g = np.random.default_rng(3).standard_normal((H, W)).astype(np.float32)
    got = stencil5(torch.from_numpy(g), 0.1).numpy()
    pallas = np.asarray(jax_stencil5(jnp.asarray(g), 0.1, tile_h=th,
                                     interpret=True))
    ref = np.asarray(jax_stencil5_ref(jnp.asarray(g), 0.1))
    np.testing.assert_allclose(got, pallas, atol=STENCIL_ATOL)
    np.testing.assert_allclose(got, ref, atol=STENCIL_ATOL)


@pytest.mark.parametrize("H,W", [(300, 7), (1, 5), (5, 1), (1, 1)])
def test_stencil5_ragged_shapes(H, W):
    g = np.random.default_rng(4).standard_normal((H, W)).astype(np.float32)
    got = stencil5(torch.from_numpy(g), 0.1).numpy()
    ref = np.asarray(jax_stencil5_ref(jnp.asarray(g), 0.1))
    assert got.shape == (H, W) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=STENCIL_ATOL)


def _state_and_gate(n, seed=2):
    rng = np.random.default_rng(seed)
    st = rng.standard_normal(2 ** n) + 1j * rng.standard_normal(2 ** n)
    st = (st / np.linalg.norm(st)).astype(np.complex64)
    u, _ = np.linalg.qr(rng.standard_normal((4, 4))
                        + 1j * rng.standard_normal((4, 4)))
    return st, u.astype(np.complex64)


@pytest.mark.parametrize("n,q1,q2", [(10, 0, 1), (12, 3, 9), (12, 11, 2), (11, 7, 6)])
def test_qv_gate_matches_jax(n, q1, q2):
    st, u = _state_and_gate(n)
    state = torch.from_numpy(st.copy())
    out = apply_two_qubit_gate(state, torch.from_numpy(u), q1, q2, n)
    assert out is state  # updated in place
    pallas = np.asarray(jax_gate(jnp.asarray(st), jnp.asarray(u), q1, q2, n,
                                 interpret=True))
    ref = np.asarray(jax_gate_ref(jnp.asarray(st), jnp.asarray(u), q1, q2, n))
    np.testing.assert_allclose(out.numpy(), pallas, atol=GATE_ATOL)
    np.testing.assert_allclose(out.numpy(), ref, atol=GATE_ATOL)
    assert abs(float(torch.linalg.vector_norm(out)) - 1.0) < GATE_ATOL
