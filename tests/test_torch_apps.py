"""The port's apps against the JAX apps on the CPU: each per-iteration
function on shared numpy inputs, and each runner's checksum and charges at
the "small" preset with the JAX runner's own inputs injected."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.apps import APPS as JAX_APPS
from repro.apps import charge_snapshot as jax_charge_snapshot
from repro.apps.qsim import _random_su4 as jax_random_su4
from repro.apps.srad import _srad_iter as jax_srad_iter
from repro.kernels.qv_gate import apply_two_qubit_gate as jax_gate
from repro.kernels.stencil5 import stencil5 as jax_stencil5
from repro_torch.apps import APPS, charge_snapshot
from repro_torch.apps.hotspot import COEFF, hotspot_step
from repro_torch.apps.qsim import qv_layer
from repro_torch.apps.srad import _srad_iter
from repro_torch.kernels.qv_gate import apply_two_qubit_gate

ITER_RTOL = 1e-5     # fp32 elementwise chains, a few iterations
CHECKSUM_RTOL = 1e-5


def test_registry_matches_jax_presets():
    assert set(APPS) == {"hotspot", "srad", "qiskit"}
    for name, spec in APPS.items():
        assert spec.sizes == JAX_APPS[name].sizes
        assert spec.init_actor == JAX_APPS[name].init_actor


def test_hotspot_step_matches_jax():
    rng = np.random.default_rng(0)
    temp = (300.0 + 50.0 * rng.random((64, 96))).astype(np.float32)
    power = rng.random((64, 96)).astype(np.float32)
    t_jax, t_port = jnp.asarray(temp), torch.from_numpy(temp)
    for _ in range(3):
        t_jax = jax_stencil5(t_jax, COEFF, interpret=True) + 0.001 * jnp.asarray(power)
        t_port = hotspot_step(t_port, torch.from_numpy(power))
    np.testing.assert_allclose(t_port.numpy(), np.asarray(t_jax), rtol=ITER_RTOL)


def test_srad_iter_matches_jax():
    rng = np.random.default_rng(1)
    J = np.exp(rng.random((64, 64)) / 255.0).astype(np.float32)
    J_jax, J_port = jnp.asarray(J), torch.from_numpy(J)
    for _ in range(3):
        J_jax = jax_srad_iter(J_jax, 0.5, True)
        J_port = _srad_iter(J_port, 0.5)
    np.testing.assert_allclose(J_port.numpy(), np.asarray(J_jax), rtol=ITER_RTOL)


def test_qsim_circuit_matches_jax():
    n, depth = 8, 3
    st = np.zeros(2 ** n, np.complex64)
    st[0] = 1.0
    s_jax, s_port = jnp.asarray(st), torch.from_numpy(st.copy())
    rng_jax, rng_port = np.random.default_rng(5), np.random.default_rng(5)
    for _ in range(depth):
        perm = rng_jax.permutation(n)
        for g in range(n // 2):
            q1, q2 = int(perm[2 * g]), int(perm[2 * g + 1])
            s_jax = jax_gate(s_jax, jax_random_su4(rng_jax), q1, q2, n,
                             interpret=True)
        for q1, q2, gate in qv_layer(rng_port, n):
            s_port = apply_two_qubit_gate(s_port, gate, q1, q2, n)
    np.testing.assert_allclose(s_port.numpy(), np.asarray(s_jax), atol=1e-5)


def _jax_inputs(name, kw):
    """The JAX runner's own input draws, as numpy, for injection."""
    shape = (kw["rows"], kw["cols"]) if "rows" in kw else None
    if name == "hotspot":
        temp = 300.0 + 50.0 * jax.random.uniform(jax.random.PRNGKey(0), shape,
                                                 jnp.float32)
        power = jax.random.uniform(jax.random.PRNGKey(1), shape, jnp.float32)
        return dict(temp0=np.asarray(temp), power=np.asarray(power))
    if name == "srad":
        img = jax.random.uniform(jax.random.PRNGKey(7), shape, jnp.float32)
        return dict(img=np.asarray(img))
    return {}  # qiskit draws its circuit from numpy on both sides


@pytest.mark.parametrize("name", ["hotspot", "srad", "qiskit"])
def test_runner_matches_jax_runner(name):
    kw = dict(APPS[name].sizes["small"])
    want = JAX_APPS[name].run("system", **kw)
    got = APPS[name].run("system", device="cpu", **kw, **_jax_inputs(name, kw))
    assert got.checksum == pytest.approx(want.checksum, rel=CHECKSUM_RTOL)
    assert charge_snapshot(got) == jax_charge_snapshot(want)
    assert got.extra["compute_ms"] is None  # no device time from a CPU run
