"""The port's apps against the JAX apps on the CPU: each per-iteration
function on shared numpy inputs, and each runner's checksum and charges at
the "small" preset with the JAX runner's own inputs injected. The integer
apps (pathfinder, needle, bfs) match exactly."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.apps import APPS as JAX_APPS
from repro.apps import charge_snapshot as jax_charge_snapshot
from repro.apps.bfs import _bfs_levels as jax_bfs_levels
from repro.apps.bfs import _random_graph as jax_random_graph
from repro.apps.needle import _nw_rows as jax_nw_rows
from repro.apps.pathfinder import _dp_all_rows as jax_dp_all_rows
from repro.apps.qsim import _random_su4 as jax_random_su4
from repro.apps.srad import _srad_iter as jax_srad_iter
from repro.kernels.qv_gate import apply_two_qubit_gate as jax_gate
from repro.kernels.stencil5 import stencil5 as jax_stencil5
from repro_torch.apps import APP_RUNNERS, APPS, charge_snapshot, run_app
from repro_torch.apps.bfs import _bfs_levels, _random_graph
from repro_torch.apps.hotspot import COEFF, hotspot_step
from repro_torch.apps.needle import _nw_rows
from repro_torch.apps.pathfinder import _dp_all_rows
from repro_torch.apps.qsim import qv_layer
from repro_torch.apps.srad import _srad_iter
from repro_torch.kernels.qv_gate import apply_two_qubit_gate

ITER_RTOL = 1e-5     # fp32 elementwise chains, a few iterations
CHECKSUM_RTOL = 1e-5


def test_registry_matches_jax_presets():
    # all six apps, in the paper's Table 2 order
    assert list(APPS) == list(JAX_APPS)
    assert APP_RUNNERS == {name: spec.run for name, spec in APPS.items()}
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


def test_pathfinder_dp_matches_jax():
    data = np.random.default_rng(2).integers(0, 10, (300, 77), dtype=np.int32)
    want = np.asarray(jax_dp_all_rows(jnp.asarray(data)))
    got = _dp_all_rows(torch.from_numpy(data))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("penalty", [1, 3])
def test_needle_rows_match_jax(penalty):
    sim = np.random.default_rng(3).integers(-2, 3, (150, 150), dtype=np.int32)
    want = np.asarray(jax_nw_rows(jnp.asarray(sim), penalty))
    got = _nw_rows(torch.from_numpy(sim), penalty)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n_nodes,deg", [(1 << 10, 8), (3000, 3), (500, 1)])
def test_bfs_levels_and_frontiers_match_jax(n_nodes, deg):
    """The same numpy graph; the frontier sizes drive the charges, so they
    and the levels must match exactly, with the expanded frontiers too."""
    row_ptr, cols = jax_random_graph(n_nodes, deg)
    tcols = _random_graph(n_nodes, deg, torch.device("cpu"))
    np.testing.assert_array_equal(tcols.numpy(), np.asarray(cols))
    lv_j, sizes_j, fronts_j = jax_bfs_levels(row_ptr, cols, n_nodes, deg,
                                             collect_frontiers=True)
    lv_t, sizes_t, fronts_t = _bfs_levels(tcols, n_nodes, deg,
                                          collect_frontiers=True)
    assert sizes_t == sizes_j
    np.testing.assert_array_equal(lv_t.numpy(), np.asarray(lv_j))
    assert len(fronts_t) == len(fronts_j)
    for a, b in zip(fronts_t, fronts_j):
        np.testing.assert_array_equal(a, b)
    assert _bfs_levels(tcols, n_nodes, deg)[1] == sizes_j


@pytest.mark.parametrize("sparse", [False, True])
def test_bfs_runner_matches_jax(sparse):
    kw = dict(APPS["bfs"].sizes["small"], sparse_access=sparse)
    want = JAX_APPS["bfs"].run("system", **kw)
    got = run_app("bfs", "system", device="cpu", **kw)
    assert got.checksum == want.checksum
    assert got.extra["levels"] == want.extra["levels"]
    assert charge_snapshot(got) == jax_charge_snapshot(want)


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
    if name == "pathfinder":
        data = jax.random.randint(jax.random.PRNGKey(3), shape, 0, 10,
                                  jnp.int32)
        return dict(data=np.asarray(data))
    if name == "needle":
        sim = jax.random.randint(jax.random.PRNGKey(11), (kw["n"], kw["n"]),
                                 -2, 3, jnp.int32)
        return dict(sim=np.asarray(sim))
    return {}  # qiskit and bfs draw their inputs from numpy on both sides


@pytest.mark.parametrize("name", ["hotspot", "srad", "qiskit", "pathfinder",
                                  "needle", "bfs"])
def test_runner_matches_jax_runner(name):
    kw = dict(APPS[name].sizes["small"])
    want = JAX_APPS[name].run("system", **kw)
    got = APPS[name].run("system", device="cpu", **kw, **_jax_inputs(name, kw))
    if name in ("pathfinder", "needle", "bfs"):  # integer math: exact
        assert got.checksum == want.checksum
    else:
        assert got.checksum == pytest.approx(want.checksum, rel=CHECKSUM_RTOL)
    assert charge_snapshot(got) == jax_charge_snapshot(want)
    assert got.extra["compute_ms"] is None  # no device time from a CPU run
