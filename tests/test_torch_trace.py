"""The port's trace capture/replay (repro_torch.core.trace): the
round-trip identities of tests/test_trace.py and of
test_cluster.py::test_replay_single_node_trace_under_cluster_backend on the
port, and traces that cross packages: one recorded by the JAX package
replays under the port to the same charge_snapshot, and the other way."""
import numpy as np
import pytest
import torch

from repro.apps import APPS as JAX_APPS
from repro.apps import charge_snapshot as jax_charge_snapshot
from repro.core.trace import record_app as jax_record_app
from repro.core.trace import replay as jax_replay
from repro_torch.apps import APPS, charge_snapshot
from repro_torch.core.trace import _open_r, record, record_app, replay
from repro_torch.examples.trace_replay import fingerprint


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sizes(app, **kw):
    return dict(APPS[app].sizes["small"], device="cpu", **kw)


def _assert_same(got: dict, want: dict) -> None:
    for section in want:
        assert got[section] == want[section], f"{section} drifted in replay"


@pytest.mark.parametrize("app,policy", [
    ("srad", "system"),       # GPU-init regular, batched inner loop
    ("bfs", "managed"),       # CPU-init graph app, fault/migration path
])
def test_record_replay_round_trip(app, policy, tmp_path):
    path = tmp_path / f"{app}.trace"
    native = record_app(app, policy, path, **_sizes(app))
    _assert_same(fingerprint(replay(path)), charge_snapshot(native))


def test_replay_two_policy_backends(tmp_path):
    path = tmp_path / "srad.trace"
    native_sys = record_app("srad", "system", path, **_sizes("srad"))
    _assert_same(fingerprint(replay(path)), charge_snapshot(native_sys))
    native_mi = APPS["srad"].run("mi300a_unified", **_sizes("srad"))
    um = replay(path, policy="mi300a_unified")
    _assert_same(fingerprint(um), charge_snapshot(native_mi))


def test_record_gzip_round_trip(tmp_path):
    path = tmp_path / "hotspot.trace.gz"
    native = record_app("hotspot", "system", path, **_sizes("hotspot"))
    _assert_same(fingerprint(replay(path)), charge_snapshot(native))


def test_record_with_oversub_ballast(tmp_path):
    path = tmp_path / "srad_oversub.trace"
    kw = _sizes("srad", oversub_ratio=2.0, page_size=4 * 1024)
    native = record_app("srad", "managed", path, **kw)
    um = replay(path)
    _assert_same(fingerprint(um), charge_snapshot(native))
    assert "__ballast__" in um.allocs


def test_recorder_detaches_on_close(tmp_path):
    from repro_torch.core import Actor, UnifiedMemory, system_policy

    um = UnifiedMemory()
    a = um.alloc("x", 64 * 1024, system_policy(4 * 1024))
    with record(um, tmp_path / "t.trace"):
        um.kernel(writes=[(a, 0, 64 * 1024)], actor=Actor.CPU, name="w")
    assert um._trace is None
    um.kernel(reads=[(a, 0, 64 * 1024)], actor=Actor.GPU, name="r")  # silent
    um2 = replay(tmp_path / "t.trace")
    assert "r" not in um2.prof.kernel_counts
    assert um2.prof.kernel_counts["w"] == 1


def test_replay_single_node_trace_under_cluster_backend(tmp_path):
    path = tmp_path / "srad.trace"
    record_app("srad", "system", path, **_sizes("srad"))
    native = APPS["srad"].run("cluster_system", **_sizes("srad"))
    um1 = replay(path, policy="cluster_system")
    snap = charge_snapshot(native)
    rep = um1.report()
    assert snap["phase_times"] == {
        k: float(v).hex() for k, v in sorted(um1.prof.phase_times.items())}
    assert snap["traffic_total"] == {
        k: int(v) for k, v in sorted(rep["traffic_total"].items())}

    um2 = replay(path, policy="cluster_system", hw="gh200_x2")
    assert um2._recompute_residency() == (um2.host_bytes(),
                                          um2.device_bytes())
    for a in um2.allocs.values():
        if not a.freed and a.table is not None:
            _, nb = a.table.recount()
            assert np.array_equal(nb, a.table._tier_bytes)


@pytest.mark.parametrize("app,policy,suffix", [
    ("srad", "system", ".trace"),
    ("hotspot", "managed", ".trace.gz"),
    ("srad", "managed", ".trace"),
])
def test_traces_cross_packages(app, policy, suffix, tmp_path):
    """Each package's trace of an app is the other's, event for event, and
    replays under the other package to the recorder's charge_snapshot."""
    jpath, path = tmp_path / f"jax{suffix}", tmp_path / f"port{suffix}"
    jax_native = jax_record_app(app, policy, jpath,
                                **JAX_APPS[app].sizes["small"])
    native = record_app(app, policy, path, **_sizes(app))
    want = jax_charge_snapshot(jax_native)
    _assert_same(fingerprint(replay(jpath)), want)
    _assert_same(fingerprint(jax_replay(path)), charge_snapshot(native))
    _assert_same(charge_snapshot(native), want)
    _assert_same(fingerprint(replay(jpath, policy="mi300a_unified")),
                 fingerprint(jax_replay(path, policy="mi300a_unified")))
    with _open_r(jpath) as fj, _open_r(path) as fp:
        assert fj.read() == fp.read()
