"""The port's UM-backed trainer (repro_torch.train.UMTrainer) against the
JAX package's: the same launches, phases and hints give the same modeled
clock, profiler report and events bit for bit under every backend; the
losses (torch here, numpy there) agree to 1e-6 and are bit-identical across
backends and ratios within the port. Then the checkpoint, drain, elastic
resize and cluster tests of tests/test_umtrain.py on the port."""
import tempfile

import numpy as np
import pytest
import torch

from repro.train import UMTrainer as JaxUMTrainer
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import Actor, UnifiedMemory, make_policy
from repro_torch.train import (UMTrainer, capacity_for, device_demand_bytes,
                               get_train_model, state_bytes)

KB = 1024
TINY = get_train_model("train_tiny")
LOSS_RTOL = 1e-6
BACKENDS = [("system", None), ("managed", None), ("explicit", None),
            ("mi300a_unified", "mi300a"), ("cluster_system", "gh200_x2"),
            ("cluster_striped", "gh200_x2")]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _total(um, field):
    return um.prof.report()["traffic_total"][field]


def _run(policy, hw=None, ratio=1.0, steps=3, **kw):
    tr = UMTrainer(TINY, policy=policy, hw=hw, ratio=ratio,
                   page_size=4 * KB, device="cpu", **kw)
    return tr, tr.run(steps)


@pytest.fixture(scope="module")
def ref_losses():
    tr, out = _run("system", ratio=1.0)
    tr.close()
    return out["losses"]


@pytest.mark.parametrize("policy,hw", BACKENDS, ids=[b[0] for b in BACKENDS])
@pytest.mark.parametrize("ratio", [1.0, 1.5])
def test_charges_equal_jax_and_losses_match(policy, hw, ratio, ref_losses):
    jtr = JaxUMTrainer(TINY, policy=policy, hw=hw, ratio=ratio,
                       page_size=4 * KB)
    jout = jtr.run(3)
    tr, out = _run(policy, hw, ratio)
    assert tr.um.clock == jtr.um.clock
    assert tr.um.prof.report() == jtr.um.prof.report()
    assert out["events"] == jout["events"]
    assert [h["dt"] for h in out["history"]] == [h["dt"] for h in jout["history"]]
    for k in ("modeled_s", "capacity", "peak_bytes", "demand_bytes",
              "eff_ratio"):
        assert out[k] == jout[k], k
    np.testing.assert_allclose(out["losses"], jout["losses"], rtol=LOSS_RTOL)
    assert out["losses"] == ref_losses, f"{policy} x{ratio}: losses diverged"
    jtr.close()
    tr.close()
    assert (tr.um.host_bytes(), tr.um.device_bytes()) == (0, 0)


def test_umtrainer_clock_is_modeled():
    tr, out = _run("system")
    assert tr.now() == tr.um.clock
    assert out["modeled_s"] == pytest.approx(sum(h["dt"] for h in out["history"]))
    assert 0.0 < out["modeled_s"] < 1.0
    tr.close()


def test_oversubscription_costs_time_not_loss():
    tr1, out1 = _run("managed", ratio=1.0)
    tr2, out2 = _run("managed", ratio=1.5)
    assert out2["losses"] == out1["losses"]
    assert out2["modeled_s"] > out1["modeled_s"]
    assert _total(tr2.um, "migrated_out") > _total(tr1.um, "migrated_out")
    tr1.close()
    tr2.close()


def test_capacity_floors_and_eff_ratio():
    demand = device_demand_bytes(TINY)
    sysp = make_policy("system", page_size=4 * KB)
    assert capacity_for(TINY, sysp, 1.0) >= demand
    assert capacity_for(TINY, sysp, 2.0) < demand
    mi = make_policy("mi300a_unified", page_size=4 * KB)
    assert capacity_for(TINY, mi, 4.0) == state_bytes(TINY)
    tr, out = _run("mi300a_unified", hw="mi300a", ratio=1.5)
    tr.close()
    assert out["eff_ratio"] < 1.0 and out["capacity"] == state_bytes(TINY)


def test_checkpoint_save_is_pure_pressure_event():
    with tempfile.TemporaryDirectory() as tmp:
        tr_a, out_a = _run("managed", ratio=1.5, steps=4)
        cm = CheckpointManager(tmp, async_save=False)
        tr_b = UMTrainer(TINY, policy="managed", ratio=1.5, page_size=4 * KB,
                         device="cpu")
        out_b = tr_b.run(4, ckpt=cm, ckpt_every=2)
        assert out_b["losses"] == out_a["losses"]
        dts_a = [h["dt"] for h in out_a["history"]]
        dts_b = [h["dt"] for h in out_b["history"]]
        assert dts_b[:2] == dts_a[:2]
        np.testing.assert_allclose(dts_b, dts_a, rtol=1e-12, atol=0.0)
        assert tr_b.um.clock > tr_a.um.clock
        assert _total(tr_b.um, "link_d2h") > _total(tr_a.um, "link_d2h")
        assert [e["kind"] for e in out_b["events"]] == ["checkpoint"] * 2
        tr_a.close()
        tr_b.close()
        assert (tr_b.um.host_bytes(), tr_b.um.device_bytes()) == (0, 0)


def test_checkpoint_restore_roundtrip_across_packages():
    """restore + continue reproduces the uninterrupted run bit for bit, from
    the port's checkpoint; the JAX trainer restores the same checkpoint and
    continues to the same losses at tolerance."""
    with tempfile.TemporaryDirectory() as tmp:
        tr_full, out_full = _run("system", ratio=1.5, steps=4)
        tr_full.close()
        cm = CheckpointManager(tmp, async_save=False)
        tr_head, _ = _run("system", ratio=1.5, steps=2)
        tr_head.save_checkpoint(cm)
        tr_head.close()
        tr_tail = UMTrainer(TINY, policy="system", ratio=1.5, page_size=4 * KB,
                            device="cpu")
        assert tr_tail.restore_checkpoint(cm) == 2
        out_tail = tr_tail.run(2)
        assert out_tail["losses"] == out_full["losses"][2:]
        tr_tail.close()

        from repro.checkpoint import CheckpointManager as JaxCheckpointManager
        jtr = JaxUMTrainer(TINY, policy="system", ratio=1.5, page_size=4 * KB)
        assert jtr.restore_checkpoint(JaxCheckpointManager(tmp)) == 2
        np.testing.assert_allclose(jtr.run(2)["losses"], out_full["losses"][2:],
                                   rtol=LOSS_RTOL)
        jtr.close()


def test_drain_dirty_moves_no_pages():
    um = UnifiedMemory()
    a = um.alloc("d", 64 * KB, make_policy("system", page_size=4 * KB))
    um.kernel(writes=[(a, 0, 64 * KB)], actor=Actor.GPU, name="w")
    um.sync()
    res = (um.host_bytes(), um.device_bytes())
    clock = um.clock
    moved = um.drain_dirty([(a, 0, 64 * KB)])
    assert moved > 0 and um.clock > clock
    assert (um.host_bytes(), um.device_bytes()) == res
    assert um.drain_dirty([(a, 0, 64 * KB)]) == moved
    um.free(a)


def test_elastic_resize_is_pressure_not_math():
    tr_a, out_a = _run("managed", ratio=1.0, steps=6)
    shrunk = capacity_for(TINY, make_policy("managed", page_size=4 * KB), 2.0)
    tr_b = UMTrainer(TINY, policy="managed", ratio=1.0, page_size=4 * KB,
                     device="cpu")
    out_b = tr_b.run(6, resize_at={3: shrunk})
    assert out_b["losses"] == out_a["losses"]
    assert [e["kind"] for e in out_b["events"]] == ["resize"]
    assert tr_b.um.hw.device_capacity == shrunk
    assert _total(tr_b.um, "migrated_out") > _total(tr_a.um, "migrated_out")
    assert out_b["modeled_s"] > out_a["modeled_s"]
    tr_a.close()
    tr_b.close()
    assert (tr_b.um.host_bytes(), tr_b.um.device_bytes()) == (0, 0)


def test_elastic_resize_grow_restores_speed():
    tr_a, out_a = _run("system", ratio=1.0, steps=6)
    pol = make_policy("system", page_size=4 * KB)
    small, big = capacity_for(TINY, pol, 2.0), capacity_for(TINY, pol, 1.0)
    tr_b = UMTrainer(TINY, policy="system", ratio=1.0, page_size=4 * KB,
                     device="cpu")
    out_b = tr_b.run(6, resize_at={2: small, 4: big})
    assert out_b["losses"] == out_a["losses"]
    assert [(e["kind"], e["capacity"]) for e in out_b["events"]] \
        == [("resize", small), ("resize", big)]
    tr_a.close()
    tr_b.close()


def test_cluster_training_spreads_layers():
    from repro_torch.cluster import device_used_on
    tr = UMTrainer(TINY, policy="cluster_system", hw="gh200_x2", ratio=1.0,
                   page_size=4 * KB, device="cpu")
    tr.run(2)
    used = [device_used_on(tr.um, k) for k in range(tr.um.hw.nodes)]
    assert all(u > 0 for u in used), used
    tr.close()


def test_umtrainer_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        UMTrainer(TINY)
