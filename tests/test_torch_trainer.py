"""The port's training loop around the step: the fault-tolerant
``Trainer`` (restore-and-replay, bit for bit, under fixed and Poisson
failure schedules), the straggler monitor (tests/test_straggler.py and the
detection test of tests/test_fault_tolerance.py on the port), and the data
pipeline (SyntheticLM batches equal to the JAX package's; resume after
``seek``)."""
import tempfile

import numpy as np
import pytest
import torch

from repro.data import SyntheticLM as JaxSyntheticLM
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data import DataLoader, SyntheticLM
from repro_torch.models import RunPolicy, init_params
from repro_torch.runtime import FailureInjector, StragglerMonitor
from repro_torch.train import Trainer, TrainerConfig, make_train_state, make_train_step


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------ tests/test_fault_tolerance.py, ported
def _setup(tmp, ckpt_every=4, fail_at=(), injector=None):
    cfg = get_config("yi-6b").reduced()
    state = make_train_state(cfg, init_params(cfg, seed=0, device="cpu"))
    tc = TrainerConfig(grad_accum=2, total_steps=50, warmup_steps=2)
    step = make_train_step(cfg, RunPolicy(), tc)
    ds = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4)
    loader = DataLoader(ds, device="cpu")
    cm = CheckpointManager(tmp, keep_last=2)
    inj = injector or (FailureInjector.at(fail_at) if fail_at else None)
    return Trainer(cfg, state, step, loader, ckpt=cm, ckpt_every=ckpt_every,
                   injector=inj)


def test_failure_recovery_bitwise_replay():
    """A failed-and-restored run produces the same losses as an uninterrupted
    one (deterministic data pipeline + logical checkpoints)."""
    with tempfile.TemporaryDirectory() as t1, tempfile.TemporaryDirectory() as t2:
        tr_plain = _setup(t1)
        out_plain = tr_plain.run(12)
        tr_plain.loader.close()

        tr_fail = _setup(t2, fail_at=[6, 9])
        out_fail = tr_fail.run(18)
        tr_fail.loader.close()

        assert out_fail["restarts"] == 2
        plain = {h["step"]: h["loss"] for h in out_plain["history"]}
        replayed = {}
        for h in out_fail["history"]:
            if h["step"] in replayed:  # replayed step: must be bit-identical
                assert h["loss"] == replayed[h["step"]], h
            replayed[h["step"]] = h["loss"]
        for s, l in plain.items():
            assert replayed[s] == l, (s, l, replayed[s])
        assert int(tr_plain.state["step"]) == 12


def test_failure_recovery_with_poisson_injector():
    inj = FailureInjector.poisson(rate=0.25, seed=1, horizon=12)
    assert inj.fail_at_steps == {4, 5}
    with tempfile.TemporaryDirectory() as t1, tempfile.TemporaryDirectory() as t2:
        tr_plain = _setup(t1)
        out_plain = tr_plain.run(10)
        tr_plain.loader.close()

        tr_fail = _setup(t2, injector=inj)
        out_fail = tr_fail.run(10 + 8 * len(inj.fail_at_steps))
        tr_fail.loader.close()

        assert out_fail["restarts"] == len(inj.fail_at_steps)
        plain = {h["step"]: h["loss"] for h in out_plain["history"]}
        replayed = {h["step"]: h["loss"] for h in out_fail["history"]}
        for s, l in plain.items():
            assert replayed[s] == l, (s, l, replayed[s])


def test_trainer_accepts_injected_clock():
    import itertools
    ticks = itertools.count()
    loader = iter([(i, {"labels": np.zeros((1, 1))}) for i in range(3)])
    tr = Trainer(None, {}, lambda state, batch: (state, {"loss": 1.5}), loader,
                 clock=lambda: 5.0 * next(ticks))
    out = tr.run(3)
    assert [h["dt"] for h in out["history"]] == [5.0, 5.0, 5.0]


def test_trainer_default_clock_is_wall():
    import time
    assert Trainer(None, {}, None, None).clock is time.perf_counter


def test_straggler_detection_and_hints():
    mon = StragglerMonitor(window=16, k_mad=4.0)
    rng = np.random.default_rng(0)
    for i in range(16):
        for w in range(4):
            base = 0.10 + 0.001 * rng.standard_normal()
            mon.record(f"w{w}", base * (4.0 if (w == 3 and i >= 8) else 1.0))
    assert mon.stragglers() == ["w3"]
    hints = mon.rebalance_hint()
    assert hints["w3"] <= 0.5
    assert hints["w0"] > 0.9
    assert mon.deadline() > 0.1


# ------------------------------------------ tests/test_straggler.py, ported
def _feed(mon, worker, times):
    for t in times:
        mon.record(worker, t)


def test_uniform_workers_no_stragglers():
    mon = StragglerMonitor()
    rng = np.random.default_rng(0)
    for w in ("w0", "w1", "w2", "w3"):
        _feed(mon, w, 1.0 + 0.01 * rng.standard_normal(16))
    assert mon.stragglers() == []


def test_slow_worker_flagged():
    mon = StragglerMonitor()
    rng = np.random.default_rng(1)
    for w in ("w0", "w1", "w2"):
        _feed(mon, w, 1.0 + 0.01 * rng.standard_normal(16))
    _feed(mon, "slow", 1.0 + 0.01 * rng.standard_normal(12))
    _feed(mon, "slow", [3.0, 3.1, 2.9, 3.0])
    assert mon.stragglers() == ["slow"]


def test_recovered_worker_unflagged():
    mon = StragglerMonitor(window=8)
    for w in ("w0", "w1", "w2"):
        _feed(mon, w, [1.0] * 8)
    _feed(mon, "flaky", [3.0] * 4)
    assert "flaky" in mon.stragglers()
    _feed(mon, "flaky", [1.0] * 8)
    assert mon.stragglers() == []


def test_deadline_tracks_median_times_slack():
    mon = StragglerMonitor(deadline_slack=2.0)
    for w in ("w0", "w1"):
        _feed(mon, w, [1.0] * 8)
    assert mon.deadline() == pytest.approx(2.0)
    mon2 = StragglerMonitor(deadline_slack=3.0)
    _feed(mon2, "w0", [0.5] * 8)
    assert mon2.deadline() == pytest.approx(1.5)


def test_empty_monitor_is_safe():
    mon = StragglerMonitor()
    assert mon.stragglers() == []
    assert mon.deadline() == 0.0
    assert mon.rebalance_hint() == {}


def test_rebalance_hint_shrinks_only_the_slow_worker():
    mon = StragglerMonitor()
    for w in ("w0", "w1", "w2"):
        _feed(mon, w, [1.0] * 8)
    _feed(mon, "slow", [2.0] * 8)
    hints = mon.rebalance_hint()
    assert hints["w0"] == pytest.approx(1.0)
    assert hints["w1"] == pytest.approx(1.0)
    assert hints["slow"] == pytest.approx(0.5)
    mon2 = StragglerMonitor()
    for w in ("w0", "w1", "w2"):
        _feed(mon2, w, [1.0] * 8)
    _feed(mon2, "dying", [100.0] * 8)
    assert mon2.rebalance_hint()["dying"] == pytest.approx(0.25)


# ---------------------------------------------------------- data pipeline
@pytest.mark.parametrize("kw", [dict(vocab_size=1000, seq_len=64,
                                     global_batch=2, seed=3),
                                dict(vocab_size=64000, seq_len=2048,
                                     global_batch=2, seed=0),
                                dict(vocab_size=256, seq_len=16, global_batch=4,
                                     seed=1, emb_dim=8)],
                         ids=["small", "yi-6b", "embeddings"])
def test_synthetic_batches_equal_jax(kw):
    ds, jds = SyntheticLM(**kw), JaxSyntheticLM(**kw)
    for step in (0, 1, 17):
        for a, b in zip(ds.batch(step), jds.batch(step)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_data_pipeline_determinism_and_resume():
    ds = SyntheticLM(vocab_size=1000, seq_len=64, global_batch=2, seed=3)
    loader = DataLoader(ds, start_step=0, device="cpu")
    first = [next(loader) for _ in range(3)]
    loader.seek(1)
    again = [next(loader) for _ in range(2)]
    loader.close()
    assert [s for s, _ in first] == [0, 1, 2] and [s for s, _ in again] == [1, 2]
    for (_, a), (_, b) in zip(first[1:], again):
        assert a["tokens"].device.type == "cpu"
        assert torch.equal(a["tokens"], b["tokens"])
        assert torch.equal(a["labels"], b["labels"])
    np.testing.assert_array_equal(first[0][1]["labels"].numpy(), ds.batch(0)[1])
