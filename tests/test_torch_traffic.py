"""The port's traffic harness (repro_torch.serve.traffic) against the JAX
package's: the same schedules, and on the micro model with the JAX weights
injected, the same request records field for field, tokens, SLO metrics,
engine stats and modeled clock. Then the invariants of tests/test_traffic.py
on the port: same-seed determinism, leak-free soak, preemption and
oversubscription token identity, TTFT anchored at arrival, the presets."""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

import repro.serve as jax_serve
import repro_torch.serve as port_serve
from repro.configs.base import ArchConfig as JaxArchConfig
from repro.models import init_params as jax_init_params
from repro_torch.configs.base import ArchConfig
from repro_torch.core import Tier
from repro_torch.models import load_jax_params
from repro_torch.serve import (
    SCENARIOS,
    ArrivalProcess,
    LengthDist,
    RequestRecord,
    ServeEngine,
    TrafficSim,
    collect,
    get_scenario,
    policy_supports,
    summarize,
)

POLICIES = ("system", "managed", "mi300a_unified")
MICRO_KW = dict(name="micro", family="dense", source="test", num_layers=1,
                d_model=32, num_heads=2, num_kv_heads=2, head_dim=16, d_ff=64,
                vocab_size=64)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The models here are tiny: one intra-op thread per process keeps
    parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def micro_pair():
    """The micro model in both packages, with the JAX package's weights."""
    jcfg, cfg = JaxArchConfig(**MICRO_KW), ArchConfig(**MICRO_KW)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    model = load_jax_params(cfg, jax.tree.map(np.asarray, jparams), "cpu")
    return {"micro": (jcfg, jparams)}, {"micro": (cfg, model)}


@pytest.fixture(scope="module")
def micro_model(micro_pair):
    return micro_pair[1]


def _scenario(mod, name="micro", *, n=5, tenants=2, num_pages=None,
              oversub=1.0, adf=0.5, max_seqs=4, max_len=48, prefill_chunk=12,
              arrival=("poisson", dict(rate=2e5)),
              prompt=("lognormal", dict(lo=4, hi=24, mean=10.0)),
              output=("lognormal", dict(lo=1, hi=8, mean=4.0))):
    """tests/test_traffic.py's micro scenario, built from ``mod`` (the JAX
    or the port's serve package)."""
    return mod.Scenario(
        name=name,
        tenants=tuple(mod.TenantSpec(
            name=f"t{i}", arch="micro", num_requests=n,
            arrival=mod.ArrivalProcess(arrival[0], **arrival[1]),
            prompt=mod.LengthDist(prompt[0], **prompt[1]),
            output=mod.LengthDist(output[0], **output[1]))
            for i in range(tenants)),
        oversub=oversub, page_size=4, max_seqs=max_seqs, max_len=max_len,
        prefill_chunk=prefill_chunk, num_pages=num_pages,
        admit_device_fraction=adf)


def _micro_scenario(**kw):
    return _scenario(port_serve, **kw)


TIGHT = dict(name="tight", n=8, tenants=2, num_pages=8, max_seqs=3,
             arrival=("bursty", dict(rate=4e5, burst_size=8)),
             prompt=("pareto", dict(lo=8, hi=20, alpha=1.4)),
             output=("lognormal", dict(lo=4, hi=8, mean=6.0)))
OVER = dict(name="over", n=8, tenants=2, num_pages=24, oversub=1.5, adf=0.0,
            max_seqs=4, arrival=("poisson", dict(rate=4e5)),
            prompt=("lognormal", dict(lo=8, hi=32, mean=16.0, sigma=0.5)),
            output=("lognormal", dict(lo=2, hi=8, mean=5.0)))
# (scenario kwargs, seed, policy) of the runs held against the JAX sim: the
# micro schedule under every paged backend, and the preempting burst
VS_JAX = {f"micro-{p}": ({}, 3, p) for p in POLICIES}
VS_JAX["tight-system"] = (TIGHT, 2, "system")


@pytest.fixture(scope="module")
def jax_results(micro_pair):
    jmodels, _ = micro_pair
    return {key: jax_serve.TrafficSim(_scenario(jax_serve, **kw), policy=pol,
                                      seed=seed, models=jmodels).run()
            for key, (kw, seed, pol) in VS_JAX.items()}


def _same_result(got, want):
    assert got.tokens == want.tokens
    assert ([dataclasses.asdict(r) for r in got.records]
            == [dataclasses.asdict(r) for r in want.records])
    assert json.dumps(got.metrics, sort_keys=True) == \
        json.dumps(want.metrics, sort_keys=True)
    for arch, pe in want.per_engine.items():
        mine = got.per_engine[arch]
        assert mine["clock"] == pe["clock"]
        assert mine["stats"] == pe["stats"]
        assert mine["pool_bytes"] == pe["pool_bytes"]
        if pe["um_report"] is not None:
            assert (mine["um_report"]["traffic_total"]
                    == pe["um_report"]["traffic_total"])


# ---------------------------------------------------- port vs the JAX sim
@pytest.mark.parametrize("key", sorted(VS_JAX))
def test_run_matches_jax_sim(micro_model, jax_results, key):
    kw, seed, policy = VS_JAX[key]
    got = TrafficSim(_micro_scenario(**kw), policy=policy, seed=seed,
                     models=micro_model, device="cpu").run()
    _same_result(got, jax_results[key])
    assert all(r.done for r in got.records)


def test_schedule_matches_jax(micro_pair):
    """Arrival times, prompts and output lengths are drawn with numpy from
    the same seeds: the two packages build identical schedules."""
    jmodels, models = micro_pair
    for kw in ({}, TIGHT, OVER):
        mine = TrafficSim(_micro_scenario(**kw), seed=5, models=models,
                          device="cpu")._arrivals["micro"]
        theirs = jax_serve.TrafficSim(_scenario(jax_serve, **kw), seed=5,
                                      models=jmodels)._arrivals["micro"]
        assert len(mine) == len(theirs) > 0
        for a, b in zip(mine, theirs):
            assert (a.t, a.tenant, a.max_new) == (b.t, b.tenant, b.max_new)
            np.testing.assert_array_equal(a.prompt, b.prompt)


def test_presets_match_jax():
    for name in SCENARIOS:
        for scale in (0.25, 1.0):
            assert dataclasses.asdict(get_scenario(name, scale)) == \
                dataclasses.asdict(jax_serve.get_scenario(name, scale))


# ------------------------------------------------------- schedule building
def test_arrival_processes_are_seeded_and_ordered():
    t = ArrivalProcess("poisson", rate=100.0).times(
        np.random.default_rng(0), 50)
    t2 = ArrivalProcess("poisson", rate=100.0).times(
        np.random.default_rng(0), 50)
    assert np.array_equal(t, t2)
    assert len(t) == 50 and (np.diff(t) > 0).all()
    t3 = ArrivalProcess("poisson", rate=100.0).times(
        np.random.default_rng(1), 50)
    assert not np.array_equal(t, t3)

    u = ArrivalProcess("uniform", rate=10.0).times(np.random.default_rng(0), 5)
    assert np.allclose(np.diff(u), 0.1)

    b = ArrivalProcess("bursty", rate=100.0, burst_size=8).times(
        np.random.default_rng(0), 24)
    assert len(b) == 24 and (np.diff(b) >= 0).all()
    gaps = np.diff(b)
    assert np.median(gaps) < 1e-4 < gaps.max()
    assert np.array_equal(b, jax_serve.ArrivalProcess(
        "bursty", rate=100.0, burst_size=8).times(np.random.default_rng(0), 24))

    with pytest.raises(ValueError, match="unknown arrival kind"):
        ArrivalProcess("fractal").times(np.random.default_rng(0), 4)


def test_length_dists_clip_to_bounds():
    rng = np.random.default_rng(0)
    for kind in ("lognormal", "pareto"):
        s = LengthDist(kind, lo=4, hi=24, mean=10.0).sample(rng, 500)
        assert s.dtype == np.int64
        assert s.min() >= 4 and s.max() <= 24
        assert len(np.unique(s)) > 1
        assert np.array_equal(
            LengthDist(kind, lo=4, hi=24, mean=10.0).sample(
                np.random.default_rng(7), 50),
            jax_serve.LengthDist(kind, lo=4, hi=24, mean=10.0).sample(
                np.random.default_rng(7), 50))
    f = LengthDist("fixed", lo=1, hi=64, mean=7.0).sample(rng, 8)
    assert (f == 7).all()
    with pytest.raises(ValueError, match="unknown length kind"):
        LengthDist("weird").sample(rng, 4)


# ------------------------------------------------------------ determinism
@pytest.mark.parametrize("policy", POLICIES)
def test_same_seed_reproduces_tokens_and_metrics(micro_model, policy):
    sc = _micro_scenario(n=5)
    a = TrafficSim(sc, policy=policy, seed=3, models=micro_model,
                   device="cpu").run()
    b = TrafficSim(sc, policy=policy, seed=3, models=micro_model,
                   device="cpu").run()
    assert a.tokens == b.tokens
    assert json.dumps(a.metrics, sort_keys=True) == \
        json.dumps(b.metrics, sort_keys=True)
    assert a.per_engine["micro"]["clock"] == b.per_engine["micro"]["clock"]
    assert a.records == b.records


def test_different_seed_changes_the_workload(micro_model):
    sc = _micro_scenario(n=5)
    a = TrafficSim(sc, policy="system", seed=0, models=micro_model,
                   device="cpu")
    b = TrafficSim(sc, policy="system", seed=1, models=micro_model,
                   device="cpu")
    assert [x.t for x in a._arrivals["micro"]] != \
        [x.t for x in b._arrivals["micro"]]


def test_tokens_match_across_policy_backends(micro_model):
    sc = _micro_scenario(n=4)
    tokens = [TrafficSim(sc, policy=p, seed=0, models=micro_model,
                         device="cpu").run().tokens for p in POLICIES]
    assert all(t == tokens[0] for t in tokens[1:])


# ------------------------------------------------------------------- soak
@pytest.mark.parametrize("policy", POLICIES)
def test_soak_1k_requests_no_kv_page_leak(micro_model, policy):
    sc = _micro_scenario(
        name="soak", n=500, tenants=2, num_pages=12, max_seqs=3,
        arrival=("bursty", dict(rate=4e5, burst_size=8)),
        prompt=("pareto", dict(lo=6, hi=20, alpha=1.4)),
        output=("lognormal", dict(lo=2, hi=8, mean=4.0)))
    sim = TrafficSim(sc, policy=policy, seed=1, models=micro_model,
                     device="cpu")
    res = sim.run(max_steps=500_000)
    assert res.metrics["n"] == res.metrics["completed"] == 1000
    assert all(r.done for r in res.records)
    cache = sim.engines["micro"].cache
    assert cache.free_pages() == cache.num_pages - 1
    assert not cache.active.any()
    assert (cache.page_table == 0).all()
    assert sorted(cache._free) == list(range(1, cache.num_pages))
    assert res.per_engine["micro"]["stats"]["preempted"] > 0


# ------------------------------------------------ preemption / oversubscribe
@pytest.mark.parametrize("policy", POLICIES)
def test_burst_preemption_resume_bit_identity(micro_model, policy):
    tight = _micro_scenario(**TIGHT)
    roomy = dataclasses.replace(tight, num_pages=None)
    a = TrafficSim(tight, policy=policy, seed=2, models=micro_model,
                   device="cpu").run()
    b = TrafficSim(roomy, policy=policy, seed=2, models=micro_model,
                   device="cpu").run()
    assert a.per_engine["micro"]["stats"]["preempted"] > 0
    assert b.per_engine["micro"]["stats"]["preempted"] == 0
    assert a.tokens == b.tokens
    assert a.metrics["preemptions"] > 0


@pytest.mark.parametrize("policy", ("system", "managed"))
def test_oversubscribed_tokens_match_in_memory_run(micro_model, policy):
    over = _micro_scenario(**OVER)
    sim = TrafficSim(over, policy=policy, seed=0, models=micro_model,
                     device="cpu")
    a = sim.run()
    b = TrafficSim(dataclasses.replace(over, oversub=1.0), policy=policy,
                   seed=0, models=micro_model, device="cpu").run()
    assert a.tokens == b.tokens
    cap = int(sim.pool_bytes["micro"] / over.oversub)
    tbl = sim.engines["micro"].cache.alloc.table
    assert tbl.resident_bytes(Tier.DEVICE) <= cap
    rep = a.per_engine["micro"]["um_report"]
    if policy == "system":
        assert rep["traffic_total"]["remote_h2d"] > 0
        assert rep["remote_access_share"] > 0


def test_mi300a_cannot_run_oversubscribed():
    assert not policy_supports("mi300a_unified",
                               _micro_scenario(oversub=1.5))
    assert not policy_supports("explicit", _micro_scenario())
    assert all(policy_supports(p, _micro_scenario()) for p in POLICIES)


# ------------------------------------------------------------------ timing
def test_ttft_anchors_at_arrival_not_admission(micro_model):
    cfg, params = micro_model["micro"]
    eng = ServeEngine(cfg, params, max_seqs=1, max_len=32, page_size=4,
                      device="cpu")
    rng = np.random.default_rng(0)
    r0 = eng.add_request(rng.integers(2, cfg.vocab_size, 6), 4)
    r1 = eng.add_request(rng.integers(2, cfg.vocab_size, 6), 4)
    eng.run_to_completion()
    recs = {r.rid: r for r in collect(eng)}
    for r in (recs[r0], recs[r1]):
        assert (r.arrival_time <= r.admit_time <= r.first_token_time
                <= r.finish_time)
        assert r.ttft == r.first_token_time - r.arrival_time
    assert recs[r0].queue_delay == 0.0
    assert recs[r1].admit_time > recs[r1].arrival_time
    assert recs[r1].queue_delay > 0.0
    assert recs[r1].ttft > recs[r0].ttft
    assert recs[r1].ttft >= recs[r1].queue_delay


def test_explicit_arrival_time_and_clock(micro_model):
    cfg, params = micro_model["micro"]
    eng = ServeEngine(cfg, params, max_seqs=2, max_len=32, page_size=4,
                      device="cpu")
    rid = eng.add_request(np.arange(2, 8), 2, arrival_time=5.0, tenant="acme")
    assert eng.requests[rid].arrival_time == 5.0
    assert eng.requests[rid].tenant == "acme"
    assert eng.advance_to(10.0) == 10.0
    assert eng.advance_to(3.0) == 10.0
    t0 = eng.now()
    eng.step()
    assert eng.now() > t0


# ----------------------------------------------------------------- metrics
def _rec(rid, tenant, arrival, first, finish, ntok=4, preempts=0):
    return RequestRecord(rid=rid, tenant=tenant, prompt_len=6,
                         new_tokens=ntok, arrival_time=arrival,
                         admit_time=arrival + 0.5 * (first - arrival),
                         first_token_time=first, finish_time=finish,
                         preemptions=preempts)


def test_summarize_slo_report():
    recs = [_rec(0, "a", 0.0, 1.0, 4.0),
            _rec(1, "a", 1.0, 3.0, 7.0, preempts=1),
            _rec(2, "b", 0.0, 5.0, 9.0)]
    m = summarize(recs, slo_ttft=2.5)
    assert m["n"] == m["completed"] == 3
    assert m["tokens"] == 12
    assert m["preemptions"] == 1
    assert m["ttft"]["p50"] == 2.0 and m["ttft"]["max"] == 5.0
    assert m["tpot"]["p50"] == pytest.approx(4 / 3)
    assert m["goodput_tok_s"] == pytest.approx(12 / 9.0)
    assert m["slo_attainment"] == pytest.approx(2 / 3)
    assert set(m["tenants"]) == {"a", "b"}
    assert m["tenants"]["a"]["completed"] == 2
    assert m["tenants"]["b"]["ttft"]["p50"] == 5.0
    jrecs = [jax_serve.RequestRecord(**dataclasses.asdict(r)) for r in recs]
    assert m == jax_serve.summarize(jrecs, slo_ttft=2.5)
    recs.append(RequestRecord(rid=3, tenant="b", prompt_len=6, new_tokens=0,
                              arrival_time=8.0, admit_time=None,
                              first_token_time=None, finish_time=None,
                              preemptions=0))
    m2 = summarize(recs)
    assert m2["n"] == 4 and m2["completed"] == 3 and m2["tokens"] == 12


def test_summarize_empty():
    m = summarize([], slo_ttft=1.0)
    assert m["n"] == 0 and m["goodput_tok_s"] == 0.0
    assert m["slo_attainment"] == 0.0 and m["tenants"] == {}


# ----------------------------------------------------------------- presets
def test_scenario_presets_shape():
    assert set(SCENARIOS) == {"steady", "burst", "oversubscribed"}
    for name in SCENARIOS:
        sc = get_scenario(name)
        assert sc.name == name
        assert len({t.arch for t in sc.tenants}) >= 3
    ov = get_scenario("oversubscribed")
    assert ov.oversub > 1.0
    assert ov.admit_device_fraction == 0.0
    full = get_scenario("steady").tenants[0].num_requests
    assert get_scenario("steady", 0.5).tenants[0].num_requests < full
    with pytest.raises(KeyError, match="unknown scenario"):
        get_scenario("nope")


def test_steady_preset_end_to_end_real_configs():
    """The steady preset across three reduced configs (dense GQA, dense,
    MoE) with random weights, through the paged decode path."""
    sc = get_scenario("steady", scale=0.25)
    sim = TrafficSim(sc, policy="system", seed=0, device="cpu")
    res = sim.run()
    assert set(sim.engines) == {"yi-6b", "qwen2.5-32b", "olmoe-1b-7b"}
    expect = sum(t.num_requests for t in sc.tenants)
    assert res.metrics["n"] == res.metrics["completed"] == expect
    assert set(res.metrics["tenants"]) == {t.name for t in sc.tenants}
    assert all(len(v) > 0 for v in res.tokens.values())
    assert res.metrics["goodput_tok_s"] > 0
    assert res.metrics["ttft"]["p50"] > 0
    # the records do not depend on the weights' values: the JAX sim's
    # schedule gives the same records and per-engine stats
    want = jax_serve.TrafficSim(jax_serve.get_scenario("steady", scale=0.25),
                                policy="system", seed=0)
    for arch, eng in sim.engines.items():
        assert [(a.t, a.tenant, a.max_new, a.prompt.tolist())
                for a in sim._arrivals[arch]] == \
            [(a.t, a.tenant, a.max_new, a.prompt.tolist())
             for a in want._arrivals[arch]]
