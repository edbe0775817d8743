"""The port's ServeEngine against the JAX package's on reduced yi-6b, and on
the reduced MoE archs (olmoe-1b-7b, granite-moe-3b-a800m): the same weights
and schedules give the same tokens, the same EngineStats and, under the same
hardware model, bit-identical unified-memory traffic and clock."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import TPU_V5E as JAX_TPU_V5E
from repro.core import UnifiedMemory as JaxUnifiedMemory
from repro.models import init_params as jax_init_params
from repro.models.cache import kv_head_layout as jax_kv_head_layout
from repro.serve import PagedKVCache as JaxPagedKVCache
from repro.serve import ServeEngine as JaxServeEngine
from repro.serve import collect as jax_collect
from repro.serve import summarize as jax_summarize
from repro_torch.configs import get_config
from repro_torch.core import TPU_V5E, UnifiedMemory
from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.models import init_cache, load_jax_params
from repro_torch.models.cache import kv_head_layout
from repro_torch.serve import PagedKVCache, ServeEngine, collect, summarize


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The models here are tiny: one intra-op thread per process keeps
    parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(arch):
    jcfg = jax_get_config(arch).reduced()
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    cfg = get_config(arch).reduced()
    model = load_jax_params(cfg, jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, jparams, cfg, model


@pytest.fixture(scope="module")
def yi():
    return _pair("yi-6b")


@pytest.fixture(scope="module", params=["olmoe-1b-7b", "granite-moe-3b-a800m"])
def moe_pair(request):
    return _pair(request.param)


def _oversub_um(make_um, hw, cfg, layout_fn, page_bytes_fn, kw):
    """As examples/serve_batched.py: a modeled device that holds 1/1.5 of
    the KV pool."""
    page_bytes = page_bytes_fn(cfg, layout_fn(cfg, 1), kw["page_size"])
    return make_um(hw=dataclasses.replace(
        hw, device_capacity=int(kw["num_pages"] * page_bytes / 1.5)))


def _prompts(name, vocab):
    if name == "oversubscribed":
        rng = np.random.default_rng(0)
        return [rng.integers(2, vocab, int(rng.integers(8, 40)))
                for _ in range(6)], 16
    if name == "preempting":
        rng = np.random.default_rng(0)
        return [rng.integers(2, vocab, int(rng.integers(10, 30)))
                for _ in range(5)], 10
    return {
        "dense_schedule": ([np.arange(5, 15), np.arange(20, 52),
                            np.arange(7, 19)], 6),
        "page_reuse": ([np.arange(2, 20)], 4),
        "umem_pool": ([np.arange(2, 34)], 8),
    }[name]


# (engine kwargs, umem: None | "default" | "oversub") of tests/test_serve.py's
# three schedules, examples/serve_batched.py's oversubscribed one, and
# tests/test_serve_oversub.py's preempting one (10 pages of 8 tokens for
# five sequences) with the admission gate off and a device of 1/1.5 pool
SCHEDULES = {
    "dense_schedule": (dict(max_seqs=4, max_len=96, page_size=16), None),
    "page_reuse": (dict(max_seqs=2, max_len=64, page_size=16), None),
    "umem_pool": (dict(max_seqs=2, max_len=64, page_size=16), "default"),
    "oversubscribed": (dict(max_seqs=4, max_len=128, page_size=16,
                            num_pages=10, prefill_chunk=32), "oversub"),
    "preempting": (dict(max_seqs=5, max_len=96, page_size=8, num_pages=10,
                        admit_device_fraction=0.0), "oversub"),
}


def _run(engine_cls, cfg, params, kw, um, prompts, n_new, **extra):
    eng = engine_cls(cfg, params, um=um, **kw, **extra)
    rids = [eng.add_request(p, max_new_tokens=n_new) for p in prompts]
    out = eng.run_to_completion()
    return eng, [out[r] for r in rids]


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_engine_matches_jax_engine(yi, name):
    _check_engine_matches_jax_engine(yi, name)


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_moe_engine_matches_jax_engine(moe_pair, name):
    """The MoE blocks route each prefill chunk's and decode batch's tokens
    as the JAX engine's do, so tokens, stats and charges all agree."""
    _check_engine_matches_jax_engine(moe_pair, name)


def _check_engine_matches_jax_engine(pair, name):
    jcfg, jparams, cfg, model = pair
    kw, umem = SCHEDULES[name]
    prompts, n_new = _prompts(name, cfg.vocab_size)
    if umem == "default":
        jum, um = JaxUnifiedMemory(), UnifiedMemory()
    elif umem == "oversub":
        jum = _oversub_um(JaxUnifiedMemory, JAX_TPU_V5E, jcfg,
                          jax_kv_head_layout, JaxPagedKVCache.page_bytes_for,
                          kw)
        um = _oversub_um(UnifiedMemory, TPU_V5E, cfg, kv_head_layout,
                         PagedKVCache.page_bytes_for, kw)
    else:
        jum = um = None
    jeng, jtoks = _run(JaxServeEngine, jcfg, jparams, kw, jum, prompts, n_new)
    launches = paged_attention.launches
    eng, toks = _run(ServeEngine, cfg, model, kw, um, prompts, n_new,
                     device="cpu")
    assert paged_attention.launches == launches  # CPU tensors: plain version
    assert toks == jtoks
    assert all(len(t) == n_new for t in toks)
    assert eng.stats.modeled() == dataclasses.asdict(jeng.stats)
    # the CPU runs every decode pass eagerly
    assert (eng.stats.decode_graph_captures, eng.stats.decode_graph_replays
            ) == (0, 0)
    # no window layers: no window pool, its counters untouched
    assert eng.wcache is None and eng.pools == [eng.cache]
    assert (eng.stats.window_pages_released, eng.stats.window_pages_held,
            eng.stats.window_pages_all_keys, eng.stats.window_seq_pages_max
            ) == (0, 0, 0, 0)
    # the SLO report reads the modeled timestamps (um.clock or step index)
    assert summarize(collect(eng)) == jax_summarize(jax_collect(jeng))
    if um is not None:
        assert um.report()["traffic_total"] == jum.report()["traffic_total"]
        assert um.clock == jum.clock
        eng.cache.close()  # the pool's residency goes back to zero
        assert (um.host_bytes(), um.device_bytes()) == (0, 0)
    if umem == "oversub":  # part of the pool is read remotely
        assert um.report()["traffic_total"]["remote_h2d"] > 0
    if name == "preempting":
        assert eng.stats.preempted > 0 and eng.stats.resumed > 0


def test_page_reuse_after_release(yi):
    *_, cfg, model = yi
    eng = ServeEngine(cfg, model, max_seqs=2, max_len=64, page_size=16,
                      device="cpu")
    free0 = eng.cache.free_pages()
    eng.add_request(np.arange(2, 20), max_new_tokens=4)
    eng.add_request(np.arange(30, 70), max_new_tokens=4)
    eng.run_to_completion()
    assert eng.cache.free_pages() == free0  # all pages returned
    assert not eng.cache.active.any() and not eng.cache.page_table.any()


def _dense_generate(model, cfg, prompt, n_new, max_len):
    cache = init_cache(cfg, 1, max_len, dtype=torch.float32, device="cpu")
    toks = list(prompt)
    gen = []
    for i in range(len(prompt) + n_new - 1):
        t = toks[i] if i < len(prompt) else gen[-1]
        lg, cache = model.decode_step(torch.tensor([[t]], dtype=torch.int32),
                                      torch.tensor([i], dtype=torch.int32),
                                      cache)
        if i >= len(prompt) - 1:
            gen.append(int(torch.argmax(lg[0, 0])))
    return gen


def test_paged_engine_matches_dense_decode(yi):
    *_, cfg, model = yi
    eng = ServeEngine(cfg, model, max_seqs=4, max_len=96, page_size=16,
                      prefill_chunk=8, device="cpu")
    prompts = [np.arange(5, 15), np.arange(20, 52), np.arange(7, 19)]
    rids = [eng.add_request(p, max_new_tokens=6) for p in prompts]
    out = eng.run_to_completion()
    for rid, p in zip(rids, prompts):
        assert out[rid] == _dense_generate(model, cfg, p, 6, 96)


def test_swap_out_returns_host_copies(yi):
    *_, cfg, model = yi
    cache = PagedKVCache(cfg, model.layout, max_seqs=2, max_len=64,
                         page_size=16, device="cpu")
    sid = cache.new_seq()
    k = torch.randn(20, model.layout.n_kv_eff, cfg.head_dim)
    cache.alloc_range(sid, 0, 20)
    for layer in range(cfg.num_layers):
        cache.write_at(sid, layer, k, -k, 0)
    cache.commit_prefill(sid, 20)
    saved = cache.swap_out(sid)
    assert isinstance(saved["k"][0], np.ndarray) and saved["len"] == 20
    np.testing.assert_array_equal(saved["v"][1], -k.numpy())
    sid2 = cache.swap_in(saved)
    got_k, _ = cache.gather_kv(sid2, 0, 20)
    np.testing.assert_array_equal(got_k.numpy(), k.numpy())


def test_engine_refuses_params_on_another_device(yi):
    *_, cfg, model = yi
    with pytest.raises(ValueError, match="params live on"):
        ServeEngine(cfg, model, device="meta")


def test_launcher_serves_on_the_cpu(capsys):
    from repro_torch.launch import serve as launch_serve

    launch_serve.main(["--arch", "yi-6b", "--reduced", "--device", "cpu",
                       "--requests", "3", "--max-new", "5", "--umem"])
    out = capsys.readouterr().out
    assert "requests=3 tokens=15" in out
    assert "umem (modeled, GRACE_HOPPER)" in out


# one request a step for five steps, each for six tokens, so the decode
# batch is 1, 2, 3, 4, 5, 4, 3, 2, 1: it changes on every step; between
# steps 2 and 3 the youngest sequence is preempted, and it resumes at
# step 3 beside that step's new request
VARYING_PROMPTS = (5, 9, 3, 12, 7)
PREEMPT_AFTER_STEP = 2


def _serve_varying(engine_cls, cfg, params, watch=None, **extra):
    eng = engine_cls(cfg, params, max_seqs=5, max_len=64, page_size=8,
                     prefill_chunk=32, **extra)
    if watch is not None:
        watch(eng)
    rids = []
    for step, n in enumerate(VARYING_PROMPTS):
        rids.append(eng.add_request(np.arange(2, 2 + n) * (step + 3)
                                    % cfg.vocab_size, max_new_tokens=6))
        eng.step()
        if step == PREEMPT_AFTER_STEP:
            eng._preempt(eng.requests[rids[-1]])
    while eng.step():
        pass
    return eng, [eng.requests[r].generated for r in rids]


@pytest.mark.parametrize("arch", ["yi-6b", "olmoe-1b-7b"])
def test_decode_inputs_follow_a_varying_batch(arch):
    """The decode pass's static inputs as the CPU engine runs them: each
    batch reads exactly its own sequences' tokens, positions, lengths,
    write slots and page rows, every row past the batch is the null page
    at length 0 (no finished or preempted sequence's rows stay), and the
    tokens and counts equal the JAX engine's."""
    jcfg, jparams, cfg, model = _pair(arch)
    seen = []

    def watch(eng):
        run_batch, run_layers = eng._decode_batch, eng._decode_layers

        def decode_batch(reqs):
            seen.append({"sids": [r.sid for r in reqs],
                         "rows": eng.cache.page_table[[r.sid for r in reqs]].copy(),
                         "pos": eng.cache.lengths[[r.sid for r in reqs]].copy(),
                         "last": [r.generated[-1] for r in reqs],
                         "decoding": sorted(
                             r.sid for r in eng.requests.values()
                             if r.state.value == "decoding")})
            return run_batch(reqs)

        def decode_layers(B):
            inp = eng._inputs
            seen[-1].update(B=B, views={k: t.clone() for k, t in
                                        inp.views(B).items()},
                            host=inp.host.clone())
            return run_layers(B)
        eng._decode_batch, eng._decode_layers = decode_batch, decode_layers

    _, jtoks = _serve_varying(JaxServeEngine, jcfg, jparams)
    eng, toks = _serve_varying(ServeEngine, cfg, model, watch, device="cpu")
    assert toks == jtoks
    assert eng.stats.preempted == eng.stats.resumed == 1
    Bs = [s["B"] for s in seen]
    assert Bs == [1, 2, 3, 4, 5, 4, 3, 2, 1]
    n, NP = eng.cache.max_seqs, eng.cache.pages_per_seq
    for s in seen:
        B, v = s["B"], s["views"]
        assert sorted(s["sids"]) == s["decoding"]  # every decoding sequence
        assert v["tokens"][:, 0].tolist() == s["last"]
        assert v["positions"][:, 0].tolist() == s["pos"].tolist()
        assert v["lengths"].tolist() == (s["pos"] + 1).tolist()
        np.testing.assert_array_equal(v["page_table"].numpy(), s["rows"])
        pages = s["rows"][np.arange(B), s["pos"] // eng.cache.page_size]
        assert (pages != 0).all()
        assert v["pages"].tolist() == pages.tolist()
        assert v["slots"].tolist() == (s["pos"] % eng.cache.page_size).tolist()
        cols = s["host"][:5 * n].view(5, n)
        assert not cols[:, B:].any() and not s["host"][5 * n:].view(
            n, NP)[B:].any()
    assert eng.stats.decode_graph_replays == eng.stats.decode_graph_captures == 0
