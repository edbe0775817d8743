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
    assert dataclasses.asdict(eng.stats) == dataclasses.asdict(jeng.stats)
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
