"""The port's model stack against the JAX package's on reduced configs: the
same weights (JAX's init_params, carried over by load_jax_params) and inputs
give the same forward, prefill and decode logits."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import list_archs as jax_list_archs
from repro.models import RunPolicy as JaxRunPolicy
from repro.models import decode_step as jax_decode_step
from repro.models import forward as jax_forward
from repro.models import init_params as jax_init_params
from repro.models import prefill as jax_prefill
from repro.models.cache import init_cache as jax_init_cache
from repro.models.layout import HeadLayout as JaxHeadLayout
from repro_torch.configs import get_config, list_archs
from repro_torch.models import (
    HeadLayout,
    RunPolicy,
    init_cache,
    init_params,
    load_jax_params,
    numpy_params,
)

RTOL, ATOL = 1e-4, 1e-5  # fp32 on the CPU; sums taken in another order
ARCHS = ["yi-6b", "starcoder2-7b", "chameleon-34b"]
B, S = 2, 12


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    jcfg = jax_get_config(request.param).reduced()
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(1))
    cfg = get_config(request.param).reduced()
    model = load_jax_params(cfg, jax.tree.map(np.asarray, jparams), "cpu")
    rng = np.random.default_rng(2)
    if cfg.input_kind == "embeddings":  # chameleon: (B,S,d) embeddings in
        toks = rng.standard_normal((B, S, cfg.d_model), np.float32)
    else:
        toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return jcfg, jparams, cfg, model, toks


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("blocked", [False, True], ids=["full", "blocked"])
def test_forward_matches_jax(pair, blocked):
    jcfg, jparams, cfg, model, toks = pair
    kw = dict(attn_q_block=4, attn_kv_block=4) if blocked else {}
    want, _ = jax_forward(jcfg, jparams, jnp.asarray(toks), JaxRunPolicy(**kw))
    got = model(torch.from_numpy(toks), RunPolicy(**kw))
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, S, cfg.vocab_size)
    _close(got, want)


def test_prefill_then_decode_match_jax(pair):
    jcfg, jparams, cfg, model, toks = pair
    want, jcaches = jax_prefill(jcfg, jparams, jnp.asarray(toks), JaxRunPolicy())
    got, caches = model.prefill(torch.from_numpy(toks))
    _close(got, want)
    for c, jc in zip(caches, jcaches):
        _close(c["k"], jc["k"])
        _close(c["v"], jc["v"])
    # decode S tokens one by one into dense caches of S + 2 positions
    jcache = jax_init_cache(jcfg, B, S + 2, dtype=jnp.float32)
    cache = init_cache(cfg, B, S + 2, dtype=torch.float32, device="cpu")
    for i in range(S):
        tok = toks[:, i:i + 1]
        pos = np.full((B,), i, np.int32)
        want, jcache = jax_decode_step(jcfg, jparams, jnp.asarray(tok),
                                       jnp.asarray(pos), jcache, JaxRunPolicy())
        got, cache = model.decode_step(torch.from_numpy(tok),
                                       torch.from_numpy(pos), cache)
        _close(got, want)
    # the last decode step reads what prefill computed for that position
    _close(got[:, 0], model.prefill(torch.from_numpy(toks))[0][:, 0])


@pytest.mark.parametrize("tp", [1, 3, 16])
@pytest.mark.parametrize("n_q,n_kv", [(32, 4), (40, 8), (24, 24), (16, 1)])
def test_head_layout_expansion_matches_jax(n_q, n_kv, tp):
    lay, jlay = HeadLayout.make(n_q, n_kv, tp), JaxHeadLayout.make(n_q, n_kv, tp)
    assert dataclasses.asdict(lay) == dataclasses.asdict(jlay)
    rng = np.random.default_rng(tp)
    wq = rng.standard_normal((8, n_q, 4), np.float32)
    wk = rng.standard_normal((8, n_kv, 4), np.float32)
    wo = rng.standard_normal((n_q, 4, 8), np.float32)
    t = torch.from_numpy
    np.testing.assert_array_equal(lay.expand_q(t(wq), 1).numpy(),
                                  np.asarray(jlay.expand_q(jnp.asarray(wq), 1)))
    np.testing.assert_array_equal(lay.expand_q(t(wo), 0).numpy(),
                                  np.asarray(jlay.expand_q(jnp.asarray(wo), 0)))
    np.testing.assert_array_equal(lay.expand_kv(t(wk), 1).numpy(),
                                  np.asarray(jlay.expand_kv(jnp.asarray(wk), 1)))
    if not lay.pad:
        g = rng.standard_normal((8, lay.n_kv_eff, 4), np.float32)
        np.testing.assert_allclose(
            lay.reduce_kv_grad(t(g), 1).numpy(),
            np.asarray(jlay.reduce_kv_grad(jnp.asarray(g), 1)), rtol=1e-6)


def test_configs_match_jax():
    """The port's ArchConfig is a superset of the JAX package's: the fields
    they share are equal for every registered architecture (and its
    reduced config), and the port-only fields (YaRN's) stay at their
    defaults, so no registered architecture runs otherwise."""
    assert list_archs() == jax_list_archs()
    ours = {f.name: f for f in dataclasses.fields(get_config("yi-6b"))}
    jax_fields = {f.name for f in dataclasses.fields(jax_get_config("yi-6b"))}
    assert jax_fields <= set(ours)
    port_only = {k: f.default for k, f in ours.items() if k not in jax_fields}
    assert port_only and all(k.startswith("yarn_") for k in port_only)
    for arch in list_archs():
        for cfg, jcfg in ((get_config(arch), jax_get_config(arch)),
                          (get_config(arch).reduced(),
                           jax_get_config(arch).reduced())):
            got, want = dataclasses.asdict(cfg), dataclasses.asdict(jcfg)
            assert {k: got[k] for k in want} == want
            assert {k: got[k] for k in port_only} == port_only
            assert cfg.param_count() == jcfg.param_count()
            assert cfg.layer_kinds() == jcfg.layer_kinds()


@pytest.mark.parametrize("arch", list_archs())
@pytest.mark.parametrize("tp", [1, 3])
def test_numpy_params_has_the_jax_tree_structure(arch, tp):
    jcfg = jax_get_config(arch).reduced()
    cfg = get_config(arch).reduced()
    shapes = jax.eval_shape(lambda: jax_init_params(
        jcfg, jax.random.PRNGKey(0), tp=tp))
    want = jax.tree.map(lambda a: tuple(a.shape), shapes)
    assert jax.tree.map(lambda a: a.shape, numpy_params(cfg, 0, tp=tp)) == want
    model = init_params(cfg, seed=0, tp=tp, device="cpu")
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == {
        jax.tree_util.keystr(p, simple=True, separator="."): s
        for p, s in jax.tree_util.tree_flatten_with_path(
            want, is_leaf=lambda x: isinstance(x, tuple))[0]}


def test_load_rejects_a_tree_of_another_arch():
    tree = numpy_params(get_config("yi-6b").reduced(), 0)
    with pytest.raises(ValueError, match="does not fit"):
        load_jax_params(get_config("starcoder2-7b").reduced(), tree, "cpu")


def test_mesh_options_raise_until_the_launch_slice():
    cfg = get_config("yi-6b").reduced()
    model = init_params(cfg, seed=0, device="cpu")
    toks = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="device mesh"):
        model(toks, RunPolicy(quantize_tp_collectives=True))
