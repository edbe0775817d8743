"""The port's MoE layer (repro_torch.models.moe) against the JAX package's:
routing exactness, capacity drops, expert padding, sorted == dense, and the
reduced MoE archs' TransformerLM against the JAX model."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import get_config as jax_get_config
from repro.models import RunPolicy as JaxRunPolicy
from repro.models import decode_step as jax_decode_step
from repro.models import forward as jax_forward
from repro.models import init_params as jax_init_params
from repro.models import moe as jax_moe
from repro.models import prefill as jax_prefill
from repro.models.cache import init_cache as jax_init_cache
from repro_torch.configs import get_config
from repro_torch.models import RunPolicy, init_cache, init_params, load_jax_params
from repro_torch.models import moe
from repro_torch.models.moe import MoE

RTOL, ATOL = 1e-5, 1e-6  # fp32 on the CPU
MODEL_RTOL, MODEL_ATOL = 1e-4, 1e-5  # whole models: as tests/test_torch_models.py
ARCHS = ["olmoe-1b-7b", "granite-moe-3b-a800m"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The models here are tiny: one intra-op thread per process keeps
    parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(n_experts=8, top_k=2, arch="olmoe-1b-7b"):
    """Reduced config of ``arch`` in both packages (8 experts, top-2 unless
    stated), with the expert count and top-k replaced."""
    return tuple(dataclasses.replace(g(arch).reduced(), num_experts=n_experts,
                                     top_k=top_k)
                 for g in (jax_get_config, get_config))


def _jax_params(jcfg, tp, seed=0):
    p = jax_moe.moe_init(jcfg, jax.random.PRNGKey(seed), jnp.float32, tp=tp)
    return p, {k: torch.from_numpy(np.array(v)) for k, v in p.items()}


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape, np.float32)


def _module(cfg, p, tp):
    m = MoE(cfg, torch.float32, "cpu", tp)
    for k, v in p.items():
        getattr(m, k).copy_(v)
    return m


# ------------------------------------------------- tests/test_moe.py, ported
def test_moe_matches_dense_routing_at_high_capacity():
    """With capacity >= T, dense-dispatch MoE == explicit per-token gather."""
    jcfg, cfg = _cfg()
    _, p = _jax_params(jcfg, 1)
    x = torch.from_numpy(_x((2, 16, cfg.d_model)))
    y, aux = moe.moe_apply(cfg, p, x, RunPolicy(moe_capacity_factor=64.0))
    xt = x.reshape(-1, cfg.d_model)
    g, idx = torch.topk(torch.softmax(xt @ p["router"], -1), cfg.top_k)
    g = g / g.sum(-1, keepdim=True)
    ref = torch.zeros_like(xt)
    for t in range(xt.shape[0]):
        for s in range(cfg.top_k):
            e = int(idx[t, s])
            h = F.silu(xt[t] @ p["w_gate"][e]) * (xt[t] @ p["w_up"][e])
            ref[t] += g[t, s] * (h @ p["w_down"][e])
    np.testing.assert_allclose(y.reshape(-1, cfg.d_model).numpy(),
                               ref.numpy(), atol=1e-4)
    assert float(aux) > 0


def test_expert_padding_never_routed():
    """6 experts padded to 8 at tp=8: pads get NEG_INF logits, no traffic,
    and the padded layer equals the unpadded one."""
    jcfg, cfg = _cfg(n_experts=6)
    _, p8 = _jax_params(jcfg, 8)
    _, p1 = _jax_params(jcfg, 1)
    assert p8["router"].shape[1] == 8 == moe.num_experts_eff(cfg, 8)
    x = torch.from_numpy(_x((2, 16, cfg.d_model)))
    _, _, idx = moe._route(cfg, p8, x.reshape(-1, cfg.d_model), 8)
    assert int(idx.max()) < 6
    y8, _ = moe.moe_apply(cfg, p8, x, RunPolicy(), tp=8)
    y1, _ = moe.moe_apply(cfg, p1, x, RunPolicy(), tp=1)
    np.testing.assert_allclose(y8.numpy(), y1.numpy(), atol=1e-5)


def test_capacity_drops_pass_through():
    """Over-capacity routings are dropped: their tokens' outputs are zero."""
    jcfg, cfg = _cfg(n_experts=2, top_k=1)
    _, p = _jax_params(jcfg, 1)
    x = torch.from_numpy(_x((1, 64, cfg.d_model)))
    y_t, _ = moe.moe_apply(cfg, p, x, RunPolicy(moe_capacity_factor=0.25))
    y_l, _ = moe.moe_apply(cfg, p, x, RunPolicy(moe_capacity_factor=64.0))
    zt = (y_t.abs().sum(-1) == 0).sum()
    zl = (y_l.abs().sum(-1) == 0).sum()
    assert zt > zl


@pytest.mark.parametrize("cf", [64.0, 1.25, 0.5])
def test_sorted_dispatch_matches_dense(cf):
    """Sorted (scatter) dispatch == dense dispatch, drop priority included."""
    jcfg, cfg = _cfg()
    _, p = _jax_params(jcfg, 1)
    x = torch.from_numpy(_x((2, 16, cfg.d_model)))
    pol = RunPolicy(moe_capacity_factor=cf)
    yd, ad = moe.moe_apply_dense(cfg, p, x, pol)
    ys, as_ = moe.moe_apply_sorted(cfg, p, x, pol)
    np.testing.assert_allclose(yd.numpy(), ys.numpy(), atol=2e-5)
    assert float(ad) == float(as_)
    assert moe.moe_apply(cfg, p, x, dataclasses.replace(
        pol, moe_impl="sorted"))[0].equal(ys)


# ------------------------------------------------------- port vs the JAX MoE
# olmoe's reduced layer (8 experts, top-2) at tp 1, and granite's 40 experts
# (top-8) padded to 48 at tp 16
LAYERS = {"olmoe": ("olmoe-1b-7b", 8, 2, 1), "granite": (
    "granite-moe-3b-a800m", 40, 8, 16)}


@pytest.mark.parametrize("impl", ["dense", "sorted"])
@pytest.mark.parametrize("cf", [0.5, 1.25])
@pytest.mark.parametrize("layer", sorted(LAYERS))
def test_moe_matches_jax(layer, cf, impl):
    arch, n_exp, top_k, tp = LAYERS[layer]
    jcfg, cfg = _cfg(n_exp, top_k, arch)
    jp, p = _jax_params(jcfg, tp)
    x = _x((2, 16, cfg.d_model))
    jfn = getattr(jax_moe, f"moe_apply_{impl}")
    want, want_aux = jfn(jcfg, jp, jnp.asarray(x),
                         JaxRunPolicy(moe_capacity_factor=cf), tp=tp)
    pol = RunPolicy(moe_capacity_factor=cf, moe_impl=impl)
    got, aux = getattr(moe, f"moe_apply_{impl}")(cfg, p, torch.from_numpy(x),
                                                 pol, tp=tp)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=RTOL)
    # the module runs the same function on its own parameters
    m = _module(cfg, p, tp)
    assert m(torch.from_numpy(x), pol).equal(got)
    # routing ids and capacity equal, hence the same drops; and at 0.5 some
    # expert is routed more tokens than it holds
    E = moe.num_experts_eff(cfg, tp)
    xt = x.reshape(-1, cfg.d_model)
    _, _, idx = moe._route(cfg, p, torch.from_numpy(xt), E)
    logits = jnp.asarray(xt) @ jp["router"]
    logits = jnp.where(jnp.arange(E)[None] >= cfg.num_experts,
                       jax_moe.NEG_INF, logits)
    _, jidx = jax.lax.top_k(jax.nn.softmax(logits, -1), cfg.top_k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    T = xt.shape[0]
    cap = moe.capacity(cfg, T, pol)
    assert cap == min(int(max(4, np.ceil(T * top_k / n_exp * cf))), T)
    counts = np.bincount(np.asarray(jidx).ravel(), minlength=E)
    assert cf != 0.5 or (counts > cap).any()
    assert int(idx.max()) < cfg.num_experts


def test_bf16_einsums_run_in_fp32():
    """bf16 inputs: the einsums run in fp32 and the result is cast back, so
    the layer stays within bf16 rounding of its fp32 result."""
    jcfg, cfg = _cfg()
    _, p = _jax_params(jcfg, 1)
    x = torch.from_numpy(_x((2, 16, cfg.d_model)))
    y32, _ = moe.moe_apply_dense(cfg, p, x, RunPolicy(moe_capacity_factor=64.0))
    pb = {k: v.bfloat16() for k, v in p.items()}
    yb, _ = moe.moe_apply_dense(cfg, pb, x.bfloat16(),
                                RunPolicy(moe_capacity_factor=64.0))
    assert yb.dtype == torch.bfloat16
    np.testing.assert_allclose(yb.float().numpy(), y32.numpy(), atol=5e-2)


def test_init_draws_logical_experts_and_zero_pads():
    cfg = dataclasses.replace(get_config("granite-moe-3b-a800m").reduced(),
                              num_experts=40, top_k=8)
    model = init_params(cfg, seed=0, tp=16, device="cpu")
    ffn = model.layers[0].ffn
    assert isinstance(ffn, MoE) and tuple(ffn.router.shape) == (64, 48)
    assert not ffn.router[:, 40:].any() and not ffn.w_down[40:].any()
    assert ffn.router[:, :40].std() > 0 and ffn.w_gate[:40].std() > 0


# ------------------------------------------ the reduced MoE archs, whole model
@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    jcfg = jax_get_config(request.param).reduced()
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(1))
    cfg = get_config(request.param).reduced()
    model = load_jax_params(cfg, jax.tree.map(np.asarray, jparams), "cpu")
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size,
                                             (2, 12)).astype(np.int32)
    return jcfg, jparams, cfg, model, toks


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=MODEL_RTOL,
                               atol=MODEL_ATOL)


def test_model_forward_matches_jax(pair):
    jcfg, jparams, cfg, model, toks = pair
    assert isinstance(model.layers[0].ffn, MoE)
    assert hasattr(model, "head") != cfg.tie_embeddings
    want, _ = jax_forward(jcfg, jparams, jnp.asarray(toks), JaxRunPolicy())
    _close(model(torch.from_numpy(toks)), want)


def test_model_prefill_then_decode_match_jax(pair):
    jcfg, jparams, cfg, model, toks = pair
    B, S = toks.shape
    want, _ = jax_prefill(jcfg, jparams, jnp.asarray(toks), JaxRunPolicy())
    got, _ = model.prefill(torch.from_numpy(toks))
    _close(got, want)
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


def test_launcher_serves_moe_on_the_cpu(capsys):
    from repro_torch.launch import serve as launch_serve

    launch_serve.main(["--arch", "olmoe-1b-7b", "--reduced", "--device",
                       "cpu", "--requests", "3", "--max-new", "5"])
    assert "requests=3 tokens=15" in capsys.readouterr().out
