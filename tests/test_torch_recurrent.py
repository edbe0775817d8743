"""The port's recurrent archs (rwkv6, recurrentgemma's rglru and local
attention layers) against the JAX package's: the wkv6 forms, the rglru scan,
the ring-buffer decode, and the reduced models' forward, prefill and every
decode step on one weight tree loaded into both."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import RunPolicy as JaxRunPolicy
from repro.models import decode_step as jax_decode_step
from repro.models import forward as jax_forward
from repro.models import init_params as jax_init_params
from repro.models import prefill as jax_prefill
from repro.models.attention import attn_decode as jax_attn_decode
from repro.models.attention import attn_init as jax_attn_init
from repro.models.cache import init_cache as jax_init_cache
from repro.models.layout import HeadLayout as JaxHeadLayout
from repro.models.rwkv import wkv6_chunked as jax_wkv6_chunked
from repro.models.rwkv import wkv6_ref as jax_wkv6_ref
from repro_torch.configs import get_config, list_archs
from repro_torch.models import (
    HeadLayout,
    RunPolicy,
    init_cache,
    init_params,
    linear_scan,
    load_jax_params,
    numpy_params,
    wkv6_chunked,
    wkv6_ref,
)
from repro_torch.models.attention import Attention

WKV_ATOL = 2e-5  # as test_model_consistency.py::test_wkv6_chunked_vs_ref
SCAN_ATOL = 1e-5  # fp32, sums in another order than associative_scan's
RING_ATOL = 1e-4  # as test_sliding_window_decode_ring_buffer
MODEL_ATOL = 1e-4  # fp32 on the CPU, the whole reduced model vs JAX's
SELF_ATOL, SELF_RTOL = 2e-3, 1e-3  # as test_prefill_then_decode_matches_forward
ARCHS = ["rwkv6-1.6b", "recurrentgemma-2b"]
# the terms that init_params leaves at zero, perturbed so their paths count
ZERO_INIT = ("lora_B", "w_lora_B", "conv_b", "bias_i", "bias_r", "ln_bias")
B, S = 2, 24


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The models here are tiny: one intra-op thread per process keeps
    parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, atol, rtol=0.0):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol,
                               rtol=rtol)


def _rand(rng, shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


# ---------------------------------------------------------------- wkv6, scan
@pytest.mark.parametrize("b,s,h,k,chunk", [(2, 64, 2, 8, 16), (1, 96, 4, 16, 32),
                                           (2, 33, 2, 8, 16)])
def test_wkv6_matches_jax(b, s, h, k, chunk):
    rng = np.random.default_rng(s)
    r, kk, v = (_rand(rng, (b, s, h, k), 0.5) for _ in range(3))
    wlog = -np.exp(_rand(rng, (b, s, h, k)) - 2.0)
    u = _rand(rng, (h, k), 0.3)
    s0 = _rand(rng, (b, h, k, k), 0.1)
    args = (r, kk, v, wlog, u, s0)
    targs = [torch.from_numpy(a) for a in args]
    jargs = [jnp.asarray(a) for a in args]
    for got, want in ((wkv6_ref(*targs), jax_wkv6_ref(*jargs)),
                      (wkv6_chunked(*targs, chunk),
                       jax_wkv6_chunked(*jargs, chunk)),
                      (wkv6_chunked(*targs, chunk), wkv6_ref(*targs))):
        _close(got[0], want[0], WKV_ATOL)
        _close(got[1], want[1], WKV_ATOL)


@pytest.mark.parametrize("s", [1, 2, 5, 24, 33])
def test_linear_scan_matches_associative_scan(s):
    rng = np.random.default_rng(s)
    a = rng.uniform(0.5, 1.0, (2, s, 8)).astype(np.float32)
    b = _rand(rng, (2, s, 8))

    def combine(c1, c2):
        return c1[0] * c2[0], c1[1] * c2[0] + c2[1]

    _, want = jax.lax.associative_scan(combine, (jnp.asarray(a), jnp.asarray(b)),
                                       axis=1)
    _close(linear_scan(torch.from_numpy(a), torch.from_numpy(b)), want,
           SCAN_ATOL)


def test_ring_buffer_decode_matches_jax():
    """Decode through a ring of W = 8 slots over 24 tokens: each step
    equals JAX ``attn_decode`` and the port's own windowed full pass."""
    W, T = 8, 24
    jcfg = dataclasses.replace(jax_get_config("recurrentgemma-2b").reduced(),
                               local_window=W)
    cfg = dataclasses.replace(get_config("recurrentgemma-2b").reduced(),
                              local_window=W)
    jlay = JaxHeadLayout.make(cfg.num_heads, cfg.num_kv_heads, 1)
    lay = HeadLayout.make(cfg.num_heads, cfg.num_kv_heads, 1)
    jp = jax_attn_init(jcfg, jlay, jax.random.PRNGKey(0), jnp.float32)
    attn = Attention(cfg, lay, torch.float32, "cpu")
    attn.load_state_dict({k: torch.from_numpy(np.array(v))
                          for k, v in jp.items()})
    x = _rand(np.random.default_rng(0), (1, T, cfg.d_model))
    full, _ = attn(torch.from_numpy(x), RunPolicy(), torch.arange(T),
                   window=W)
    shape = (1, W, lay.n_kv_eff, cfg.head_dim)
    ring = {"k": torch.zeros(shape), "v": torch.zeros(shape)}
    jring = {"k": jnp.zeros(shape), "v": jnp.zeros(shape)}
    for i in range(T):
        want, jring = jax_attn_decode(jcfg, jp, jnp.asarray(x[:, i:i + 1]),
                                      jlay, JaxRunPolicy(),
                                      jnp.asarray([i], jnp.int32), jring,
                                      window=W)
        got, ring = attn.decode(torch.from_numpy(x[:, i:i + 1]),
                                torch.tensor([i]), ring, RunPolicy(), window=W)
        _close(got, want, RING_ATOL)
        _close(got[:, 0], full[:, i], RING_ATOL)
        _close(ring["k"], jring["k"], RING_ATOL)


# ------------------------------------------------------------ whole models
def _perturbed_tree(jcfg):
    """JAX init_params' tree with its zero-initialized terms made nonzero."""
    tree = jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(1)))
    rng = np.random.default_rng(5)
    for layer in tree["layers"]:
        for part in (layer["mixer"], layer["ffn"]):
            for name in ZERO_INIT:
                if name in part:
                    part[name] = _rand(rng, part[name].shape, 0.2)
    return tree


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    jcfg = jax_get_config(request.param).reduced()
    cfg = get_config(request.param).reduced()
    tree = _perturbed_tree(jcfg)
    jparams = jax.tree.map(jnp.asarray, tree)
    model = load_jax_params(cfg, tree, "cpu")
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (B, S)
                                             ).astype(np.int32)
    want, _ = jax_forward(jcfg, jparams, jnp.asarray(toks), JaxRunPolicy())
    return jcfg, jparams, cfg, model, toks, np.asarray(want)


def test_zero_init_terms_are_perturbed(pair):
    _, _, cfg, model, _, _ = pair
    names = {k.split(".")[-1] for k, v in model.state_dict().items()
             if k.split(".")[-1] in ZERO_INIT and bool(v.abs().min() > 0)}
    assert names == ({"lora_B", "w_lora_B", "ln_bias"} if cfg.mixer == "rwkv6"
                     else {"conv_b", "bias_i", "bias_r"})


def test_forward_matches_jax(pair):
    _, _, cfg, model, toks, want = pair
    got = model(torch.from_numpy(toks))
    assert tuple(got.shape) == (B, S, cfg.vocab_size)
    _close(got, want, MODEL_ATOL)


@pytest.mark.parametrize("n", [6, 20], ids=["S<W", "S>W"])
def test_prefill_and_every_decode_step_match_jax(pair, n):
    """Prefill n tokens in chunks of 8 (rwkv6 halves them to 4 at n = 20;
    recurrentgemma's window is 16, so n = 20 rolls the ring), then decode
    the rest from prefill's caches in both packages; recurrentgemma at n = 6
    decodes from caches of S + 2 positions, as a dense local cache of 6 rows
    has no room."""
    jcfg, jparams, cfg, model, toks, _ = pair
    want, jcaches = jax_prefill(jcfg, jparams, jnp.asarray(toks[:, :n]),
                                JaxRunPolicy(rwkv_chunk=8))
    got, caches = model.prefill(torch.from_numpy(toks[:, :n]),
                                RunPolicy(rwkv_chunk=8))
    _close(got, want, MODEL_ATOL)
    for c, jc in zip(caches, jcaches):
        assert c.keys() == jc.keys()
        for name in c:
            _close(c[name], jc[name], MODEL_ATOL)
    start = n
    if n < cfg.local_window:  # decode from scratch instead
        caches = init_cache(cfg, B, S + 2, dtype=torch.float32, device="cpu")
        jcaches = jax_init_cache(jcfg, B, S + 2, dtype=jnp.float32)
        start = 0
    step = jax.jit(lambda p, t, ps, c: jax_decode_step(jcfg, p, t, ps, c,
                                                       JaxRunPolicy()))
    for i in range(start, S):
        tok, pos = toks[:, i:i + 1], np.full((B,), i, np.int32)
        want, jcaches = step(jparams, jnp.asarray(tok), jnp.asarray(pos),
                             jcaches)
        got, caches = model.decode_step(torch.from_numpy(tok),
                                        torch.from_numpy(pos), caches)
        _close(got, want, MODEL_ATOL)
    for c, jc in zip(caches, jcaches):
        for name in c:
            _close(c[name], jc[name], MODEL_ATOL)


@pytest.mark.parametrize("n", [16, 20], ids=["S=W", "S>W"])
def test_prefill_then_decode_matches_forward(pair, n):
    """Decode from prefill's own caches at S >= W, and from init_cache,
    against the forward pass."""
    _, _, cfg, model, toks, _ = pair
    full = model(torch.from_numpy(toks))
    last, caches = model.prefill(torch.from_numpy(toks[:, :n]))
    _close(last[:, 0], full[:, n - 1], SELF_ATOL, SELF_RTOL)
    for start, c in ((n, caches),
                     (0, init_cache(cfg, B, S + 2, dtype=torch.float32,
                                    device="cpu"))):
        for i in range(start, S):
            lg, c = model.decode_step(torch.from_numpy(toks[:, i:i + 1]),
                                      torch.full((B,), i, dtype=torch.int32), c)
            _close(lg[:, 0], full[:, i], SELF_ATOL, SELF_RTOL)


# ------------------------------------------- faults of the reference, raised
def test_short_prompt_conv_cache_raises():
    """A prompt shorter than conv_width - 1 leaves a short conv window: the
    JAX package's decode_step fails inside an einsum; the port's raises
    ValueError naming the cause."""
    cfg = get_config("recurrentgemma-2b").reduced()
    model = init_params(cfg, seed=0, device="cpu")
    toks = torch.tensor([[3, 4], [5, 6]], dtype=torch.int32)
    _, caches = model.prefill(toks)
    assert caches[0]["conv"].shape[1] == 2 < cfg.conv_width - 1
    # a ring for the local layer, whose 2 dense rows would raise first
    caches[2] = init_cache(cfg, 2, S, dtype=torch.float32, device="cpu")[2]
    with pytest.raises(ValueError, match="conv_width - 1"):
        model.decode_step(toks[:, :1], torch.tensor([2, 2]), caches)


@pytest.mark.parametrize("arch,n,rows", [("recurrentgemma-2b", 6, 6),
                                         ("yi-6b", 6, 8)])
def test_position_past_a_dense_cache_raises(arch, n, rows):
    """A prompt shorter than the window leaves a dense local cache of n
    rows, where JAX's decode_step drops the write at pos n silently; the
    port raises ValueError for any position past a dense cache's rows."""
    cfg = get_config(arch).reduced()
    model = init_params(cfg, seed=0, device="cpu")
    toks = torch.arange(2, 2 + 2 * n, dtype=torch.int32).reshape(2, n)
    _, caches = model.prefill(toks)
    if rows != n:
        caches = init_cache(cfg, 2, rows, dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="does not fit a dense KV cache"):
        model.decode_step(toks[:, :1], torch.tensor([1, rows]), caches)


# ----------------------------------------------------------- all ten archs
@pytest.mark.parametrize("arch", list_archs())
def test_init_cache_matches_jax(arch):
    jcfg, cfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    for n in (5, 40):
        want = jax_init_cache(jcfg, 2, n, dtype=jnp.float32)
        got = init_cache(cfg, 2, n, dtype=torch.float32, device="cpu")
        assert [{k: (tuple(t.shape), str(t.dtype)[6:]) for k, t in c.items()}
                for c in got] == [
            {k: (a.shape, str(a.dtype)) for k, a in c.items()} for c in want]


@pytest.mark.parametrize("arch", list_archs())
def test_every_arch_decodes_as_it_runs_forward(arch):
    """TransformerLM, init_cache, prefill and decode_step for every arch."""
    cfg = get_config(arch).reduced()
    model = init_params(cfg, seed=0, device="cpu")
    pol = RunPolicy(moe_capacity_factor=1e9)  # no drops: T differs
    T = 6
    rng = np.random.default_rng(0)
    if cfg.input_kind == "embeddings":
        toks = torch.from_numpy(_rand(rng, (1, T, cfg.d_model)))
    else:
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, T)))
    full = model(toks, pol)
    last, _ = model.prefill(toks, pol)
    _close(last[:, 0], full[:, -1], SELF_ATOL, SELF_RTOL)
    caches = init_cache(cfg, 1, T, dtype=torch.float32, device="cpu")
    for i in range(T):
        lg, caches = model.decode_step(toks[:, i:i + 1], torch.tensor([i]),
                                       caches, pol)
        _close(lg[:, 0], full[:, i], SELF_ATOL, SELF_RTOL)


def test_load_takes_the_dtype_of_a_matrix_and_keeps_fp32_terms():
    """A float16 tree whose first leaf is the fp32 ``w0`` loads as a float16
    model; ``w0``, ``u`` and ``lambda`` stay fp32 even when the tree holds
    them in float16."""
    for arch, keep in (("rwkv6-1.6b", ("w0", "u")),
                       ("recurrentgemma-2b", ("lambda",))):
        cfg = get_config(arch).reduced()
        tree = jax.tree.map(lambda a: a.astype(np.float16),
                            numpy_params(cfg, 0))
        mixer = tree["layers"][0]["mixer"]
        first = {keep[0]: mixer.pop(keep[0]).astype(np.float32)}
        tree["layers"][0] = {"mixer": {**first, **mixer},
                             **{k: v for k, v in tree["layers"][0].items()
                                if k != "mixer"}}
        model = load_jax_params(cfg, {"layers": tree.pop("layers"), **tree},
                                "cpu")
        for name, p in model.state_dict().items():
            want = (torch.float32 if name.split(".")[-1] in keep
                    and ".mixer." in name else torch.float16)
            assert p.dtype == want, name
