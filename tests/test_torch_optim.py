"""The port's optimizer (repro_torch.optim) against the JAX package's:
AdamW, the warmup-cosine schedule and int8 error-feedback compression, on
the same numpy inputs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw_init as jax_adamw_init
from repro.optim import adamw_update as jax_adamw_update
from repro.optim import ef_int8_roundtrip as jax_ef
from repro.optim import int8_quant as jax_int8_quant
from repro.optim.schedule import warmup_cosine as jax_warmup_cosine
from repro_torch.optim import (
    adamw_init,
    adamw_update,
    ef_int8_roundtrip,
    int8_dequant,
    int8_quant,
    warmup_cosine,
)
from repro_torch.optim.compression import BLOCK
from repro_torch.tree import flatten, tree_map

ADAMW_RTOL = 1e-6  # of each tensor's max |value| (FMA and reduction order)
LR_TOL = 1e-7  # of the peak lr (cos rounds in the last bit)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(rng, scale=1.0):
    """A parameter-shaped tree: dicts, a list, odd sizes."""
    def a(*shape):
        return (scale * rng.standard_normal(shape)).astype(np.float32)
    return {"layers": [{"w": a(7, 5), "b": a(5)}, {"w": a(5, 3), "b": a(3)}],
            "embed": {"w": a(11, 7)}, "scale": a(300)}


def _close(got: torch.Tensor, want, what):
    want = np.asarray(want)
    tol = ADAMW_RTOL * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got.numpy(), want, rtol=ADAMW_RTOL, atol=tol,
                               err_msg=what)


@pytest.mark.parametrize("grad_scale", [0.01, 10.0], ids=["no_clip", "clip"])
def test_adamw_update_matches_jax(grad_scale):
    rng = np.random.default_rng(0)
    p0 = _tree(rng)
    jp = jax.tree.map(jnp.asarray, p0)
    jopt = jax_adamw_init(jp)
    params = tree_map(torch.from_numpy, _tree(np.random.default_rng(0)))
    opt = adamw_init(params)
    assert opt["master"]["embed"]["w"] is params["embed"]["w"]  # fp32: aliased
    lr_fn = warmup_cosine(1e-2, 2, 10)
    for step in range(4):
        g = _tree(rng, grad_scale)
        jp, jopt, jnorm = jax_adamw_update(
            jax.tree.map(jnp.asarray, g), jopt, jp,
            lr=jax_warmup_cosine(1e-2, 2, 10)(step))
        gnorm = adamw_update(tree_map(torch.from_numpy, g), opt, params,
                             lr=lr_fn(step))
        assert (float(jnorm) > 1.0) == (grad_scale > 1.0)
        np.testing.assert_allclose(float(gnorm), float(jnorm), rtol=ADAMW_RTOL)
        for name, want in (("params", jp), ("m", jopt["m"]), ("v", jopt["v"]),
                           ("master", jopt["master"])):
            got = params if name == "params" else opt[name]
            for path, w in flatten(want).items():
                _close(flatten(got)[path], w, f"step {step} {name}/{path}")
        assert int(opt["count"]) == int(jopt["count"]) == step + 1
        assert opt["count"].dtype == torch.int32


def test_adamw_keeps_an_fp32_master_of_bf16_params():
    params = {"w": torch.ones(4, dtype=torch.bfloat16)}
    opt = adamw_init(params)
    assert opt["master"]["w"].dtype == torch.float32
    assert opt["master"]["w"] is not params["w"]
    adamw_update({"w": torch.full((4,), 0.5, dtype=torch.bfloat16)}, opt,
                 params, lr=0.1)
    assert torch.equal(params["w"], opt["master"]["w"].to(torch.bfloat16))


@pytest.mark.parametrize("warmup,total", [(2, 10), (100, 1000), (0, 7)])
def test_warmup_cosine_matches_jax(warmup, total):
    jfn, fn = jax_warmup_cosine(3e-4, warmup, total), warmup_cosine(3e-4, warmup, total)
    want = np.array([float(jfn(s)) for s in range(total + 2)], np.float32)
    got = np.array([float(fn(s)) for s in range(total + 2)], np.float32)
    np.testing.assert_allclose(got, want, rtol=0, atol=LR_TOL * 3e-4)
    assert fn(0).dtype == torch.float32


@pytest.mark.parametrize("n,scale,seed", [(1, 1.0, 0), (255, 1e-3, 1),
                                          (256, 7.0, 2), (1000, 1e3, 3),
                                          (2048, 1e-6, 4)])
def test_int8_quant_matches_jax(n, scale, seed):
    x = (scale * np.random.default_rng(seed).standard_normal(n)).astype(np.float32)
    jq, js = jax_int8_quant(jnp.asarray(x))
    q, s = int8_quant(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_max_ulp(s.numpy(), np.asarray(js), maxulp=1)
    # the roundtrip bound of tests/test_compression.py: half a grid step
    y = int8_dequant(q, s, x.shape).numpy()
    pad = (-n) % BLOCK
    blocks = np.pad(x, (0, pad)).reshape(-1, BLOCK)
    bound = np.abs(blocks).max(axis=1) / 127.0 * 0.5 + 1e-9
    err = np.abs(np.pad(x - y, (0, pad)).reshape(-1, BLOCK))
    assert np.all(err <= bound[:, None] + 1e-12)


def test_ef_roundtrip_matches_jax():
    rng = np.random.default_rng(5)
    g = rng.standard_normal((37, 29)).astype(np.float32)
    e = (1e-3 * rng.standard_normal((37, 29))).astype(np.float32)
    jd, je = jax_ef(jnp.asarray(g), jnp.asarray(e))
    d, ne = ef_int8_roundtrip(torch.from_numpy(g), torch.from_numpy(e))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(ne.numpy(), np.asarray(je), rtol=1e-5, atol=1e-7)


def test_error_feedback_converges_quadratic():
    """EF-compressed GD on a quadratic reaches the optimum (as
    tests/test_compression.py), and int8 + scales is < 0.3 of fp32."""
    dim = 512
    target = torch.from_numpy(
        np.random.default_rng(0).standard_normal(dim).astype(np.float32))
    x, err = torch.zeros(dim), torch.zeros(dim)
    for _ in range(300):
        g, err = ef_int8_roundtrip(x - target, err)
        x = x - 0.2 * g
    assert float(torch.linalg.norm(x - target)) < 1e-2
    q, s = int8_quant(torch.randn(4096))
    assert q.numel() * 1 + s.numel() * 4 < 0.3 * 4096 * 4


@pytest.mark.parametrize("seed", [0, 7, 50])
def test_ef_residual_bounded(seed):
    g = torch.from_numpy(
        np.random.default_rng(seed).standard_normal(1024).astype(np.float32))
    err = torch.zeros_like(g)
    for _ in range(20):
        _, err = ef_int8_roundtrip(g, err)
    assert float(err.abs().max()) < float(g.abs().max())
