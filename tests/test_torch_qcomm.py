"""The port's int8 levers against the JAX package's: the two-phase int8 TP
all-reduce (``repro_torch.models.qcomm`` on a 4-rank gloo world, JAX's
under ``shard_map`` on 4 fake devices, each in a subprocess) and the int8
KV cache (``init_cache(kv_quant=True)`` and decode over it)."""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import RunPolicy as JaxRunPolicy
from repro.models import qcomm as jax_qcomm
from repro.models.cache import init_cache as jax_init_cache
from repro.models.transformer import decode_step as jax_decode_step
from repro_torch.configs import get_config
from repro_torch.models import RunPolicy, init_cache, load_jax_params, numpy_params
from repro_torch.models import qcomm
from repro_torch.models.attention import quantize_cache

ROOT = Path(__file__).resolve().parent.parent
N, B, S, D = 4, 2, 3, 64

_PORT = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import torch.multiprocessing as mp

    def rank(r, port, out):
        torch.set_num_threads(1)
        from repro_torch.launch.mesh import start_world, end_world
        from repro_torch.models.parallel import Axis
        from repro_torch.models.qcomm import quantized_allreduce
        import torch.distributed as dist
        start_world(r, %(n)d, backend="gloo", port=port)
        y = torch.from_numpy(np.load(out + "/y.npy")[r])
        got = quantized_allreduce(y, Axis(dist.group.WORLD, %(n)d, r))
        np.save(out + f"/port{r}.npy", got.numpy())
        end_world()

    if __name__ == "__main__":
        from repro_torch.launch.mesh import free_port
        mp.spawn(rank, args=(free_port(), sys.argv[1]), nprocs=%(n)d)
""")

_JAX = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=%(n)d"
    import jax, numpy as np
    from jax.sharding import AxisType, PartitionSpec as P
    from repro.models.qcomm import quantized_allreduce
    shard_map = getattr(jax, "shard_map", None)
    if shard_map is None:
        from jax.experimental.shard_map import shard_map
    out = sys.argv[1]
    y = np.load(out + "/y.npy")
    mesh = jax.make_mesh((%(n)d,), ("model",), axis_types=(AxisType.Auto,))
    f = shard_map(lambda t: quantized_allreduce(t[0], "model")[None], mesh=mesh,
                  in_specs=P("model"), out_specs=P("model"))
    np.save(out + "/jax.npy", np.asarray(jax.jit(f)(y)))
""")


def _env():
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")


@pytest.fixture(scope="module")
def allreduce_runs(tmp_path_factory):
    """Both packages' results on the same partial sums (N, B, S, D)."""
    out = tmp_path_factory.mktemp("qcomm")
    rng = np.random.default_rng(0)
    y = rng.standard_normal((N, B, S, D)).astype(np.float32)
    y[0, 0, 0] *= 50.0  # one block with a wide range
    np.save(out / "y.npy", y)
    (out / "port_side.py").write_text(_PORT % {"n": N})
    (out / "jax_side.py").write_text(_JAX % {"n": N})
    procs = [subprocess.Popen([sys.executable, str(out / name), str(out)],
                              env=_env(), cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for name in ("port_side.py", "jax_side.py")]
    for p in procs:
        _, err = p.communicate(timeout=240)
        assert p.returncode == 0, err[-3000:]
    port = np.stack([np.load(out / f"port{r}.npy") for r in range(N)])
    return y, port, np.load(out / "jax.npy")


def test_quantized_allreduce_matches_jax(allreduce_runs):
    """Every rank gets the same sum, within one quantization step of the
    JAX result and of the exact sum's error budget."""
    y, port, want = allreduce_runs
    assert port.shape == want.shape == (N, B, S, D)
    for r in range(1, N):
        np.testing.assert_array_equal(port[r], port[0])
    exact = y.sum(axis=0)
    # a step of the final codes: max |shard of the reduced sum| / 127
    part = exact.reshape(B, S, N, D // N)
    step = np.abs(part).max(axis=-1, keepdims=True) / 127.0
    step = np.broadcast_to(step, part.shape).reshape(B, S, D)
    assert np.all(np.abs(port[0] - want[0]) <= step + 1e-6)
    # and both stay near the exact sum (two roundings of N blocks)
    phase1 = np.abs(y).reshape(N, B, S, N, D // N).max(-1).sum(0) / 127.0
    budget = np.broadcast_to((phase1 / 2)[..., None], part.shape).reshape(B, S, D)
    assert np.all(np.abs(port[0] - exact) <= budget + step)


def test_quant_blocks_codes_match_jax():
    """Codes equal but where y / scale lands on a .5 tie that the two
    divisions round to opposite sides (none in this draw), scales equal."""
    rng = np.random.default_rng(1)
    y = rng.standard_normal((B, S, N, D // N)).astype(np.float32) * 3
    jq, js = jax_qcomm._quant_blocks(jnp.asarray(y), N)
    q, s = qcomm._quant_blocks(torch.from_numpy(y))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    ratio = y / np.asarray(js)
    tie = np.abs(np.abs(ratio - np.trunc(ratio)) - 0.5) < 1e-5
    diff = q.numpy().astype(np.int32) - np.asarray(jq).astype(np.int32)
    assert np.all(np.abs(diff) <= 1) and np.all(diff[~tie] == 0)


def test_quantized_allreduce_rejects_indivisible_width():
    from repro_torch.models.parallel import Axis

    with pytest.raises(ValueError, match="does not split"):
        qcomm.quantized_allreduce(torch.zeros(1, 1, 6), Axis(None, 4, 0))


# ------------------------------------------------------------ int8 KV cache
@pytest.mark.parametrize("arch", ["yi-6b", "qwen2.5-32b", "recurrentgemma-2b"])
def test_init_cache_kv_quant_leaves_match_jax(arch):
    cfg = get_config(arch).reduced()
    want = jax_init_cache(jax_get_config(arch).reduced(), 2, 12, tp=2,
                          dtype=jnp.float32, kv_quant=True)
    got = init_cache(cfg, 2, 12, tp=2, dtype=torch.float32, kv_quant=True,
                     device="cpu")
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k in w:
            assert tuple(g[k].shape) == w[k].shape
            assert str(g[k].dtype).split(".")[-1] == str(w[k].dtype)
            assert not g[k].any()


@pytest.mark.parametrize("arch", ["yi-6b", "qwen2.5-32b"])
def test_int8_kv_decode_matches_jax(arch):
    """Decode from an empty int8 cache, token by token, on one numpy tree:
    logits and every cache leaf (codes equal, scales to fp32 rounding) as
    the JAX decode_step with kv_quant (tests/test_model_consistency.py's
    int8 cache test, on both packages)."""
    jcfg, cfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    tree = numpy_params(cfg, 0)
    model = load_jax_params(cfg, tree, "cpu")
    Bd, Sd = 2, 10
    toks = np.random.default_rng(2).integers(2, cfg.vocab_size, (Bd, Sd)).astype(np.int32)
    jcache = jax_init_cache(jcfg, Bd, Sd, tp=1, dtype=jnp.float32, kv_quant=True)
    cache = init_cache(cfg, Bd, Sd, tp=1, dtype=torch.float32, kv_quant=True,
                       device="cpu")
    jparams = jax.tree.map(jnp.asarray, tree)
    jstep = jax.jit(lambda p, t, ps, c: jax_decode_step(jcfg, p, t, ps, c,
                                                        JaxRunPolicy()))
    pol = RunPolicy(kv_cache_quant=True)
    for i in range(Sd):
        pos = np.full((Bd,), i, np.int32)
        jl, jcache = jstep(jparams, jnp.asarray(toks[:, i:i + 1]),
                           jnp.asarray(pos), jcache)
        lg, cache = model.decode_step(torch.from_numpy(toks[:, i:i + 1]),
                                      torch.from_numpy(pos), cache, pol)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl), atol=2e-5,
                                   rtol=1e-5)
    for c, jc in zip(cache, jcache):
        np.testing.assert_array_equal(c["k"].numpy(), np.asarray(jc["k"]))
        np.testing.assert_array_equal(c["v"].numpy(), np.asarray(jc["v"]))
        np.testing.assert_allclose(c["ks"].numpy(), np.asarray(jc["ks"]), rtol=1e-6)
        np.testing.assert_allclose(c["vs"].numpy(), np.asarray(jc["vs"]), rtol=1e-6)


def test_int8_kv_cache_decode_close_to_fp():
    """The reference's tolerance on the port: softmax within 0.05 of the
    full-precision forward at every step; ``quantize_cache`` of a prefill
    cache equals the codes decode writes token by token."""
    cfg = get_config("yi-6b").reduced()
    model = load_jax_params(cfg, numpy_params(cfg, 0), "cpu")
    Bd, Sd = 2, 16
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        2, cfg.vocab_size, (Bd, Sd)).astype(np.int32))
    full = model(toks)
    cache = init_cache(cfg, Bd, Sd + 2, tp=1, dtype=torch.float32,
                       kv_quant=True, device="cpu")
    for i in range(Sd):
        lg, cache = model.decode_step(toks[:, i:i + 1],
                                      torch.full((Bd,), i, dtype=torch.int32),
                                      cache)
        np.testing.assert_allclose(torch.softmax(lg[:, 0], -1).numpy(),
                                   torch.softmax(full[:, i], -1).numpy(),
                                   atol=0.05)
    _, pre = model.prefill(toks)
    q = quantize_cache(pre[0])
    np.testing.assert_array_equal(q["k"].numpy(), cache[0]["k"][:, :Sd].numpy())
    np.testing.assert_array_equal(q["ks"].numpy(), cache[0]["ks"][:, :Sd].numpy())
    assert json.dumps(sorted(q)) == json.dumps(["k", "ks", "v", "vs"])
