"""The port's LM train step (repro_torch.train.make_train_step) against the
JAX package's on one numpy train state and the same batches: every reduced
arch, gradient accumulation, int8 error-feedback compression; remat against
no remat; and the padded TP layout's training exactness on the port."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import list_archs
from repro.models import RunPolicy as JaxRunPolicy
from repro.train import TrainerConfig as JaxTrainerConfig
from repro.train import make_train_state as jax_make_train_state
from repro.train import make_train_step as jax_make_train_step
from repro_torch.configs import get_config
from repro_torch.data import SyntheticLM
from repro_torch.models import RunPolicy, init_params, numpy_params
from repro_torch.models.convert import load_jax_train_state, numpy_train_state
from repro_torch.models.layout import HeadLayout
from repro_torch.train import TrainerConfig, make_train_state, make_train_step
from repro_torch.tree import flatten, tree_map

LOSS_RTOL = 1e-5    # loss and grad norm, relative
PARAM_RTOL = 1e-5   # params, of max |param| over the tree, where ...
ILL = 1e-6          # ... JAX's sqrt(v_hat) >= 100 eps at every step so far:
# below that AdamW's g / (|g| + eps) divides a gradient that is a sum of
# cancelling terms (its last bits are rounding) by a number of its own size,
# and two correct implementations may move the weight by anything up to
# lr; there the test holds |dw| <= 2 (1 + wd) * the sum of the lrs
B, S = 4, 16
TC = dict(total_steps=10, warmup_steps=2)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batches(cfg, n, seed=0):
    """``n`` SyntheticLM batches (labels marked -1 at document joints);
    embeddings for an 'embeddings' arch."""
    ds = SyntheticLM(cfg.vocab_size, S, B, seed=seed, mean_doc_len=8,
                     emb_dim=cfg.d_model if cfg.input_kind == "embeddings" else 0)
    return [dict(zip(("tokens", "labels"), ds.batch(i))) for i in range(n)]


def _jax_state(jcfg, tree):
    return jax_make_train_state(jcfg, jax.tree.map(jnp.asarray, tree))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _run_both(arch, steps=2, accum=1, compress=False, tp=1, seed=0):
    """Both packages from one numpy train state over the same batches:
    per step (jax loss, port loss, jax grad norm, port grad norm, lr) and
    (jax state, port state) as numpy trees."""
    jcfg, cfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    jstate = _jax_state(jcfg, numpy_params(cfg, seed, tp=tp))
    state = load_jax_train_state(cfg, _np(jstate), "cpu", tp=tp)
    kw = dict(TC, grad_accum=accum, compress_grads=compress, tp=tp)
    jstep = jax.jit(jax_make_train_step(jcfg, JaxRunPolicy(), JaxTrainerConfig(**kw)))
    step = make_train_step(cfg, RunPolicy(), TrainerConfig(**kw))
    jerr = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32),
                        jstate["params"]) if compress else None
    err = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                   state["params"]) if compress else None
    out, states, errs = [], [], []
    for batch in _batches(cfg, steps):
        if compress:
            jstate, jm, jerr = jstep(jstate, jax.tree.map(jnp.asarray, batch), jerr)
            state, m, err = step(state, {k: torch.from_numpy(v)
                                         for k, v in batch.items()}, err)
        else:
            jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, batch))
            state, m = step(state, {k: torch.from_numpy(v)
                                    for k, v in batch.items()})
        out.append((float(jm["loss"]), float(m["loss"]),
                    float(jm["grad_norm"]), float(m["grad_norm"]),
                    float(jm["lr"])))
        states.append((_np(jstate), numpy_train_state(state)))
        if compress:
            errs.append((flatten(_np(jerr)),
                         {k: v.numpy().copy() for k, v in flatten(err).items()}))
    return out, states, errs


def _assert_close(out, states, wd=0.1, b2=0.95, flips=None):
    """Losses and grad norms to LOSS_RTOL; every step's params to
    PARAM_RTOL of max |param| where the update is well conditioned
    (``ILL``) and no int8 code flipped (``flips``: path -> mask)."""
    for jl, pl, jg, pg, _ in out:
        np.testing.assert_allclose(pl, jl, rtol=LOSS_RTOL)
        np.testing.assert_allclose(pg, jg, rtol=LOSS_RTOL)
    ill, n_ill, n = {}, 0, 0
    for t, (jstate, pstate) in enumerate(states, 1):
        jf, pf = flatten(jstate), flatten(pstate)
        assert sorted(jf) == sorted(pf)
        tol = PARAM_RTOL * max(float(np.abs(v).max()) for k, v in jf.items()
                               if k.startswith("params/"))
        lr_sum = sum(o[4] for o in out[:t])
        for path, want in jf.items():
            got = pf[path]
            assert got.shape == want.shape and got.dtype == want.dtype, path
            if not path.startswith("params/"):
                continue
            v_hat = jf["opt/v/" + path[7:]] / (1 - b2 ** t)
            ill[path] = ill.get(path, False) | (np.sqrt(v_hat) < ILL)
            if flips is not None:
                ill[path] = ill[path] | flips[path[7:]]
            for p in (path, "opt/master/" + path[7:]):
                d = np.abs(pf[p] - jf[p])
                assert d[~ill[path]].max(initial=0) <= tol, (t, p)
                assert d[ill[path]].max(initial=0) <= 2 * (1 + wd) * lr_sum + tol
        for path in ("opt/count", "step"):
            assert int(pf[path]) == int(jf[path]) == t
    n_ill = sum(int(m.sum()) for m in ill.values())
    n = sum(m.size for m in ill.values())
    assert n_ill < 0.2 * n  # the strict check covers most of the weights


@pytest.mark.parametrize("arch", list_archs())
def test_two_train_steps_match_jax(arch):
    out, states, _ = _run_both(arch)
    _assert_close(out, states)
    # the params moved (test_arch_smoke.py::test_one_train_step)
    assert not np.allclose(states[-1][1]["params"]["final_norm"]["scale"], 1.0)


@pytest.mark.parametrize("arch", ["yi-6b", "olmoe-1b-7b"])
def test_grad_accum_matches_jax(arch):
    out, states, _ = _run_both(arch, accum=2)
    _assert_close(out, states)


def test_compressed_grads_match_jax():
    """The grads go through int8 error feedback. Where the two packages'
    accumulated grads straddle a rounding boundary of the int8 grid, a code
    differs by one (a residual differs by a grid step): those elements are
    held to the AdamW bound and the rest to PARAM_RTOL; no residual differs
    by more than a grid step, and fewer than 1 % by more than 1e-5 of the
    grid's range."""
    out, states, errs = _run_both("yi-6b", compress=True)
    flips, n_flip, n = {}, 0, 0
    for jerr, err in errs:
        for path, want in jerr.items():
            scale = max(float(np.abs(want).max()), 1e-30)  # <= half a step
            d = np.abs(err[path] - want)
            flip = d > 1e-5 * 254 * scale  # 1e-5 of the grid's range
            flips[path] = flips.get(path, False) | flip
            # one grid step at most: the block's scale, <= 2 max |residual|
            assert d.max(initial=0) <= 2.0 * scale * (1 + 1e-5), path
            n_flip, n = n_flip + int(flip.sum()), n + flip.size
    assert n_flip < 1e-2 * n, (n_flip, n)
    _assert_close(out, states, flips=flips)


@pytest.mark.parametrize("arch", ["yi-6b", "olmoe-1b-7b", "rwkv6-1.6b",
                                  "recurrentgemma-2b"])
def test_remat_is_bit_equal(arch):
    """``RunPolicy(remat=True)`` recomputes each block in the backward pass:
    the same losses, grad norms and params, bit for bit, on the CPU."""
    cfg = get_config(arch).reduced()
    res = []
    for remat in (False, True):
        state = make_train_state(cfg, init_params(cfg, seed=3, device="cpu"))
        step = make_train_step(cfg, RunPolicy(remat=remat),
                               TrainerConfig(grad_accum=2, **TC))
        ms = []
        for batch in _batches(cfg, 2):
            state, m = step(state, {k: torch.from_numpy(v)
                                    for k, v in batch.items()})
            ms.append((float(m["loss"]), float(m["grad_norm"])))
        res.append((ms, numpy_train_state(state)))
    assert res[0][0] == res[1][0]
    for path, a in flatten(res[0][1]).items():
        np.testing.assert_array_equal(flatten(res[1][1])[path], a, err_msg=path)


# -------------------------- tests/test_tp_layout.py:55,81 on the port
def _tp_cfg(arch, mha=False):
    return dataclasses.replace(get_config(arch).reduced(), num_heads=6,
                               num_kv_heads=6 if mha else 2, head_dim=16)


def _tp_run(cfg, tp, steps):
    state = make_train_state(cfg, init_params(cfg, seed=0, tp=tp, device="cpu"))
    step = make_train_step(cfg, RunPolicy(), TrainerConfig(
        grad_accum=1, total_steps=10, warmup_steps=1, tp=tp))
    gen = torch.Generator().manual_seed(7)
    losses = []
    for _ in range(steps):
        if cfg.input_kind == "embeddings":
            toks = torch.randn(2, 16, cfg.d_model, generator=gen)
        else:
            toks = torch.randint(0, cfg.vocab_size, (2, 16), generator=gen)
        labels = torch.randint(0, cfg.vocab_size, (2, 16), generator=gen)
        state, m = step(state, {"tokens": toks, "labels": labels})
        losses.append(float(m["loss"]))
    return losses, state


@pytest.mark.parametrize("arch,mha", [("yi-6b", False), ("musicgen-medium", True)])
def test_training_equivalence_under_padded_tp(arch, mha):
    """3 AdamW steps at the tp=4 layout == the tp=1 layout (grad mask +
    replica sync), to 2e-5 as the JAX test holds it."""
    cfg = _tp_cfg(arch, mha)
    l1, _ = _tp_run(cfg, 1, 3)
    l4, _ = _tp_run(cfg, 4, 3)
    np.testing.assert_allclose(l1, l4, rtol=2e-5)


def test_kv_replicas_stay_identical_after_updates():
    cfg, tp = _tp_cfg("yi-6b"), 4
    _, state = _tp_run(cfg, tp, 2)
    lay = HeadLayout.make(cfg.num_heads, cfg.num_kv_heads, tp)
    assert lay.rep > 1 and lay.q_pad_mask().any()
    mixer = state["params"]["layers"][0]["mixer"]
    wk = mixer["wk"].detach().numpy()
    wk = wk.reshape(wk.shape[0], lay.n_kv, lay.rep, -1)
    for c in range(1, lay.rep):
        np.testing.assert_array_equal(wk[:, :, 0], wk[:, :, c])
    wo = mixer["wo"].detach().numpy()
    assert np.all(wo[lay.q_pad_mask()] == 0.0)  # padded W_o rows stay zero
