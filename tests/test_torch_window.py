"""Sliding-window and YaRN layers side by side in the port's paged serve
engine: YaRN's table against its formula, the windowed paged attention, the
window layers' pool (pages released as they leave the window, swaps of the
live keys only), the engine against the model's full forward at contexts
3-5 times the window and across a preemption."""
import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.kernels.paged_attention.ref import paged_attention_ref
from repro_torch.models import init_params
from repro_torch.models.layers import RunPolicy, _yarn_inv, rope_apply, yarn_freqs
from repro_torch.serve import ServeEngine
from repro_torch.serve.paged import window_pages

W, PS, CHUNK = 16, 4, 8
MELLUM_TINY = ArchConfig(
    name="mellum-tiny", family="moe", source="test", num_layers=4, d_model=64,
    num_heads=4, num_kv_heads=2, head_dim=16, d_ff=32, vocab_size=256,
    rope_theta=5e5, num_experts=8, top_k=2,
    layer_pattern=("local", "local", "local", "attention"), local_window=W,
    yarn_factor=16.0, yarn_original_max_len=8192, yarn_beta_fast=32.0,
    yarn_beta_slow=1.0, yarn_attention_factor=1.2772588722239782)
# no capacity drops: a token's output does not depend on its batch, so the
# engine's tokens can be held to the full forward's
NO_DROPS = RunPolicy(moe_capacity_factor=100.0)



def _yarn_ref(D, theta, factor, orig, fast, slow):
    """YaRN's inverse frequencies in float64, from the formula, and the
    correction bounds."""
    def dim(rot):
        return D * math.log(orig / (rot * 2 * math.pi)) / (2 * math.log(theta))
    low, high = max(math.floor(dim(fast)), 0), min(math.ceil(dim(slow)), D - 1)
    i = np.arange(D // 2)
    extra = 1.0 / theta ** (2 * i / D)
    ramp = np.clip((i - low) / (high - low), 0, 1)
    return extra / factor * ramp + extra * (1 - ramp), low, high


def test_yarn_table_matches_the_formula_at_published_dims():
    want, low, high = _yarn_ref(128, 5e5, 16.0, 8192, 32.0, 1.0)
    assert (low, high) == (18, 35)
    got = _yarn_inv(128, 5e5, 16.0, 8192, 32.0, 1.0).double().numpy()
    np.testing.assert_allclose(got, want, rtol=2e-6)
    base = 1.0 / 5e5 ** (np.arange(64) / 64)
    np.testing.assert_allclose(got[:18], base[:18], rtol=2e-6)  # extrapolated
    np.testing.assert_allclose(got[35:], base[35:] / 16, rtol=2e-6)  # ÷ factor
    # the port's table for a config, made once a device
    cfg = dataclasses.replace(MELLUM_TINY, head_dim=128)
    assert yarn_freqs(cfg, "cpu") is yarn_freqs(cfg, "cpu")
    np.testing.assert_allclose(yarn_freqs(cfg, "cpu").double().numpy(), want,
                               rtol=2e-6)


def test_rope_with_a_table_scales_cos_and_sin():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(5, 2, 16, generator=g)
    pos = torch.arange(3, 8)
    inv = _yarn_inv(16, 5e5, 16.0, 8192, 32.0, 1.0)
    got = rope_apply(x, pos, 5e5, inv, 1.5)
    ang = pos.double()[:, None] * inv.double()
    c, s = torch.cos(ang)[:, None] * 1.5, torch.sin(ang)[:, None] * 1.5
    x1, x2 = x[..., :8].double(), x[..., 8:].double()
    want = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], -1)
    torch.testing.assert_close(got.double(), want, rtol=1e-5, atol=1e-5)
    # without a table: the plain rope of before
    assert torch.equal(rope_apply(x, pos, 5e5), rope_apply(x, pos, 5e5, None))


@pytest.mark.parametrize("window,lengths", [
    (5, [1, 5, 6, 17, 33]),      # windows that start mid-page
    (16, [16, 17, 31, 40, 64]),  # windows that start on a page boundary
    (0, [1, 9, 40, 64, 3]),
])
def test_paged_attention_window(window, lengths):
    """The plain version with a window against a dense masked softmax over
    each sequence's keys; the pages wholly before the window are the null
    page, which a window never reads."""
    g = torch.Generator().manual_seed(window + 1)
    B, H, Hkv, D, NP = len(lengths), 4, 2, 16, 16
    P = B * NP + 1
    kp, vp = torch.randn(P, PS, Hkv, D, generator=g), torch.randn(P, PS, Hkv, D, generator=g)
    kp[0] = vp[0] = 0
    q = torch.randn(B, H, D, generator=g)
    pt = torch.zeros(B, NP, dtype=torch.int32)
    for b, L in enumerate(lengths):
        lo = max(0, L - window) if window else 0
        for j in range(-(-L // PS)):
            if (j + 1) * PS > lo:
                pt[b, j] = 1 + b * NP + j
    ln = torch.tensor(lengths, dtype=torch.int32)
    got = paged_attention(q, kp, vp, pt, ln, window)
    for b, L in enumerate(lengths):
        lo = max(0, L - window) if window else 0
        rows = torch.arange(lo, L)
        ids = 1 + b * NP + rows // PS
        k, v = kp[ids, rows % PS], vp[ids, rows % PS]  # (n, Hkv, D)
        kh = k.repeat_interleave(H // Hkv, 1)
        vh = v.repeat_interleave(H // Hkv, 1)
        p = torch.softmax(torch.einsum("hd,nhd->hn", q[b], kh) / math.sqrt(D), -1)
        torch.testing.assert_close(got[b], torch.einsum("hn,nhd->hd", p, vh),
                                   rtol=1e-5, atol=1e-6)
    if window:  # the same as the masked plain version over every page
        pt_all = torch.where(torch.arange(NP)[None] * PS < ln[:, None],
                             1 + torch.arange(B)[:, None] * NP
                             + torch.arange(NP)[None], 0).int()
        torch.testing.assert_close(
            got, paged_attention_ref(q, kp, vp, pt_all, ln, window))
    with pytest.raises(ValueError, match="window"):
        paged_attention(q, kp, vp, pt, ln, -1)


def test_window_pool_releases_pages_and_swaps_the_live_keys():
    eng = _engine()
    c = eng.wcache
    assert c.layers == [0, 1, 2] and eng.cache.layers == [3]
    sid = c.new_seq()
    held, released = [], 0
    L = 0
    for n in [8, 8, 8, 1, 1, 1, 1, 1, 1, 8, 8] + [1] * 20:  # chunks, then decode
        released += c.trim()
        c.alloc_range(sid, L, L + n)
        held.append(int(np.count_nonzero(c.page_table[sid])))
        assert held[-1] <= window_pages(W, n, PS)
        for j in range(3):
            k = torch.arange(L, L + n, dtype=torch.float32)[:, None, None].expand(
                n, 2, 16)
            c.write_at(sid, j, k, -k, L)
        c.commit_prefill(sid, L + n)
        L += n
        assert c.live_from(sid) == max(0, L - W + 1)
    assert released + held[-1] == -(-L // PS)  # every page ever allocated
    assert c.free_pages() + held[-1] == c.num_pages - 1
    assert released > 0 and max(held) == window_pages(W, 8, PS)
    saved = c.swap_out(sid)
    assert saved["start"] == L - W + 1 and saved["k"][0].shape[0] == W - 1
    np.testing.assert_array_equal(saved["k"][1][:, 0, 0],
                                  np.arange(L - W + 1, L, dtype=np.float32))
    assert c.free_pages() == c.num_pages - 1
    sid2 = c.swap_in(saved, 1)
    assert sid2 == 1 and int(c.lengths[1]) == L
    k, v = c.gather_kv(1, 2, L, c.live_from(1))
    assert torch.equal(k[:, 0, 0], torch.arange(L - W + 1, L).float())
    assert torch.equal(v, -k)
    assert c.missing_pages(1, L + 1) == int(L % PS == 0)


def _engine(policy=NO_DROPS, **kw):
    model = init_params(MELLUM_TINY, seed=5, device="cpu")
    args = dict(max_seqs=4, max_len=128, page_size=PS, prefill_chunk=CHUNK,
                device="cpu", policy=policy)
    args.update(kw)
    return ServeEngine(MELLUM_TINY, model, **args)


PROMPTS = [(50, 30), (61, 20), (48, 26), (70, 10)]  # contexts 3-5 windows


def _serve(eng, preempt_at=None):
    """Serve PROMPTS; with ``preempt_at`` (step, request), preempt that
    request after that step. Returns each request's tokens."""
    rng = np.random.default_rng(3)
    rids = [eng.add_request(rng.integers(2, 256, n), m) for n, m in PROMPTS]
    n = 0
    while eng.step():
        n += 1
        if preempt_at and n == preempt_at[0]:
            eng._preempt(eng.requests[rids[preempt_at[1]]])
    return [eng.requests[r].generated for r in rids]


def test_engine_matches_the_full_forward_past_the_window():
    """Chunked prefill and paged decode through both pools give, at every
    served token, the logits of the model's full forward over the prompt
    and the served tokens (window masks and YaRN in its attention)."""
    eng = _engine()
    toks = _serve(eng)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(2, 256, n) for n, _ in PROMPTS]
    model = eng.params
    for p, t in zip(prompts, toks):
        ids = torch.as_tensor(list(p) + t[:-1])[None]
        with torch.inference_mode():
            lg = model(ids, NO_DROPS)[0, len(p) - 1:]
        assert lg.argmax(-1).tolist() == t
    s = eng.stats
    assert s.window_pages_released > 0
    assert 0 < s.window_pages_held < s.window_pages_all_keys
    assert s.window_seq_pages_max <= window_pages(W, CHUNK, PS)
    assert eng.cache.free_pages() == eng.cache.num_pages - 1
    assert eng.wcache.free_pages() == eng.wcache.num_pages - 1


def test_engine_logits_equal_the_forward_within_rounding():
    """One prompt of 75 tokens (over four windows) and 12 decode steps:
    the logits of each served token within fp32 rounding of the full
    forward's (sums taken in another order)."""
    eng = _engine()
    rng = np.random.default_rng(9)
    p = rng.integers(2, 256, 75)
    rid = eng.add_request(p, 12)
    seen = []
    real = eng.params.logits_out
    eng.params.logits_out = lambda x, *a, **k: seen.append(real(x, *a, **k)) or seen[-1]
    while eng.step():
        pass
    del eng.params.logits_out
    t = eng.requests[rid].generated
    with torch.inference_mode():
        lg = eng.params(torch.as_tensor(list(p) + t[:-1])[None], NO_DROPS)[0]
    got = torch.cat([x.reshape(-1, x.shape[-1])[-1:] for x in seen])
    torch.testing.assert_close(got, lg[len(p) - 1:], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("at", [(14, 1), (25, 0)])  # mid-prefill, decoding
def test_preempted_past_its_window_resumes_to_the_same_tokens(at):
    ref = _serve(_engine())
    eng = _engine()
    got = _serve(eng, preempt_at=at)
    assert eng.stats.preempted == eng.stats.resumed == 1
    assert got == ref
