"""The port's flash attention on the CPU: its plain version against the JAX
package's Pallas kernel (interpret mode) and oracle on the same numpy
inputs, against the port's blocked model attention, and the wrapper's checks.

Tolerances are tests/test_kernels.py's: 2e-5 in fp32, 2e-2 in bf16. The
Pallas kernel casts v to fp32, so it keeps the probabilities in fp32 for
P V, as the plain version does; the CUDA tensor-core kernel for bf16 rounds
them to bf16 (its operand type), and a plain mirror of that arithmetic is
held here against the Pallas kernel within the bf16 tolerance."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.flash_attention import flash_attention_ref as jax_flash_ref
from repro_torch.kernels.flash_attention import (
    flash_attention,
    flash_attention_ref,
)
from repro_torch.models.attention import _blocked_causal

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JAX_DTYPE = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}
BLOCK = 64


def _inputs(B, Sq, Sk, H, Hkv, D, dtype, seed=0):
    """The same q, k, v as JAX arrays and torch tensors: fp32 numpy draws,
    rounded to bf16 the same way by both frameworks."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Sq, H, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D))]
    jx = [jnp.asarray(a, JAX_DTYPE[dtype]) for a in arrs]
    tx = [torch.from_numpy(a).to(TORCH_DTYPE[dtype]) for a in arrs]
    for j, t in zip(jx, tx):  # identical values on both sides
        np.testing.assert_array_equal(np.asarray(j, np.float32),
                                      t.float().numpy())
    return jx, tx


def _f32(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor) else x,
                      np.float32)


def _check(B, Sq, Sk, H, Hkv, D, dtype, window, causal):
    (jq, jk, jv), (tq, tk, tv) = _inputs(B, Sq, Sk, H, Hkv, D, dtype)
    got = flash_attention_ref(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == TORCH_DTYPE[dtype]
    assert got.shape == (B, Sq, H, D)
    pallas = jax_flash(jq, jk, jv, causal=causal, window=window,
                       block_q=BLOCK, block_k=BLOCK, interpret=True)
    oracle = jax_flash_ref(jq, jk, jv, causal=causal, window=window)
    np.testing.assert_allclose(_f32(got), _f32(pallas), atol=TOL[dtype])
    np.testing.assert_allclose(_f32(got), _f32(oracle), atol=TOL[dtype])
    # on a CPU tensor the wrapper is the plain version, and launches nothing
    before = flash_attention.launches
    wrapped = flash_attention(tq, tk, tv, causal=causal, window=window)
    assert torch.equal(wrapped, got)
    assert flash_attention.launches == before


@pytest.mark.parametrize("B,S,H,Hkv,D", [
    (2, 256, 8, 2, 64),
    (1, 512, 4, 4, 128),
    (2, 128, 16, 1, 64),
    (1, 256, 6, 2, 128),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 64])
def test_plain_matches_pallas_and_oracle(B, S, H, Hkv, D, dtype, window):
    """tests/test_kernels.py's 16 cases (causal)."""
    _check(B, S, S, H, Hkv, D, dtype, window, causal=True)


# Sq != Sk, both ways, at block multiples; the mask stays top-left. Held
# where every row sees a key (a window row past Sk + window - 1 has none).
@pytest.mark.parametrize("B,Sq,Sk,H,Hkv,D,window,causal", [
    (1, 128, 256, 4, 2, 64, 0, True),
    (1, 128, 256, 4, 2, 64, 64, True),
    (2, 64, 192, 2, 1, 32, 0, False),
    (1, 128, 256, 4, 2, 64, 64, False),
    (1, 256, 128, 4, 2, 64, 0, True),
    (1, 256, 128, 4, 1, 128, 0, False),
    (1, 192, 128, 6, 3, 32, 128, True),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_uneven_lengths(B, Sq, Sk, H, Hkv, D, window,
                                             causal, dtype):
    assert not (window and Sq > Sk + window - 1)
    _check(B, Sq, Sk, H, Hkv, D, dtype, window, causal)


def _flash_bf16_mirror(q, k, v, causal, window, block_k=64):
    """A plain mirror of the bf16 tensor-core kernel's arithmetic: fp32
    scores of the bf16 inputs scaled after the product, an online softmax
    over key tiles of ``block_k``, P rounded to bf16 before P V while l sums
    the fp32 P, fp32 accumulation, a row that has seen no key taken against
    0, and acc / max(l, 1e-30) rounded to bf16."""
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    qf = q.float().reshape(B, Sq, Hkv, H // Hkv, D)
    kf, vf = k.float(), v.float()
    qpos = torch.arange(Sq)[:, None]
    m = torch.full((B, Hkv, H // Hkv, Sq, 1), -1e30)
    l = torch.zeros_like(m)
    acc = torch.zeros(B, Hkv, H // Hkv, Sq, D)
    for k0 in range(0, Sk, block_k):
        kpos = torch.arange(k0, min(k0 + block_k, Sk))[None, :]
        s = torch.einsum("bqnpd,bknd->bnpqk", qf,
                         kf[:, k0:k0 + block_k]) / math.sqrt(D)
        ok = torch.ones(Sq, kpos.shape[1], dtype=torch.bool)
        if causal:
            ok &= kpos <= qpos
        if window > 0:
            ok &= kpos > qpos - window
        s = torch.where(ok, s, -1e30)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        ref = torch.where(m_new > -1e30, m_new, 0.0)
        alpha = torch.exp(m - ref)
        p = torch.exp(s - ref)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.einsum(
            "bnpqk,bknd->bnpqd", p.to(torch.bfloat16).float(),
            vf[:, k0:k0 + block_k])
        m = m_new
    out = acc / l.clamp_min(1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D).to(torch.bfloat16)


# the bf16 cases of the tests above: (B, Sq, Sk, H, Hkv, D, window, causal)
BF16_CASES = (
    [(B, S, S, H, Hkv, D, w, True)
     for B, S, H, Hkv, D in [(2, 256, 8, 2, 64), (1, 512, 4, 4, 128),
                             (2, 128, 16, 1, 64), (1, 256, 6, 2, 128)]
     for w in (0, 64)]
    + [(1, 128, 256, 4, 2, 64, 0, True), (1, 128, 256, 4, 2, 64, 64, True),
       (2, 64, 192, 2, 1, 32, 0, False), (1, 128, 256, 4, 2, 64, 64, False),
       (1, 256, 128, 4, 2, 64, 0, True), (1, 256, 128, 4, 1, 128, 0, False),
       (1, 192, 128, 6, 3, 32, 128, True)])


@pytest.mark.parametrize("B,Sq,Sk,H,Hkv,D,window,causal", BF16_CASES)
def test_bf16_rounded_p_stays_within_tolerance(B, Sq, Sk, H, Hkv, D, window,
                                               causal):
    """Rounding P to bf16 before P V, as the tensor-core kernel does, stays
    within the bf16 tolerance of the Pallas kernel (interpret), which keeps
    P in fp32."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(B, Sq, Sk, H, Hkv, D, "bfloat16")
    got = _flash_bf16_mirror(tq, tk, tv, causal, window)
    pallas = jax_flash(jq, jk, jv, causal=causal, window=window,
                       block_q=BLOCK, block_k=BLOCK, interpret=True)
    np.testing.assert_allclose(_f32(got), _f32(pallas), atol=TOL["bfloat16"])
    # the rounding moves the result: the mirror is not the plain version
    plain = flash_attention_ref(tq, tk, tv, causal=causal, window=window)
    assert not torch.equal(got, plain)


def test_plain_matches_model_blocked_path():
    """The plain version and the port's blocked model attention agree, as
    tests/test_kernels.py holds the Pallas kernel to the JAX model's."""
    B, S, N, P, D = 1, 256, 2, 3, 32
    _, (q, k, v) = _inputs(B, S, S, N * P, N, D, "float32", seed=4)
    blocked = _blocked_causal(q.reshape(B, S, N, P, D), k, v, 64, 64, 0)
    np.testing.assert_allclose(
        blocked.reshape(B, S, N * P, D).numpy(),
        flash_attention(q, k, v).numpy(), atol=2e-5)


def test_window_covering_everything_is_plain_causal():
    _, (q, k, v) = _inputs(1, 96, 96, 4, 2, 32, "float32", seed=5)
    np.testing.assert_array_equal(
        flash_attention_ref(q, k, v, window=96).numpy(),
        flash_attention_ref(q, k, v).numpy())


@pytest.mark.parametrize("q_shape,kv_shape,dtypes,match", [
    ((1, 8, 4, 48), (1, 8, 2, 48), ("float32",) * 3, "head dim"),
    ((1, 8, 6, 32), (1, 8, 4, 32), ("float32",) * 3, "multiple"),
    ((1, 8, 4, 32), (1, 8, 2, 64), ("float32",) * 3, "do not fit"),
    ((2, 8, 4, 32), (1, 8, 2, 32), ("float32",) * 3, "do not fit"),
    ((1, 8, 4, 32), (1, 8, 2, 32), ("float32", "bfloat16", "float32"),
     "share"),
    ((8, 4, 32), (1, 8, 2, 32), ("float32",) * 3, "B,Sq,H,D"),
])
def test_wrapper_rejects_bad_inputs(q_shape, kv_shape, dtypes, match):
    q = torch.zeros(q_shape, dtype=TORCH_DTYPE[dtypes[0]])
    k = torch.zeros(kv_shape, dtype=TORCH_DTYPE[dtypes[1]])
    v = torch.zeros(kv_shape, dtype=TORCH_DTYPE[dtypes[2]])
    with pytest.raises((ValueError, TypeError), match=match):
        flash_attention(q, k, v)
