"""The port's flash attention on the CPU: its plain version against the JAX
package's Pallas kernel (interpret mode) and oracle on the same numpy
inputs, against the port's blocked model attention, and the wrapper's checks.

Tolerances are tests/test_kernels.py's: 2e-5 in fp32, 2e-2 in bf16. The
Pallas kernel casts v to fp32, so it keeps the probabilities in fp32 for
P V, as the plain version does; the CUDA tensor-core kernel for bf16 rounds
them to bf16 (its operand type), and a plain mirror of that arithmetic is
held here against the Pallas kernel within the bf16 tolerance. The fp32
kernel (and bf16 at D = 32) takes each product as three TF32 products of
hi/lo pieces (3xTF32); a plain mirror of that arithmetic is held here to
the Pallas kernel within the same tolerances, and one TF32 product alone is
shown to miss the fp32 one."""
import functools
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


QK = "bqnpd,bknd->bnpqk"  # scores of q (B,Sq,N,P,D) and k (B,Sk,N,D)
PV = "bnpqk,bknd->bnpqd"  # probabilities times v (B,Sk,N,D)


def _flash_mirror(q, k, v, causal, window, block_k, scores, pv):
    """The online softmax of the CUDA kernels, in plain torch: key tiles of
    ``block_k`` (the last zero-padded), ``scores(q, k_tile)`` scaled after
    the product and masked with -1e30, a row that has seen no key taken
    against 0, acc += ``pv(p, v_tile)`` while l sums the fp32 P, and
    acc / max(l, 1e-30) in q's dtype."""
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    nk = -(-Sk // block_k) * block_k
    qf = q.float().reshape(B, Sq, Hkv, H // Hkv, D)
    kf = torch.zeros(B, nk, Hkv, D)
    vf = torch.zeros(B, nk, Hkv, D)
    kf[:, :Sk], vf[:, :Sk] = k.float(), v.float()
    qpos = torch.arange(Sq)[:, None]
    m = torch.full((B, Hkv, H // Hkv, Sq, 1), -1e30)
    l = torch.zeros_like(m)
    acc = torch.zeros(B, Hkv, H // Hkv, Sq, D)
    for k0 in range(0, nk, block_k):
        kpos = torch.arange(k0, k0 + block_k)[None, :]
        s = scores(qf, kf[:, k0:k0 + block_k]) * (1.0 / math.sqrt(D))
        ok = (kpos < Sk).expand(Sq, block_k)
        if causal:
            ok = ok & (kpos <= qpos)
        if window > 0:
            ok = ok & (kpos > qpos - window)
        s = torch.where(ok, s, -1e30)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        ref = torch.where(m_new > -1e30, m_new, 0.0)
        alpha = torch.exp(m - ref)
        p = torch.exp(s - ref)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + pv(p, vf[:, k0:k0 + block_k])
        m = m_new
    out = acc / l.clamp_min(1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D).to(q.dtype)


def _flash_bf16_mirror(q, k, v, causal, window, block_k=64):
    """A plain mirror of the bf16 tensor-core kernel's arithmetic: fp32
    scores of the bf16 inputs, P rounded to bf16 before P V (its operand
    type), fp32 accumulation."""
    return _flash_mirror(
        q, k, v, causal, window, block_k,
        lambda a, b: torch.einsum(QK, a, b),
        lambda p, w: torch.einsum(PV, p.to(torch.bfloat16).float(), w))


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


# csrc/flash_attention.cu: keys per K/V tile (Cfg::BK) at each head dim
KEY_TILE = {32: 64, 64: 64, 128: 32, 256: 32}
# TF32 products of Q K^T and of P V as (A has a lo piece, B has one): each
# product takes 1 + A_LO + B_LO (mma3 in csrc/flash_attention.cu)
PRODUCTS = {"float32": ((True, True), (True, True)),     # 3 and 3
            "bfloat16": ((False, False), (True, False)),  # 1 and 2
            "one_tf32": ((False, False), (False, False))}  # 1 and 1
# the file's fp32 cases: (B, Sq, Sk, H, Hkv, D, window, causal)
FP32_CASES = ([(B, S, S, H, Hkv, D, w, True)
               for B, S, H, Hkv, D in [(2, 256, 8, 2, 64), (1, 512, 4, 4, 128),
                                       (2, 128, 16, 1, 64),
                                       (1, 256, 6, 2, 128)]
               for w in (0, 64)]
              + [(1, 128, 256, 4, 2, 64, 0, True),
                 (1, 128, 256, 4, 2, 64, 64, True),
                 (2, 64, 192, 2, 1, 32, 0, False),
                 (1, 128, 256, 4, 2, 64, 64, False),
                 (1, 256, 128, 4, 2, 64, 0, True),
                 (1, 256, 128, 4, 1, 128, 0, False),
                 (1, 192, 128, 6, 3, 32, 128, True)])


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The mirrors are small: one intra-op thread per process keeps
    parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tf32(x):
    """TF32 rounding as cvt.rna.tf32.f32: to nearest, ties away from zero,
    on the fp32 bit pattern, the low 13 mantissa bits cleared."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split(x):
    """x as TF32 pieces hi + lo, |x - hi - lo| <= 2^-22 |x|."""
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _tf32_product(eq, a, b, a_lo, b_lo):
    """The einsum ``eq`` of a and b as the kernel's mma3 takes it: hi_a hi_b
    plus the small products, lo_a hi_b where a_lo and hi_a lo_b where b_lo,
    summed apart; each product of TF32 pieces is exact in fp32 and summed in
    fp32."""
    (ah, al), (bh, bl) = _split(a), _split(b)
    small = torch.zeros(())
    if a_lo:
        small = small + torch.einsum(eq, al, bh)
    if b_lo:
        small = small + torch.einsum(eq, ah, bl)
    return torch.einsum(eq, ah, bh) + small


def _pv_key_order():
    """The key each k slot of the kernel's P V takes within an 8-key tile: a
    lane (g, t) holds S columns 2t and 2t + 1 (the m16n8 fp32 accumulator)
    and hands them on as the A fragment's k slots t and t + 4 (m16n8k8 TF32),
    so slot t is key 2t and slot t + 4 key 2t + 1; V's rows are read in the
    same order."""
    order = [0] * 8
    for t in range(4):
        order[t], order[t + 4] = 2 * t, 2 * t + 1
    return order


def _flash_tf32_mirror(q, k, v, causal, window, products, key_order=None):
    """A plain mirror of csrc/flash_attention.cu's arithmetic: S = Q K^T and
    P V from TF32 pieces (``products`` of PRODUCTS) over key tiles of the
    kernel's size, the keys of each 8-key tile of P V in ``key_order``."""
    (qk_a, qk_b), (pv_a, pv_b) = products
    bk = KEY_TILE[q.shape[3]]
    perm = torch.arange(bk)
    if key_order is not None:
        perm = perm // 8 * 8 + torch.tensor(key_order).repeat(bk // 8)
    return _flash_mirror(
        q, k, v, causal, window, bk,
        lambda a, b: _tf32_product(QK, a, b, qk_a, qk_b),
        lambda p, w: _tf32_product(PV, p[..., perm], w[:, perm], pv_a, pv_b))


@functools.cache
def _case(B, Sq, Sk, H, Hkv, D, window, causal, dtype):
    """Inputs of a case and the Pallas kernel's (interpret) output on them."""
    (jq, jk, jv), tx = _inputs(B, Sq, Sk, H, Hkv, D, dtype)
    pallas = jax_flash(jq, jk, jv, causal=causal, window=window,
                       block_q=BLOCK, block_k=BLOCK, interpret=True)
    return tx, _f32(pallas)


@pytest.mark.parametrize("B,Sq,Sk,H,Hkv,D,window,causal", FP32_CASES)
def test_tf32_mirror_matches_pallas_fp32(B, Sq, Sk, H, Hkv, D, window,
                                         causal):
    """Three TF32 products a product, in both S = Q K^T and P V, keep the
    fp32 kernel within the fp32 tolerance of the Pallas kernel and of the
    plain version."""
    (tq, tk, tv), pallas = _case(B, Sq, Sk, H, Hkv, D, window, causal,
                                 "float32")
    got = _flash_tf32_mirror(tq, tk, tv, causal, window, PRODUCTS["float32"])
    assert got.dtype == torch.float32 and got.shape == (B, Sq, H, D)
    np.testing.assert_allclose(_f32(got), pallas, atol=TOL["float32"])
    plain = flash_attention_ref(tq, tk, tv, causal=causal, window=window)
    np.testing.assert_allclose(_f32(got), _f32(plain), atol=TOL["float32"])


@pytest.mark.parametrize("B,Sq,Sk,H,Hkv,D,window,causal",
                         [c for c in BF16_CASES if c[5] == 32])
def test_tf32_mirror_matches_pallas_bf16_d32(B, Sq, Sk, H, Hkv, D, window,
                                             causal):
    """bf16 at D = 32 takes one TF32 product in Q K^T and two in P V: a bf16
    value is exact in TF32, so the products dropped are exactly 0."""
    (tq, tk, tv), pallas = _case(B, Sq, Sk, H, Hkv, D, window, causal,
                                 "bfloat16")
    for x in (tq, tk, tv):
        assert not _split(x.float())[1].any()
    got = _flash_tf32_mirror(tq, tk, tv, causal, window, PRODUCTS["bfloat16"])
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(got), pallas, atol=TOL["bfloat16"])
    assert torch.equal(got, _flash_tf32_mirror(tq, tk, tv, causal, window,
                                               PRODUCTS["float32"]))


def test_one_tf32_product_misses_fp32_tolerance():
    """A single TF32 product (hi x hi) misses 2e-5 where 3xTF32 meets it:
    the tolerance needs the split."""
    case = (1, 512, 512, 4, 4, 128, 0, True)
    (tq, tk, tv), pallas = _case(*case, "float32")
    one = _flash_tf32_mirror(tq, tk, tv, True, 0, PRODUCTS["one_tf32"])
    three = _flash_tf32_mirror(tq, tk, tv, True, 0, PRODUCTS["float32"])
    err_one = np.abs(_f32(one) - pallas).max()
    err_three = np.abs(_f32(three) - pallas).max()
    assert err_three <= TOL["float32"] < err_one, (err_three, err_one)


@pytest.mark.parametrize("B,Sq,Sk,H,Hkv,D,window,causal",
                         [(1, 256, 128, 4, 1, 128, 0, False),
                          (1, 192, 128, 6, 3, 32, 128, True)])
def test_pv_key_order(B, Sq, Sk, H, Hkv, D, window, causal):
    """P V over each 8-key tile in the kernel's slot order (keys 0, 2, 4, 6,
    1, 3, 5, 7: a lane's own S columns, no shuffle) gives the key-order
    result within 2e-5."""
    order = _pv_key_order()
    assert order == [0, 2, 4, 6, 1, 3, 5, 7]
    (tq, tk, tv), pallas = _case(B, Sq, Sk, H, Hkv, D, window, causal,
                                 "float32")
    got = _flash_tf32_mirror(tq, tk, tv, causal, window, PRODUCTS["float32"],
                             key_order=order)
    want = _flash_tf32_mirror(tq, tk, tv, causal, window,
                              PRODUCTS["float32"])
    np.testing.assert_allclose(_f32(got), _f32(want), atol=TOL["float32"])
    np.testing.assert_allclose(_f32(got), pallas, atol=TOL["float32"])


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
