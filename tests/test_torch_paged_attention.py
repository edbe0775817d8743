"""The port's paged_attention on CPU tensors (its plain version) against the
JAX package's Pallas kernel in interpret mode and its jnp oracle, on shared
numpy inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention import paged_attention as jax_paged
from repro.kernels.paged_attention import paged_attention_ref as jax_paged_ref
from repro_torch.kernels.paged_attention import paged_attention, paged_attention_ref

# as tests/test_kernels.py: fp32 and bf16 inputs, fp32 softmax inside
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
JAX_DTYPE = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _inputs(B, H, Hkv, D, P, PS, NP, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, D), np.float32)
    kp = rng.standard_normal((P, PS, Hkv, D), np.float32)
    vp = rng.standard_normal((P, PS, Hkv, D), np.float32)
    pt = rng.permutation(P)[:B * NP].reshape(B, NP).astype(np.int32)
    # lengths >= 1 with partial last pages: the full table less 3, then
    # random lengths over the table
    lengths = np.concatenate([[NP * PS - 3],
                              rng.integers(1, NP * PS + 1, B - 1)])
    return q, kp, vp, pt, lengths.astype(np.int32)


@pytest.mark.parametrize("B,H,Hkv,D,P,PS,NP", [
    (2, 8, 2, 64, 16, 16, 4),    # the three shapes of tests/test_kernels.py
    (3, 4, 4, 128, 32, 8, 6),
    (1, 16, 1, 64, 8, 32, 3),
    (3, 16, 2, 128, 40, 16, 12),  # GQA group of 8, PS = 16
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_paged_attention_matches_jax(B, H, Hkv, D, P, PS, NP, dtype):
    q, kp, vp, pt, lengths = _inputs(B, H, Hkv, D, P, PS, NP, seed=B * H + D)
    got = paged_attention(*(torch.from_numpy(a).to(dtype) for a in (q, kp, vp)),
                          torch.from_numpy(pt), torch.from_numpy(lengths))
    assert got.dtype == dtype and tuple(got.shape) == (B, H, D)
    jx = [jnp.asarray(a, JAX_DTYPE[dtype]) for a in (q, kp, vp)]
    jt = (jnp.asarray(pt), jnp.asarray(lengths))
    pallas = np.asarray(jax_paged(*jx, *jt, interpret=True), np.float32)
    oracle = np.asarray(jax_paged_ref(*jx, *jt), np.float32)
    got = got.float().numpy()
    np.testing.assert_allclose(got, pallas, atol=TOL[dtype])
    np.testing.assert_allclose(got, oracle, atol=TOL[dtype])


def test_paged_attention_reads_only_live_positions():
    """Values past a sequence's length, and pages past its last one, do not
    change the result."""
    q, kp, vp, pt, lengths = _inputs(2, 8, 2, 32, 16, 8, 4, seed=7)
    lengths[:] = [13, 25]
    args = [torch.from_numpy(a) for a in (q, kp, vp, pt, lengths)]
    want = paged_attention(*args)
    for b, n in enumerate(lengths):
        live = set(pt[b, :-(-n // 8)].tolist())
        for p in set(range(16)) - live - {int(x) for x in pt[1 - b]}:
            args[1][p] = 1e3  # poison every page neither sequence reads
            args[2][p] = -1e3
        last = int(pt[b, (n - 1) // 8])
        args[1][last, n % 8 or 8:] = 1e3  # and the dead tail of the last page
    torch.testing.assert_close(paged_attention(*args), want, rtol=0, atol=0)


def test_paged_attention_rejects_bad_arguments():
    q = torch.zeros(2, 6, 16)
    pool = torch.zeros(4, 8, 4, 16)
    pt = torch.zeros(2, 3, dtype=torch.int32)
    ln = torch.ones(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple"):
        paged_attention(q, pool, pool, pt, ln)
    with pytest.raises(TypeError, match="fp32 or bf16"):
        paged_attention(q[:, :4].double(), pool.double(), pool.double(), pt, ln)
    with pytest.raises(ValueError, match="page_table"):
        paged_attention(q[:, :4], pool, pool, pt[:1], ln)


def test_ref_is_the_oracle_on_gathered_pages():
    """paged_attention_ref equals plain softmax attention over each
    sequence's gathered live tokens."""
    q, kp, vp, pt, lengths = _inputs(2, 4, 2, 16, 12, 4, 5, seed=3)
    out = paged_attention_ref(*(torch.from_numpy(a)
                                for a in (q, kp, vp, pt, lengths))).numpy()
    for b in range(2):
        n = int(lengths[b])
        k = kp[pt[b]].reshape(-1, 2, 16)[:n]
        v = vp[pt[b]].reshape(-1, 2, 16)[:n]
        for h in range(4):
            s = k[:, h // 2] @ q[b, h] / 4.0
            p = np.exp(s - s.max())
            np.testing.assert_allclose(out[b, h], (p / p.sum()) @ v[:, h // 2],
                                       atol=1e-5)
