"""The port's paged_attention on CPU tensors (its plain version) against the
JAX package's Pallas kernel in interpret mode and its jnp oracle, on shared
numpy inputs; and a plain mirror of the CUDA kernel's split-sequence
arithmetic (partials per chunk, then the combining pass) against both."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention import paged_attention as jax_paged
from repro.kernels.paged_attention import paged_attention_ref as jax_paged_ref
from repro_torch.kernels.paged_attention import paged_attention, paged_attention_ref
from repro_torch.kernels.paged_attention.ops import CHUNK, split_plan

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


def _split_combine(q, kp, vp, pt, lengths, chunk):
    """A plain mirror of the CUDA kernel's two passes: each chunk of
    ``chunk`` tokens below the length gives a partial (m, l, acc) in fp32
    (pass 1), and the live chunks combine as M = max m_s, L = sum l_s
    e^(m_s - M), out = sum acc_s e^(m_s - M) / max(L, 1e-30) (pass 2).
    Chunks at or past the length are empty and never read."""
    B, H, D = q.shape
    _, PS, Hkv, _ = kp.shape
    NP = pt.shape[1]
    group = H // Hkv
    out = np.zeros((B, H, D), np.float32)
    for b in range(B):
        n = min(int(lengths[b]), NP * PS)
        k = kp[pt[b]].reshape(NP * PS, Hkv, D).astype(np.float32)
        v = vp[pt[b]].reshape(NP * PS, Hkv, D).astype(np.float32)
        for h in range(H):
            parts = []
            for t0 in range(0, n, chunk):  # the live chunks only
                t1 = min(t0 + chunk, n)
                s = (k[t0:t1, h // group] @ q[b, h].astype(np.float32)
                     ) * np.float32(1 / np.sqrt(D))
                m = s.max()
                p = np.exp(s - m)
                parts.append((m, p.sum(), p @ v[t0:t1, h // group]))
            if not parts:
                continue  # length 0: zeros
            M = max(m for m, _, _ in parts)
            L = sum(l * np.exp(m - M) for m, l, _ in parts)
            acc = sum(a * np.exp(m - M) for m, _, a in parts)
            out[b, h] = acc / max(L, 1e-30)
    return out


@pytest.mark.parametrize("chunk", ["PS", "2PS", "NP*PS"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_split_combine_matches_ref_and_pallas(chunk, dtype):
    """The split kernel's arithmetic at lengths on and next to the chunk
    boundaries, with empty chunks after each sequence's last, against the
    plain version and the Pallas kernel (interpret)."""
    B, H, Hkv, D, P, PS, NP = 6, 8, 2, 32, 50, 8, 8
    C = {"PS": PS, "2PS": 2 * PS, "NP*PS": NP * PS}[chunk]
    q, kp, vp, pt, _ = _inputs(B, H, Hkv, D, P, PS, NP, seed=C)
    lengths = np.clip([1, C - 1, C, C + 1, 2 * C + 1, NP * PS], 1,
                      NP * PS).astype(np.int32)
    # round through the input dtype, as the kernel reads the pools
    q, kp, vp = (torch.from_numpy(a).to(dtype).float().numpy()
                 for a in (q, kp, vp))
    got = _split_combine(q, kp, vp, pt, lengths, C)
    targs = [torch.from_numpy(a) for a in (q, kp, vp, pt, lengths)]
    ref = paged_attention_ref(*targs).numpy()
    jx = [jnp.asarray(a) for a in (q, kp, vp, pt, lengths)]
    pallas = np.asarray(jax_paged(*jx, interpret=True), np.float32)
    np.testing.assert_allclose(got, ref, atol=TOL[torch.float32])
    np.testing.assert_allclose(got, pallas, atol=TOL[torch.float32])


def test_split_combine_gives_zeros_at_length_zero():
    """Pass 2 over no live chunk: M = NEG_INF, L = 0, so zeros, as the
    Pallas kernel gives."""
    q, kp, vp, pt, _ = _inputs(2, 4, 2, 16, 12, 4, 5, seed=9)
    lengths = np.array([0, 7], np.int32)
    got = _split_combine(q, kp, vp, pt, lengths, 8)
    assert not got[0].any()
    pallas = np.asarray(jax_paged(*(jnp.asarray(a) for a in
                                    (q, kp, vp, pt, lengths)),
                                  interpret=True), np.float32)
    np.testing.assert_allclose(got, pallas, atol=TOL[torch.float32])


@pytest.mark.parametrize("B,H,D,PS,NP", [
    (8, 32, 128, 16, 128),  # yi-6b's decode shape in the serve phase
    (3, 4, 128, 8, 6),
    (1, 16, 64, 32, 3),
    (2, 4, 16, 7, 11),      # a page size that does not divide the chunk
])
def test_split_plan_covers_every_position(B, H, D, PS, NP):
    S, numel = split_plan(B, H, D, PS, NP)
    chunks = np.arange(NP * PS) // CHUNK
    assert chunks.max() == S - 1  # every position has a chunk, none is spare
    assert numel == B * H * S * (D + 2)  # acc[D], m and l per chunk
