"""Plain PyTorch version of flash attention (GQA, causal, sliding window)."""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.common import NEG_INF


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B,Sq,H,D); k,v: (B,Sk,Hkv,D); H % Hkv == 0, query head h reads
    kv head h // (H // Hkv). Returns (B,Sq,H,D) in q's dtype.

    All arithmetic in fp32. Positions count from 0 in both sequences, so the
    causal mask ``kpos <= qpos`` is top-left aligned also when Sq != Sk;
    ``window > 0`` keeps ``kpos > qpos - window``. A row with no visible key
    gets the mean of v over all keys."""
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    qf = q.float().reshape(B, Sq, Hkv, H // Hkv, D)
    logits = torch.einsum("bqnpd,bknd->bnpqk", qf, k.float()) / math.sqrt(D)
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    ok = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        ok &= kpos <= qpos
    if window > 0:
        ok &= kpos > qpos - window
    logits = torch.where(ok, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bnpqk,bknd->bqnpd", probs, v.float())
    return out.reshape(B, Sq, H, D).to(q.dtype)
