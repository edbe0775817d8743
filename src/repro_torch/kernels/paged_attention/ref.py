"""Plain PyTorch version of paged decode attention."""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.common import NEG_INF


def paged_attention_ref(q, k_pool, v_pool, page_table, lengths, window=0):
    """q: (B,H,D); pools: (P, PS, Hkv, D); page_table: (B, NP) int32;
    lengths: (B,) tokens valid per sequence, of which a ``window`` > 0 keeps
    the last ``window``. Returns (B,H,D) in q's dtype.

    Gathers each sequence's pages, then masked softmax attention in fp32;
    query head h reads kv head h // (H // Hkv). At length 0 every position
    is masked and the result is the mean of v over the gathered pages."""
    B, H, D = q.shape
    _, PS, Hkv, _ = k_pool.shape
    NP = page_table.shape[1]
    group = H // Hkv
    pt = page_table.long()
    k = k_pool[pt].reshape(B, NP * PS, Hkv, D).float()
    v = v_pool[pt].reshape(B, NP * PS, Hkv, D).float()
    qf = q.float().reshape(B, Hkv, group, D)
    logits = torch.einsum("bngd,bknd->bngk", qf, k) / math.sqrt(float(D))
    pos = torch.arange(NP * PS, device=q.device)[None, :]
    ln = lengths.to(q.device)[:, None]
    ok = pos < ln
    if window > 0:
        ok &= pos >= ln - window
    logits = torch.where(ok[:, None, None, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bngk,bknd->bngd", probs, v)
    return out.reshape(B, H, D).to(q.dtype)
