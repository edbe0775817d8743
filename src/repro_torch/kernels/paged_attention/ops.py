"""Paged decode attention: CUDA kernel (csrc/paged_attention.cu) on the card,
plain PyTorch on the CPU.

The kernel splits each sequence into chunks of :data:`CHUNK` tokens, one
block per (sequence, kv head, chunk), and a second pass combines the
chunks' partial softmax states; :func:`split_plan` sizes both."""
from __future__ import annotations

import torch

from repro_torch.kernels.common import (
    check_launch,
    library,
    require_cuda_tensor,
    stream_of,
)
from repro_torch.kernels.paged_attention.ref import paged_attention_ref

_ENTRY = {torch.float32: "paged_attention_f32",
          torch.bfloat16: "paged_attention_bf16"}
HEAD_DIMS = (16, 32, 64, 128, 256)
CHUNK = 64  # tokens per pass-1 block; csrc/paged_attention.cu's CHUNK


def split_plan(B: int, H: int, D: int, PS: int, NP: int) -> tuple:
    """(splits, scratch numel) of the kernel for these shapes: S chunks of
    CHUNK tokens cover the NP * PS positions a page table can address, and
    the scratch holds each (sequence, query head, chunk)'s fp32 partial
    ``acc[D]`` and ``(m, l)``. Host arithmetic only: no device sync."""
    S = -(-(NP * PS) // CHUNK)
    return S, B * H * S * (D + 2)


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, page_table: torch.Tensor,
                    lengths: torch.Tensor, window: int = 0) -> torch.Tensor:
    """Decode attention, one query token per sequence, over a paged KV pool.

    q: (B,H,D); k_pool/v_pool: (P,PS,Hkv,D), fp32 or bf16 like q;
    page_table: (B,NP) int32, the pool page of each sequence's j-th
    PS-token block, 0 (the null page) past its allocated pages; lengths:
    (B,) int32, the tokens each sequence attends to; with ``window`` > 0
    only its last ``window`` of them (a sliding-window layer: positions
    before ``length - window`` are not read, so their pages may be the null
    page). Query head h reads kv head h // (H // Hkv). Returns (B,H,D) in
    q's dtype.

    Lengths must be >= 1 for the two devices to agree: at length 0 the
    kernel returns zeros (as the JAX package's Pallas kernel does) and the
    plain version the mean of v. Positions past NP * PS are not read.

    CPU tensors run :func:`paged_attention_ref`. CUDA tensors must be
    contiguous and on one card, the pools 16-byte aligned, D one of
    :data:`HEAD_DIMS`; the kernel's two passes run on the current stream,
    without synchronizing, over scratch from one ``torch.empty``, and
    ``paged_attention.launches`` counts the call. Page ids are not checked
    on the card: each must lie in [0, P)."""
    if q.dim() != 3 or k_pool.dim() != 4:
        raise ValueError(f"q must be (B,H,D) and the pools (P,PS,Hkv,D), got "
                         f"{tuple(q.shape)} and {tuple(k_pool.shape)}")
    B, H, D = q.shape
    P, PS, Hkv, Dk = k_pool.shape
    NP = page_table.shape[-1]
    if tuple(v_pool.shape) != tuple(k_pool.shape) or Dk != D:
        raise ValueError(f"pools {tuple(k_pool.shape)}, {tuple(v_pool.shape)} "
                         f"do not fit q {tuple(q.shape)}")
    if H % Hkv:
        raise ValueError(f"H={H} is not a multiple of Hkv={Hkv}")
    if tuple(page_table.shape) != (B, NP) or tuple(lengths.shape) != (B,):
        raise ValueError(f"page_table must be ({B}, NP) and lengths ({B},), "
                         f"got {tuple(page_table.shape)}, {tuple(lengths.shape)}")
    if q.dtype not in _ENTRY or k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise TypeError(f"q and pools must share fp32 or bf16, got {q.dtype}, "
                        f"{k_pool.dtype}, {v_pool.dtype}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pool, v_pool, page_table, lengths,
                                   window)
    for name, t, dt, nd in (("q", q, q.dtype, 3), ("k_pool", k_pool, q.dtype, 4),
                            ("v_pool", v_pool, q.dtype, 4),
                            ("page_table", page_table, torch.int32, 2),
                            ("lengths", lengths, torch.int32, 1)):
        require_cuda_tensor(t, name, dt, nd)
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim D={D} is not one of {HEAD_DIMS}")
    if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError("the pools must start on a 16-byte boundary")
    out = torch.empty_like(q)
    S, numel = split_plan(B, H, D, PS, NP)
    part = torch.empty(numel, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = library().fns[_ENTRY[q.dtype]](
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            part.data_ptr(), B, H, Hkv, D, PS, NP, S, int(window),
            stream_of(q))
    check_launch("paged_attention", err)
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
