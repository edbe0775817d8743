"""Flash attention forward: CUDA kernels on the card, plain PyTorch on the CPU.

bf16 at D in {64, 128, 256} runs csrc/flash_attention_sm90.cu (TMA, wgmma);
fp32, and bf16 at D = 32, csrc/flash_attention.cu (mma.sync on TF32 pieces,
three products a fp32 product: 3xTF32). Both are on the tensor cores."""
from __future__ import annotations

import torch

from repro_torch.kernels.common import (
    check_launch,
    library,
    require_cuda_tensor,
    stream_of,
)
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

_ENTRY = {torch.float32: "flash_attention_f32",
          torch.bfloat16: "flash_attention_bf16"}
HEAD_DIMS = (32, 64, 128, 256)
SM90_HEAD_DIMS = (64, 128, 256)  # bf16 on the tensor cores


def _entry(dtype: torch.dtype, D: int) -> str:
    """The C entry point that takes these inputs on the card."""
    if dtype == torch.bfloat16 and D in SM90_HEAD_DIMS:
        return "flash_attention_bf16_sm90"
    return _ENTRY[dtype]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """Prefill attention forward over grouped-query heads.

    q: (B,Sq,H,D); k,v: (B,Sk,Hkv,D), fp32 or bf16 like q, D in
    {32, 64, 128, 256}; query head h reads kv head h // (H // Hkv). Scale
    1/sqrt(D); the causal mask ``kpos <= qpos`` is top-left aligned also when
    Sq != Sk; ``window > 0`` keeps ``kpos > qpos - window``. Returns
    (B,Sq,H,D) in q's dtype. Any Sq, Sk >= 1: the JAX package's Pallas
    kernel takes only multiples of its blocks.

    A row with no visible key (only where window > 0, at rows
    i >= Sk + window - 1) differs between the devices: the kernel gives it
    zeros, the plain version the mean of v over all keys. In bf16 at D >= 64
    the kernel rounds the probabilities to bf16 before P V (the tensor
    cores' operand type); the plain version, the fp32/D = 32 kernel and the
    JAX package's Pallas kernel keep them in fp32 (that kernel splits them
    into two TF32 pieces, and fp32 q, k, v into two each, so its products
    keep fp32 accuracy).

    CPU tensors run :func:`flash_attention_ref`. CUDA tensors must be
    contiguous, 16-byte aligned and on one card; the kernel runs on the
    current stream, without synchronizing, and ``flash_attention.launches``
    counts the launch."""
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q must be (B,Sq,H,D) and k, v (B,Sk,Hkv,D), got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    B, Sq, H, D = q.shape
    _, Sk, Hkv, _ = k.shape
    if (tuple(v.shape) != tuple(k.shape) or k.shape[0] != B
            or k.shape[3] != D):
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not "
                         f"fit q {tuple(q.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim D={D} is not one of {HEAD_DIMS}")
    if Hkv == 0 or H % Hkv:
        raise ValueError(f"H={H} is not a multiple of Hkv={Hkv}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if q.dtype not in _ENTRY or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share fp32 or bf16, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    for name, t in (("q", q), ("k", k), ("v", v)):
        require_cuda_tensor(t, name, q.dtype, 4)
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")
    out = torch.empty_like(q)
    if out.numel() == 0 or Sk == 0:
        return out.zero_()
    with torch.cuda.device(q.device):
        err = library().fns[_entry(q.dtype, D)](
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, Sq, Sk, H, Hkv, D, int(bool(causal)), int(window),
            stream_of(q))
    check_launch("flash_attention", err)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
