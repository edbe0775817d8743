"""TransformerLM: the decoder of ``repro.models.transformer`` as an
``nn.Module`` tree, for attention archs.

``TransformerLM`` -> ``Block`` -> ``Attention`` / ``MLP`` / ``Norm``. The
parameters carry the JAX tree's keys (``layers.<i>.mixer.wq``,
``layers.<i>.ffn.w_gate``, ``layers.<i>.norm1.scale``, ``final_norm.scale``,
``embed.w``, ``head.w``), so ``models/convert.py`` maps one onto the other
name for name. ``forward``, ``prefill`` and ``decode_step`` run under
``torch.inference_mode()``. A MoE arch's ``ffn`` is a
:class:`~repro_torch.models.moe.MoE` (``ffn.router``, ``ffn.w_gate``, ...).
rglru and rwkv6 layers come with a later slice and raise
``NotImplementedError``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from repro_torch.kernels.common import resolve_device
from repro_torch.models.attention import Attention
from repro_torch.models.cache import kv_head_layout
from repro_torch.models.layers import MLP, Norm, RunPolicy, dense_init, sinusoidal_table
from repro_torch.models.moe import MoE


class _Weight(nn.Module):
    """Holds one matrix as ``w`` (the JAX tree's ``embed.w`` / ``head.w``)."""

    def __init__(self, shape, dtype: torch.dtype, device):
        super().__init__()
        self.w = nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                              requires_grad=False)


class Block(nn.Module):
    """Pre-norm residual block: x + mixer(norm1(x)), then + ffn(norm2(x))."""

    def __init__(self, cfg, layout, dtype: torch.dtype, device, tp: int = 1):
        super().__init__()
        self.norm1 = Norm(cfg.norm, cfg.d_model, dtype, device)
        self.mixer = Attention(cfg, layout, dtype, device)
        self.norm2 = Norm(cfg.norm, cfg.d_model, dtype, device)
        self.ffn = (MoE(cfg, dtype, device, tp) if cfg.is_moe
                    else MLP(cfg, dtype, device))

    def forward(self, x, policy: RunPolicy, positions):
        mixed, kv = self.mixer(self.norm1(x), policy, positions)
        x = x + mixed
        return x + self.ffn(self.norm2(x), policy), kv

    def decode(self, x, pos, cache, policy: RunPolicy):
        mixed, cache = self.mixer.decode(self.norm1(x), pos, cache, policy)
        x = x + mixed
        return x + self.ffn(self.norm2(x), policy), cache


def _check_supported(cfg) -> None:
    other = sorted(set(cfg.layer_kinds()) - {"attention"})
    if other:
        raise NotImplementedError(
            f"{cfg.name}: {other} layers come with the recurrent-arch slice "
            "of the port")


class TransformerLM(nn.Module):
    """Parameters are allocated uninitialized on ``device``; use
    :func:`init_params` for random weights or ``models.convert`` to load the
    JAX package's."""

    def __init__(self, cfg, *, tp: int = 1, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        _check_supported(cfg)
        self.cfg = cfg
        self.layout = kv_head_layout(cfg, tp)
        self.layers = nn.ModuleList(
            Block(cfg, self.layout, dtype, device, tp)
            for _ in range(cfg.num_layers))
        self.final_norm = Norm(cfg.norm, cfg.d_model, dtype, device)
        if cfg.input_kind == "tokens" or cfg.tie_embeddings:
            self.embed = _Weight((cfg.vocab_size, cfg.d_model), dtype, device)
        if not cfg.tie_embeddings:
            self.head = _Weight((cfg.d_model, cfg.vocab_size), dtype, device)

    @property
    def device(self) -> torch.device:
        return self.final_norm.scale.device

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        """Random weights as the JAX ``init_params`` draws them: N(0,
        1/fan_in) matrices, unit norm scales, zero biases (other numbers:
        the generators differ)."""
        for blk in self.layers:
            blk.mixer.reset_parameters(gen)
            blk.ffn.reset_parameters(gen)
        d = self.cfg.d_model
        if hasattr(self, "embed"):
            self.embed.w.copy_(dense_init(gen, tuple(self.embed.w.shape),
                                          self.embed.w.dtype, in_axis_size=d))
        if hasattr(self, "head"):
            self.head.w.copy_(dense_init(gen, tuple(self.head.w.shape),
                                         self.head.w.dtype))

    # -------------------------------------------------------------- ends
    def embed_in(self, tokens, positions):
        """tokens (B,S) int, or (B,S,d) embeddings for an 'embeddings' arch."""
        cfg = self.cfg
        if cfg.input_kind == "embeddings" and tokens.dim() == 3:
            x = tokens
        else:
            x = self.embed.w[tokens.long()]
        if cfg.pos_emb == "sinusoidal":
            x = x + sinusoidal_table(positions, cfg.d_model).to(x.dtype)
        return x

    def logits_out(self, x):
        """(B,S,d) -> fp32 logits (B,S,V)."""
        if self.cfg.tie_embeddings:
            return torch.einsum("bsd,vd->bsv", x.float(), self.embed.w.float())
        return torch.matmul(x.float(), self.head.w.float())

    # ------------------------------------------------------------ passes
    @torch.inference_mode()
    def forward(self, tokens, policy: Optional[RunPolicy] = None):
        """Full-sequence logits (B,S,V) for tokens (B,S) or (B,S,d)."""
        logits, _ = self._run(tokens, policy or RunPolicy())
        return logits

    @torch.inference_mode()
    def prefill(self, tokens, policy: Optional[RunPolicy] = None
                ) -> Tuple[torch.Tensor, List[Dict[str, torch.Tensor]]]:
        """Run the whole prompt; return the last position's logits (B,1,V)
        and each layer's {'k', 'v'} (B,S,Hkv_eff,D)."""
        return self._run(tokens, policy or RunPolicy(), last_only=True)

    def _run(self, tokens, policy: RunPolicy, last_only=False):
        positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                                 device=tokens.device)
        x = self.embed_in(tokens, positions)
        caches = []
        for blk in self.layers:
            x, kv = blk(x, policy, positions)
            caches.append(kv)
        x = self.final_norm(x)
        return self.logits_out(x[:, -1:] if last_only else x), caches

    @torch.inference_mode()
    def decode_step(self, tokens, pos, cache: List[Dict[str, torch.Tensor]],
                    policy: Optional[RunPolicy] = None):
        """One token per sequence: tokens (B,1) or (B,1,d); pos (B,) absolute
        positions. The cache (:func:`init_cache`) is updated in place and
        returned with the logits (B,1,V)."""
        policy = policy or RunPolicy()
        x = self.embed_in(tokens, pos[:, None])
        for blk, c in zip(self.layers, cache):
            x, _ = blk.decode(x, pos, c, policy)
        return self.logits_out(self.final_norm(x)), cache


def init_params(cfg, generator: Optional[torch.Generator] = None, *,
                seed: int = 0, dtype: torch.dtype = torch.float32, tp: int = 1,
                device=None) -> TransformerLM:
    """A :class:`TransformerLM` with random weights, made on ``device`` (the
    CUDA card unless the caller passes ``device="cpu"``) from ``generator``,
    or from a generator on that device seeded with ``seed``."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(dev).manual_seed(seed)
    model = TransformerLM(cfg, tp=tp, dtype=dtype, device=dev)
    model.reset_parameters(generator)
    return model
