"""Griffin/RecurrentGemma recurrent block: temporal conv + RG-LRU (the port
of ``repro.models.rglru``).

RG-LRU: a_t = exp(-c * softplus(L) * r_t),  h_t = a_t h_{t-1} + sqrt(1-a_t^2) (i_t x_t)
with block-diagonal (per-head) input and recurrence gates. Over a sequence
the linear recurrence runs as a log-depth scan (:func:`linear_scan`, in
place of ``jax.lax.associative_scan``); decode is one step carrying (h, the
conv window). The reference has no Pallas kernel here; this is plain torch.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import RunPolicy, dense_init

_C = 8.0


def lambda_init(u: torch.Tensor) -> torch.Tensor:
    """softplus^-1(-log(u) / c), so that a^c = u (u in [0.9, 0.999])."""
    return torch.log(torch.exp(-torch.log(u) / _C) - 1.0)


def linear_scan(a, b):
    """h_t = a_t h_{t-1} + b_t along dim 1 from h_{-1} = 0, as
    Hillis-Steele doubling: log2(S) passes of the associative combine
    (a1, b1) . (a2, b2) = (a1 a2, b1 a2 + b2) with the element d places
    earlier. The sums run in another order than ``associative_scan``'s."""
    S = a.shape[1]
    d = 1
    while d < S:
        b = torch.cat([b[:, :d], torch.addcmul(b[:, d:], b[:, :-d], a[:, d:])], 1)
        if 2 * d < S:  # the last pass needs no products of a
            a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], 1)
        d *= 2
    return b


def _blockdiag(x, w, H: int):
    """x (..., width) times the block-diagonal w (H, hw, hw), accumulated in
    fp32 and returned in x's dtype."""
    shp = x.shape
    xh = x.reshape(shp[:-1] + (H, shp[-1] // H))
    y = torch.einsum("...hi,hij->...hj", xh.float(), w.float())
    return y.reshape(shp).to(x.dtype)


class RgLru(nn.Module):
    """``rglru_init`` / ``rglru_apply`` / ``rglru_decode``. Parameters under
    the JAX tree's names: ``w_y``, ``w_gate`` (d,w), ``conv_w`` (cw,w),
    ``conv_b`` (w), ``gate_i``, ``gate_r`` (H,hw,hw), ``bias_i``,
    ``bias_r`` (w), ``lambda`` (w) fp32, ``w_out`` (w,d)."""

    def __init__(self, cfg, dtype: torch.dtype, device):
        super().__init__()
        d, w, H = cfg.d_model, cfg.lru_width or cfg.d_model, cfg.num_heads
        self.cfg = cfg

        def param(*shape, fill=None, dt=dtype):
            t = torch.empty(shape, dtype=dt, device=device)
            if fill is not None:
                t.fill_(fill)
            return nn.Parameter(t, requires_grad=False)

        self.w_y = param(d, w)
        self.w_gate = param(d, w)
        self.conv_w = param(cfg.conv_width, w)
        self.conv_b = param(w, fill=0.0)
        self.gate_i = param(H, w // H, w // H)
        self.gate_r = param(H, w // H, w // H)
        self.bias_i = param(w, fill=0.0)
        self.bias_r = param(w, fill=0.0)
        # a Python keyword: the state-dict key stays ``mixer.lambda``
        self.register_parameter("lambda", param(w, dt=torch.float32))
        self.w_out = param(w, d)

    @property
    def lam(self) -> torch.Tensor:
        return getattr(self, "lambda")

    def reset_parameters(self, gen: torch.Generator) -> None:
        """N(0, 1/fan_in) matrices (``conv_w`` over its width, the gates
        over a head's width), zero biases, ``lambda`` with a^c ~ U[0.9,
        0.999]."""
        cw, hw = self.cfg.conv_width, self.gate_i.shape[-1]
        for w, fan in ((self.w_y, None), (self.w_gate, None),
                       (self.conv_w, cw), (self.gate_i, hw),
                       (self.gate_r, hw), (self.w_out, None)):
            w.copy_(dense_init(gen, tuple(w.shape), w.dtype, in_axis_size=fan))
        u = 0.9 + 0.099 * torch.rand(self.lam.shape, generator=gen,
                                     device=gen.device, dtype=torch.float32)
        self.lam.copy_(lambda_init(u))

    def _gates(self, xc):
        """(a, gated input) in fp32 from the conv output xc."""
        H = self.cfg.num_heads
        i_t = torch.sigmoid(_blockdiag(xc, self.gate_i, H).float() + self.bias_i)
        r_t = torch.sigmoid(_blockdiag(xc, self.gate_r, H).float() + self.bias_r)
        log_a = -_C * F.softplus(self.lam) * r_t  # <= 0
        beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
        return torch.exp(log_a), beta * i_t * xc.float()

    def _conv_train(self, y):
        """Causal depthwise temporal conv of y (B,S,w) via shifts."""
        cw = self.cfg.conv_width
        out = y * self.conv_w[cw - 1]
        for k in range(1, cw):
            shifted = F.pad(y, (0, 0, k, 0))[:, :y.shape[1]]
            out = out + shifted * self.conv_w[cw - 1 - k]
        return out + self.conv_b

    def forward(self, x, policy: RunPolicy
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Over a whole sequence x (B,S,d) from a zero state. Returns the
        output and the decode cache {'h': (B,w) fp32, 'conv': the last
        cw - 1 inputs of the conv (fewer when S < cw - 1)}."""
        y = x @ self.w_y
        gate = F.gelu((x @ self.w_gate).float(), approximate="tanh")
        a, gated = self._gates(self._conv_train(y))
        h = linear_scan(a, gated)
        out = (h * gate).to(x.dtype) @ self.w_out
        return out, {"h": h[:, -1], "conv": y[:, -(self.cfg.conv_width - 1):]}

    def decode(self, x, cache: Dict[str, torch.Tensor]
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """One step: x (B,1,d); cache {'h': (B,w) fp32, 'conv': (B,cw-1,w)}.
        Raises ValueError on a conv window shorter than cw - 1 (a prompt
        shorter than that leaves one)."""
        cw = self.cfg.conv_width
        if cache["conv"].shape[1] != cw - 1:
            raise ValueError(
                f"rglru conv cache holds {cache['conv'].shape[1]} inputs, "
                f"decode needs conv_width - 1 = {cw - 1}: prefill a prompt "
                f"of at least {cw - 1} tokens")
        xt = x[:, 0]
        y = xt @ self.w_y  # (B,w)
        gate = F.gelu((xt @ self.w_gate).float(), approximate="tanh")
        win = torch.cat([cache["conv"], y[:, None]], dim=1)  # (B,cw,w)
        yc = torch.einsum("bkw,kw->bw", win, self.conv_w) + self.conv_b
        a, gated = self._gates(yc)
        h = a * cache["h"] + gated
        out = (h * gate).to(x.dtype) @ self.w_out
        return out[:, None], {"h": h, "conv": win[:, 1:]}
