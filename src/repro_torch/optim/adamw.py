"""AdamW with fp32 master weights (the port of ``repro.optim.adamw``).

The state mirrors the parameter tree: {'m', 'v', 'master'} per leaf and the
step ``count``. :func:`adamw_update` follows the JAX formula and order --
global-norm clip, fp32 bias corrections ``1 - b**count``, then
``w -= lr * (m_hat / (sqrt(v_hat) + eps) + wd * w)`` -- but updates the
state in place, one tensor at a time, under ``torch.no_grad()``, so the
full-width state is never made twice. Where a parameter is fp32 its master
copy *is* the parameter (16 bytes of state a parameter instead of 20); a
checkpoint still writes ``opt/master``.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.tree import leaves, tree_map


def adamw_init(params) -> Dict[str, Any]:
    """Zero moments, fp32 master weights (the fp32 parameters themselves)
    and an int32 step count on the parameters' device."""
    first = leaves(params)[0]
    return {
        "m": tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                      params),
        "v": tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                      params),
        "master": tree_map(lambda p: p if p.dtype == torch.float32
                           else p.detach().float(), params),
        "count": torch.zeros((), dtype=torch.int32, device=first.device),
    }


@torch.no_grad()
def adamw_update(grads, opt, params, *, lr, b1: float = 0.9, b2: float = 0.95,
                 eps: float = 1e-8, weight_decay: float = 0.1,
                 clip_norm: float = 1.0, grad_norm=None) -> torch.Tensor:
    """One step over the trees ``grads``, ``opt`` and ``params`` (same
    structure), in place: the grads are clipped in place, ``opt`` and
    ``params`` updated. ``lr`` is a float or a 0-d tensor. Returns the
    global grad norm before the clip (a 0-d fp32 tensor; no host sync).
    ``grad_norm`` gives that norm where the trees hold only a part of the
    gradient (the ZeRO-1 slices of a sharded step)."""
    g_l = [g.float() for g in leaves(grads)]
    if grad_norm is None:
        norms = torch._foreach_norm(g_l)
        gnorm = torch.sqrt(sum(n * n for n in norms))
    else:
        gnorm = grad_norm
    scale = torch.clamp(clip_norm / torch.clamp(gnorm, min=1e-12), max=1.0)

    count = opt["count"]
    count.add_(1)
    c1 = 1.0 - torch.pow(b1, count.float())
    c2 = 1.0 - torch.pow(b2, count.float())
    for g, m, v, w, p in zip(g_l, leaves(opt["m"]), leaves(opt["v"]),
                             leaves(opt["master"]), leaves(params)):
        g.mul_(scale)
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        upd = (m / c1).div_((v / c2).sqrt_().add_(eps))
        w.sub_(upd.add_(w, alpha=weight_decay).mul_(lr))
        if p is not w:
            p.copy_(w)
    return gnorm
