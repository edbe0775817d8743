"""TransformerLM: the decoder of ``repro.models.transformer`` as an
``nn.Module`` tree, for all ten archs.

``TransformerLM`` -> ``Block`` -> mixer / ffn / ``Norm``. A block's mixer
follows its layer kind: ``Attention`` for ``attention`` and ``local``
(sliding-window) layers, :class:`~repro_torch.models.rglru.RgLru` for
``rglru``, :class:`~repro_torch.models.rwkv.RwkvTimeMix` for ``rwkv6``; its
ffn is :class:`~repro_torch.models.rwkv.RwkvChannelMix` for ``rwkv6``, a
:class:`~repro_torch.models.moe.MoE` for a MoE arch, else an ``MLP``. The
parameters carry the JAX tree's keys (``layers.<i>.mixer.wq``,
``layers.<i>.mixer.lambda``, ``layers.<i>.ffn.w_gate``,
``layers.<i>.norm1.scale``, ``final_norm.scale``, ``embed.w``, ``head.w``),
so ``models/convert.py`` maps one onto the other name for name, and
:meth:`TransformerLM.params_tree` presents them as the JAX tree.
``forward``, ``prefill`` and ``decode_step`` run under
``torch.inference_mode()``; training runs :meth:`TransformerLM.forward_train`
through :func:`loss_fn` (the parameters take grads once
``train.make_train_state`` enables them), with :func:`grad_mask` and
:func:`sync_replica_grads` keeping a padded TP head layout exact.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.common import resolve_device
from repro_torch.models.attention import Attention
from repro_torch.models.cache import kv_head_layout
from repro_torch.models.layers import MLP, Norm, RunPolicy, dense_init, sinusoidal_table
from repro_torch.models.moe import MoE, num_experts_eff
from repro_torch.models.rglru import RgLru
from repro_torch.models.rwkv import RwkvChannelMix, RwkvTimeMix
from repro_torch.tree import leaves, tree_map


class _Weight(nn.Module):
    """Holds one matrix as ``w`` (the JAX tree's ``embed.w`` / ``head.w``)."""

    def __init__(self, shape, dtype: torch.dtype, device):
        super().__init__()
        self.w = nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                              requires_grad=False)


class Block(nn.Module):
    """Pre-norm residual block of one layer kind: x + mixer(norm1(x)), then
    + ffn(norm2(x)) (``_layer_init`` / ``_block_apply``)."""

    def __init__(self, cfg, kind: str, layout, dtype: torch.dtype, device,
                 tp: int = 1):
        super().__init__()
        self.kind = kind
        self.window = cfg.local_window if kind == "local" else 0
        self.norm1 = Norm(cfg.norm, cfg.d_model, dtype, device)
        if kind in ("attention", "local"):
            self.mixer = Attention(cfg, layout, dtype, device)
        elif kind == "rglru":
            self.mixer = RgLru(cfg, dtype, device)
        elif kind == "rwkv6":
            self.mixer = RwkvTimeMix(cfg, dtype, device)
        else:
            raise ValueError(f"unknown layer kind {kind!r}")
        self.norm2 = Norm(cfg.norm, cfg.d_model, dtype, device)
        if kind == "rwkv6":
            self.ffn = RwkvChannelMix(cfg, dtype, device)
        elif cfg.is_moe:
            self.ffn = MoE(cfg, dtype, device, tp)
        else:
            self.ffn = MLP(cfg, dtype, device)

    def forward(self, x, policy: RunPolicy, positions):
        """x (B,S,d) from the start of the sequence -> (x, this layer's
        decode cache after it): {'k', 'v'} (a local layer's last W tokens as
        a ring when S > W), {'h', 'conv'} or {'s', 'xa', 'xf'}."""
        h = self.norm1(x)
        if self.kind == "rwkv6":
            mixed, c = self.mixer(h, policy)
            cache = {"s": c["s"], "xa": c["x_prev"]}
        elif self.kind == "rglru":
            mixed, cache = self.mixer(h, policy)
        else:
            mixed, cache = self.mixer(h, policy, positions, window=self.window)
            S, W = x.shape[1], self.window
            if W and S > W:  # slot s holds the position that is s mod W
                cache = {n: torch.roll(t[:, S - W:], S % W, dims=1)
                         for n, t in cache.items()}
        x = x + mixed
        h = self.norm2(x)
        if self.kind == "rwkv6":
            y, cache["xf"] = self.ffn(h)
        else:
            y = self.ffn(h, policy)
        return x + y, cache

    def forward_train(self, x, policy: RunPolicy, positions):
        """x (B,S,d) -> (x, this block's MoE load-balance loss, 0 for other
        ffns) with no decode cache (``_block_apply``)."""
        h = self.norm1(x)
        if self.kind in ("rwkv6", "rglru"):
            mixed, _ = self.mixer(h, policy)
        else:
            mixed, _ = self.mixer(h, policy, positions, window=self.window)
        x = x + mixed
        h = self.norm2(x)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if self.kind == "rwkv6":
            y, _ = self.ffn(h)
        elif isinstance(self.ffn, MoE):
            y, aux = self.ffn(h, policy, with_aux=True)
        else:
            y = self.ffn(h, policy)
        return x + y, aux

    def decode(self, x, pos, cache, policy: RunPolicy):
        """One token x (B,1,d) at positions pos (B,) -> (x, the updated
        cache); attention caches are written in place."""
        h = self.norm1(x)
        if self.kind == "rwkv6":  # the time mix over a sequence of one
            mixed, c = self.mixer(h, policy, x_prev=cache["xa"], s0=cache["s"])
            cache = {"s": c["s"], "xa": c["x_prev"], "xf": cache["xf"]}
        elif self.kind == "rglru":
            mixed, cache = self.mixer.decode(h, cache)
        else:
            mixed, cache = self.mixer.decode(h, pos, cache, policy,
                                             window=self.window)
        x = x + mixed
        h = self.norm2(x)
        if self.kind == "rwkv6":
            y, cache["xf"] = self.ffn(h, x_prev=cache["xf"])
        else:
            y = self.ffn(h, policy)
        return x + y, cache

    def dense_len(self, cache) -> Optional[int]:
        """Rows of a dense KV cache (the positions it can take), None for a
        ring buffer or a recurrent state."""
        if self.kind not in ("attention", "local"):
            return None
        n = cache["k"].shape[1]
        return None if self.window and n == self.window else n


class TransformerLM(nn.Module):
    """Parameters are allocated uninitialized on ``device``; use
    :func:`init_params` for random weights or ``models.convert`` to load the
    JAX package's."""

    def __init__(self, cfg, *, tp: int = 1, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.cfg = cfg
        self.layout = kv_head_layout(cfg, tp) if cfg.mixer != "rwkv6" else None
        self.layers = nn.ModuleList(
            Block(cfg, kind, self.layout, dtype, device, tp)
            for kind in cfg.layer_kinds())
        self.final_norm = Norm(cfg.norm, cfg.d_model, dtype, device)
        if cfg.input_kind == "tokens" or cfg.tie_embeddings:
            self.embed = _Weight((cfg.vocab_size, cfg.d_model), dtype, device)
        if not cfg.tie_embeddings:
            self.head = _Weight((cfg.d_model, cfg.vocab_size), dtype, device)

    @property
    def device(self) -> torch.device:
        return self.final_norm.scale.device

    def params_tree(self) -> Dict[str, Any]:
        """The parameters as the JAX package's tree: ``layers.0.mixer.wq``
        at ``["layers"][0]["mixer"]["wq"]``; the leaves are the module's own
        parameters."""
        return _tree_of(self)

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        """Random weights as the JAX ``init_params`` draws them: N(0,
        1/fan_in) matrices, unit norm scales, zero biases, and each
        recurrent mixer's own (other numbers: the generators differ)."""
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
        and each layer's decode cache (:meth:`Block.forward`)."""
        return self._run(tokens, policy or RunPolicy(), last_only=True)

    def _run(self, tokens, policy: RunPolicy, last_only=False):
        positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                                 device=tokens.device)
        x = self.embed_in(tokens, positions)
        caches = []
        for blk in self.layers:
            x, cache = blk(x, policy, positions)
            caches.append(cache)
        x = self.final_norm(x)
        return self.logits_out(x[:, -1:] if last_only else x), caches

    def forward_train(self, tokens, policy: Optional[RunPolicy] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The full-sequence pass of training (``forward``): fp32 logits
        (B,S,V) and the summed MoE load-balance loss, with grad enabled and
        no decode caches. With ``policy.remat`` each block's activations are
        recomputed in the backward pass instead of kept."""
        policy = policy or RunPolicy()
        positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                                 device=tokens.device)
        x = self.embed_in(tokens, positions)
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        for blk in self.layers:
            if policy.remat and torch.is_grad_enabled():
                x, aux = checkpoint(blk.forward_train, x, policy, positions,
                                    use_reentrant=False)
            else:
                x, aux = blk.forward_train(x, policy, positions)
            aux_total = aux_total + aux
        return self.logits_out(self.final_norm(x)), aux_total

    @torch.inference_mode()
    def decode_step(self, tokens, pos, cache: List[Dict[str, torch.Tensor]],
                    policy: Optional[RunPolicy] = None):
        """One token per sequence: tokens (B,1) or (B,1,d); pos (B,) absolute
        positions. Takes the caches of :func:`init_cache` or
        :meth:`prefill` and returns the logits (B,1,V) with the updated
        caches (attention caches are written in place). Raises ValueError
        when a position does not fit a dense KV cache."""
        policy = policy or RunPolicy()
        dense = [n for blk, c in zip(self.layers, cache)
                 if (n := blk.dense_len(c)) is not None]
        if dense and int(pos.max()) >= min(dense):  # one host sync a step
            raise ValueError(
                f"position {int(pos.max())} does not fit a dense KV cache of "
                f"{min(dense)} positions")
        x = self.embed_in(tokens, pos[:, None])
        new_cache = []
        for blk, c in zip(self.layers, cache):
            x, c = blk.decode(x, pos, c, policy)
            new_cache.append(c)
        return self.logits_out(self.final_norm(x)), new_cache


def _tree_of(module: nn.Module):
    if isinstance(module, nn.ModuleList):
        return [_tree_of(m) for m in module]
    tree: Dict[str, Any] = dict(module.named_parameters(recurse=False))
    tree.update((name, _tree_of(m)) for name, m in module.named_children())
    return tree


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


def loss_fn(model: TransformerLM, batch: Dict[str, torch.Tensor],
            policy: Optional[RunPolicy] = None):
    """Next-token cross-entropy over the labels >= 0 (the data pipeline
    shifts them and marks document joints -1), plus 0.01 * the MoE
    load-balance loss / the layer count. Returns (loss, {'ce', 'aux'})."""
    logits, aux = model.forward_train(batch["tokens"], policy)
    labels = batch["labels"].long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(logp, -1, labels.clamp(min=0)[..., None])[..., 0]
    mask = (labels >= 0).float()
    ce = -(ll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    loss = ce + 0.01 * aux / max(1, model.cfg.num_layers)
    return loss, {"ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# Exactness hooks for the padded TP head layout (see models/layout.py)
# ---------------------------------------------------------------------------


def grad_mask(cfg, params, tp: int):
    """A tree of ``params``' structure: a 0/1 mask broadcasting against the
    parameter where it holds structural padding (padded q heads; padded MHA
    kv heads; padded experts), None where every entry is real."""
    mask = tree_map(lambda p: None, params)
    if cfg.mixer == "rwkv6":
        return mask
    lay = kv_head_layout(cfg, tp)
    dev = leaves(params)[0].device
    qpad, kpad = lay.q_pad_mask(), lay.kv_pad_mask()
    qm = torch.as_tensor(~qpad, dtype=torch.float32, device=dev)
    km = torch.as_tensor(~kpad, dtype=torch.float32, device=dev)
    for i, kind in enumerate(cfg.layer_kinds()):
        if kind not in ("attention", "local"):
            continue
        m = mask["layers"][i]["mixer"]
        if qpad.any():
            m["wq"] = qm[None, :, None]
            m["wo"] = qm[:, None, None]
            if cfg.qkv_bias:
                m["bq"] = qm[:, None]
        if lay.pad:
            m["wk"] = m["wv"] = km[None, :, None]
            if cfg.qkv_bias:
                m["bk"] = m["bv"] = km[:, None]
    if cfg.is_moe and num_experts_eff(cfg, tp) != cfg.num_experts:
        em = (torch.arange(num_experts_eff(cfg, tp), device=dev)
              < cfg.num_experts).float()
        for f in (mask["layers"][i]["ffn"] for i in range(cfg.num_layers)):
            f["router"] = em[None, :]
            for name in ("w_gate", "w_up", "w_down"):
                f[name] = em[:, None, None]
    return mask


@torch.no_grad()
def sync_replica_grads(cfg, grads, tp: int):
    """Sum the KV-projection grads across a layout's replicas and give each
    replica the sum (keeps replicas identical), in place. Returns grads."""
    if cfg.mixer == "rwkv6":
        return grads
    lay = kv_head_layout(cfg, tp)
    if lay.rep == 1:
        return grads
    for i, kind in enumerate(cfg.layer_kinds()):
        if kind not in ("attention", "local"):
            continue
        g = grads["layers"][i]["mixer"]
        for name, axis in (("wk", 1), ("wv", 1), ("bk", 0), ("bv", 0)):
            if name in g:
                g[name].copy_(lay.reduce_kv_grad(g[name], axis))
    return grads
