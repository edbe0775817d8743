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

Under a mesh (``RunPolicy.mesh``; ``launch.sharding.shard_model_`` leaves
each parameter as this rank's shard) the blocks run tensor-parallel (see
each block's module), the embedding and the logits are vocab-sharded (a
masked local lookup plus an all-reduce, exact against the one-hot product;
each rank's logits are its vocab slice), and :func:`loss_fn` takes the
vocab-parallel cross-entropy and, under data parallelism, returns this
rank's share of the global batch's loss. Under sequence parallelism
(``RunPolicy.sequence_parallel``, a sequence the model axis divides) the
residual from the embedding to the final norm is this rank's positions:
the embedding reduce-scatters (or slices) on the sequence, the blocks
gather it where they need it whole, and the head gathers it back, so the
logits and the loss see the whole sequence.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.common import resolve_device
from repro_torch.models.attention import Attention
from repro_torch.models.cache import kv_head_layout
from repro_torch.models.layers import MLP, Norm, RunPolicy, dense_init, sinusoidal_table
from repro_torch.models.moe import MoE, num_experts_eff
from repro_torch.models.parallel import (
    all_gather,
    all_reduce_,
    copy_in,
    dp_axis,
    gather_from,
    local_slice,
    reduce_from,
    reduce_out,
    seq_axis,
    tp_axis,
)
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
            self.mixer = Attention(cfg, layout, dtype, device, kind)
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
        """x (B,S,d) from the start of the sequence at ``positions`` (S,) ->
        (x, this layer's decode cache after it): {'k', 'v'} (a local
        layer's last W tokens as a ring when S > W), {'h', 'conv'} or {'s',
        'xa', 'xf'}. Under sequence parallelism x is this rank's positions
        and the cache the whole sequence's."""
        S = positions.shape[-1]
        seq = seq_axis(policy, S)
        h = self.norm1(x, seq)
        if self.kind == "rwkv6":
            mixed, c = self.mixer(h, policy, seq=seq)
            cache = {"s": c["s"], "xa": c["x_prev"]}
        elif self.kind == "rglru":
            mixed, cache = self.mixer(h, policy, seq=seq)
        else:
            mixed, cache = self.mixer(h, policy, positions, window=self.window,
                                      seq=seq)
            W = self.window
            if W and S > W:  # slot s holds the position that is s mod W
                cache = {n: torch.roll(t[:, S - W:], S % W, dims=1)
                         for n, t in cache.items()}
        x = x + mixed
        h = self.norm2(x, seq)
        if self.kind == "rwkv6":
            y, cache["xf"] = self.ffn(h, policy=policy, seq=seq)
        else:
            y = self.ffn(h, policy, seq=seq)
        return x + y, cache

    def forward_train(self, x, policy: RunPolicy, positions):
        """x (B,S,d) -> (x, this block's MoE load-balance loss, 0 for other
        ffns) with no decode cache (``_block_apply``)."""
        seq = seq_axis(policy, positions.shape[-1])
        h = self.norm1(x, seq)
        if self.kind in ("rwkv6", "rglru"):
            mixed, _ = self.mixer(h, policy, seq=seq)
        else:
            mixed, _ = self.mixer(h, policy, positions, window=self.window,
                                  seq=seq)
        x = x + mixed
        h = self.norm2(x, seq)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if self.kind == "rwkv6":
            y, _ = self.ffn(h, policy=policy, seq=seq)
        elif isinstance(self.ffn, MoE):
            y, aux = self.ffn(h, policy, with_aux=True, seq=seq)
        else:
            y = self.ffn(h, policy, seq=seq)
        return x + y, aux

    def decode(self, x, pos, cache, policy: RunPolicy):
        """One token x (B,1,d) at positions pos (B,) -> (x, the updated
        cache); attention caches are written in place."""
        h = self.norm1(x)
        if self.kind == "rwkv6":  # the time mix over a sequence of one
            mixed, c = self.mixer(h, policy, x_prev=cache["xa"], s0=cache["s"])
            cache = {"s": c["s"], "xa": c["x_prev"], "xf": cache["xf"]}
        elif self.kind == "rglru":
            mixed, cache = self.mixer.decode(h, cache, policy)
        else:
            mixed, cache = self.mixer.decode(h, pos, cache, policy,
                                             window=self.window)
        x = x + mixed
        h = self.norm2(x)
        if self.kind == "rwkv6":
            y, cache["xf"] = self.ffn(h, x_prev=cache["xf"], policy=policy)
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
    def embed_in(self, tokens, positions, policy: Optional[RunPolicy] = None,
                 seq=None):
        """tokens (B,S) int, or (B,S,d) embeddings for an 'embeddings' arch.
        A vocab-sharded embedding (under a mesh, fewer rows than the vocab)
        looks up the tokens of this rank's rows, zeros elsewhere, and
        all-reduces: the JAX package's one-hot einsum, exactly. With ``seq``
        (sequence parallelism) the result is this rank's positions: the
        reduce-scatter in place of the all-reduce, else a slice; a
        sinusoidal table is taken at the sequence's ``positions`` (S,)."""
        cfg = self.cfg
        ax = None
        if cfg.input_kind == "embeddings" and tokens.dim() == 3:
            x = tokens
        else:
            w = self.embed.w
            ax = tp_axis(policy, w.shape[0] != cfg.vocab_size)
            if ax is not None:
                rows = tokens.long() - ax.rank * w.shape[0]
                mine = (rows >= 0) & (rows < w.shape[0])
                x = w[rows.clamp(0, w.shape[0] - 1)] * mine[..., None].to(w.dtype)
            else:
                x = w[tokens.long()]
        x = reduce_out(x, ax, seq)
        if cfg.pos_emb == "sinusoidal":
            table = sinusoidal_table(positions, cfg.d_model)
            if seq is not None:
                table = local_slice(table, 0, seq)
            x = x + table.to(x.dtype)
        return x

    def logits_out(self, x, policy: Optional[RunPolicy] = None, seq=None):
        """(B,S,d) -> fp32 logits (B,S,V); under a mesh with a vocab-sharded
        head (or tied embedding), this rank's vocab slice. With ``seq`` x
        is this rank's positions and the logits the whole sequence's."""
        w = self.embed.w if self.cfg.tie_embeddings else self.head.w
        vdim = 0 if self.cfg.tie_embeddings else 1
        x = copy_in(x, tp_axis(policy, w.shape[vdim] != self.cfg.vocab_size),
                    seq)
        if self.cfg.tie_embeddings:
            return torch.einsum("bsd,vd->bsv", x.float(), w.float())
        return torch.matmul(x.float(), w.float())

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
        seq = seq_axis(policy, tokens.shape[1])
        x = self.embed_in(tokens, positions, policy, seq)
        caches = []
        for blk in self.layers:
            x, cache = blk(x, policy, positions)
            caches.append(cache)
        x = self.final_norm(x, seq)
        if last_only:  # the last position is the last rank's
            x = gather_from(x[:, -1:], 1, seq)[:, -1:]
            seq = None
        return self.logits_out(x, policy, seq), caches

    def forward_train(self, tokens, policy: Optional[RunPolicy] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The full-sequence pass of training (``forward``): fp32 logits
        (B,S,V) and the summed MoE load-balance loss, with grad enabled and
        no decode caches. With ``policy.remat`` each block's activations are
        recomputed in the backward pass instead of kept."""
        policy = policy or RunPolicy()
        positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                                 device=tokens.device)
        seq = seq_axis(policy, tokens.shape[1])
        x = self.embed_in(tokens, positions, policy, seq)
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        for blk in self.layers:
            if policy.remat and torch.is_grad_enabled():
                x, aux = checkpoint(blk.forward_train, x, policy, positions,
                                    use_reentrant=False)
            else:
                x, aux = blk.forward_train(x, policy, positions)
            aux_total = aux_total + aux
        return self.logits_out(self.final_norm(x, seq), policy, seq), aux_total

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
        # one host sync a step (none for the dry-run's fake tensors)
        if dense and not isinstance(pos, FakeTensor) and int(pos.max()) >= min(dense):
            raise ValueError(
                f"position {int(pos.max())} does not fit a dense KV cache of "
                f"{min(dense)} positions")
        x = self.embed_in(tokens, pos[:, None], policy)
        new_cache = []
        for blk, c in zip(self.layers, cache):
            x, c = blk.decode(x, pos, c, policy)
            new_cache.append(c)
        return self.logits_out(self.final_norm(x), policy), new_cache


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


def set_policy_tp(policy: RunPolicy, tp: int) -> RunPolicy:
    """Record the tensor-parallel degree the params were laid out for (the
    JAX package keeps it out of band; MoE padding depends on it)."""
    policy._tp = tp
    return policy


def policy_tp(policy: RunPolicy) -> int:
    return getattr(policy, "_tp", 1)


def init_params_specs(cfg, *, dtype: torch.dtype = torch.bfloat16, tp: int = 1):
    """The parameter tree of a :class:`TransformerLM` on the ``meta`` device:
    shapes and dtypes, no allocation (the dry-run's and the sharding
    rules' input)."""
    return TransformerLM(cfg, tp=tp, dtype=dtype, device="meta").params_tree()


def _label_logp(cfg, logits, labels, policy):
    """log p(label) per position; with vocab-sharded logits the
    vocab-parallel form (max, sum-exp and the label's logit all-reduced
    over the model axis)."""
    lf = logits.float()
    ax = tp_axis(policy, lf.shape[-1] != cfg.vocab_size)
    if ax is None:
        logp = torch.log_softmax(lf, dim=-1)
        return torch.gather(logp, -1, labels.clamp(min=0)[..., None])[..., 0]
    Vl = lf.shape[-1]
    m = all_reduce_(lf.detach().amax(dim=-1, keepdim=True), ax,
                    torch.distributed.ReduceOp.MAX)
    sumexp = reduce_from(torch.exp(lf - m).sum(dim=-1), ax)
    rows = labels.clamp(min=0) - ax.rank * Vl
    mine = (rows >= 0) & (rows < Vl)
    picked = torch.gather(lf, -1, rows.clamp(0, Vl - 1)[..., None])[..., 0]
    picked = reduce_from(torch.where(mine, picked, 0.0), ax)
    return picked - m[..., 0] - torch.log(sumexp)


def loss_fn(model: TransformerLM, batch: Dict[str, torch.Tensor],
            policy: Optional[RunPolicy] = None):
    """Next-token cross-entropy over the labels >= 0 (the data pipeline
    shifts them and marks document joints -1), plus 0.01 * the MoE
    load-balance loss / the layer count. Returns (loss, {'ce', 'aux'}).
    Under data parallelism the cross-entropy divides by the global batch's
    label count and the MoE loss is this rank's share, so the ranks'
    losses sum to the loss of the global batch."""
    logits, aux = model.forward_train(batch["tokens"], policy)
    labels = batch["labels"].long()
    ll = _label_logp(model.cfg, logits, labels, policy)
    mask = (labels >= 0).float()
    count = all_reduce_(mask.sum(), dp_axis(policy))
    ce = -(ll * mask).sum() / torch.clamp(count, min=1.0)
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
def sync_replica_grads(cfg, grads, tp: int, axis=None):
    """Sum the KV-projection grads across a layout's replicas and give each
    replica the sum (keeps replicas identical), in place. Returns grads.
    With ``axis`` (the model axis of a mesh) the grads are this rank's
    heads: they are gathered over it, summed, and this rank's part kept."""
    if cfg.mixer == "rwkv6":
        return grads
    lay = kv_head_layout(cfg, tp)
    if lay.rep == 1:
        return grads
    for i, kind in enumerate(cfg.layer_kinds()):
        if kind not in ("attention", "local"):
            continue
        g = grads["layers"][i]["mixer"]
        for name, dim in (("wk", 1), ("wv", 1), ("bk", 0), ("bv", 0)):
            if name not in g:
                continue
            if axis is not None and g[name].shape[dim] != lay.n_kv_eff:
                full = lay.reduce_kv_grad(all_gather(g[name], dim, axis), dim)
                g[name].copy_(local_slice(full, dim, axis))
            else:
                g[name].copy_(lay.reduce_kv_grad(g[name], dim))
    return grads
