"""Carrying weights across: the JAX package's parameter tree <-> the port's
:class:`~repro_torch.models.transformer.TransformerLM`.

The tree is the JAX ``init_params`` pytree with numpy leaves (in a test:
``jax.tree.map(np.asarray, params)``): ``{"layers": [{"norm1": {...},
"mixer": {...}, "norm2": {...}, "ffn": {...}}, ...], "final_norm": {...},
"embed": {"w"}, "head": {"w"}}``; a MoE arch's ``ffn`` is ``{"router",
"w_gate", "w_up", "w_down"}``, an rwkv6 layer's mixer and ffn and an rglru
layer's mixer hold their own parameters (``models/rwkv.py``,
``models/rglru.py``), and a tied-embedding arch has no ``head``. Its paths
are the module's parameter names, so the load is name for name and shape
for shape.

The whole train state crosses too: :func:`load_jax_train_state` takes a
numpy JAX train state (``make_train_state``'s tree: params, the AdamW
``m``/``v``/``master`` and ``count``, ``step``) to the port's
``train.TrainState``, and :func:`numpy_train_state` takes the port's back.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.kernels.common import resolve_device
from repro_torch.models.cache import kv_head_layout
from repro_torch.models.moe import num_experts_eff
from repro_torch.models.rglru import lambda_init
from repro_torch.models.rwkv import _COMPONENTS, w0_init
from repro_torch.models.transformer import TransformerLM


def _flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def load_jax_params(cfg, tree: Dict[str, Any], device=None, *,
                    tp: int = 1) -> TransformerLM:
    """The port's model with the values of the JAX parameter tree, on
    ``device`` (the CUDA card unless the caller passes ``device="cpu"``).
    The model's dtype is that of the tree's matrices; the parameters the
    JAX package keeps in fp32 whatever the dtype (rwkv6's ``w0`` and ``u``,
    rglru's ``lambda``) stay fp32. Raises on a missing, extra or misshapen
    parameter."""
    dev = resolve_device(device)
    flat = {k: torch.from_numpy(np.array(v)) for k, v in _flatten(tree).items()}
    dtype = next(t.dtype for t in flat.values() if t.dim() >= 2)
    model = TransformerLM(cfg, tp=tp, dtype=dtype, device="meta")
    want = {k: tuple(p.shape) for k, p in model.state_dict().items()}
    got = {k: tuple(t.shape) for k, t in flat.items()}
    if want != got:
        diff = sorted(set(want.items()) ^ set(got.items()))
        raise ValueError(f"parameter tree does not fit {cfg.name}: {diff[:8]}")
    dtypes = {k: p.dtype for k, p in model.state_dict().items()}
    model.load_state_dict({k: t.to(dev, dtypes[k]) for k, t in flat.items()},
                          strict=True, assign=True)
    return model.requires_grad_(False)


def numpy_params(cfg, seed: int, *, tp: int = 1) -> Dict[str, Any]:
    """An fp32 parameter tree of the JAX package's structure, drawn with
    numpy from ``seed`` as ``init_params`` draws it (N(0, 1/fan_in)
    matrices, unit norm scales, zero biases; rwkv6's ``w0`` ramp and zero
    LoRA outputs, rglru's ``lambda`` from U[0.9, 0.999] through
    softplus^-1), for loading the same weights on two devices."""
    f32 = np.float32
    rng = np.random.default_rng(seed)
    d, f, hd, V = cfg.d_model, cfg.d_ff, cfg.head_dim, cfg.vocab_size
    lay = kv_head_layout(cfg, tp) if cfg.mixer != "rwkv6" else None

    def dense(shape, fan_in):
        return (rng.standard_normal(shape, f32)
                / np.sqrt(max(1, fan_in))).astype(f32)

    def norm():
        p = {"scale": np.ones(d, f32)}
        if cfg.norm == "layernorm":
            p["bias"] = np.zeros(d, f32)
        return p

    def expand(w, axis, kv):
        src = lay.kv_src() if kv else lay.q_src()
        out = np.take(w, np.where(src < 0, 0, src), axis=axis)
        if not kv:
            shape = [1] * w.ndim
            shape[axis] = len(src)
            out = out * (src >= 0).reshape(shape)
        return out.astype(f32)

    def attention():
        mixer = {
            "wq": expand(dense((d, lay.n_q, hd), d), 1, kv=False),
            "wk": expand(dense((d, lay.n_kv, hd), d), 1, kv=True),
            "wv": expand(dense((d, lay.n_kv, hd), d), 1, kv=True),
            "wo": expand(dense((lay.n_q, hd, d), lay.n_q * hd), 0, kv=False),
        }
        if cfg.qkv_bias:
            mixer.update(bq=np.zeros((lay.n_q_eff, hd), f32),
                         bk=np.zeros((lay.n_kv_eff, hd), f32),
                         bv=np.zeros((lay.n_kv_eff, hd), f32))
        if cfg.qk_norm:
            mixer.update(q_norm=np.ones(hd, f32), k_norm=np.ones(hd, f32))
        return mixer

    def rglru():
        w, H, cw = cfg.lru_width or d, cfg.num_heads, cfg.conv_width
        return {"w_y": dense((d, w), d), "w_gate": dense((d, w), d),
                "conv_w": dense((cw, w), cw), "conv_b": np.zeros(w, f32),
                "gate_i": dense((H, w // H, w // H), w // H),
                "gate_r": dense((H, w // H, w // H), w // H),
                "bias_i": np.zeros(w, f32), "bias_r": np.zeros(w, f32),
                "lambda": lambda_init(torch.from_numpy(
                    rng.uniform(0.9, 0.999, w).astype(f32))).numpy(),
                "w_out": dense((w, d), w)}

    def rwkv_att():
        hs, r = cfg.rwkv_head_size, cfg.rwkv_lora_rank
        mixer = {"mu_x": np.full(d, 0.5, f32),
                 "mu": np.full((_COMPONENTS, d), 0.5, f32),
                 "lora_A": dense((d, _COMPONENTS * r), d),
                 "lora_B": np.zeros((_COMPONENTS, r, d), f32),
                 "w0": w0_init(d),
                 "w_lora_A": dense((d, 2 * r), d),
                 "w_lora_B": np.zeros((2 * r, d), f32)}
        for name in ("wr", "wk", "wv", "wg", "wo"):
            mixer[name] = dense((d, d), d)
        mixer.update(u=(0.1 * dense((d // hs, hs), 1)).astype(f32),
                     ln_scale=np.ones(d, f32), ln_bias=np.zeros(d, f32))
        return mixer

    def moe_ffn():
        # the logical experts, then zero pads up to num_experts_eff
        E0 = cfg.num_experts
        pad = num_experts_eff(cfg, tp) - E0
        w = {"router": dense((d, E0), d), "w_gate": dense((E0, d, f), d),
             "w_up": dense((E0, d, f), d), "w_down": dense((E0, f, d), f)}
        w["router"] = np.pad(w["router"], ((0, 0), (0, pad)))
        for k in ("w_gate", "w_up", "w_down"):
            w[k] = np.pad(w[k], ((0, pad), (0, 0), (0, 0)))
        return w

    layers = []
    for kind in cfg.layer_kinds():
        mixer = {"rglru": rglru, "rwkv6": rwkv_att}.get(kind, attention)()
        if kind == "rwkv6":
            ffn = {"mu_k": np.full(d, 0.5, f32), "mu_r": np.full(d, 0.5, f32),
                   "wk": dense((d, f), d), "wv": dense((f, d), f),
                   "wr": dense((d, d), d)}
        elif cfg.is_moe:
            ffn = moe_ffn()
        elif cfg.mlp_act in ("swiglu", "geglu"):
            ffn = {"w_gate": dense((d, f), d), "w_up": dense((d, f), d),
                   "w_down": dense((f, d), f)}
        else:
            ffn = {"w_up": dense((d, f), d), "b_up": np.zeros(f, f32),
                   "w_down": dense((f, d), f), "b_down": np.zeros(d, f32)}
        layers.append({"norm1": norm(), "norm2": norm(), "mixer": mixer,
                       "ffn": ffn})
    tree: Dict[str, Any] = {"layers": layers, "final_norm": norm()}
    if cfg.input_kind == "tokens" or cfg.tie_embeddings:
        tree["embed"] = {"w": dense((V, d), d)}
    if not cfg.tie_embeddings:
        tree["head"] = {"w": dense((d, V), d)}
    return tree


def load_jax_train_state(cfg, tree: Dict[str, Any], device=None, *,
                         tp: int = 1):
    """The port's train state (``train.TrainState``) holding the values of
    the JAX train state ``tree`` (numpy leaves), on ``device`` (the CUDA
    card unless the caller passes ``device="cpu"``)."""
    from repro_torch.train.trainer import load_state_, make_train_state

    model = load_jax_params(cfg, tree["params"], device, tp=tp)
    state = make_train_state(cfg, model)
    load_state_(state, {k: tree[k] for k in state})
    return state


def numpy_train_state(state) -> Dict[str, Any]:
    """The port's train state as the JAX package's tree of numpy arrays
    (``count`` and ``step`` int32 scalars; ``master`` its own copy)."""
    from repro_torch.tree import tree_map

    return tree_map(lambda t: t.detach().to("cpu", copy=True).numpy(),
                    dict(state))
