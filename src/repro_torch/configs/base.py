"""Architecture configs and run shapes (a copy of ``repro.configs.base``).

Every assigned architecture is a selectable config (``--arch <id>``).
``reduced()`` yields a same-family tiny config for CPU tests.
``input_specs()`` returns shape and dtype stand-ins (tensors on the ``meta``
device: no allocation) for every model input of an (arch x run-shape) cell.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, List, Tuple


@dataclass(frozen=True)
class RunShape:
    """A named (seq_len, global_batch) workload cell.

    kind: 'train'   -> train_step
          'prefill' -> prefill (serve) over the full sequence
          'decode'  -> serve_step: ONE new token against a KV cache of seq_len
    """

    name: str
    kind: str
    seq_len: int
    global_batch: int
    grad_accum: int = 1  # train only: number of microbatch steps
    sub_quadratic_only: bool = False


SHAPES: Dict[str, RunShape] = {
    "train_4k": RunShape("train_4k", "train", 4096, 256, grad_accum=16),
    "prefill_32k": RunShape("prefill_32k", "prefill", 32768, 32),
    "decode_32k": RunShape("decode_32k", "decode", 32768, 128),
    "long_500k": RunShape("long_500k", "decode", 524288, 1, sub_quadratic_only=True),
}


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | vlm | audio | hybrid | moe | ssm
    source: str  # provenance [arXiv/hf; tier]

    num_layers: int = 0
    d_model: int = 0
    num_heads: int = 0  # query heads (0 for attention-free archs)
    num_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    vocab_size: int = 0

    # block details
    mixer: str = "attention"  # attention | rglru_hybrid | rwkv6
    mlp_act: str = "swiglu"  # swiglu | gelu | geglu
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    qkv_bias: bool = False
    qk_norm: bool = False
    pos_emb: str = "rope"  # rope | sinusoidal | none
    rope_theta: float = 10_000.0
    # YaRN on the global 'attention' layers of a pattern with 'local' ones
    # (Hugging Face's ``_compute_yarn_parameters``, truncated bounds); the
    # local layers keep plain rope at rope_theta. 0 => plain rope everywhere.
    # Port-only fields: the JAX package's ArchConfig has none of them.
    yarn_factor: float = 0.0
    yarn_original_max_len: int = 0
    yarn_beta_fast: float = 32.0
    yarn_beta_slow: float = 1.0
    yarn_attention_factor: float = 1.0
    tie_embeddings: bool = False

    # MoE
    num_experts: int = 0
    top_k: int = 0

    # hybrid (recurrentgemma): cycle of layer kinds; empty => [mixer]*L
    layer_pattern: Tuple[str, ...] = ()
    local_window: int = 0  # sliding-window size for 'local' attention layers
    lru_width: int = 0  # RG-LRU state width
    conv_width: int = 4  # temporal conv width (hybrid)

    # rwkv6
    rwkv_head_size: int = 64
    rwkv_lora_rank: int = 32

    # 'tokens', or 'embeddings' for vlm/audio backbones that take
    # precomputed patch/frame embeddings (B, S, d_model)
    input_kind: str = "tokens"

    def __post_init__(self):
        # a pattern read from JSON comes as a list; keep the config hashable
        object.__setattr__(self, "layer_pattern", tuple(self.layer_pattern))
        if self.mixer in ("attention", "rglru_hybrid"):
            if self.num_heads <= 0:
                raise ValueError(f"{self.name}: attention needs num_heads > 0")
            if self.head_dim == 0:
                object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def attention_free(self) -> bool:
        return self.mixer == "rwkv6"

    @property
    def sub_quadratic(self) -> bool:
        """True if the arch can run 500k-token decode (SSM / hybrid-local)."""
        return self.mixer in ("rwkv6", "rglru_hybrid")

    def layer_kinds(self) -> List[str]:
        """Per-layer mixer kind, length num_layers."""
        if self.layer_pattern:
            pat = list(self.layer_pattern)
            return [pat[i % len(pat)] for i in range(self.num_layers)]
        return [self.mixer] * self.num_layers

    def param_count(self) -> int:
        """Total parameter count (exact, pre-TP-padding)."""
        d, V = self.d_model, self.vocab_size
        n = V * d  # embedding
        if not self.tie_embeddings:
            n += V * d  # lm head
        for kind in self.layer_kinds():
            if kind in ("attention", "local"):
                hq, hk, hd = self.num_heads, self.num_kv_heads, self.head_dim
                n += d * hq * hd + 2 * d * hk * hd + hq * hd * d
                if self.qkv_bias:
                    n += (hq + 2 * hk) * hd
                n += d  # norm
            elif kind == "rglru":
                w = self.lru_width or d
                # in-proj (2 branches), conv, lru params, out
                n += 2 * d * w + self.conv_width * w + 3 * w + 2 * w + w * d
                n += d
            elif kind == "rwkv6":
                hs = self.rwkv_head_size
                H = d // hs
                r = self.rwkv_lora_rank
                n += 4 * d * d  # r,k,v,out  (w via lora)
                n += d * d  # gate
                n += 5 * (d * r + r * d) + 6 * d  # ddlerp loras + mus
                n += H * hs  # u bonus
                n += d  # norm
            # ffn
            if self.is_moe:
                n += d * self.num_experts  # router
                if self.mlp_act in ("swiglu", "geglu"):
                    n += self.num_experts * 3 * d * self.d_ff
                else:
                    n += self.num_experts * 2 * d * self.d_ff
            elif kind == "rwkv6":
                n += 2 * d * self.d_ff + 2 * d  # channel-mix (k,v) + mixes
            else:
                if self.mlp_act in ("swiglu", "geglu"):
                    n += 3 * d * self.d_ff
                else:
                    n += 2 * d * self.d_ff
            n += d  # ffn norm
        n += d  # final norm
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k of num_experts)."""
        if not self.is_moe:
            return self.param_count()
        d, L = self.d_model, self.num_layers
        per_expert = (3 if self.mlp_act in ("swiglu", "geglu") else 2) * d * self.d_ff
        inactive = L * (self.num_experts - self.top_k) * per_expert
        return self.param_count() - inactive

    def reduced(self) -> "ArchConfig":
        """Same-family tiny config for CPU tests."""
        kw: Dict[str, Any] = dict(
            name=self.name + "-smoke",
            num_layers=min(self.num_layers, 2 if not self.layer_pattern else 3),
            d_model=64,
            d_ff=128,
            vocab_size=256,
        )
        if self.mixer in ("attention", "rglru_hybrid"):
            kw.update(num_heads=4, num_kv_heads=max(1, min(self.num_kv_heads, 2)), head_dim=16)
            if self.num_kv_heads == self.num_heads:
                kw.update(num_kv_heads=4)
        if self.mixer == "rglru_hybrid":
            kw.update(lru_width=64, local_window=16)
        if self.is_moe:
            kw.update(num_experts=8, top_k=2)
        if self.mixer == "rwkv6":
            kw.update(rwkv_head_size=16, rwkv_lora_rank=8)
        return dataclasses.replace(self, **kw)


_REGISTRY: Dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    import repro_torch.configs  # noqa: F401  (trigger registration)

    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs() -> List[str]:
    import repro_torch.configs  # noqa: F401

    return sorted(_REGISTRY)


def cells(include_skipped: bool = False):
    """All assigned (arch x shape) dry-run cells as (arch, shape, live).

    Pure full-attention archs skip long_500k (quadratic): 8 skips => 32 live
    cells of the 40.
    """
    out = []
    for arch in list_archs():
        cfg = get_config(arch)
        for s in SHAPES.values():
            live = cfg.sub_quadratic or not s.sub_quadratic_only
            if live or include_skipped:
                out.append((arch, s.name, live))
    return out


# ---------------------------------------------------------------------------
# Input specs (meta-device stand-ins; no allocation)
# ---------------------------------------------------------------------------


def input_specs(cfg: ArchConfig, shape: RunShape, *, tp: int = 1) -> Dict[str, Any]:
    """Shape/dtype stand-ins (``meta`` tensors) for the inputs of the step
    that ``shape`` runs:

    train  -> the batch of a train step: tokens/embeddings + labels
    prefill-> prefill(params, tokens) inputs
    decode -> decode_step(params, cache, tokens, pos) inputs (cache included)

    The modality frontend of [vlm]/[audio] archs is a stub: the stand-ins
    are precomputed patch/frame embeddings (input_kind == 'embeddings').
    """
    import torch

    B, S = shape.global_batch, shape.seq_len

    def meta(*shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")

    def tok(b, s):
        if cfg.input_kind == "embeddings":
            return meta(b, s, cfg.d_model, dtype=torch.bfloat16)
        return meta(b, s, dtype=torch.int32)

    if shape.kind == "train":
        return {"tokens": tok(B, S), "labels": meta(B, S, dtype=torch.int32),
                "micro_batch": B // shape.grad_accum}
    if shape.kind == "prefill":
        return {"tokens": tok(B, S)}
    if shape.kind == "decode":
        from repro_torch.models.cache import init_cache  # avoid an import cycle

        return {"tokens": tok(B, 1), "pos": meta(B, dtype=torch.int32),
                "cache": init_cache(cfg, B, S, tp=tp, device="meta")}
    raise ValueError(shape.kind)
