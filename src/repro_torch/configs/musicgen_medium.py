"""musicgen-medium: decoder-only over EnCodec tokens (MHA). [arXiv:2306.05284; hf]

Backbone only: the EnCodec frontend is a stub — input_specs() provides
precomputed frame embeddings. Cross-attention text conditioning is out of the
assigned backbone scope (see DESIGN.md).
"""
from repro_torch.configs.base import ArchConfig, register

ARCH = register(
    ArchConfig(
        name="musicgen-medium",
        family="audio",
        source="arXiv:2306.05284; hf",
        num_layers=48,
        d_model=1536,
        num_heads=24,
        num_kv_heads=24,  # MHA
        head_dim=64,
        d_ff=6144,
        vocab_size=2048,
        mixer="attention",
        mlp_act="gelu",
        norm="layernorm",
        pos_emb="sinusoidal",
        input_kind="embeddings",
    )
)
