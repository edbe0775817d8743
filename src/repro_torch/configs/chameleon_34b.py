"""chameleon-34b: early-fusion VLM backbone, VQ image tokens in vocab, qk-norm.

[arXiv:2405.09818; unverified]. Backbone only: the modality frontend is a stub
— input_specs() provides precomputed patch embeddings (input_kind='embeddings').
"""
from repro_torch.configs.base import ArchConfig, register

ARCH = register(
    ArchConfig(
        name="chameleon-34b",
        family="vlm",
        source="arXiv:2405.09818; unverified",
        num_layers=48,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,
        d_ff=22016,
        vocab_size=65536,
        mixer="attention",
        mlp_act="swiglu",
        norm="rmsnorm",
        qk_norm=True,
        rope_theta=10_000.0,
        input_kind="embeddings",
    )
)
