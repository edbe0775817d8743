"""starcoder2-7b: GQA + RoPE, GELU MLP, layernorm. [arXiv:2402.19173; hf]"""
from repro_torch.configs.base import ArchConfig, register

ARCH = register(
    ArchConfig(
        name="starcoder2-7b",
        family="dense",
        source="arXiv:2402.19173; hf",
        num_layers=32,
        d_model=4608,
        num_heads=36,
        num_kv_heads=4,
        head_dim=128,
        d_ff=18432,
        vocab_size=49152,
        mixer="attention",
        mlp_act="gelu",
        norm="layernorm",
        qkv_bias=True,
        rope_theta=100_000.0,
    )
)
