"""qwen2.5-32b: GQA with QKV bias. [hf:Qwen/Qwen2.5-0.5B; hf]"""
from repro_torch.configs.base import ArchConfig, register

ARCH = register(
    ArchConfig(
        name="qwen2.5-32b",
        family="dense",
        source="hf:Qwen/Qwen2.5-0.5B; hf",
        num_layers=64,
        d_model=5120,
        num_heads=40,
        num_kv_heads=8,
        head_dim=128,
        d_ff=27648,
        vocab_size=152064,
        mixer="attention",
        mlp_act="swiglu",
        norm="rmsnorm",
        qkv_bias=True,
        rope_theta=1_000_000.0,
    )
)
