"""olmoe-1b-7b: 64-expert top-8 MoE. [arXiv:2409.02060; hf]"""
from repro_torch.configs.base import ArchConfig, register

ARCH = register(
    ArchConfig(
        name="olmoe-1b-7b",
        family="moe",
        source="arXiv:2409.02060; hf",
        num_layers=16,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,  # MHA
        head_dim=128,
        d_ff=1024,  # per-expert
        vocab_size=50304,
        mixer="attention",
        mlp_act="swiglu",
        norm="rmsnorm",
        qk_norm=True,
        rope_theta=10_000.0,
        num_experts=64,
        top_k=8,
    )
)
