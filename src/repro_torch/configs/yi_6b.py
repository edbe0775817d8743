"""yi-6b: llama-arch GQA dense LM. [arXiv:2403.04652; hf]"""
from repro_torch.configs.base import ArchConfig, register

ARCH = register(
    ArchConfig(
        name="yi-6b",
        family="dense",
        source="arXiv:2403.04652; hf",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=4,
        head_dim=128,
        d_ff=11008,
        vocab_size=64000,
        mixer="attention",
        mlp_act="swiglu",
        norm="rmsnorm",
        rope_theta=10_000.0,
    )
)
