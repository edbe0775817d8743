"""granite-moe-3b-a800m: 40-expert top-8 MoE, GQA.

[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]. 40 experts are padded to 48
(-inf router logits on pads; exact) so experts shard over the model axis of 16.
"""
from repro_torch.configs.base import ArchConfig, register

ARCH = register(
    ArchConfig(
        name="granite-moe-3b-a800m",
        family="moe",
        source="hf:ibm-granite/granite-3.0-1b-a400m-base; hf",
        num_layers=32,
        d_model=1536,
        num_heads=24,
        num_kv_heads=8,
        head_dim=64,
        d_ff=512,  # per-expert
        vocab_size=49155,
        mixer="attention",
        mlp_act="swiglu",
        norm="rmsnorm",
        rope_theta=10_000.0,
        num_experts=40,
        top_k=8,
        tie_embeddings=True,
    )
)
