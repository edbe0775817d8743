"""recurrentgemma-2b: RG-LRU + local attention, 2 recurrent : 1 attention.

[arXiv:2402.19427; hf]. Hybrid => runs long_500k (sub-quadratic).
"""
from repro_torch.configs.base import ArchConfig, register

ARCH = register(
    ArchConfig(
        name="recurrentgemma-2b",
        family="hybrid",
        source="arXiv:2402.19427; hf",
        num_layers=26,
        d_model=2560,
        num_heads=10,
        num_kv_heads=1,  # MQA on local-attention layers
        head_dim=256,
        d_ff=7680,
        vocab_size=256_000,
        mixer="rglru_hybrid",
        layer_pattern=("rglru", "rglru", "local"),
        local_window=2048,
        lru_width=2560,
        conv_width=4,
        mlp_act="geglu",
        norm="rmsnorm",
        rope_theta=10_000.0,
        tie_embeddings=True,
    )
)
