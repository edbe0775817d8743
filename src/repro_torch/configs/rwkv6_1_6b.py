"""rwkv6-1.6b (Finch): attention-free, data-dependent decay. [arXiv:2404.05892; unverified]

SSM family => runs long_500k (state is O(L * H * hs^2), sequence-length free).
"""
from repro_torch.configs.base import ArchConfig, register

ARCH = register(
    ArchConfig(
        name="rwkv6-1.6b",
        family="ssm",
        source="arXiv:2404.05892; unverified",
        num_layers=24,
        d_model=2048,
        num_heads=0,  # attention-free
        num_kv_heads=0,
        d_ff=7168,
        vocab_size=65536,
        mixer="rwkv6",
        norm="layernorm",
        pos_emb="none",
        rwkv_head_size=64,
        rwkv_lora_rank=32,
    )
)
