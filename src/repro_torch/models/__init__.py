"""The model stack of the port: configs' layers as ``nn.Module``s (attention,
MoE, rwkv6 and rglru blocks), the decode caches and the weight loader from
the JAX package's tree."""
from repro_torch.models.cache import init_cache, kv_head_layout  # noqa: F401
from repro_torch.models.convert import load_jax_params, numpy_params  # noqa: F401
from repro_torch.models.layers import RunPolicy  # noqa: F401
from repro_torch.models.layout import HeadLayout  # noqa: F401
from repro_torch.models.rglru import RgLru, linear_scan  # noqa: F401
from repro_torch.models.rwkv import (  # noqa: F401
    RwkvChannelMix,
    RwkvTimeMix,
    wkv6_chunked,
    wkv6_ref,
)
from repro_torch.models.transformer import TransformerLM, init_params  # noqa: F401
