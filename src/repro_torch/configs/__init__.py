"""Assigned-architecture registry. Importing this package registers all archs."""
from repro_torch.configs.base import (  # noqa: F401
    SHAPES,
    ArchConfig,
    RunShape,
    cells,
    get_config,
    input_specs,
    list_archs,
    register,
)

# one module per assigned architecture (registration side-effect)
from repro_torch.configs import (  # noqa: F401
    chameleon_34b,
    granite_moe_3b_a800m,
    musicgen_medium,
    olmoe_1b_7b,
    qwen2_5_32b,
    recurrentgemma_2b,
    rwkv6_1_6b,
    starcoder2_7b,
    yi_6b,
    yi_9b,
)
