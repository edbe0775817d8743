from repro_torch.kernels.stencil5.ops import stencil5  # noqa: F401
from repro_torch.kernels.stencil5.ref import stencil5_ref  # noqa: F401
