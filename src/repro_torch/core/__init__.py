"""COX core on torch: hierarchical collapsing for CUDA-style SPMD kernels.

Public surface:

    from repro_torch.core import cox          # kernel decorator + dtypes
    from repro_torch.core.execute import compile_kernel
    from repro_torch.core.oracle import run_grid as oracle_run
"""

from . import api as cox  # noqa: F401
from .types import BarrierLevel, CoxUnsupported, DType, WARP_SIZE  # noqa: F401
