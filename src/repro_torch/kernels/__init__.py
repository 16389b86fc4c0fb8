"""Hand-written CUDA kernels for Hopper (``csrc/``) and their wrappers.

  matmul            tiled matmul (the paper's systolic GEMM binding)

Use via ``repro_torch.kernels.ops`` (padding).  Each kernel has a plain
PyTorch version in ``ref`` that CPU tensors take.
"""

from . import ops  # noqa: F401
from .ref import matmul_ref  # noqa: F401
