"""Hand-written CUDA kernels for Hopper (``csrc/``) and their wrappers.

  matmul            tiled matmul (the paper's systolic GEMM binding)     K2
  flash_attention   causal / windowed / GQA attention, online softmax    K3
  decode_attention  one token against a KV cache, per-lane lengths      K4
  ssd_scan          Mamba-2 SSD chunked scan                             K5
  rglru_scan        RG-LRU diagonal linear recurrence                    K6

Use via ``repro_torch.kernels.ops`` (padding, model layouts).  Each kernel
has a plain PyTorch version in ``ref`` that CPU tensors take.
"""

from . import ops  # noqa: F401
from .ref import (decode_attention_ref, flash_attention_ref, matmul_ref,  # noqa: F401
                  rglru_scan_ref, ssd_scan_ref)
