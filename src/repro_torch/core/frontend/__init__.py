"""Model-to-accelerator frontend: trace restricted integer PyTorch programs
into scheduled HIR designs (see ``tracer`` for the supported subset and
``workloads`` for the traced gallery kernels)."""

from .tracer import (FrontendError, SUPPORTED_PRIMITIVES,  # noqa: F401
                     UnsupportedPrimitiveError, trace)
from .workloads import (FRONTEND_WORKLOADS, frontend_matmul,  # noqa: F401
                        frontend_scan, frontend_softmax_row)
