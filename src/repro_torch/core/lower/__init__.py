from .to_sim import SimulationError, simulate, simulate_batch  # noqa: F401
from .to_torch import lower_to_torch  # noqa: F401
from .to_cuda import lower_to_cuda  # noqa: F401
