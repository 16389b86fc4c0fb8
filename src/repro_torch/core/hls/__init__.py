from .eraser import erase_schedule  # noqa: F401
from .scheduler import (HLSResult, HLSScheduler, SchedulerOptions,  # noqa: F401
                        hls_compile, hls_schedule)
from .dse import (COMPILE_CACHE, FUNC_CODEGEN_CACHE,  # noqa: F401
                  SCHEDULE_CACHE, CompileCache, DiskCompileCache, DSEConfig,
                  DSEPoint, DSEResult, FuncCodegenCache, ScheduleCache,
                  apply_structural_knobs, design_space, estimate_resources,
                  explore_design, fingerprint_func, merge_local_banks,
                  pareto_front, partition_local_banks, sim_verify_front)
