"""Shared process-pool mapper with graceful serial fallback.

Every parallel path in the compiler (per-function scheduling, per-candidate
DSE evaluation, per-module backend emission) funnels through
:func:`pool_map`: the worker function must be a top-level callable (the pool
pickles it by reference) and the payloads must be picklable — in practice,
printed IR text plus plain config objects, never live RTL trees (whose
interned expression keys are process-local, see PR 5).

When no pool can be created — sandboxes without ``/dev/shm`` semaphores, a
missing ``multiprocessing`` start method, restricted CI runners — the mapper
returns ``None`` after emitting a :class:`RuntimeWarning`, and the caller
runs its serial path, which by contract produces the identical result."""

from __future__ import annotations

import pickle
import warnings
from concurrent.futures import ProcessPoolExecutor
from concurrent.futures.process import BrokenProcessPool
from typing import Callable, Optional, Sequence

#: failures that mean "no usable pool here", not "the work itself is broken":
#: semaphore/fork denials (OSError/PermissionError), missing start methods
#: (RuntimeError), workers dying (BrokenProcessPool), unpicklable payloads
#: (PicklingError).  Anything else — including MemoryError and the worker
#: function's own exceptions — propagates to the caller.
POOL_FALLBACK_ERRORS = (OSError, RuntimeError, BrokenProcessPool,
                        pickle.PicklingError)


def pool_map(fn: Callable, payloads: Sequence, max_workers: int, *,
             label: str = "work") -> Optional[list]:
    """Map ``fn`` over ``payloads`` on a ``ProcessPoolExecutor``.

    Returns the result list in payload order, or ``None`` when the pool is
    unavailable (or pointless: one worker / one payload) — the caller then
    falls back to serial execution.  Only pool-infrastructure failures
    (:data:`POOL_FALLBACK_ERRORS`) degrade to the serial path; a genuine
    error raised by ``fn`` is re-raised so bugs are not retried serially."""
    if max_workers <= 1 or len(payloads) <= 1:
        return None
    try:
        with ProcessPoolExecutor(max_workers=max_workers) as ex:
            return list(ex.map(fn, payloads))
    except POOL_FALLBACK_ERRORS as e:
        warnings.warn(
            f"process pool unavailable for {label} "
            f"({type(e).__name__}: {e}); falling back to serial execution",
            RuntimeWarning, stacklevel=2)
        return None
