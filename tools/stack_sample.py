"""Run a Python script under a low-cost stack sampler and write where its
main thread spent its time.

    python tools/stack_sample.py OUT.json script.py [args ...]

A thread reads the main thread's stack every 0.1 s.  OUT.json gets the
sample interval and three counts, most frequent first: each function of
``script.py`` that was on the stack (``funcs``), the innermost line of
``script.py`` on it (``leaf``, ``function:line``) and the innermost frame
anywhere (``inner``, ``file:function``).  A count times the interval is
seconds.  A thread that holds the GIL in a long C call delays the samples
taken meanwhile, so such stretches are undercounted.  The script runs as
``__main__`` with the current directory first on ``sys.path``; its exit
code is kept.
"""

from __future__ import annotations

import collections
import json
import os
import runpy
import sys
import threading
import time
import traceback

INTERVAL_S = 0.1


def main() -> None:
    out_path, script = sys.argv[1], sys.argv[2]
    name = os.path.basename(script)
    main_id = threading.get_ident()
    funcs, leaf, inner = (collections.Counter() for _ in range(3))
    done = threading.Event()

    def sample() -> None:
        while not done.wait(INTERVAL_S):
            frame = sys._current_frames().get(main_id)
            if frame is None:
                continue
            stack = traceback.extract_stack(frame)
            mine = [f for f in stack if os.path.basename(f.filename) == name]
            for fn in {f.name for f in mine}:
                funcs[fn] += 1
            if mine:
                leaf[f"{mine[-1].name}:{mine[-1].lineno}"] += 1
            inner[f"{os.path.basename(stack[-1].filename)}:{stack[-1].name}"] += 1

    threading.Thread(target=sample, daemon=True).start()
    sys.argv = sys.argv[2:]
    sys.path[0] = os.getcwd()
    try:
        runpy.run_path(script, run_name="__main__")
    finally:
        done.set()
        with open(out_path, "w") as fh:
            json.dump({"interval_s": INTERVAL_S, "funcs": funcs.most_common(80),
                       "leaf": leaf.most_common(150), "inner": inner.most_common(60)},
                      fh, indent=0)


if __name__ == "__main__":
    main()
