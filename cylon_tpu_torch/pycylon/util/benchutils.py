"""pycylon.util.benchutils over the port — reference:
python/pycylon/util/benchutils.py:35-46 (`benchmark_with_repitions`,
spelling and all)."""
from __future__ import annotations

import time

_DIV = {"ns": 1, "us": 1e3, "ms": 1e6, "s": 1e9}


def benchmark_with_repitions(repititions: int = 10, time_type: str = "ms"):
    """Decorator: run the function ``repititions`` times, return
    (mean elapsed in ``time_type``, last result)."""

    def wrap(f):
        def wrapped_f(*args, **kwargs):
            t1 = time.perf_counter_ns()
            rets = None
            for _ in range(repititions):
                rets = f(*args, **kwargs)
            t2 = time.perf_counter_ns()
            return (t2 - t1) / _DIV.get(time_type, 1e6) / float(repititions), rets

        return wrapped_f

    return wrap
