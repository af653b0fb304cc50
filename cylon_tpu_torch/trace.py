"""Named counters: how many times a path ran, how many bytes it moved.

The counter part of ``cylon_tpu/trace.py``.  Counters are off until
``enable_counters()``; a disabled ``count`` costs one flag read and never
reads the device.  Operators bump them where the host already holds the
number (the shuffle's count matrix, a replica's row bound), so counting
adds no host sync either.  Sums and maxima merge across threads at read
time.  Names and meanings are the JAX package's:

    shuffle.rows_sent / shuffle.bytes_sent    rows (and bytes) a hash or
                                              range exchange moved off
                                              their shard
    shuffle.exchanges                         exchanges run
    broadcast.rows_sent / broadcast.bytes_sent  replica rows sent to the
                                              other P - 1 shards
    groupby.bytes_moved                       the groupby-owned part of
                                              both byte counters
    join.broadcast / join.multiway / groupby.pushdown /
    groupby.psum_combine                      strategy decisions
    plan.* / optimizer.*                      the planner (plan/executor.py)

Spans, the flight recorder and export are not ported.
"""
from __future__ import annotations

import threading
from typing import Dict

__all__ = ["count", "count_max", "enable_counters", "disable_counters",
           "counters_enabled", "reset", "counters"]

_counters_enabled = False
_lock = threading.Lock()
_sums: Dict[str, int] = {}
_maxima: Dict[str, int] = {}


def enable_counters() -> None:
    global _counters_enabled
    _counters_enabled = True


def disable_counters() -> None:
    global _counters_enabled
    _counters_enabled = False


def counters_enabled() -> bool:
    return _counters_enabled


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the named counter (no-op while counters are off)."""
    if not _counters_enabled:
        return
    with _lock:
        _sums[name] = _sums.get(name, 0) + int(n)


def count_max(name: str, n: int) -> None:
    """Record the largest value a named quantity reaches."""
    if not _counters_enabled:
        return
    with _lock:
        _maxima[name] = max(_maxima.get(name, int(n)), int(n))


def reset() -> None:
    """Clear every counter."""
    with _lock:
        _sums.clear()
        _maxima.clear()


def counters() -> Dict[str, int]:
    """A copy of every counter: sums, then maxima."""
    with _lock:
        out = dict(_sums)
        out.update(_maxima)
    return out
