"""glog-style logging: the line format, severity gating and ``vlog``.

The port of ``cylon_tpu/logging.py`` (the reference logs through glog
exclusively, reference: cpp/src/cylon/CMakeLists.txt:91; LOG(INFO /
ERROR / FATAL) at op-phase granularity, e.g. join/join.cpp:61-102).  The
one-letter-severity line format, ``FATAL`` aborting, and a ``vlog``
verbosity gate, on stdlib printing.

Format: ``I0730 12:34:56.789012 file.py:42] message``

Env knobs (glog names, minus the GLOG_ prefix):
  CYLON_MINLOGLEVEL  0=INFO 1=WARNING 2=ERROR 3=FATAL (default 0)
  CYLON_V            vlog verbosity, ``vlog(n)`` logs when n <= CYLON_V
"""
from __future__ import annotations

import io
import os
import sys
import time
import traceback
from typing import Any

from .observe.locks import OrderedLock

INFO, WARNING, ERROR, FATAL = 0, 1, 2, 3
_LETTER = "IWEF"

_min_level = int(os.environ.get("CYLON_MINLOGLEVEL", "0"))
_verbosity = int(os.environ.get("CYLON_V", "0"))
_sink = sys.stderr


def set_min_level(level: int) -> None:
    global _min_level
    _min_level = level


def set_verbosity(v: int) -> None:
    global _verbosity
    _verbosity = v


def set_sink(stream) -> None:
    """Redirect log lines (tests, file capture)."""
    global _sink
    _sink = stream


def _emit(level: int, msg: str, depth: int = 2) -> None:
    if level < _min_level:
        return
    frame = sys._getframe(depth)
    now = time.time()
    lt = time.localtime(now)
    us = int((now % 1) * 1e6)
    fname = os.path.basename(frame.f_code.co_filename)
    line = (f"{_LETTER[level]}{lt.tm_mon:02d}{lt.tm_mday:02d} "
            f"{lt.tm_hour:02d}:{lt.tm_min:02d}:{lt.tm_sec:02d}.{us:06d} "
            f"{fname}:{frame.f_lineno}] {msg}")
    print(line, file=_sink)


def info(msg: Any, *args) -> None:
    _emit(INFO, str(msg) % args if args else str(msg))


def warning(msg: Any, *args) -> None:
    _emit(WARNING, str(msg) % args if args else str(msg))


# Keys that already warned this session (warn_once), guarded by a lock:
# concurrent callers hit the same registry, and the check-then-add pair
# must be atomic for the "at most once" promise (and the return value)
# to hold across threads.  Every write to _warned_keys holds _warn_lock.

GUARDED_STATE = {"_warned_keys": "_warn_lock"}

_warned_keys: set = set()
_warn_lock = OrderedLock("log.warn_once")


def warn_once(key: Any, msg: Any, *args) -> bool:
    """Emit a WARNING at most once per ``key`` per session; returns
    whether a line was emitted.  Thread-safe: exactly one of N racing
    callers with the same key emits (and returns True).

    The shared rate-limit behind every per-condition diagnostic (a
    lock-order inversion keyed by its lock pair, a recompile storm keyed
    by its factory): a condition hit in a loop logs one line, not one
    per call.  ``key`` must be hashable; tests reset
    with :func:`reset_warn_once`.
    """
    with _warn_lock:
        if key in _warned_keys:
            return False
        _warned_keys.add(key)
    _emit(WARNING, str(msg) % args if args else str(msg))
    return True


def reset_warn_once(key: Any = None) -> None:
    """Forget one warn_once key (or all of them) — test isolation."""
    with _warn_lock:
        if key is None:
            _warned_keys.clear()
        else:
            _warned_keys.discard(key)


def error(msg: Any, *args) -> None:
    _emit(ERROR, str(msg) % args if args else str(msg))


def fatal(msg: Any, *args) -> None:
    """LOG(FATAL): log with a stack trace, then abort (glog semantics —
    the reference relies on this in e.g. mpi_channel.cpp:85)."""
    text = str(msg) % args if args else str(msg)
    buf = io.StringIO()
    traceback.print_stack(sys._getframe(1), file=buf)
    _emit(FATAL, f"{text}\n{buf.getvalue()}")
    raise SystemExit(1)


def vlog(verbosity: int, msg: Any, *args) -> None:
    """VLOG(n): emitted at INFO severity when ``n <= CYLON_V``."""
    if verbosity <= _verbosity:
        _emit(INFO, str(msg) % args if args else str(msg))
