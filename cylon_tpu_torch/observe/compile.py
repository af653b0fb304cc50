"""Build observability: make every kernel build a measured event.

The port of ``cylon_tpu/observe/compile.py``.  The JAX package's builds
are XLA compiles of jit programs; the port has none.  Its build events
are:

  * the ``nvcc`` build of a CUDA source under ``csrc/`` and its load
    (``ops/hash_cuda.py`` reports it through :func:`record_build`): a
    library already loaded in this process is a cache hit;
  * the first call of each new shape signature through a kernel built by
    a factory wrapped in :func:`kernel_factory` (a drop-in for
    ``functools.lru_cache(maxsize=None)``; factory misses feed the
    recompile-storm detector).

Each build tallies ``compile.builds`` / ``compile.build_us``, records a
``compile.build`` span (args: factory, key, build ms) and is attributed
to the innermost open collector (:func:`attribute_compiles`; EXPLAIN
ANALYZE opens one, so ``report.totals["compile_ms"]`` is exact).  Cache
traffic tallies ``compile.cache_hits`` / ``compile.cache_misses``.

The recompile-storm detector: when one factory builds
:data:`STORM_KEYS` distinct keys within :data:`STORM_WINDOW_S` seconds, a
``glog.warn_once`` names the key component that varies, and
``compile.storms`` tallies.

The JAX package's ``serial_call`` (a launch lock for XLA's CPU
collective rendezvous) has no PyTorch counterpart and is not ported.
"""
from __future__ import annotations

import functools
import inspect
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Any, Dict, List, Optional, Tuple

import torch

from .locks import OrderedLock

__all__ = ["kernel_factory", "attribute_compiles", "note_build",
           "record_build", "clear_state", "STORM_KEYS", "STORM_WINDOW_S"]

# the storm detector's window: this many DISTINCT cache keys built by
# one factory within this many seconds is a rebuild storm worth a warn
STORM_KEYS = 8
STORM_WINDOW_S = 30.0

# how much of a cache key / key component run the warn line renders
_KEY_REPR_LEN = 120


# ---------------------------------------------------------------------------
# per-query attribution (EXPLAIN ANALYZE opens a collector)
# ---------------------------------------------------------------------------

_tls = threading.local()


@contextmanager
def attribute_compiles():
    """Collect every build event on this thread inside the block; yields
    the (live) list of ``{"factory", "key", "compile_ms", "trace_ms"}``
    dicts.  Nests: the innermost collector owns the events of its
    extent."""
    stack = getattr(_tls, "collectors", None)
    if stack is None:
        stack = _tls.collectors = []
    out: List[Dict[str, Any]] = []
    stack.append(out)
    try:
        yield out
    finally:
        stack.pop()


def _attribute(event: Dict[str, Any]) -> None:
    stack = getattr(_tls, "collectors", None)
    if stack:
        stack[-1].append(event)


def _observing() -> bool:
    """Is anyone watching builds right now: counters on, or a collector
    open on this thread?  The kernel handles' fast-path gate."""
    from .. import trace
    if trace.counters_enabled():
        return True
    return bool(getattr(_tls, "collectors", None))


# ---------------------------------------------------------------------------
# recompile-storm detection (factory-level, on cache misses)
# ---------------------------------------------------------------------------

GUARDED_STATE = {"_recent_keys": "_storm_lock"}

_storm_lock = OrderedLock("compile.storm")
_recent_keys: Dict[str, deque] = {}   # factory -> deque[(t, key)]


def _differing_components(keys, params: Tuple[str, ...]) -> str:
    """Name the cache-key component(s) that vary across ``keys``."""
    keys = [k for k in keys if isinstance(k, tuple)]
    if not keys or len({len(k) for k in keys}) != 1:
        return "heterogeneous keys"
    parts = []
    for i in range(len(keys[0])):
        vals = []
        for k in keys:
            v = repr(k[i])
            if v not in vals:
                vals.append(v)
        if len(vals) <= 1:
            continue
        name = params[i] if i < len(params) else f"arg{i}"
        run = "/".join(sorted(vals)[:6])
        if len(vals) > 6:
            run += f"/… ({len(vals)} values)"
        parts.append(f"{name}={run}"[:_KEY_REPR_LEN])
    return ", ".join(parts) if parts else "identical keys re-built"


def note_build(factory: str, key: Tuple,
               params: Tuple[str, ...] = ()) -> None:
    """Record one cache MISS into the storm window (and tally it); fires
    the storm warning when the window fills with distinct keys."""
    from .. import trace
    trace.count("compile.cache_misses")
    now = time.monotonic()
    with _storm_lock:
        dq = _recent_keys.setdefault(factory, deque())
        dq.append((now, key))
        while dq and now - dq[0][0] > STORM_WINDOW_S:
            dq.popleft()
        distinct = {k for _, k in dq}
    if len(distinct) < STORM_KEYS:
        return
    from .. import logging as glog
    fired = glog.warn_once(
        ("compile.storm", factory),
        "recompile storm: factory %s built %d distinct kernels within "
        "%.0f s — differing key component(s): %s. A thrashing key "
        "component usually means an unquantized size or an "
        "identity-keyed callable rebuilt per call. (warned once per "
        "factory per session)",
        factory, len(distinct), STORM_WINDOW_S,
        _differing_components(distinct, params))
    if fired:
        trace.count("compile.storms")


def record_build(factory: str, key: Tuple, build_ms: float, t0: float,
                 trace_ms: Optional[float] = None) -> None:
    """Book one measured build (``t0`` on the ``time.perf_counter``
    clock): the counters, the ``compile.build`` span and the open
    collector's event."""
    from .. import trace
    trace.count("compile.builds")
    trace.count("compile.build_us", int(round(build_ms * 1e3)))
    if trace_ms is not None:
        trace.count("compile.trace_us", int(round(trace_ms * 1e3)))
    trace.record_span(
        "compile.build", t0, build_ms,
        args={"factory": factory, "key": repr(key)[:_KEY_REPR_LEN],
              "trace_ms": None if trace_ms is None else round(trace_ms, 3),
              "compile_ms": round(build_ms, 3)})
    _attribute({"factory": factory, "key": key, "compile_ms": build_ms,
                "trace_ms": trace_ms})


def clear_state() -> None:
    """Forget the storm windows (test isolation)."""
    with _storm_lock:
        _recent_keys.clear()


# ---------------------------------------------------------------------------
# the factory decorator + the per-kernel build timer
# ---------------------------------------------------------------------------

def _flatten(tree, out: List[Any]) -> List[Any]:
    if isinstance(tree, (list, tuple)):
        for x in tree:
            _flatten(x, out)
    elif isinstance(tree, dict):
        for k in sorted(tree):
            _flatten(tree[k], out)
    else:
        out.append(tree)
    return out


def _signature(args, kwargs) -> Tuple:
    """Hashable shape / dtype / device signature of one call."""
    sig: List[Any] = [len(args), tuple(sorted(kwargs))]
    for lf in _flatten((args, kwargs), []):
        if isinstance(lf, torch.Tensor):
            sig.append(("t", tuple(lf.shape), str(lf.dtype), str(lf.device)))
        else:
            sig.append(("o", lf))
    return tuple(sig)


class _KernelHandle:
    """Wraps one built kernel: transparent call-through, with the first
    call of each new shape signature timed as a build event."""

    __slots__ = ("_fn", "factory", "key", "_seen", "fresh")

    def __init__(self, fn, factory: str, key: Tuple) -> None:
        self._fn = fn
        self.factory = factory
        self.key = key
        self._seen: set = set()
        self.fresh = True

    def __call__(self, *args, **kwargs):
        # unobserved dispatch goes straight to the kernel: no signature
        if not _observing():
            return self._fn(*args, **kwargs)
        try:
            leaves = _flatten((args, kwargs), [])
            if any(isinstance(lf, torch.Tensor) and lf.device.type == "meta"
                   for lf in leaves):
                # abstract plan run: nothing builds on the device, so the
                # call is not charged as a build
                return self._fn(*args, **kwargs)
            sig = _signature(args, kwargs)
            seen = sig in self._seen
        except TypeError:
            return self._fn(*args, **kwargs)  # unhashable leaf: skip
        if seen:
            return self._fn(*args, **kwargs)
        t0 = time.perf_counter()
        out = self._fn(*args, **kwargs)
        build_ms = (time.perf_counter() - t0) * 1e3
        # mark seen AFTER a successful call: a failed first call must
        # re-measure (and re-raise) next time
        self._seen.add(sig)
        record_build(self.factory, self.key, build_ms, t0)
        return out


def kernel_factory(fn):
    """``functools.lru_cache(maxsize=None)`` for kernel factories, plus
    build observability (module docstring).  Same positional
    hashable-args contract; ``cache_clear`` / ``cache_info`` kept."""
    factory = fn.__qualname__
    try:
        params = tuple(inspect.signature(fn).parameters)
    except (TypeError, ValueError):
        params = ()

    @functools.lru_cache(maxsize=None)
    def _build(*key) -> _KernelHandle:
        return _KernelHandle(fn(*key), factory, key)

    @functools.wraps(fn)
    def wrapper(*key):
        handle = _build(*key)
        if handle.fresh:
            handle.fresh = False
            note_build(factory, key, params)
        else:
            from .. import trace
            trace.count("compile.cache_hits")
        return handle

    wrapper.cache_clear = _build.cache_clear
    wrapper.cache_info = _build.cache_info
    wrapper.__wrapped__ = fn
    return wrapper
