"""OrderedLock: the runtime half of the concurrency discipline.

The port of ``cylon_tpu/observe/locks.py``.  ``OrderedLock`` is a named
drop-in for ``threading.Lock`` (and, with ``reentrant=True``,
``threading.RLock``) that

* counts acquisitions and tracks a held-time watermark
  (``lock.acquires`` / ``lock.held_us`` in the observe catalogue);
* maintains a per-thread acquisition stack and, whenever a thread
  acquires B while holding A, inserts the edge A→B into a process-wide
  lock-order DAG (with the first witness site per edge);
* detects a cycle at edge-insert time, BEFORE blocking on the inner
  lock, so the AB/BA deadlock is reported instead of experienced.  A
  cycle raises a typed :class:`LockOrderViolation` naming both chains
  when enforcement is on (``CYLON_LOCKCHECK=1`` /
  ``config.set_lockcheck``); otherwise it is recorded to the flight
  recorder and warned once;
* feeds a hold-time watchdog: a release after holding longer than
  ``config.lock_hold_watchdog_ms()`` notes the event into the flight
  recorder ring, where ``doctor`` renders it next to the DAG.

Deliberately NOT OrderedLocks: ``MetricsRegistry._lock`` and
``flightrec._lock``, since OrderedLock's own telemetry calls into those
modules and wrapping them would recurse.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

from ..status import Code, CylonError, Status

__all__ = ["OrderedLock", "LockOrderViolation", "lock_graph",
           "clear_graph", "known_locks"]


class LockOrderViolation(CylonError):
    """Typed lock-order (potential-deadlock) report: acquiring this
    lock here inverts an order the process has already witnessed.  The
    message names both chains — the recorded path that orders the locks
    one way, and this thread's held stack ordering them the other way —
    each with the thread and call site that first witnessed it.

    Raised at acquire time (before blocking) under enforcement
    (``CYLON_LOCKCHECK=1`` / ``config.set_lockcheck(True)``); recorded
    to flightrec + warn_once otherwise."""

    def __init__(self, msg: str, cycle: List[str]):
        super().__init__(Status(Code.ExecutionError, msg))
        self.cycle = list(cycle)


# ---------------------------------------------------------------------------
# process-wide lock-order DAG
#
# _edges[src][dst] = (thread_name, "file:line") — the first witness of
# a thread acquiring dst while holding src.  Guarded by _graph_lock,
# which stays a PLAIN threading.Lock on purpose: it is the detector's
# own internals, always leaf-level, and wrapping it in OrderedLock
# would recurse.
# ---------------------------------------------------------------------------

_graph_lock = threading.Lock()
_edges: Dict[str, Dict[str, Tuple[str, str]]] = {}
_names: Dict[str, "OrderedLock"] = {}   # name -> most recent instance

_tls = threading.local()


def _stack() -> List["OrderedLock"]:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def _caller_site() -> str:
    """file:line of the nearest frame outside this module (the acquire
    site a human would grep for)."""
    import sys

    f = sys._getframe(1)
    while f is not None and f.f_code.co_filename == __file__:
        f = f.f_back
    if f is None:
        return "?"
    return f"{f.f_code.co_filename.rsplit('/', 1)[-1]}:{f.f_lineno}"


def _find_path(src: str, dst: str) -> Optional[List[str]]:
    """A path src ⇝ dst in the DAG, or None.  Caller holds _graph_lock."""
    seen = {src}
    trail = [(src, [src])]
    while trail:
        node, path = trail.pop()
        for nxt in _edges.get(node, {}):
            if nxt == dst:
                return path + [nxt]
            if nxt not in seen:
                seen.add(nxt)
                trail.append((nxt, path + [nxt]))
    return None


def _fmt_chain(path: List[str]) -> str:
    """Render a DAG path with each edge's first witness site."""
    parts = [path[0]]
    for a, b in zip(path, path[1:]):
        thr, site = _edges.get(a, {}).get(b, ("?", "?"))
        parts.append(f"-> {b} (first seen: thread {thr!r} at {site})")
    return " ".join(parts)


def lock_graph() -> Dict[str, Dict[str, Tuple[str, str]]]:
    """A snapshot of the lock-order DAG: {src: {dst: (thread, site)}}.
    Read by tests and by live triage; crash bundles carry the same
    edges as ``lock_edge`` flightrec events."""
    with _graph_lock:
        return {src: dict(dsts) for src, dsts in _edges.items()}


def known_locks() -> Dict[str, "OrderedLock"]:
    """Name → most-recently-constructed OrderedLock (telemetry view)."""
    with _graph_lock:
        return dict(_names)


def clear_graph() -> None:
    """Forget every recorded edge (test isolation; the per-lock
    counters on live instances are untouched)."""
    with _graph_lock:
        _edges.clear()


def _enforcing() -> bool:
    from .. import config

    return config.lockcheck_enabled()


def _note(kind: str, **payload) -> None:
    from . import flightrec

    flightrec.note(kind, **payload)


class OrderedLock:
    """A named lock with order checking, acquisition counters and a
    held-time watermark.  Drop-in for ``threading.Lock``
    (``reentrant=True`` for ``threading.RLock`` call sites); also
    Condition-compatible — ``threading.Condition(OrderedLock("x"))``
    works because CPython's Condition falls back to
    acquire/release/try-acquire for foreign lock types.
    """

    __slots__ = ("name", "reentrant", "_inner", "acquires",
                 "held_us_max", "_acquired_at")

    def __init__(self, name: str, *, reentrant: bool = False):
        self.name = str(name)
        self.reentrant = bool(reentrant)
        self._inner = (threading.RLock() if reentrant
                       else threading.Lock())
        self.acquires = 0          # lifetime acquisition count
        self.held_us_max = 0       # peak outermost hold, microseconds
        self._acquired_at = 0.0    # outermost-acquire timestamp
        with _graph_lock:
            _names[self.name] = self

    def __repr__(self) -> str:
        return (f"OrderedLock({self.name!r}"
                + (", reentrant=True" if self.reentrant else "") + ")")

    # -- order bookkeeping --------------------------------------------

    def _record_order(self) -> None:
        """Insert the edge (innermost held lock) → self, cycle-checking
        at insert time.  Runs BEFORE the inner acquire so an inversion
        is reported instead of deadlocking."""
        stack = _stack()
        if not stack:
            return
        held = stack[-1]
        if held is self or held.name == self.name:
            return
        src, dst = held.name, self.name
        site = None
        with _graph_lock:
            dsts = _edges.setdefault(src, {})
            if dst in dsts:
                return                      # edge already witnessed
            back = _find_path(dst, src)     # would this edge close a cycle?
            if back is None:
                site = _caller_site()
                dsts[dst] = (threading.current_thread().name, site)
                prior = None
            else:
                prior = _fmt_chain(back)
        if prior is None:
            _note("lock_edge", src=src, dst=dst,
                  thread=threading.current_thread().name, site=site)
            return
        # cycle: the DAG already orders dst ⇝ src; this thread is
        # ordering src → dst.  Name both chains.
        here = " -> ".join([lk.name for lk in stack] + [dst])
        msg = (f"lock-order violation: thread "
               f"{threading.current_thread().name!r} at {_caller_site()} "
               f"acquires {dst!r} while holding {src!r} ({here}), but "
               f"the recorded order is {prior} — an AB/BA inversion "
               f"that can deadlock")
        from .. import trace

        trace.count("lock.order_violations")
        _note("lock_violation", src=src, dst=dst, chain_held=here,
              chain_prior=prior,
              thread=threading.current_thread().name)
        if _enforcing():
            raise LockOrderViolation(msg, back + [dst])
        # warn_once itself acquires an OrderedLock; the tls flag keeps
        # a violation detected INSIDE that acquire from re-entering
        if not getattr(_tls, "in_violation", False):
            _tls.in_violation = True
            try:
                from .. import logging as glog

                glog.warn_once(("lock.order", src, dst), "%s", msg)
            finally:
                _tls.in_violation = False

    def _on_acquired(self) -> None:
        self.acquires += 1
        self._acquired_at = time.perf_counter()
        _stack().append(self)

    def _depth(self) -> int:
        """How many times THIS thread currently holds self."""
        return sum(1 for lk in _stack() if lk is self)

    # -- the Lock protocol --------------------------------------------

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if self._depth() > 0:
            # re-acquire of an already-held lock: no ordering edge.
            # Reentrant locks nest (push for symmetric release);
            # non-reentrant re-acquire is Condition._is_owned probing
            # with blocking=False, or a genuine self-deadlock — either
            # way the inner lock gives the true answer.
            if self.reentrant:
                ok = self._inner.acquire(blocking, timeout)
                if ok:
                    _stack().append(self)
                return ok
            return self._inner.acquire(False)
        self._record_order()
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            self._on_acquired()
        return ok

    def release(self) -> None:
        stack = _stack()
        outermost = self._depth() == 1
        held_us = 0
        if outermost and self._acquired_at:
            held_us = int((time.perf_counter() - self._acquired_at) * 1e6)
        self._inner.release()
        # unwind the tracking stack from the top (locks may be released
        # out of LIFO order; remove the nearest entry)
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] is self:
                del stack[i]
                break
        if not outermost:
            return
        if held_us > self.held_us_max:
            self.held_us_max = held_us
        from .. import trace

        trace.count("lock.acquires")
        trace.count_max("lock.held_us", held_us)
        from .. import config

        watchdog_ms = config.lock_hold_watchdog_ms()
        if watchdog_ms > 0 and held_us >= watchdog_ms * 1000:
            trace.count("lock.hold_watchdog")
            _note("lock_hold", lock=self.name, held_ms=held_us // 1000,
                  watchdog_ms=watchdog_ms,
                  thread=threading.current_thread().name)

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        if self.reentrant:
            if self._depth() > 0:
                return True
            if self._inner.acquire(False):
                self._inner.release()
                return False
            return True
        return self._inner.locked()
