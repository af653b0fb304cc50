"""The persistent run-stats store: observed cardinalities per plan.

The port of ``cylon_tpu/observe/stats.py``.  After an EXPLAIN ANALYZE
run, what the engine OBSERVED (per-node rows in/out, bytes moved,
wall-clock, the planner's decision) is recorded here keyed by the
**plan-cache fingerprint** (``plan/executor.py``'s compiled-plan cache
key, digested to a stable hex string), so a later planner pass can read
observed rather than assumed cardinalities back (``STORE.get(digest)``).

Storage is in-memory with optional JSON persistence: when
``CYLON_STATS_PATH`` names a file, the store loads it at first use and
flushes dirty records back, at most once per
:data:`StatsStore.SAVE_INTERVAL_S` on the recording path, plus an
``atexit`` hook and explicit ``save()``.  A corrupt file reads as a cold
store.

Digest wiring: ``plan/executor.materialize`` calls :func:`note_plan`
with its cache key on every materialization; the call is a no-op unless
a collector (:func:`collect_digests`) is open on the thread (the ANALYZE
runner opens one around a query), so plain eager runs pay one
thread-local read.
"""
from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, List, Optional

import torch

from .locks import OrderedLock

__all__ = ["StatsStore", "STORE", "plan_digest", "note_plan",
           "collect_digests"]


def _canon(x) -> Any:
    """Canonicalize one fingerprint element into a stable, hashable
    description: primitives pass through; containers recurse; a torch
    device or dtype becomes its name; anything else degrades to its type
    name and repr.  Equal cache keys give equal digests within a
    process; across processes the structural parts (ops, schemas,
    counts, the configuration) must match too, which is the plan-cache
    contract."""
    if x is None or isinstance(x, (bool, int, float, str, bytes)):
        return x
    if isinstance(x, (tuple, list)):
        return tuple(_canon(v) for v in x)
    if isinstance(x, dict):
        return tuple(sorted((str(k), _canon(v)) for k, v in x.items()))
    if isinstance(x, (torch.device, torch.dtype)):
        return (type(x).__name__, str(x))
    return (type(x).__name__, repr(x))


def plan_digest(key) -> str:
    """Stable hex digest of one compiled-plan cache key — the stats
    store's fingerprint string (short enough for JSON keys, long enough
    not to collide)."""
    blob = repr(_canon(key)).encode()
    return hashlib.sha1(blob).hexdigest()[:20]


# ---------------------------------------------------------------------------
# digest collection (executor → per-query attribution)
# ---------------------------------------------------------------------------

_tls = threading.local()

@contextmanager
def collect_digests():
    """Collect the plan digests of every ``materialize`` on this thread
    inside the block; yields the (live) list.  Nests: inner collectors
    shadow outer ones for their extent (a pre-flighted sub-plan's
    digests belong to the pre-flight, not the enclosing query)."""
    stack = getattr(_tls, "collectors", None)
    if stack is None:
        stack = _tls.collectors = []
    out: List[str] = []
    stack.append(out)
    try:
        yield out
    finally:
        stack.pop()


def note_plan(key) -> Optional[str]:
    """Record the digest of one materialization's cache key into the
    active collector (no-op — and no digest computed — without one).
    Called by ``plan/executor.materialize`` on every run."""
    stack = getattr(_tls, "collectors", None)
    if not stack:
        return None
    d = plan_digest(key)
    if d not in stack[-1]:
        stack[-1].append(d)
    return d


# ---------------------------------------------------------------------------
# the store
# ---------------------------------------------------------------------------

class StatsStore:
    """fingerprint digest → observed-run record.

    Record shape (all fields optional except ``runs``)::

        {"label": "q9",            # last label a recorder attached
         "runs": 3,                # times this fingerprint executed
         "nodes": [{"op", "rows_in", "rows_out", "ms", "bytes_moved",
                    "decision", "exchange"}, ...],   # last ANALYZE run
         "counters": {...},        # last run's counter slice
         "latency_ms": 12.3,       # last served latency
         "updated_s": 1723...}     # wall-clock of the last record

    Thread-safe; reads return copies.  ``CYLON_STATS_PATH`` (or an
    explicit ``path``) enables JSON persistence — loaded lazily at
    first access, flushed on the recording path at most once per
    ``SAVE_INTERVAL_S`` (plus atexit / explicit ``save()``)."""

    # writes closer together than this batch into one disk flush — a
    # sustained serving loop records per query, and rewriting the whole
    # JSON map per record would be O(N^2) I/O on the dispatcher thread
    # (the dirty state is flushed by the next record past the window,
    # an explicit save(), or the atexit hook)
    SAVE_INTERVAL_S = 1.0

    def __init__(self, path: Optional[str] = None) -> None:
        self._lock = OrderedLock("observe.stats")
        self._records: Dict[str, Dict[str, Any]] = {}
        self._path = path
        self._loaded = False
        self._dirty = False
        self._last_save = 0.0
        self._atexit_registered = False

    # -- persistence --------------------------------------------------------

    def _resolve_path(self) -> Optional[str]:
        if self._path is not None:
            return self._path
        return os.environ.get("CYLON_STATS_PATH") or None

    def _ensure_loaded_locked(self) -> None:
        if self._loaded:
            return
        self._loaded = True
        path = self._resolve_path()
        if not path or not os.path.exists(path):
            return
        try:
            with open(path) as f:
                data = json.load(f)
            if isinstance(data, dict):
                # on-disk records merge UNDER in-memory ones: anything
                # recorded before the lazy load wins over stale disk
                for k, v in data.items():
                    if isinstance(v, dict):
                        self._records.setdefault(k, v)
        except (OSError, ValueError):
            pass  # a corrupt stats file just means a cold store

    def _save_locked(self) -> None:
        path = self._resolve_path()
        if not path:
            self._dirty = False
            return
        try:
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(self._records, f, sort_keys=True)
            os.replace(tmp, path)
        except OSError:
            pass  # persistence is best-effort; never fail the run
        self._dirty = False
        self._last_save = time.monotonic()

    def _flush_maybe_locked(self) -> None:
        """Flush dirty state when the save window elapsed; otherwise
        just arm the atexit hook so nothing recorded is ever lost."""
        if not self._resolve_path():
            self._dirty = False
            return
        if not self._atexit_registered:
            import atexit
            atexit.register(self._flush_at_exit)
            self._atexit_registered = True
        if time.monotonic() - self._last_save >= self.SAVE_INTERVAL_S:
            self._save_locked()

    def _flush_at_exit(self) -> None:
        # bounded acquire: at interpreter exit a daemon thread (a serve
        # dispatcher mid-record, a sampler) can hold the lock and then
        # be frozen by runtime teardown — a plain acquire would hang
        # the whole exit inside atexit.  Missing one final flush beats
        # deadlocking shutdown; explicit save() remains unbounded.
        if not self._lock.acquire(timeout=2.0):
            return
        try:
            if self._dirty:
                self._save_locked()
        finally:
            self._lock.release()

    def save(self, path: Optional[str] = None) -> None:
        """Explicit save (to ``path`` or the resolved default)."""
        with self._lock:
            self._ensure_loaded_locked()
            if path is not None:
                prev, self._path = self._path, path
                try:
                    self._save_locked()
                finally:
                    self._path = prev
            else:
                self._save_locked()

    def load(self, path: Optional[str] = None) -> None:
        """Explicit (re)load — merges the file's records under any
        already in memory."""
        with self._lock:
            if path is not None:
                self._path = path
            self._loaded = False
            self._ensure_loaded_locked()

    # -- writes -------------------------------------------------------------

    def _record(self, digest: str, updates: Dict[str, Any]) -> None:
        from .. import trace
        with self._lock:
            self._ensure_loaded_locked()
            rec = self._records.setdefault(digest, {"runs": 0})
            rec["runs"] = int(rec.get("runs", 0)) + 1
            for k, v in updates.items():
                if v is not None:
                    rec[k] = v
            rec["updated_s"] = time.time()
            n = len(self._records)
            self._dirty = True
            self._flush_maybe_locked()
        trace.count("stats.records")
        trace.gauge("stats.fingerprints", n)

    def record_report(self, digest: str, report,
                      label: Optional[str] = None) -> None:
        """Record an EXPLAIN ANALYZE report's per-node observations
        under ``digest`` — the full-cardinality form (rows in/out per
        node, bytes, ms, decision, exchange strategy annotation)."""
        nodes = []
        for n in getattr(report, "nodes", ()):
            rt = n.runtime or {}
            nodes.append({
                "op": n.op,
                "rows_in": rt.get("rows_in"),
                "rows_out": rt.get("rows_out"),
                "ms": round(float(rt.get("ms", 0.0)), 3),
                "bytes_moved": rt.get("bytes_moved", 0),
                "decision": rt.get("decision"),
                "exchange": n.info.get("exchange"),
                "peak": n.info.get("peak"),
            })
        totals = getattr(report, "totals", {}) or {}
        self._record(digest, {
            "label": label, "nodes": nodes,
            "counters": dict(totals.get("counters", {})),
        })

    def record_run(self, digest: str, counters: Optional[Dict] = None,
                   latency_ms: Optional[float] = None,
                   label: Optional[str] = None) -> None:
        """Record one eager execution's counter slice + latency under
        ``digest`` (the cheap form — no per-node sync cost; node
        cardinalities come from ANALYZE runs of the same fingerprint)."""
        self._record(digest, {
            "label": label,
            "counters": dict(counters) if counters else None,
            "latency_ms": (None if latency_ms is None
                           else round(float(latency_ms), 3)),
        })

    def set_label(self, digest: str, label: str) -> None:
        with self._lock:
            self._ensure_loaded_locked()
            if digest in self._records:
                self._records[digest]["label"] = label
                self._dirty = True
                self._flush_maybe_locked()

    # -- reads -----------------------------------------------------------------

    def get(self, digest: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            self._ensure_loaded_locked()
            rec = self._records.get(digest)
            return None if rec is None else json.loads(json.dumps(rec))

    def fingerprints(self) -> List[str]:
        with self._lock:
            self._ensure_loaded_locked()
            return sorted(self._records)

    def observed_rows(self, digest: str) -> Dict[str, int]:
        """op → last observed output rows for one fingerprint (ops
        without a recorded rows_out are omitted)."""
        rec = self.get(digest)
        out: Dict[str, int] = {}
        for n in (rec or {}).get("nodes", []):
            if n.get("rows_out") is not None:
                out[n["op"]] = int(n["rows_out"])
        return out

    def clear(self) -> None:
        """Drop every in-memory record (tests).  The on-disk file is
        not touched BY THE CLEAR — but a cleared store stays clear
        (the lazy load is marked done), so a LATER record's flush
        rewrites the file without the cleared entries.  Don't clear a
        persistence-enabled store you intend to keep."""
        with self._lock:
            self._records.clear()
            self._loaded = True  # a clear store must stay clear
            self._dirty = False


STORE = StatsStore()
