"""Flight recorder: a bounded ring of recent engine events + crash bundles.

The port of ``cylon_tpu/observe/flightrec.py``.

  * an always-on, bounded, thread-safe **event ring**
    (:func:`note` / :func:`events`): lock-order edges and violations,
    long lock holds, query records.  Constant memory (:data:`CAPACITY`
    events, oldest drop; ``dropped`` is visible), a dict build and a
    deque append per event, cheap enough never to turn off.
  * a **diagnostic bundle** (:func:`dump`): one JSON document holding
    the ring, a typed counter snapshot, the config fingerprint (knob
    state, the torch and CUDA versions, the card's name), the last-K
    query records, and the current Perfetto trace document: everything
    ``python -m cylon_tpu_torch.observe.doctor`` needs to render a
    post-mortem without access to the crashed process.
  * **dump-on-error**: :func:`maybe_dump_on_error` writes a bundle only
    when ``CYLON_FLIGHTREC_DIR`` names a directory (a library must not
    spray files by default), at most :data:`MAX_AUTO_DUMPS` per process.

Bundle shape is deterministic (sorted keys, fixed section set).
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

__all__ = ["note", "events", "dropped", "clear", "bundle", "dump",
           "maybe_dump_on_error", "set_tap", "config_fingerprint",
           "CAPACITY", "MAX_AUTO_DUMPS", "LAST_K_QUERIES"]

CAPACITY = int(os.environ.get("CYLON_FLIGHTREC_CAP", "256"))
MAX_AUTO_DUMPS = 3          # per process; a crash loop stays bounded
LAST_K_QUERIES = 16         # query records replicated into the bundle

_lock = threading.Lock()
_ring: deque = deque(maxlen=max(CAPACITY, 1))
_dropped = 0
_auto_dumps = 0
_dump_seq = 0   # monotone per process: two back-to-back dumps (two
#                 failures in one batch window) must never collide on
#                 a wall-clock-derived filename and clobber each other
_tap = None     # the event tap (observe/exporter.py's JSON-lines event
#                 log); called OUTSIDE _lock, so a tap that notes or
#                 logs cannot deadlock the ring


# ---------------------------------------------------------------------------
# the ring
# ---------------------------------------------------------------------------

def note(kind: str, **payload) -> None:
    """Append one event (``kind`` + JSON-serializable payload) to the
    ring."""
    global _dropped
    ev = {"t": round(time.time(), 3), "kind": kind}
    ev.update(payload)
    with _lock:
        if len(_ring) == _ring.maxlen:
            _dropped += 1
        _ring.append(ev)
    tap = _tap
    if tap is not None:
        try:
            tap(ev)
        except Exception:  # graftlint: ok[broad-except]
            # a broken tap must not take down the recorder
            pass


def set_tap(fn) -> Optional[Any]:
    """Install (``fn``) or clear (``None``) the event tap: a callable
    handed every noted event dict right after it enters the ring,
    outside the ring lock (the exporter's event log installs one).
    Returns the previous tap; tap exceptions are swallowed."""
    global _tap
    prev, _tap = _tap, fn
    return prev


def events() -> List[Dict[str, Any]]:
    """Retained events, oldest → newest (≤ :data:`CAPACITY`)."""
    with _lock:
        return list(_ring)


def dropped() -> int:
    """Events evicted by ring wrap (retention made visible, the same
    contract as the time-series sampler's ``dropped``)."""
    with _lock:
        return _dropped


def clear() -> None:
    """Drop every event and reset the auto-dump cap (test isolation)."""
    global _dropped, _auto_dumps
    with _lock:
        _ring.clear()
        _dropped = 0
        _auto_dumps = 0


# ---------------------------------------------------------------------------
# bundles
# ---------------------------------------------------------------------------

def _config_fingerprint() -> Dict[str, Any]:
    """The knob / platform state a post-mortem needs to reproduce the
    run.  Every read is best-effort: a half-torn-down process at crash
    time must still produce a bundle."""
    out: Dict[str, Any] = {}
    try:
        import sys
        out["python"] = sys.version.split()[0]
    except Exception:  # graftlint: ok[broad-except] — best-effort
        pass
    try:
        import numpy
        import torch
        out["torch"] = torch.__version__
        out["cuda"] = torch.version.cuda
        out["numpy"] = numpy.__version__
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        out["platform"] = "gpu" if n else "cpu"
        out["local_devices"] = n
        if n:
            out["device_name"] = torch.cuda.get_device_name(0)
    except Exception:  # graftlint: ok[broad-except] — best-effort
        pass
    try:
        from .. import config
        out["broadcast_threshold"] = config.broadcast_join_threshold()
        out["memory_budget"] = config.explicit_memory_budget()
        out["optimizer"] = config.optimizer_enabled()
        out["exchange_strategy"] = config.exchange_strategy()
        out["cost_measured"] = config.cost_measured_enabled()
        out["plan_cache_capacity"] = config.plan_cache_capacity()
    except Exception:  # graftlint: ok[broad-except]
        # a malformed env knob must not block the bundle
        pass
    for env in ("CYLON_TRACE", "CYLON_LOCKCHECK", "CYLON_LOCK_HOLD_MS",
                "CYLON_MEMORY_BUDGET", "CYLON_STATS_PATH",
                "CYLON_OPTIMIZER", "CYLON_MESHPROBE_PATH"):
        v = os.environ.get(env)
        if v:
            out[env] = v
    return out


def config_fingerprint() -> Dict[str, Any]:
    """Public view of the bundle's config fingerprint."""
    return _config_fingerprint()


def bundle(reason: str = "on-demand",
           error: Optional[BaseException] = None) -> Dict[str, Any]:
    """Build one diagnostic bundle dict (see the module docstring for
    the section set).  Pure read — records nothing, writes nothing."""
    from .. import trace
    evs = events()
    try:
        trace_doc = trace.export_chrome_trace(None)
    except Exception:  # graftlint: ok[broad-except] — best-effort
        trace_doc = {"traceEvents": []}  # must not block the bundle
    try:
        counters = trace.snapshot()
    except Exception:  # graftlint: ok[broad-except] — best-effort
        counters = {"counters": {}, "watermarks": {}, "gauges": {}}
    return {
        "schema": 1,
        "reason": reason,
        "created_s": round(time.time(), 3),
        "error": (None if error is None else
                  {"type": type(error).__name__,
                   "message": str(error)[:500]}),
        "config": _config_fingerprint(),
        "counters": counters,
        "events": evs,
        "events_dropped": dropped(),
        "queries": [e for e in evs
                    if e.get("kind") == "query"][-LAST_K_QUERIES:],
        "trace": trace_doc,
    }


def dump(path: Optional[str] = None, reason: str = "on-demand",
         error: Optional[BaseException] = None) -> str:
    """Write one bundle as JSON and return its path.  ``path`` defaults
    to ``flightrec-<pid>-<seq>.json`` under ``CYLON_FLIGHTREC_DIR``
    (or the cwd when that env is unset — explicit dumps are the user
    asking).  Bumps ``flightrec.dumps``."""
    global _dump_seq
    from .. import trace
    if path is None:
        base = os.environ.get("CYLON_FLIGHTREC_DIR") or "."
        with _lock:
            _dump_seq += 1
            seq = _dump_seq
        path = os.path.join(base,
                            f"flightrec-{os.getpid()}-{seq}.json")
    doc = bundle(reason, error)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, sort_keys=True, default=str)
    os.replace(tmp, path)
    trace.count("flightrec.dumps")
    return path


def maybe_dump_on_error(reason: str,
                        error: BaseException) -> Optional[str]:
    """The crash hook: dump a bundle for ``error`` when
    ``CYLON_FLIGHTREC_DIR`` is configured and the per-process auto-dump
    cap has room; returns the path (None when not dumped).  Never
    raises — a failing recorder must not mask the original error."""
    global _auto_dumps
    base = os.environ.get("CYLON_FLIGHTREC_DIR")
    if not base:
        return None
    with _lock:
        suppressed = _auto_dumps >= MAX_AUTO_DUMPS
        if not suppressed:
            _auto_dumps += 1
    if suppressed:
        # the cap fired: no bundle will be written for this error.
        # Book it loudly (direct registry bump — visible even with
        # trace counters off) and note the ring so doctor + the event
        # log can tell operators bundles are missing.
        from .metrics import REGISTRY
        REGISTRY.bump("flightrec.dumps_suppressed")
        note("dump_suppressed", reason=reason,
             error=type(error).__name__)
        return None
    try:
        return dump(None, reason, error)
    except Exception:  # graftlint: ok[broad-except] — best-effort
        return None     # the bundle is best-effort, the error is not
