"""Chrome / Perfetto trace-event export, with per-thread and per-query
tracks.

The port of ``cylon_tpu/observe/export.py``.  ``export_chrome_trace(path)``
serializes the recorded spans and counter series as Chrome trace-event
JSON (the ``chrome://tracing`` / Perfetto format).  Spans become complete
(``"ph": "X"``) events on the ``time.perf_counter`` clock; counter bumps
recorded while tracing was on become counter (``"ph": "C"``) events.

Track assignment: a span recorded under an active trace id
(``trace.trace_context(trace_id)``) lands on a synthetic per-QUERY
track, named ``query <trace_id>`` by a ``thread_name`` metadata event;
spans without a trace id keep their real thread's track.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

from .metrics import REGISTRY

__all__ = ["export_chrome_trace"]

# synthetic tid base for query tracks — far above real OS thread ids'
# collision range in practice, and deterministic per export (tracks are
# numbered in first-appearance order of their trace ids)
_QUERY_TID_BASE = 1 << 22


def export_chrome_trace(path: Optional[str] = None) -> Dict[str, Any]:
    """Serialize the recorded spans + counter series as Chrome
    trace-event JSON.

    Spans become complete (``"ph": "X"``) events — ``ts``/``dur`` in
    microseconds, nesting recovered by Perfetto from containment (the
    recorded span depth rides along in ``args.depth``); spans carrying a
    trace id are grouped onto one named track per query.  Counter bumps
    recorded while tracing was enabled become ``"ph": "C"`` events, so
    exchange volume lines up under the phase spans.  Returns the
    document (and writes it to ``path`` when given) — load the file via
    Perfetto's "Open trace file" next to a ``trace.profile()`` trace.
    """
    from .. import trace

    pid = os.getpid()
    events: List[Dict[str, Any]] = []
    query_tids: Dict[str, int] = {}
    for rec in trace.get_span_records(all_threads=True):
        name, depth, ms, t0, tid, track, args = rec
        ev_args = {"depth": depth}
        if args:
            ev_args.update(args)
        if track is not None:
            syn = query_tids.get(track)
            if syn is None:
                syn = _QUERY_TID_BASE + len(query_tids)
                query_tids[track] = syn
            tid = syn
            ev_args["trace_id"] = track
        events.append({
            "name": name, "cat": "phase", "ph": "X",
            "ts": round(t0 * 1e6, 3), "dur": round(ms * 1e3, 3),
            "pid": pid, "tid": tid, "args": ev_args,
        })
    for t, name, value, tid in REGISTRY.counter_events():
        events.append({
            "name": name, "cat": "metric", "ph": "C",
            "ts": round(t * 1e6, 3), "pid": pid, "tid": tid,
            "args": {name: value},
        })
    events.sort(key=lambda e: e["ts"])
    # metadata events name the per-query tracks (ts-less, prepended so
    # viewers see the names before any event on the track)
    meta = [{"name": "thread_name", "ph": "M", "pid": pid, "tid": syn,
             "args": {"name": f"query {track}"}}
            for track, syn in sorted(query_tids.items(),
                                     key=lambda kv: kv[1])]
    doc = {"traceEvents": meta + events, "displayTimeUnit": "ms",
           "otherData": {"clock": "time.perf_counter",
                         "producer": "cylon_tpu_torch.observe"}}
    if path is not None:
        with open(path, "w") as f:
            json.dump(doc, f)
    return doc
