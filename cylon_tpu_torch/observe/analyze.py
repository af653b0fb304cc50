"""EXPLAIN ANALYZE: the measurement run.

The port of ``cylon_tpu/observe/analyze.py``.  ``analyze(plan, tables)``
runs the real query ONCE with tracing on and stitches runtime statistics
(rows in/out, bytes moved per exchange, planner decision, span
wall-clock) onto the ``PlanNode`` list the operators' ``note()`` hooks
record, via the ``plan_check.instrument`` hook on every distributed op.
Surfaces: ``DTable.explain(plan, tables=..., analyze=True)`` and
``CylonContext.analyze(plan, tables)``.

ANALYZE is a measurement run: with tracing on, every span synchronizes
the card on its outputs and every operator's output is synchronized at
its window's end, so the wall-clock charged to each node is honest.  The
per-node SPLIT is the signal; an analyzed run's totals sit above a
production (asynchronous) run's by design.

An analyzed OPTIMIZED run additionally feeds the run-stats store
(observe.stats) under every plan-cache fingerprint it materialized.

Row peeks read counts explicitly and never cache them on the table
(``_counts_host`` stays as it was), so measuring a plan never changes
what a later planner decision sees.  The port reads counts synchronously
where the JAX package may defer them, so a peek the JAX package answers
with None (a deferred select's counts not yet read) is a number here.
"""
from __future__ import annotations

import time
from typing import Any, Dict, Optional, Tuple

from . import compile as _compile
from . import stats as _stats
from .metrics import counter_delta

__all__ = ["analyze"]

# byte-volume counters whose per-window delta IS a node's "bytes moved"
_BYTE_COUNTERS = ("shuffle.bytes_sent", "broadcast.bytes_sent")


def _bytes_of(counters: Dict[str, int]) -> int:
    return sum(counters.get(k, 0) for k in _BYTE_COUNTERS)


def _world_sum(dt) -> int:
    """The rows of every shard of the world of ``dt``: across processes
    the local counts are all-gathered first (every process peeks the same
    tables in the same order, so every process enters the gather), and
    the node's rows are global."""
    cnts = dt.counts
    if dt.ctx.get_process_count() > 1:
        cnts = dt.ctx.comm.all_gather(cnts)
    return int(cnts.sum())


def _peek_rows(x) -> Optional[int]:
    """Global row count of a DTable / local Table WITHOUT mutating it:
    no pending-mask collapse, no ``_counts_host`` caching."""
    import numpy as np

    from ..parallel.dtable import DTable
    from ..table import Table

    if isinstance(x, DTable):
        if x.pending_mask is not None:
            # the deferred select's survivor counts, already all P
            # shards' (all-gathered by the select)
            return int(x.pending_cnts.sum())
        ch = x._counts_host
        if ch is not None:
            return int(np.asarray(ch).sum())
        return _world_sum(x)
    if isinstance(x, Table):
        return x.num_rows
    return None


def _rows_in(args, kwargs, peek=_peek_rows) -> Optional[int]:
    from ..parallel.dtable import DTable

    flat = list(args) + list(kwargs.values())
    tables = [a for a in flat if isinstance(a, DTable)]
    for a in flat:
        if isinstance(a, dict):
            tables += [v for v in a.values() if isinstance(v, DTable)]
        elif isinstance(a, (list, tuple)):
            tables += [v for v in a if isinstance(v, DTable)]
    if not tables:
        return None
    rows = [peek(t) for t in tables]
    return None if any(r is None for r in rows) else sum(rows)


def _sync_result(out) -> None:
    """Honest per-node wall-clock: block until the op's output tensors
    have materialized (spans already sync their own phase tails; this
    catches work queued after the last span)."""
    from .. import trace
    from ..parallel.dtable import DTable
    from ..table import Table

    if isinstance(out, (DTable, Table)) and out.columns:
        trace.hard_sync([c.data for c in out.columns])


class _AnalyzeState:
    """Per-run bookkeeping behind ``plan_check.instrument``: each
    instrumented distributed op opens a window at entry and, at exit,
    stitches the window's runtime deltas onto the PlanNode its own
    ``note()`` created (windows nest; a node's numbers are INCLUSIVE of
    the operators it triggered)."""

    def __init__(self, report) -> None:
        self.report = report
        self.depth = 0
        # id-keyed row-peek memo for THIS run: a chained plan peeks the
        # same intermediate table as producer rows_out and consumer
        # rows_in, one read per table.  Entries pin the table so ids stay
        # unique for the run; a table's logical row count never changes
        # in place (collapse swaps the blocks but keeps the rows).
        self._rows_memo: Dict[int, Tuple[Any, Optional[int]]] = {}

    def _peek(self, t) -> Optional[int]:
        hit = self._rows_memo.get(id(t))
        if hit is not None:
            return hit[1]
        rows = _peek_rows(t)
        self._rows_memo[id(t)] = (t, rows)
        return rows

    def enter(self, name: str, args, kwargs):
        from .. import trace

        self.depth += 1
        return (len(self.report.nodes), self.depth,
                _rows_in(args, kwargs, self._peek), trace.counters(),
                time.perf_counter())

    def abort(self, token) -> None:
        self.depth -= 1

    def exit(self, token, out) -> None:
        from .. import trace

        idx, depth, rows_in, c0, t0 = token
        _sync_result(out)
        ms = (time.perf_counter() - t0) * 1e3
        self.depth -= 1
        nodes = self.report.nodes
        if idx >= len(nodes) or nodes[idx].runtime is not None:
            # no node of its own inside this window (a _local_only
            # helper), or the node belongs to a nested op that already
            # claimed it
            return
        c1 = trace.counters()
        node = nodes[idx]
        node.runtime = {
            "depth": depth,
            "ms": ms,
            "rows_in": rows_in,
            "rows_out": self._peek(out) if out is not None else None,
            "bytes_moved": _bytes_of(c1) - _bytes_of(c0),
            "decision": node.info.get("decision", "local"),
            "counters": counter_delta(c0, c1),
        }


def _processes(args, kwargs) -> int:
    """The process count of the world the plan's tables live in (1 when
    it takes none)."""
    from ..parallel.dtable import DTable
    flat = list(args) + list(kwargs.values())
    for a in flat:
        vals = (a.values() if isinstance(a, dict) else
                a if isinstance(a, (list, tuple)) else (a,))
        for v in vals:
            if isinstance(v, DTable):
                return v.ctx.get_process_count()
    return 1


def analyze(op, *args, **kwargs):
    """EXPLAIN ANALYZE: run ``op(*args, **kwargs)`` (the real query,
    once) with tracing on and every distributed operator instrumented;
    return the runtime-annotated :class:`plan_check.PlanReport`.

    Each node carries ``runtime = {ms, rows_in, rows_out, bytes_moved,
    decision, counters, depth}``; ``report.totals`` holds the run-level
    aggregates (wall ms, bytes moved, syncs, host reads, builds, the
    merged counter map, per-phase span totals) and ``report.output`` the
    query's result.  ``str(report)`` renders the EXPLAIN tree with *HOT*
    exclusive-ms highlighting; ``trace.export_chrome_trace(path)`` right
    after the run exports the same run's span profile.

    Trace state is reset at entry (the run IS the measurement) and left
    populated at exit; the span-enable flag is restored to what it was
    (counter-only mode is never touched).

    A failing plan does NOT raise: the partially annotated report comes
    back with ``ok=False`` and ``error`` set, keeping the nodes measured
    before the failure.

    Across processes every process runs the plan (SPMD) and gets its own
    report: node rows (``rows_in`` / ``rows_out``) are GLOBAL and equal in
    every process; ``bytes_moved`` and the counters count THIS process's
    senders, as ``shuffle.bytes_sent`` does, and the wall-clock is this
    process's.  ``totals["processes"]`` says which kind of report it is.
    """
    from .. import trace
    from ..analysis import plan_check

    report = plan_check.PlanReport()
    report.analyzed = True
    prev_enabled = trace.enabled()
    trace.reset()
    trace.enable()
    cap = plan_check._capture
    prev_cap = (getattr(cap, "report", None), getattr(cap, "analyze", None))
    cap.report = report
    cap.analyze = _AnalyzeState(report)
    t0 = time.perf_counter()
    digests = []
    cevents = []
    nproc = _processes(args, kwargs)
    try:
        with _stats.collect_digests() as digests, \
                _compile.attribute_compiles() as cevents:
            out = op(*args, **kwargs)
        report.ok = True
        report.output = out
        if report.result is None:
            report.result = plan_check._schema_of(out)
    except Exception as e:  # graftlint: ok[broad-except]
        # ANALYZE returns the partial report instead
        report.error = e
        report.ok = False
    finally:
        wall_ms = (time.perf_counter() - t0) * 1e3
        cap.report, cap.analyze = prev_cap
        if not prev_enabled:
            trace.disable()
        counters = trace.counters()
        for node in report.nodes:   # a note() outside any instrumented
            if node.runtime is None:  # window still reports SOMETHING
                node.runtime = {"depth": 1, "ms": 0.0, "rows_in": None,
                                "rows_out": None, "bytes_moved": 0,
                                "decision": node.info.get("decision",
                                                          "local"),
                                "counters": {}}
        report.totals = {
            "ms": wall_ms,
            "bytes_moved": _bytes_of(counters),
            "rows_sent": counters.get("shuffle.rows_sent", 0)
            + counters.get("broadcast.rows_sent", 0),
            "syncs": counters.get("trace.sync", 0),
            "host_reads": counters.get("host.read", 0),
            "compiles": len(cevents),
            "compile_ms": round(sum(e["compile_ms"] for e in cevents), 3),
            "counters": counters,
            "phase_ms": trace.phase_totals(),
            "processes": nproc,
        }
        if counters.get("plan.cache_hit", 0) \
                or counters.get("plan.cache_miss", 0):
            report.totals["optimizer"] = {
                "rule_fires": counters.get("optimizer.rule_fires", 0),
                "row_bytes_pre": counters.get("optimizer.row_bytes_pre", 0),
                "row_bytes_post": counters.get("optimizer.row_bytes_post",
                                               0),
                "cache_hits": counters.get("plan.cache_hit", 0),
                "cache_misses": counters.get("plan.cache_miss", 0),
            }
        report.stats_digests = list(digests)
        if report.ok:
            for d in digests:
                _stats.STORE.record_report(d, report)
    return report
