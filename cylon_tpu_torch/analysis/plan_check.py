"""plan_check — the plan-node capture and the abstract plan checker.

The port of ``cylon_tpu/analysis/plan_check.py``.  Two halves:

**The capture** of the public distributed operators: the thread-local
capture state, the ``PlanNode`` / ``PlanReport`` types, the hooks the
operators call (``note(op, *tables, **info)``, ``annotate``,
``annotate_append``, ``capture_index``, ``annotate_at``), the table
checks behind ``validate``, and ``instrument``, the decorator on every
public ``dist_*`` entry point, ``shuffle_table`` and ``replicate_table``:

  * under a lazy-plan capture (``plan.ir.Builder``, installed by
    ``ctx.optimize``) an instrumented call does not execute: the builder
    records an IR node and returns a ``LogicalTable``;
  * under an EXPLAIN ANALYZE run (``observe.analyze``) each call opens a
    measurement window whose deltas (wall-clock, rows, exchange bytes,
    counters) are stitched onto the ``PlanNode`` the op's own ``note()``
    created;
  * under ``recording()`` (a plain capture) or an abstract run every
    ``note()`` lands in the recorded node list.

Outside all of them, the wrapper costs two thread-local reads and
``note()`` one.

**The abstract checker** (``explain`` / ``validate``): a distributed plan
is ordinary Python composing dist ops, so the way to type-check a WHOLE
plan without running it is to run that Python over abstract tensors.
Every ``DTable`` input is rebuilt over **meta tensors** (same shapes and
dtypes, no storage) on a meta view of its context
(``CylonContext.with_device("meta")``), so every allocation the plan
makes lands on the meta device: every operator runs its ordinary code,
shapes, dtypes, capacities, dictionary unification and leaf widths are
checked by the code that will run for real, and ZERO bytes move on or
off the card.  The runtime cooperates at its host boundaries (each
branches on ``analysis.is_abstract``, see ``_abstract.py``):

  * the optimistic count protocol (``ops/compact``) sizes dispatches
    from zeroed counts instead of reading the device, and leaves the
    size hints alone; the shuffle prices from zeroed counts and never
    degrades;
  * ``DTable.head`` / ``to_table`` / ``_export`` build abstract local
    Tables instead of transferring;
  * ``Table.to_arrow`` raises :class:`PlanExportReached` — everything up
    to the export boundary has been checked, and what follows is
    host-side post-processing outside the distributed plan;
  * the broadcast replica cache skips abstract tables, and the
    partition kernel's wrapper returns a meta result without a launch.

Entry points::

    plan_check.validate(dist_join, left, right, cfg)   # raises on a bug
    plan_check.explain(lambda t: q5(ctx, t), tables)   # PlanReport
    dt.explain(plan, tables=..., validate=True)        # DTable sugar

``concrete=("nation", …)`` keeps the VALUES of named tables readable:
tiny dimension tables whose rows the plan folds at build time
(name → key lookups for literal filters) are read from the real table —
their rows are plan-time constants, not data movement — while the
leaves that flow into the plan are meta like every other.
"""
from __future__ import annotations

import contextlib
import functools
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from ._abstract import PlanExportReached

__all__ = ["PlanNode", "PlanReport", "PlanValidationError", "explain",
           "validate", "recording", "capturing", "note", "annotate",
           "annotate_append", "capture_index", "annotate_at", "instrument"]


class PlanValidationError(Exception):
    """An abstract run of the plan hit a shape/dtype/contract bug.  The
    ``__cause__`` chain carries the original error; the message names the
    failing operator so the report reads at plan altitude, not stack-trace
    altitude."""


def _fmt_bytes(n: int) -> str:
    for unit in ("B", "KB", "MB", "GB"):
        if abs(n) < 1024 or unit == "GB":
            return f"{n:.1f} {unit}" if unit != "B" else f"{int(n)} B"
        n /= 1024.0
    return f"{int(n)} B"


def _fmt_rows(n: Optional[int]) -> str:
    return "?" if n is None else str(int(n))


@dataclass
class PlanNode:
    """One distributed operator as the capture saw it.  An EXPLAIN
    ANALYZE run (observe.analyze) additionally stitches ``runtime`` on:
    ``{ms, rows_in, rows_out, bytes_moved, decision, counters, depth}``
    — the window deltas of the op's real execution, INCLUSIVE of nested
    operators it triggered."""

    op: str
    tables: List[str] = field(default_factory=list)   # input summaries
    info: Dict[str, Any] = field(default_factory=dict)
    runtime: Optional[Dict[str, Any]] = None

    def __str__(self) -> str:
        rt = self.runtime
        # analyzed nodes render the decision inside the runtime bracket
        info = {k: v for k, v in self.info.items()
                if not (rt is not None and k == "decision")}
        extra = (" " + " ".join(f"{k}={v}" for k, v in info.items())
                 if info else "")
        text = f"{self.op}({', '.join(self.tables)}){extra}"
        if rt is not None:
            text += (f" [rows {_fmt_rows(rt.get('rows_in'))}"
                     f"->{_fmt_rows(rt.get('rows_out'))}"
                     f" | {_fmt_bytes(rt.get('bytes_moved', 0))}"
                     f" | {rt.get('ms', 0.0):.1f} ms"
                     f" | {rt.get('decision', 'local')}]")
        return text


@dataclass
class PlanReport:
    ok: bool = False
    nodes: List[PlanNode] = field(default_factory=list)
    boundary: Optional[str] = None     # export boundary reached (if any)
    result: Optional[str] = None       # output schema summary
    error: Optional[BaseException] = None
    analyzed: bool = False             # runtime-annotated (EXPLAIN ANALYZE)
    totals: Dict[str, Any] = field(default_factory=dict)
    output: Any = None                 # the analyzed run's actual result
    # plan-cache fingerprints the analyzed run materialized — the
    # run-stats store keys its record under these (observe.stats)
    stats_digests: List[str] = field(default_factory=list)

    def _exclusive_ms(self) -> List[float]:
        """Per-node exclusive wall-clock: inclusive ms minus the direct
        children's inclusive ms (nodes are preorder; a node's children
        are the following deeper-depth run until depth falls back)."""
        depths = [(n.runtime or {}).get("depth", 1) for n in self.nodes]
        incl = [(n.runtime or {}).get("ms", 0.0) for n in self.nodes]
        excl = list(incl)
        for i, d in enumerate(depths):
            for j in range(i + 1, len(self.nodes)):
                if depths[j] <= d:
                    break
                if depths[j] == d + 1:
                    excl[i] -= incl[j]
        return [max(e, 0.0) for e in excl]

    def _str_analyzed(self) -> str:
        t = self.totals
        # across processes each process reports its own senders' bytes
        # beside the world's rows
        who = (f" by this process's senders (1 of {t['processes']})"
               if t.get("processes", 1) > 1 else "")
        head = (f"EXPLAIN ANALYZE: {len(self.nodes)} distributed op(s), "
                f"{t.get('ms', 0.0):.1f} ms, "
                f"{_fmt_bytes(t.get('bytes_moved', 0))} moved{who}, "
                f"{t.get('syncs', 0)} syncs")
        if t.get("compiles", 0):
            head += (f", {t.get('compile_ms', 0.0):.1f} ms compiling "
                     f"({t['compiles']} builds)")
        if not self.ok:
            head += " [FAILED]"
        lines = [head]
        opt = t.get("optimizer")
        if opt:
            lines.append(
                f"  optimizer: {opt.get('rule_fires', 0)} rule fire(s), "
                f"exchange row-bytes {_fmt_bytes(opt.get('row_bytes_pre', 0))}"
                f" -> {_fmt_bytes(opt.get('row_bytes_post', 0))}, "
                f"plan cache {opt.get('cache_hits', 0)} hit(s) / "
                f"{opt.get('cache_misses', 0)} miss(es)")
        excl = self._exclusive_ms()
        total = sum(excl) or 1.0
        hottest = max(range(len(excl)), key=excl.__getitem__, default=None)
        for i, n in enumerate(self.nodes):
            depth = (n.runtime or {}).get("depth", 1)
            hot = "  *HOT*" if (i == hottest or excl[i] >= 0.2 * total) \
                else ""
            lines.append(f"{'  ' * depth}{i:3d}. {n}{hot}")
        if self.result:
            lines.append(f"  -> {self.result}")
        if self.error is not None:
            lines.append(f"  error: {self.error}")
        return "\n".join(lines)

    def __str__(self) -> str:
        if self.analyzed:
            return self._str_analyzed()
        lines = [f"plan: {len(self.nodes)} distributed op(s), "
                 + ("VALID" if self.ok else "INVALID")]
        lines += [f"  {i:3d}. {n}" for i, n in enumerate(self.nodes)]
        if self.result:
            lines.append(f"  -> {self.result}")
        if self.error is not None:
            lines.append(f"  error: {self.error}")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# capture hooks (dist ops call note(); free when no capture is active)
# ---------------------------------------------------------------------------

_capture = threading.local()


def capturing() -> bool:
    return getattr(_capture, "report", None) is not None


@contextlib.contextmanager
def recording() -> Iterator[List[PlanNode]]:
    """Record every noted operator that runs on this thread (nested
    calls included, in call order); yields the live node list.  The
    plan executor attaches the optimizer's rule fires to the node of the
    operator it lowered."""
    prev = getattr(_capture, "report", None)
    report = PlanReport()
    _capture.report = report
    try:
        yield report.nodes
    finally:
        _capture.report = prev


def note(op: str, *tables, **info) -> Optional[PlanNode]:
    """Record one distributed operator in the active capture (no-op
    outside one: a thread-local read).  ``tables`` are the op's DTable
    inputs (summaries only are kept, never tensors); ``info`` is small
    static detail (join type, strategy hints; None values dropped).
    Returns the node (None outside a capture) so late planner decisions
    can ``annotate`` it after nested nodes were recorded."""
    report: Optional[PlanReport] = getattr(_capture, "report", None)
    if report is None:
        return None
    summaries = [_summarize(t) for t in tables]
    if getattr(_capture, "validate", False):
        for t in tables:
            _check_table(op, t)
    node = PlanNode(op, summaries,
                    {k: v for k, v in info.items() if v is not None})
    report.nodes.append(node)
    return node


def annotate(node: Optional[PlanNode] = None, **info) -> None:
    """Attach late-bound detail (typically the planner's decision and its
    reason) to ``node``, or, when None, to the most recently noted node.
    No-op outside a capture; None values are dropped like ``note``'s."""
    report: Optional[PlanReport] = getattr(_capture, "report", None)
    if report is None:
        return
    if node is None:
        node = report.nodes[-1] if report.nodes else None
    if node is None:
        return
    node.info.update({k: v for k, v in info.items() if v is not None})


def annotate_append(key: str, value, sep: str = " | ") -> None:
    """Append ``value`` to the most recently noted node's ``key`` info
    (creating it when absent): detail that may occur more than once under
    one instrumented op.  No-op outside a capture."""
    report: Optional[PlanReport] = getattr(_capture, "report", None)
    if report is None or not report.nodes:
        return
    node = report.nodes[-1]
    cur = node.info.get(key)
    node.info[key] = value if cur is None else f"{cur}{sep}{value}"


def capture_index() -> Optional[int]:
    """Index the NEXT noted node will get (None outside a capture): the
    plan executor snapshots it before lowering an operator so it can
    annotate that operator's OWN node afterwards."""
    report: Optional[PlanReport] = getattr(_capture, "report", None)
    return None if report is None else len(report.nodes)


def annotate_at(idx: Optional[int], **info) -> None:
    """Attach detail to the node recorded at ``idx`` (a prior
    ``capture_index``); no-op outside a capture or when the lowered
    operator noted nothing (rename, scan)."""
    report: Optional[PlanReport] = getattr(_capture, "report", None)
    if report is None or idx is None or idx >= len(report.nodes):
        return
    report.nodes[idx].info.update({k: v for k, v in info.items()
                                   if v is not None})


def instrument(fn: Callable) -> Callable:
    """Route ``fn`` to the active lazy-plan builder; else, under an
    EXPLAIN ANALYZE run, measure it in a window; else run it.  The
    capture check comes first: the plan executor suspends capture while
    it lowers, so the operators it calls run (and are measured)
    normally."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        lazy = getattr(_capture, "lazy", None)
        if lazy is not None:
            return lazy.intercept(fn, args, kwargs)
        state = getattr(_capture, "analyze", None)
        if state is None:
            return fn(*args, **kwargs)
        token = state.enter(fn.__name__, args, kwargs)
        try:
            out = fn(*args, **kwargs)
        except BaseException:
            state.abort(token)
            raise
        state.exit(token, out)
        return out

    return wrapper


def _summarize(dt) -> str:
    try:
        # a DTable's metadata list: summarizing a spilled table must not
        # fault its leaves in
        cols = getattr(dt, "_columns", None) or getattr(dt, "columns", ())
        cap = getattr(dt, "cap", None)
        nparts = getattr(dt, "nparts", 1)
        rows = ""
        ch = getattr(dt, "_counts_host", None)
        if ch is not None:
            rows = f"{int(np.asarray(ch).sum())} rows, "
        return f"[{rows}{len(cols)} cols, {nparts}x{cap}]"
    except Exception:  # a summary must never fail the capture
        return "[?]"


def _check_table(op: str, dt) -> None:
    """Shape invariants of one DTable that the kernels assume rather than
    verify: counts dtype and width, leaf lengths against P*cap, validity
    dtype, dictionary presence and sort order, pending-mask
    consistency."""
    from ..dtypes import is_dictionary_encoded
    from ..status import Code, CylonError, Status

    def bug(msg: str) -> None:
        raise CylonError(Status(Code.Invalid, f"plan_check[{op}]: {msg}"))

    # the leaves hold this process's L shards (L = P with one process)
    cap, nparts = dt.cap, dt.nlocal
    if tuple(dt.counts.shape) != (nparts,):
        bug(f"counts shape {tuple(dt.counts.shape)} != ({nparts},)")
    if dt.counts.dtype != torch.int32:
        bug(f"counts dtype {dt.counts.dtype} != int32 (the count "
            "protocol exchanges int32 headers)")
    for c in dt.columns:
        if c.data.shape[0] != nparts * cap:
            bug(f"column {c.name!r} leaf length {c.data.shape[0]} != "
                f"P*cap = {nparts * cap}")
        if c.validity is not None:
            if c.validity.shape[0] != nparts * cap:
                bug(f"column {c.name!r} validity length "
                    f"{c.validity.shape[0]} != P*cap = {nparts * cap}")
            if c.validity.dtype != torch.bool:
                bug(f"column {c.name!r} validity dtype {c.validity.dtype}"
                    " != bool")
        if is_dictionary_encoded(c.dtype.type):
            if c.dictionary is None:
                bug(f"dictionary column {c.name!r} carries no dictionary")
            d = np.asarray(c.dictionary)
            if d.size > 1 and not bool(np.all(d[:-1] <= d[1:])):
                bug(f"column {c.name!r} dictionary is not sorted — code "
                    "order must equal lexical order")
    if dt.pending_mask is not None:
        if dt.pending_mask.shape[0] != nparts * cap:
            bug(f"pending mask length {dt.pending_mask.shape[0]} != "
                f"P*cap = {nparts * cap}")
        if dt.pending_mask.dtype != torch.bool:
            bug(f"pending mask dtype {dt.pending_mask.dtype} != bool")


def _schema_of(out) -> Optional[str]:
    cols = getattr(out, "columns", None)
    if not cols:
        return None
    kind = type(out).__name__
    parts = ", ".join(f"{c.name}:{c.dtype.type.name}" for c in cols)
    return f"{kind}({parts})"


# ---------------------------------------------------------------------------
# DTable abstraction: rebuild over meta tensors on a meta view of the context
# ---------------------------------------------------------------------------

def _meta_ctx(ctx):
    """The meta view of ``ctx`` (made once per context and kept on it, so
    repeated checks of one plan share one view and its plan-cache key)."""
    view = getattr(ctx, "_meta_view", None)
    if view is None:
        view = ctx.with_device("meta")
        ctx._meta_view = view
    return view


def _meta_like(t):
    if t is None:
        return None
    return torch.empty(tuple(t.shape), dtype=t.dtype, device="meta")


def _flatten_dtable(dt, concrete: bool = False):
    """An equivalent DTable over meta leaves (same shapes and dtypes) on the
    meta view of ``dt``'s context; ``concrete`` keeps the real table
    reachable for the plan-time host probes of its values
    (``tpch.queries``' dimension lookups).  Host row counts are plan
    metadata, not data: they are kept, so the broadcast planner and the
    dense-range hints stay exact."""
    from ..parallel.dtable import DColumn, DTable

    cols = [DColumn(c.name, c.dtype, _meta_like(c.data),
                    _meta_like(c.validity), c.dictionary, c.arrow_type)
            for c in dt._columns]
    out = DTable(_meta_ctx(dt.ctx), cols, dt.cap, _meta_like(dt._counts),
                 _meta_like(dt.pending_mask), _meta_like(dt.pending_cnts))
    ch = dt._counts_host
    out._counts_host = None if ch is None else np.asarray(ch).copy()
    if concrete:
        out._concrete = dt
    return out


def _is_dtable(x) -> bool:
    from ..parallel.dtable import DTable

    return isinstance(x, DTable)


def _absorb(arg, concrete: Sequence[str]):
    """``arg`` with its DTables (alone, or as dict / list / tuple values)
    rebuilt over meta tensors; everything else passes through.  Dict keys
    named in ``concrete`` keep their real values reachable."""
    if _is_dtable(arg):
        return _flatten_dtable(arg)
    if isinstance(arg, dict):
        return {k: (_flatten_dtable(v, concrete=k in concrete)
                    if _is_dtable(v) else v) for k, v in arg.items()}
    if isinstance(arg, (list, tuple)):
        return type(arg)(_flatten_dtable(v) if _is_dtable(v) else v
                         for v in arg)
    return arg


def concrete_source(dt):
    """The real table behind an abstract one kept ``concrete`` (or ``dt``
    itself): the table whose values a plan-time host probe reads."""
    return getattr(dt, "_concrete", None) or dt


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def explain(op: Callable, *args, validate: bool = False,
            concrete: Sequence[str] = (), **kwargs) -> PlanReport:
    """Abstract-interpret ``op(*args, **kwargs)`` and report the plan.

    Every positional DTable (alone or inside a dict / list / tuple) is
    replaced by a twin over meta tensors; the op runs on them, so every
    operator it would run is shape/dtype-checked with no data movement,
    no host read and no kernel launch.  With ``validate=True`` each
    operator's input tables are also checked against the engine's
    plan-shape invariants, and any failure raises
    :class:`PlanValidationError` naming the op.

    Across processes each process checks the plan on its own meta view
    (``with_device("meta")`` keeps the process split): the run makes no
    collective, so it never waits on another process.  Host probes of
    ``concrete`` tables read their replicated values (every process
    holds the same global rows of an ingested table).
    """
    report = PlanReport()
    # save/restore, not set/clear: a plan callable may itself call
    # explain/validate (pre-flighting a sub-plan), and clearing would
    # silence the outer run's note()/invariant checks from there on.  The
    # analyze state is SUSPENDED for the abstract run: its row peeks and
    # syncs cannot touch meta tensors (restored on exit, so an analyze
    # whose plan pre-flights a sub-plan keeps measuring)
    prev = (getattr(_capture, "report", None),
            getattr(_capture, "validate", False),
            getattr(_capture, "analyze", None))
    try:
        rebuilt = [_absorb(a, tuple(concrete)) for a in args]
        _capture.report = report
        _capture.validate = validate
        _capture.analyze = None
        try:
            out = op(*rebuilt, **kwargs)
        finally:
            _capture.report, _capture.validate, _capture.analyze = prev
        report.result = _schema_of(out)
        report.ok = True
    except PlanExportReached as e:
        report.boundary = e.where
        if e.schema:
            report.result = "Table(" + ", ".join(
                f"{n}:{t}" for n, t, _ in e.schema) + ")"
        report.ok = True
        if validate and not report.nodes:
            # the export boundary fired before ANY distributed op: zero
            # operators were checked, so a VALID verdict would be vacuous.
            # The usual cause is a plan that folds a dimension table
            # host-side before its first dist op — keep that table
            # concrete
            report.ok = False
            raise PlanValidationError(
                f"the plan hit the host-export boundary ({e.where}) "
                "before any distributed op — nothing was validated.  If "
                "the plan reads small dimension tables host-side at "
                "build time, pass them via concrete=(...)") from None
    except Exception as e:  # shape/dtype/contract bug somewhere in the plan
        report.error = e
        report.ok = False
        if validate:
            at = (f" after {report.nodes[-1]}" if report.nodes
                  else " before the first distributed op")
            raise PlanValidationError(
                f"plan validation failed{at}: {e}") from e
    return report


def validate(op: Callable, *args, concrete: Sequence[str] = (),
             **kwargs) -> PlanReport:
    """``explain(..., validate=True)``: abstract-run ``op`` with full
    invariant checking; raises :class:`PlanValidationError` on any plan
    bug, returns the PlanReport when the plan is clean."""
    return explain(op, *args, validate=True, concrete=concrete, **kwargs)
