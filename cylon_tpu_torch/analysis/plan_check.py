"""The plan-node capture of the public distributed operators.

The port of the runtime half of ``cylon_tpu/analysis/plan_check.py``:
the thread-local capture state, the ``PlanNode`` / ``PlanReport`` types,
the hooks the operators call (``note(op, *tables, **info)``,
``annotate``, ``annotate_append``, ``capture_index``, ``annotate_at``),
the table checks behind ``DTable.explain(validate=True)``, and
``instrument``, the decorator on every public ``dist_*`` entry point,
``shuffle_table`` and ``replicate_table``:

  * under a lazy-plan capture (``plan.ir.Builder``, installed by
    ``ctx.optimize``) an instrumented call does not execute: the builder
    records an IR node and returns a ``LogicalTable``;
  * under an EXPLAIN ANALYZE run (``observe.analyze``) each call opens a
    measurement window whose deltas (wall-clock, rows, exchange bytes,
    counters) are stitched onto the ``PlanNode`` the op's own ``note()``
    created;
  * under ``recording()`` (a plain capture) every ``note()`` lands in the
    recorded node list.

Outside all three, the wrapper costs two thread-local reads and
``note()`` one.  The abstract plan checker (``explain`` / ``validate``
over abstract tensors, ``_abstract.py``) is not ported yet.
"""
from __future__ import annotations

import contextlib
import functools
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np
import torch

__all__ = ["PlanNode", "PlanReport", "recording", "capturing", "note",
           "annotate", "annotate_append", "capture_index", "annotate_at",
           "instrument"]


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
        head = (f"EXPLAIN ANALYZE: {len(self.nodes)} distributed op(s), "
                f"{t.get('ms', 0.0):.1f} ms, "
                f"{_fmt_bytes(t.get('bytes_moved', 0))} moved, "
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
    node = PlanNode(op, [_summarize(t) for t in tables],
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

    cap, nparts = dt.cap, dt.nparts
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
