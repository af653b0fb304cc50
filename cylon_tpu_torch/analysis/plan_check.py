"""The capture hook of the public distributed operators.

The port of the hook half of ``cylon_tpu/analysis/plan_check.py``: the
thread-local capture state, ``instrument`` (the decorator on every public
``dist_*`` entry point, ``shuffle_table`` and ``replicate_table``), and a
plain recorder (``recording`` / ``note`` / ``capture_index`` /
``annotate_at``).

  * Under a lazy-plan capture (``plan.ir.Builder``, installed by
    ``ctx.optimize``) an instrumented call does not execute: the builder
    records an IR node and returns a ``LogicalTable``.
  * Under ``recording()`` every instrumented call that runs is noted as a
    ``PlanNode`` in call order (nested calls included); the plan executor
    attaches the optimizer's rule fires to the node of the operator it
    lowered.

Outside both, the wrapper costs two thread-local reads.  The abstract
plan checker (``explain`` / ``validate``) is not ported.
"""
from __future__ import annotations

import contextlib
import functools
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator, List, Optional

__all__ = ["PlanNode", "recording", "note", "capture_index", "annotate_at",
           "instrument"]


@dataclass
class PlanNode:
    """One distributed operator as the recorder saw it."""

    op: str
    info: Dict[str, Any] = field(default_factory=dict)


_capture = threading.local()


@contextlib.contextmanager
def recording() -> Iterator[List[PlanNode]]:
    """Record every instrumented operator that runs on this thread."""
    prev = getattr(_capture, "report", None)
    nodes: List[PlanNode] = []
    _capture.report = nodes
    try:
        yield nodes
    finally:
        _capture.report = prev


def note(op: str, **info) -> Optional[PlanNode]:
    """Record ``op`` in the active recording (None outside one); None
    values of ``info`` are dropped."""
    report = getattr(_capture, "report", None)
    if report is None:
        return None
    node = PlanNode(op, {k: v for k, v in info.items() if v is not None})
    report.append(node)
    return node


def capture_index() -> Optional[int]:
    """Index the NEXT noted node will get (None outside a recording): the
    executor snapshots it before lowering an operator so it can annotate
    that operator's own node afterwards."""
    report = getattr(_capture, "report", None)
    return None if report is None else len(report)


def annotate_at(idx: Optional[int], **info) -> None:
    """Attach detail to the node recorded at ``idx`` (a prior
    ``capture_index``); no-op outside a recording or when the lowered
    operator noted nothing (rename, scan)."""
    report = getattr(_capture, "report", None)
    if report is None or idx is None or idx >= len(report):
        return
    report[idx].info.update({k: v for k, v in info.items() if v is not None})


def instrument(fn: Callable) -> Callable:
    """Route ``fn`` to the active lazy-plan builder, else note it in the
    active recording and run it.  The capture check comes first: the plan
    executor suspends capture while it lowers, so the operators it calls
    run (and are noted) normally."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        lazy = getattr(_capture, "lazy", None)
        if lazy is not None:
            return lazy.intercept(fn, args, kwargs)
        if getattr(_capture, "report", None) is not None:
            note(fn.__name__)
        return fn(*args, **kwargs)

    return wrapper
