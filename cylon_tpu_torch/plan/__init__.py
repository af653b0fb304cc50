"""Logical query planner: lazy plan IR, rewrite rules, compiled-plan cache.

The port of ``cylon_tpu/plan/``, the layer between the plan functions
(``tpch.queries`` and user code composing the public dist ops) and the
distributed operators:

  * ``ir``        the lazy IR: while a capture is active, every public
                  dist-op call builds a typed :class:`ir.Node` instead of
                  executing (the ``plan_check.instrument`` hook);
  * ``rules``     the rewrite engine: filter pushdown, multiway join
                  fusion, groupby pushdown, plan-time join strategy,
                  projection pruning, common-subplan elimination;
  * ``executor``  lowering back onto the eager ops + the compiled-plan
                  cache keyed by plan structure, schemas, ingest counts
                  and the configuration the rules read, under the
                  recovery driver (stage checkpoints, the escalation
                  ladder, the elastic re-mesh).

The user surface is ``ctx.optimize(plan_fn, tables)``.
``CYLON_OPTIMIZER=0`` (or ``config.set_optimizer_enabled(False)``) runs
plans eagerly instead.
"""
from __future__ import annotations

from . import executor, ir, rules  # noqa: F401  (re-exported submodules)
from .executor import clear_plan_cache, plan_cache_len
from .ir import Builder, LogicalTable

__all__ = ["optimize", "run", "Builder", "LogicalTable",
           "clear_plan_cache", "plan_cache_len", "ir", "rules",
           "executor"]


def run(ctx, op, tables=None):
    """Capture, optimize and execute ``op`` unconditionally (no enable
    check).  ``op`` receives ``tables`` (a dict of DTables, a single
    DTable, or None) with every table replaced by a lazy
    :class:`ir.LogicalTable`; logical tables in the return value are
    materialized before returning.

    The context resolves through the elastic-topology registry
    (``topology.effective``): after a mid-query shard loss re-meshed the
    process onto a survivor world, every later plan anchors on it, and
    tables still on the old world are migrated first
    (``parallel.remesh.ensure_current``), before pricing reads their
    layout."""
    from .. import topology
    if tables is not None:
        from ..parallel.remesh import ensure_current
        ensure_current(tables)
    b = Builder(topology.effective(ctx))
    wrapped = b.wrap_tables(tables) if tables is not None else None
    with ir.capture(b):
        out = op(wrapped) if tables is not None else op()
        return b.finish(out)


def optimize(ctx, op, tables=None):
    """Run ``op(tables)`` through the logical planner: capture the plan
    lazily, rewrite it (plan/rules.py), execute the optimized DAG through
    the compiled-plan cache (plan/executor.py).  With the optimizer
    disabled the plan runs eagerly instead."""
    from ..config import optimizer_enabled
    if not optimizer_enabled():
        return op(tables) if tables is not None else op()
    return run(ctx, op, tables)
