"""Plan analysis and the cost-model audits.

  * ``plan_check`` — the capture hook the planner and the recorder
    share, and the abstract plan checker (``plan_check.explain`` /
    ``validate`` over meta tensors, ``_abstract.py``).
  * ``calibrate`` — the cost-model audit: predicted-vs-observed exchange
    ms / peak bytes over the run-stats store.  CLI:
    ``python -m cylon_tpu_torch.analysis.calibrate --stats STATS.json``.
  * ``queryprof`` — which query and which plan node regressed between
    two run-stats snapshots.  CLI:
    ``python -m cylon_tpu_torch.analysis.queryprof OLD.json NEW.json``.
  * ``parity`` — the row-set comparison of the out-of-core gates.
  * ``benchdiff`` — the BENCH-artifact regression gate (the JAX bench's
    key names and thresholds).  CLI:
    ``python -m cylon_tpu_torch.analysis.benchdiff OLD.json NEW.json``.
  * ``ci`` — the one-command gate: graftlint, the plan-check pre-flight
    of the 22 TPC-H queries, eleven end-to-end smoke stages and
    benchdiff, one 0/1/2 exit.  CLI: ``python -m
    cylon_tpu_torch.analysis.ci`` (on the card; ``--device cpu`` here).
  * ``graftlint`` — AST linter for the hazard classes torch cannot
    type-check: hidden host syncs, unkeyed kernel builds, builds in
    loops, names missing from the metric / fault-point / LOWERING
    catalogues, reads that bypass the spill pool, unguarded shared state.
    CLI: ``python -m cylon_tpu_torch.analysis.graftlint cylon_tpu_torch
    chip_smoke.py`` (0 clean, 1 findings, 2 usage or parse error).
  * ``lockcheck`` — the static half of the concurrency discipline: the
    ``GUARDED_STATE`` catalogues and graftlint's two concurrency rules
    alone.  CLI: ``python -m cylon_tpu_torch.analysis.lockcheck
    cylon_tpu_torch chip_smoke.py``.
  * sanitizer mode — ``cylon_tpu_torch.config.sanitize()``, the runtime
    backstop for what graftlint proves statically: every span body runs
    under the sync guard (``torch.cuda.set_sync_debug_mode("error")`` on
    the card; the sanctioned reads lift it) and the NaN trap, and
    ``Table.to_arrow`` byte-compares its host caches.

Every module here loads lazily, so importing the package never drags the
linters (ast / symtable machinery) into a runtime process.
"""
from __future__ import annotations

from ._abstract import PlanExportReached, any_abstract, is_abstract

__all__ = ["plan_check", "calibrate", "queryprof", "parity", "graftlint",
           "lockcheck", "benchdiff", "is_abstract", "any_abstract",
           "PlanExportReached"]


def __getattr__(name):
    if name in ("plan_check", "calibrate", "queryprof", "parity",
                "graftlint", "lockcheck", "benchdiff"):
        import importlib

        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
