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

``plan_check``, ``calibrate``, ``queryprof`` and ``parity`` load lazily.
"""
from __future__ import annotations

from ._abstract import PlanExportReached, any_abstract, is_abstract

__all__ = ["plan_check", "calibrate", "queryprof", "parity",
           "is_abstract", "any_abstract", "PlanExportReached"]


def __getattr__(name):
    if name in ("plan_check", "calibrate", "queryprof", "parity"):
        import importlib

        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
