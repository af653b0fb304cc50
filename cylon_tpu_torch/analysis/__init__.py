"""Plan analysis: the capture hook the planner and the recorder share,
and the abstract plan checker (``plan_check.explain`` / ``validate``
over meta tensors, ``_abstract.py``)."""
from __future__ import annotations

from ._abstract import PlanExportReached, any_abstract, is_abstract

__all__ = ["is_abstract", "any_abstract", "PlanExportReached"]
