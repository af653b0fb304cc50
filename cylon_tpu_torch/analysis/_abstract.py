"""Abstract-value plumbing shared by plan_check and the runtime.

The plan checker (``analysis/plan_check.py``) abstract-interprets a whole
distributed plan by running it over **meta tensors**: every DTable leaf
is rebuilt on the ``meta`` device (shape and dtype, no storage), every
operator runs its ordinary PyTorch code, and no byte moves on or off the
card — the counterpart of the JAX package's tracers under one outer
``jax.eval_shape``.  The runtime has a handful of HOST boundaries (the
optimistic count protocol, ``counts_host``, the ``head`` / ``to_table``
exports, the kernel wrapper) that cannot read a meta tensor; each of
them branches on :func:`is_abstract` — abstractness IS the mode, so no
global flag can desync from the values actually flowing.

This module is import-light on purpose: table.py, dtable.py and
ops/compact.py import it at module load, so it imports no module of the
package.
"""
from __future__ import annotations

import torch

__all__ = ["is_abstract", "any_abstract", "PlanExportReached"]


def is_abstract(x) -> bool:
    """True for values that exist only inside an abstract plan run (meta
    tensors): reading them on the host is impossible, so host-boundary
    code branches on this."""
    return isinstance(x, torch.Tensor) and x.device.type == "meta"


def any_abstract(xs) -> bool:
    return any(is_abstract(x) for x in xs)


class PlanExportReached(Exception):
    """Raised by host-export boundaries (``Table.to_arrow`` and what it
    feeds) when reached with abstract data: everything UP TO this point
    of the plan has been shape/dtype-checked, and what follows is
    host-side post-processing outside the distributed plan.  plan_check
    catches this and reports the plan as validated-to-boundary."""

    def __init__(self, where: str, schema=None):
        self.where = where
        self.schema = schema  # [(name, dtype name, length)] if known
        super().__init__(
            f"abstract plan reached the host-export boundary at {where}")
