"""Join configuration and the process-wide knobs the planner reads.

The PyTorch port's copy of the join part of ``cylon_tpu/config.py``
(reference: join/join_config.hpp:29-89), the broadcast row threshold and
the device memory budget.
"""
from __future__ import annotations

import enum
import os
from dataclasses import dataclass
from typing import Optional

import torch

from .status import Code, CylonError, Status

# Global row-count threshold below which a small table is replicated to
# every shard (one all_gather) instead of hash-shuffled: the groupby's
# combine step reads it, and the broadcast joins will.  The replica costs
# P × rows per column, so the knob bounds per-shard memory.
DEFAULT_BROADCAST_JOIN_THRESHOLD = 1 << 17

_broadcast_join_threshold = DEFAULT_BROADCAST_JOIN_THRESHOLD


def broadcast_join_threshold() -> int:
    """The process-wide small-side row threshold (0 = disabled)."""
    return _broadcast_join_threshold


def set_broadcast_join_threshold(n: Optional[int]) -> Optional[int]:
    """Set the process-wide broadcast threshold; returns the previous
    setting (None when disabled) so callers can restore it in a finally.
    ``n`` is a positive int row count, or None to disable."""
    global _broadcast_join_threshold
    if n is not None:
        if isinstance(n, bool) or not isinstance(n, int):
            raise CylonError(Status(Code.Invalid,
                "broadcast join threshold must be a positive int row "
                f"count or None to disable, got {type(n).__name__} {n!r}"))
        if n <= 0:
            raise CylonError(Status(Code.Invalid,
                f"broadcast join threshold must be positive, got {n} "
                "(pass None to disable broadcast joins)"))
    prev = _broadcast_join_threshold
    _broadcast_join_threshold = 0 if n is None else n
    return prev if prev > 0 else None


# The per-device byte ceiling a replica is priced against: an explicit
# set_device_memory_budget(bytes), else DEFAULT_MEMORY_BUDGET_FRACTION of
# the device's memory (the card's total memory; physical RAM for the CPU).
DEFAULT_MEMORY_BUDGET_FRACTION = 0.5

_device_memory_budget: Optional[int] = None


def set_device_memory_budget(n: Optional[int]) -> Optional[int]:
    """Set the per-device memory budget in bytes; returns the previous
    explicit setting.  None restores the default fraction."""
    global _device_memory_budget
    if n is not None and (isinstance(n, bool) or not isinstance(n, int)
                          or n <= 0):
        raise CylonError(Status(Code.Invalid,
            f"device memory budget must be a positive int byte count, "
            f"got {n!r}"))
    prev = _device_memory_budget
    _device_memory_budget = n
    return prev


def device_memory_budget(device: torch.device) -> int:
    """The effective memory budget in bytes for ``device``."""
    if _device_memory_budget is not None:
        return _device_memory_budget
    if device.type == "cuda":
        limit = torch.cuda.get_device_properties(device).total_memory
    else:
        limit = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    return max(int(limit * DEFAULT_MEMORY_BUDGET_FRACTION), 1 << 20)


class JoinType(enum.Enum):
    INNER = "inner"
    LEFT = "left"
    RIGHT = "right"
    FULL_OUTER = "full_outer"


class JoinAlgorithm(enum.Enum):
    SORT = "sort"
    HASH = "hash"


@dataclass(frozen=True)
class JoinConfig:
    """join type × algorithm × key column index per side.

    The algorithm selects the DISTRIBUTED strategy, mirroring the
    reference's SORT/HASH split (join/join.cpp:247 do_hash_join vs :51
    do_sorted_join):

      SORT  sampled-splitter range-partition shuffle (sample-sort) —
            output is additionally globally key-ordered;
      HASH  murmur3 hash-partition shuffle — no ordering promise.

    Both run the same sort-plan local kernel (ops/join.py).  A key spec is
    a column index/name, or a tuple of them for composite keys.  The JAX
    package's ``broadcast_threshold`` has no counterpart yet: every
    distributed join shuffles both sides.
    """

    join_type: JoinType = JoinType.INNER
    algorithm: JoinAlgorithm = JoinAlgorithm.SORT
    left_column_idx: object = 0
    right_column_idx: object = 0

    @staticmethod
    def InnerJoin(left_column_idx: int = 0, right_column_idx: int = 0,
                  algorithm: JoinAlgorithm = JoinAlgorithm.SORT) -> "JoinConfig":
        return JoinConfig(JoinType.INNER, algorithm, left_column_idx, right_column_idx)

    @staticmethod
    def LeftJoin(left_column_idx: int = 0, right_column_idx: int = 0,
                 algorithm: JoinAlgorithm = JoinAlgorithm.SORT) -> "JoinConfig":
        return JoinConfig(JoinType.LEFT, algorithm, left_column_idx, right_column_idx)

    @staticmethod
    def RightJoin(left_column_idx: int = 0, right_column_idx: int = 0,
                  algorithm: JoinAlgorithm = JoinAlgorithm.SORT) -> "JoinConfig":
        return JoinConfig(JoinType.RIGHT, algorithm, left_column_idx, right_column_idx)

    @staticmethod
    def FullOuterJoin(left_column_idx: int = 0, right_column_idx: int = 0,
                      algorithm: JoinAlgorithm = JoinAlgorithm.SORT) -> "JoinConfig":
        return JoinConfig(JoinType.FULL_OUTER, algorithm, left_column_idx,
                          right_column_idx)
