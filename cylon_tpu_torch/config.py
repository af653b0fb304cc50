"""Join configuration and the process-wide knobs the planner reads.

The PyTorch port's copy of the join part of ``cylon_tpu/config.py``
(reference: join/join_config.hpp:29-89), the broadcast row threshold,
the device memory budget, the optimizer switch, the plan-cache
capacity, and the lock-order checks of ``observe.locks``.
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
# combine step and the broadcast joins read it.  The replica costs
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


# The per-device byte ceiling a replica is priced against, resolved as
#   1. an explicit set_device_memory_budget(bytes),
#   2. the CYLON_MEMORY_BUDGET env var (bytes),
#   3. DEFAULT_MEMORY_BUDGET_FRACTION of the device's memory (the card's
#      total memory; physical RAM for the CPU).
DEFAULT_MEMORY_BUDGET_FRACTION = 0.5

_device_memory_budget: Optional[int] = None


def _validate_budget(n, what: str) -> int:
    if isinstance(n, bool) or not isinstance(n, int):
        raise CylonError(Status(Code.Invalid,
            f"{what} must be a positive int byte count, "
            f"got {type(n).__name__} {n!r}"))
    if n <= 0:
        raise CylonError(Status(Code.Invalid,
            f"{what} must be positive, got {n} (pass None to restore "
            "auto-detection)"))
    return n


def set_device_memory_budget(n: Optional[int]) -> Optional[int]:
    """Set the per-device memory budget in bytes; returns the previous
    explicit setting.  None restores env / default resolution."""
    global _device_memory_budget
    if n is not None:
        n = _validate_budget(n, "device memory budget")
    prev = _device_memory_budget
    _device_memory_budget = n
    return prev


def device_memory_budget(device: torch.device) -> int:
    """The effective memory budget in bytes for ``device`` (explicit knob,
    else ``CYLON_MEMORY_BUDGET``, else the default fraction)."""
    if _device_memory_budget is not None:
        return _device_memory_budget
    env = os.environ.get("CYLON_MEMORY_BUDGET", "")
    if env:
        # any set value must be valid: "0" raises like the setter does
        try:
            return _validate_budget(int(env), "CYLON_MEMORY_BUDGET")
        except ValueError:
            raise CylonError(Status(Code.Invalid,
                f"CYLON_MEMORY_BUDGET must be an int byte count, "
                f"got {env!r}")) from None
    if device.type == "cuda":
        limit = torch.cuda.get_device_properties(device).total_memory
    else:
        limit = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    return max(int(limit * DEFAULT_MEMORY_BUDGET_FRACTION), 1 << 20)


def explicit_memory_budget() -> Optional[int]:
    """The explicitly set budget (None when env / default resolved)."""
    return _device_memory_budget


# The LRU entry cap of the planner's compiled-plan cache
# (plan/executor.py): explicit set_plan_cache_capacity() >
# CYLON_PLAN_CACHE_CAP env > DEFAULT_PLAN_CACHE_CAPACITY.  Evictions bump
# the ``plan.cache_evictions`` counter.
DEFAULT_PLAN_CACHE_CAPACITY = 128

_plan_cache_capacity: Optional[int] = None


def plan_cache_capacity() -> int:
    """The effective compiled-plan cache entry cap."""
    if _plan_cache_capacity is not None:
        return _plan_cache_capacity
    env = os.environ.get("CYLON_PLAN_CACHE_CAP", "")
    if env:
        try:
            n = int(env)
        except ValueError:
            raise CylonError(Status(Code.Invalid,
                f"CYLON_PLAN_CACHE_CAP must be an int entry count, "
                f"got {env!r}")) from None
        if n <= 0:
            raise CylonError(Status(Code.Invalid,
                f"CYLON_PLAN_CACHE_CAP must be positive, got {n}"))
        return n
    return DEFAULT_PLAN_CACHE_CAPACITY


def set_plan_cache_capacity(n: Optional[int]) -> Optional[int]:
    """Set the compiled-plan cache capacity; returns the previous explicit
    setting.  None restores env / default resolution; zero, negative,
    float and bool values raise (a stored 0 would evict every plan)."""
    global _plan_cache_capacity
    if n is not None:
        if isinstance(n, bool) or not isinstance(n, int):
            raise CylonError(Status(Code.Invalid,
                "plan cache capacity must be a positive int entry count "
                f"or None to restore defaults, got {type(n).__name__} "
                f"{n!r}"))
        if n <= 0:
            raise CylonError(Status(Code.Invalid,
                f"plan cache capacity must be positive, got {n} (pass "
                "None to restore env/default resolution)"))
    prev = _plan_cache_capacity
    _plan_cache_capacity = n
    return prev


# Whether ``ctx.optimize`` captures, rewrites and caches plans or runs
# them eagerly: explicit set_optimizer_enabled() > CYLON_OPTIMIZER env
# (any value but "0" / empty enables; default on).
_optimizer_enabled: Optional[bool] = None


def optimizer_enabled() -> bool:
    """Whether the logical-plan optimizer is active."""
    if _optimizer_enabled is not None:
        return _optimizer_enabled
    return os.environ.get("CYLON_OPTIMIZER", "1") not in ("", "0")


def set_optimizer_enabled(on: Optional[bool]) -> Optional[bool]:
    """Set the optimizer switch (None restores env resolution); returns
    the previous explicit setting."""
    global _optimizer_enabled
    if on is not None and not isinstance(on, bool):
        raise CylonError(Status(Code.Invalid,
            "optimizer switch must be True, False or None (env-resolved), "
            f"got {type(on).__name__} {on!r}"))
    prev = _optimizer_enabled
    _optimizer_enabled = on
    return prev


# Lock-order enforcement (observe.locks): explicit set_lockcheck() >
# CYLON_LOCKCHECK env (any value but "0" / empty enables; default off).
_lockcheck: Optional[bool] = None


def lockcheck_enabled() -> bool:
    """Whether a lock-order inversion raises ``LockOrderViolation``
    (explicit knob, else ``CYLON_LOCKCHECK``)."""
    if _lockcheck is not None:
        return _lockcheck
    return os.environ.get("CYLON_LOCKCHECK", "0") not in ("", "0")


def set_lockcheck(on: Optional[bool]) -> Optional[bool]:
    """Set lock-order enforcement (None restores env resolution); returns
    the previous explicit setting."""
    global _lockcheck
    if on is not None and not isinstance(on, bool):
        raise CylonError(Status(Code.Invalid,
            "lockcheck switch must be True, False or None (env-resolved), "
            f"got {type(on).__name__} {on!r}"))
    prev = _lockcheck
    _lockcheck = on
    return prev


_lock_hold_watchdog_ms: Optional[int] = None    # None -> env-resolved


def lock_hold_watchdog_ms() -> int:
    """Hold-time watchdog threshold in ms: an OrderedLock released after
    being held at least this long notes a ``lock_hold`` event into the
    flight recorder.  0 disables.  Explicit knob, else
    ``CYLON_LOCK_HOLD_MS`` (default 1000)."""
    if _lock_hold_watchdog_ms is not None:
        return _lock_hold_watchdog_ms
    try:
        return int(os.environ.get("CYLON_LOCK_HOLD_MS", "1000"))
    except ValueError:
        return 1000


def set_lock_hold_watchdog_ms(ms: Optional[int]) -> Optional[int]:
    """Set the hold-time watchdog threshold (None restores env
    resolution, 0 disables); returns the previous explicit setting."""
    global _lock_hold_watchdog_ms
    if ms is not None and (not isinstance(ms, int)
                           or isinstance(ms, bool) or ms < 0):
        raise CylonError(Status(Code.Invalid,
            "lock hold watchdog must be a non-negative int of ms or "
            f"None (env-resolved), got {type(ms).__name__} {ms!r}"))
    prev = _lock_hold_watchdog_ms
    _lock_hold_watchdog_ms = ms
    return prev


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
    a column index/name, or a tuple of them for composite keys.
    ``broadcast_threshold`` is the per-call broadcast-join override: None
    reads the process-wide ``broadcast_join_threshold()``, 0 never
    broadcasts this join, any other int is the small-side row threshold.
    Only the distributed strategy changes (replicate the small side or
    shuffle both); the result rows are the same either way.
    """

    join_type: JoinType = JoinType.INNER
    algorithm: JoinAlgorithm = JoinAlgorithm.SORT
    left_column_idx: object = 0
    right_column_idx: object = 0
    broadcast_threshold: Optional[int] = None

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
