"""Join configuration and the process-wide knobs the planner reads.

The PyTorch port's copy of the join part of ``cylon_tpu/config.py``
(reference: join/join_config.hpp:29-89), the broadcast row threshold,
the device memory budget, the host-tier (spill) budget and switch, the
exchange knobs the costed shuffle reads
(the forced strategy, the (slow, fast) mesh shape, the measured-cost
ranking, the watchdog timeout), the optimizer switch, the plan-cache capacity, the
lock-order checks of ``observe.locks``, the two recovery knobs (the
recovery switch and the re-mesh flap-damping window), and
sanitizer mode (``sanitize``: the sync guard and NaN trap of every span
body, the host-cache content check at export).
"""
from __future__ import annotations

import contextlib
import enum
import os
import re
import threading
import weakref
from dataclasses import dataclass
from typing import Iterator, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

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


def device_memory_budget(device: Optional[torch.device] = None) -> int:
    """The effective memory budget in bytes for ``device`` (explicit knob,
    else ``CYLON_MEMORY_BUDGET``, else the default fraction of the
    device's memory; None is the current CUDA device)."""
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
    if device is None or device.type == "cuda":
        limit = torch.cuda.get_device_properties(device).total_memory
    else:
        limit = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    return max(int(limit * DEFAULT_MEMORY_BUDGET_FRACTION), 1 << 20)


def explicit_memory_budget() -> Optional[int]:
    """The explicitly set budget (None when env / default resolved)."""
    return _device_memory_budget


# The host-tier (spill) budget: the byte ceiling of the spill pool
# (spill/pool.py), the host memory spilled DTable leaves and staged-spill
# payloads may hold at once.  Pinned entries (the only copy of their
# data) count in full; resident entries (host copies kept after a
# fault-in) are evictable cache.  Resolved as
#   1. an explicit set_host_memory_budget(bytes),
#   2. the CYLON_HOST_MEMORY_BUDGET env var (bytes),
#   3. DEFAULT_HOST_BUDGET_FRACTION of physical host RAM (floor 64 MiB).
DEFAULT_HOST_BUDGET_FRACTION = 0.5

_host_memory_budget: Optional[int] = None
_auto_host_budget: Optional[int] = None     # detection cache


def set_host_memory_budget(n: Optional[int]) -> Optional[int]:
    """Set the host-tier spill budget in bytes; returns the previous
    explicit setting.  None restores env / default resolution."""
    global _host_memory_budget
    if n is not None:
        n = _validate_budget(n, "host memory budget")
    prev = _host_memory_budget
    _host_memory_budget = n
    return prev


def host_memory_budget() -> int:
    """The effective host-tier spill budget in bytes (explicit knob, else
    ``CYLON_HOST_MEMORY_BUDGET``, else half the physical RAM, at least
    64 MiB).  The spill pool prices every stage-out against it and raises
    a typed ``Code.OutOfMemory`` when the pinned bytes would exceed it."""
    global _auto_host_budget
    if _host_memory_budget is not None:
        return _host_memory_budget
    env = os.environ.get("CYLON_HOST_MEMORY_BUDGET", "")
    if env:
        try:
            return _validate_budget(int(env), "CYLON_HOST_MEMORY_BUDGET")
        except ValueError:
            raise CylonError(Status(Code.Invalid,
                f"CYLON_HOST_MEMORY_BUDGET must be an int byte count, "
                f"got {env!r}")) from None
    if _auto_host_budget is None:
        try:
            limit = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
        except (ValueError, OSError, AttributeError):
            limit = 0
        if not limit or limit <= 0:
            limit = 16 << 30
        _auto_host_budget = max(int(limit * DEFAULT_HOST_BUDGET_FRACTION),
                                64 << 20)
    return _auto_host_budget


# The out-of-core switch: whether the spill tier engages at all (the
# planner's morsel scans, the chooser's staged-spill tier, DTable.spill):
# explicit set_spill_enabled() > CYLON_SPILL env (any value but "0" /
# empty enables; default on).
_spill_enabled: Optional[bool] = None


def spill_enabled() -> bool:
    """Whether the host-tier spill subsystem is active."""
    if _spill_enabled is not None:
        return _spill_enabled
    return os.environ.get("CYLON_SPILL", "1") not in ("", "0")


def set_spill_enabled(on: Optional[bool]) -> Optional[bool]:
    """Set the spill switch (None restores env resolution); returns the
    previous explicit setting."""
    global _spill_enabled
    if on is not None and not isinstance(on, bool):
        raise CylonError(Status(Code.Invalid,
            "spill switch must be True, False or None (env-resolved), "
            f"got {type(on).__name__} {on!r}"))
    prev = _spill_enabled
    _spill_enabled = on
    return prev


# The exchange lowering override (the costed chooser of
# parallel/shuffle.py picks one per exchange from the budget and the
# count matrix; this forces one session-wide, the A/B escape hatch of
# the parity tests and the chip smoke): explicit set_exchange_strategy()
# > CYLON_EXCHANGE_STRATEGY env > None (the costed choice).
_exchange_strategy: Optional[str] = None


def _validate_strategy(name, what: str) -> str:
    # the chooser's own catalogue (late import: config loads first)
    from .parallel.cost import STRATEGIES
    if not isinstance(name, str) or name not in STRATEGIES:
        raise CylonError(Status(Code.Invalid,
            f"{what} must be one of {STRATEGIES} or None to "
            f"restore the costed chooser, got {name!r}"))
    return name


def set_exchange_strategy(name: Optional[str]) -> Optional[str]:
    """Force every eligible exchange onto one lowering (None restores
    the costed chooser); returns the previous explicit setting.
    Combine-spec exchanges (the fused groupby's fold-by-key rounds)
    cannot run a forced ring / allgather / hierarchical lowering and
    stay on the single-shot / chunked / hierarchical-combine set."""
    global _exchange_strategy
    if name is not None:
        name = _validate_strategy(name, "exchange strategy")
    prev = _exchange_strategy
    _exchange_strategy = name
    return prev


def exchange_strategy() -> Optional[str]:
    """The forced exchange lowering, or None for the costed chooser."""
    if _exchange_strategy is not None:
        return _exchange_strategy
    env = os.environ.get("CYLON_EXCHANGE_STRATEGY", "")
    if env:
        return _validate_strategy(env, "CYLON_EXCHANGE_STRATEGY")
    return None


# The (slow, fast) factorization of the world: fast = the cheap axis,
# slow = the expensive boundary.  A non-trivial split makes the
# hierarchical lowerings enumerable (topology.axis_split resolves it per
# context): explicit set_mesh_shape() > CYLON_MESH_SHAPE env ("SxF") >
# the flat (1, world).
_mesh_shape: Optional[Tuple[int, int]] = None


def _validate_mesh_shape(shape, what: str) -> Tuple[int, int]:
    ok = (isinstance(shape, (tuple, list)) and len(shape) == 2
          and all(isinstance(x, int) and not isinstance(x, bool)
                  for x in shape)
          and all(x > 0 for x in shape))
    if not ok:
        raise CylonError(Status(Code.Invalid,
            f"{what} must be a (slow, fast) pair of positive ints or "
            f"None to restore platform resolution, got {shape!r}"))
    return (int(shape[0]), int(shape[1]))


def set_mesh_shape(shape: Optional[Tuple[int, int]]
                   ) -> Optional[Tuple[int, int]]:
    """Set the explicit (slow, fast) factorization (None restores env
    resolution); returns the previous explicit setting.  The shape need
    not tile every context's world: ``topology.axis_split`` falls back
    to a flat split when it does not."""
    global _mesh_shape
    if shape is not None:
        shape = _validate_mesh_shape(shape, "mesh shape")
    prev = _mesh_shape
    _mesh_shape = shape
    return prev


def mesh_shape() -> Optional[Tuple[int, int]]:
    """The configured (slow, fast) shape, or None (explicit knob, else
    ``CYLON_MESH_SHAPE`` as ``SxF``, e.g. ``2x4``)."""
    if _mesh_shape is not None:
        return _mesh_shape
    env = os.environ.get("CYLON_MESH_SHAPE", "")
    if env:
        m = re.fullmatch(r"(\d+)\s*[xX,]\s*(\d+)", env.strip())
        if not m:
            raise CylonError(Status(Code.Invalid,
                f"CYLON_MESH_SHAPE must look like 'SxF' (e.g. '2x4'), "
                f"got {env!r}"))
        return _validate_mesh_shape((int(m.group(1)), int(m.group(2))),
                                    "CYLON_MESH_SHAPE")
    return None


# The measured-cost ranking: the costed chooser normally ranks feasible
# exchange lowerings on the (rounds, wire bytes) proxy; this switch ranks
# them by cost.predicted_ms from the coefficients parallel/meshprobe.py
# fitted for the live context, when one was probed (without a profile
# the chooser keeps the proxy).  Explicit set_cost_measured() >
# CYLON_COST_MEASURED env (any value but "0" / empty enables) > off.
_cost_measured: Optional[bool] = None


def cost_measured_enabled() -> bool:
    """Whether the chooser ranks exchanges by measured collective time."""
    if _cost_measured is not None:
        return _cost_measured
    return os.environ.get("CYLON_COST_MEASURED", "0") not in ("", "0")


def set_cost_measured(on: Optional[bool]) -> Optional[bool]:
    """Set the measured-cost ranking switch (None restores env
    resolution); returns the previous explicit setting."""
    global _cost_measured
    if on is not None and not isinstance(on, bool):
        raise CylonError(Status(Code.Invalid,
            "cost-measured switch must be True, False or None "
            f"(env-resolved), got {type(on).__name__} {on!r}"))
    prev = _cost_measured
    _cost_measured = on
    return prev


# The exchange watchdog: a bounded timeout around each collective
# dispatch of parallel/shuffle.py; a breach raises a TransientFault
# naming the fault point instead of hanging.  Explicit
# set_exchange_timeout_ms() > CYLON_EXCHANGE_TIMEOUT_MS env > None
# (disabled: the guard runs each dispatch on a helper thread).
_exchange_timeout_ms: Optional[int] = None


def _validate_timeout_ms(n, what: str) -> int:
    if isinstance(n, bool) or not isinstance(n, int):
        raise CylonError(Status(Code.Invalid,
            f"{what} must be a positive int millisecond count, "
            f"got {type(n).__name__} {n!r}"))
    if n <= 0:
        raise CylonError(Status(Code.Invalid,
            f"{what} must be positive, got {n} (pass None to disable "
            "the watchdog)"))
    return n


def exchange_timeout_ms() -> Optional[int]:
    """The collective-dispatch watchdog timeout in ms, or None when the
    watchdog is off (explicit knob, else ``CYLON_EXCHANGE_TIMEOUT_MS``).
    The guarded window covers the whole dispatch, a first call's CUDA
    library warm-up included: set it generously."""
    if _exchange_timeout_ms is not None:
        return _exchange_timeout_ms
    env = os.environ.get("CYLON_EXCHANGE_TIMEOUT_MS", "")
    if env:
        try:
            return _validate_timeout_ms(int(env),
                                        "CYLON_EXCHANGE_TIMEOUT_MS")
        except ValueError:
            raise CylonError(Status(Code.Invalid,
                f"CYLON_EXCHANGE_TIMEOUT_MS must be an int millisecond "
                f"count, got {env!r}")) from None
    return None


def set_exchange_timeout_ms(n: Optional[int]) -> Optional[int]:
    """Set the exchange watchdog timeout in ms (None restores env
    resolution / off); returns the previous explicit setting.  Zero,
    negative, float and bool values raise."""
    global _exchange_timeout_ms
    if n is not None:
        n = _validate_timeout_ms(n, "exchange watchdog timeout")
    prev = _exchange_timeout_ms
    _exchange_timeout_ms = n
    return prev


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


# The self-healing recovery switch: whether plan/executor.materialize
# wraps execution in the recovery driver (classified stage retry,
# exchange replan, re-mesh, annotated fail) or propagates the first
# failure unchanged.  Explicit set_recovery_enabled() > CYLON_RECOVERY
# env (any value but "0" / empty enables; default on).
_recovery_enabled: Optional[bool] = None


def recovery_enabled() -> bool:
    """Whether the executor's recovery ladder is active (explicit knob,
    else ``CYLON_RECOVERY``)."""
    if _recovery_enabled is not None:
        return _recovery_enabled
    return os.environ.get("CYLON_RECOVERY", "1") not in ("", "0")


def set_recovery_enabled(on: Optional[bool]) -> Optional[bool]:
    """Set the recovery switch (None restores env resolution); returns
    the previous explicit setting."""
    global _recovery_enabled
    if on is not None and not isinstance(on, bool):
        raise CylonError(Status(Code.Invalid,
            "recovery switch must be True, False or None (env-resolved), "
            f"got {type(on).__name__} {on!r}"))
    prev = _recovery_enabled
    _recovery_enabled = on
    return prev


# The flap-damping window of elastic topology transitions
# (topology.mark_joined): a rejoin within this many ms of the last
# transition is held pending.  Explicit set_remesh_cooldown_ms() >
# CYLON_REMESH_COOLDOWN_MS env (default 0: joins apply at once).
_remesh_cooldown_ms: Optional[int] = None


def remesh_cooldown_ms() -> int:
    """Flap-damping hysteresis window in ms (0 disables)."""
    if _remesh_cooldown_ms is not None:
        return _remesh_cooldown_ms
    try:
        return int(os.environ.get("CYLON_REMESH_COOLDOWN_MS", "0"))
    except ValueError:
        return 0


def set_remesh_cooldown_ms(ms: Optional[int]) -> Optional[int]:
    """Set the remesh flap-damping window (None restores env resolution,
    0 disables); returns the previous explicit setting."""
    global _remesh_cooldown_ms
    if ms is not None and (not isinstance(ms, int)
                           or isinstance(ms, bool) or ms < 0):
        raise CylonError(Status(Code.Invalid,
            "remesh cooldown must be a non-negative int of ms or "
            f"None (env-resolved), got {type(ms).__name__} {ms!r}"))
    prev = _remesh_cooldown_ms
    _remesh_cooldown_ms = ms
    return prev


# ---------------------------------------------------------------------------
# the live telemetry plane (observe/exporter.py): the OpenMetrics endpoint
# port and the JSON-lines event log.  Default OFF: a library must not
# open sockets or write files unasked.  Explicit setter > env > disabled;
# the exporter reads them when a serving session starts.
# ---------------------------------------------------------------------------

_metrics_port: Optional[int] = None      # None -> env-resolved
_metrics_port_set = False                # explicit None must beat env

_event_log_path: Optional[str] = None    # None -> env-resolved
_event_log_path_set = False


def metrics_port() -> Optional[int]:
    """The OpenMetrics endpoint port (explicit knob, else
    ``CYLON_METRICS_PORT``); ``None`` when the endpoint is disabled.
    Port 0 means ephemeral: the OS picks one."""
    if _metrics_port_set:
        return _metrics_port
    env = os.environ.get("CYLON_METRICS_PORT", "")
    if not env:
        return None
    try:
        n = int(env)
    except ValueError:
        raise CylonError(Status(Code.Invalid,
            f"CYLON_METRICS_PORT must be an int port, "
            f"got {env!r}")) from None
    if not 0 <= n <= 65535:
        raise CylonError(Status(Code.Invalid,
            f"CYLON_METRICS_PORT must be in [0, 65535], got {n}"))
    return n


def set_metrics_port(port: Optional[int]) -> Optional[int]:
    """Set the OpenMetrics endpoint port (0 = ephemeral; ``None``
    restores env resolution); returns the previous EXPLICIT setting.
    Takes effect at the next exporter start, not on a live server."""
    global _metrics_port, _metrics_port_set
    if port is not None:
        if isinstance(port, bool) or not isinstance(port, int):
            raise CylonError(Status(Code.Invalid,
                "metrics port must be an int in [0, 65535] or None to "
                f"restore defaults, got {type(port).__name__} {port!r}"))
        if not 0 <= port <= 65535:
            raise CylonError(Status(Code.Invalid,
                f"metrics port must be in [0, 65535], got {port}"))
    prev = _metrics_port if _metrics_port_set else None
    _metrics_port = port
    _metrics_port_set = port is not None
    return prev


def event_log_path() -> Optional[str]:
    """The JSON-lines event log path (explicit knob, else
    ``CYLON_EVENT_LOG``); ``None`` when event logging is disabled."""
    if _event_log_path_set:
        return _event_log_path
    return os.environ.get("CYLON_EVENT_LOG") or None


def set_event_log_path(path: Optional[str]) -> Optional[str]:
    """Set the event-log path (``None`` restores env resolution);
    returns the previous EXPLICIT setting.  Takes effect at the next
    event-log start."""
    global _event_log_path, _event_log_path_set
    if path is not None and not isinstance(path, str):
        raise CylonError(Status(Code.Invalid,
            "event log path must be a str or None to restore defaults, "
            f"got {type(path).__name__} {path!r}"))
    prev = _event_log_path if _event_log_path_set else None
    _event_log_path = path
    _event_log_path_set = path is not None
    return prev


# ---------------------------------------------------------------------------
# sanitizer mode: the RUNTIME backstop for the invariants
# analysis/graftlint.py proves statically.  When on:
#
#   * the sync guard: every trace span body runs under
#     ``torch.cuda.set_sync_debug_mode("error")`` once this process has
#     initialised CUDA, so a hidden synchronizing call inside a hot span
#     (``.item()``, ``.cpu()`` into pageable memory, ``nonzero``, boolean
#     mask indexing, a blocking host→device copy) raises instead of
#     silently stalling the pipeline.  The sanctioned transfers
#     (``ops/compact.read_host`` / ``read_counts`` / ``to_device``,
#     ``table.host_batch``, ``trace.hard_sync``, the spill pool's staging)
#     lift the guard for their own duration (:func:`sync_allowed`): they
#     are the counterpart of the JAX package's explicit ``jax.device_get``
#     / ``device_put``, which its transfer guard permits.  The debug mode
#     is process-wide where JAX's guard is per thread: guarded bodies and
#     lifts are counted across threads, the mode is "error" while a body
#     is guarded and no lift runs, and the last body to end restores the
#     mode the first one found (so while one thread is inside a guarded
#     body, a synchronizing call on another thread raises too).  A process
#     that never initialised CUDA (the CPU tests) makes no
#     ``torch.cuda`` debug-mode call: like the JAX guard on its CPU
#     backend, this one bites only on the card.
#   * the NaN trap, the counterpart of ``jax_debug_nans``: each thread's
#     outermost guarded span body runs under a ``TorchDispatchMode`` that
#     notes which op last wrote every floating tensor.  When the body
#     ends, the tensors it wrote that are still alive — its results, as a
#     jitted kernel's outputs are JAX's — are checked for NaN (one flag
#     per tensor on its device, read once through a sanctioned read), and
#     the first that holds one raises ``FloatingPointError`` naming the
#     op.  A tensor freed inside the body is an intermediate: a NaN that
#     a later op masks away (``torch.where(valid, a / b, 0)``) does not
#     trip, as it does not inside a jit kernel.  Meta tensors (an
#     abstract plan run) are never checked and cost no read.
#   * ``Table.to_arrow`` byte-compares every host cache against its
#     device tensor before export (the structural length check is always
#     on).
#
# Scoped:  ``with config.sanitize(): ...``.
# ---------------------------------------------------------------------------

_sanitizing = False

# The sync guard's process-wide state (a plain leaf lock: taken on every
# guarded span entry and exit and around the worker registry, never
# around other work).
_guard_lock = threading.Lock()
_guard_depth = 0      # guarded span bodies running, all threads
_lift_depth = 0       # sanctioned transfers running, all threads
_guard_prev = 0       # the debug mode the first guarded body found
_trap_tls = threading.local()
# the engine objects whose worker threads run now (a ServeSession's
# dispatcher, a HostPipeline's lanes): the guard they share with every
# other thread is what sanitize() warns of
_workers: "weakref.WeakSet" = weakref.WeakSet()


def sanitizing() -> bool:
    """Whether sanitizer mode is active (read by trace.py / table.py)."""
    return _sanitizing


def _warn_shared_guard() -> None:
    from .logging import warn_once
    warn_once(("config.sanitize", "worker threads"),
              "sanitize() with engine worker threads running (a serving "
              "session or a host pipeline): the sync guard is "
              "process-wide, so while any thread is inside a sanitized "
              "span a synchronizing call on every other thread raises, "
              "client threads included, and a sanctioned read on one "
              "thread lifts the guard for all")


def note_worker_threads(owner, live: bool) -> None:
    """Record that ``owner`` started (``live``) or stopped its worker
    threads; under sanitize, a start warns once (:func:`sanitize`)."""
    with _guard_lock:
        if live:
            _workers.add(owner)
        else:
            _workers.discard(owner)
    if live and _sanitizing:
        _warn_shared_guard()


def _apply_sync_mode_locked() -> None:
    on = _guard_depth > 0 and _lift_depth == 0
    torch.cuda.set_sync_debug_mode("error" if on else _guard_prev)


def _guard_enter() -> bool:
    """Count one guarded body in; False (nothing engaged) when this
    process has not initialised CUDA."""
    global _guard_depth, _guard_prev
    if not torch.cuda.is_initialized():
        return False
    with _guard_lock:
        if _guard_depth == 0:
            _guard_prev = torch.cuda.get_sync_debug_mode()
        _guard_depth += 1
        _apply_sync_mode_locked()
    return True


def _guard_exit() -> None:
    global _guard_depth
    with _guard_lock:
        _guard_depth -= 1
        _apply_sync_mode_locked()


@contextlib.contextmanager
def sync_allowed() -> Iterator[None]:
    """Lift the sync guard for a sanctioned transfer (a no-op when no
    guard is engaged or could be)."""
    global _lift_depth
    if not (_sanitizing or _guard_depth):
        yield
        return
    with _guard_lock:
        _lift_depth += 1
        if _guard_depth:
            _apply_sync_mode_locked()
    try:
        yield
    finally:
        with _guard_lock:
            _lift_depth -= 1
            if _guard_depth:
                _apply_sync_mode_locked()


class _NanTrap(TorchDispatchMode):
    """Notes the op that last wrote each floating tensor of a span body
    (a weak reference: the trap keeps nothing alive); :meth:`check` reads
    the survivors' NaN flags."""

    def __init__(self) -> None:
        super().__init__()
        self.written: dict = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.is_view:
            return out   # a view's values belong to its base's writer
        for t in out if isinstance(out, (tuple, list)) else (out,):
            if (isinstance(t, torch.Tensor) and t.is_floating_point()
                    and t.device.type != "meta"):
                # an in-place write through a view writes its base
                base = t._base if t._base is not None else t
                self.written[id(base)] = (weakref.ref(base), func)
        return out

    def check(self) -> None:
        by_dev: dict = {}
        for ref, op in self.written.values():
            t = ref()
            if t is not None and t.numel():
                by_dev.setdefault(t.device, []).append((t, op))
        self.written = {}
        for items in by_dev.values():
            flags = torch.stack([torch.isnan(t).any() for t, _ in items])
            with sync_allowed():
                hot = flags.cpu().numpy()  # graftlint: ok[implicit-host-sync] — the trap's one flag read
            for (t, op), bad in zip(items, hot):
                if bad:
                    raise FloatingPointError(
                        f"invalid value (nan) encountered in {op} (a "
                        f"{tuple(t.shape)} {t.dtype} tensor written inside "
                        "a sanitized span)")


class _SanitizeScope:
    """One span body under sanitize: the sync guard, and the NaN trap
    when no outer span of this thread holds one."""

    __slots__ = ("_sync", "_trap")

    def __enter__(self) -> "_SanitizeScope":
        self._sync = _guard_enter()
        self._trap = None
        if not getattr(_trap_tls, "on", False):
            self._trap = _NanTrap()
            self._trap.__enter__()
            _trap_tls.on = True
        return self

    def __exit__(self, et, ev, tb) -> bool:
        try:
            if self._trap is not None:
                _trap_tls.on = False
                self._trap.__exit__(None, None, None)
                if et is None:
                    self._trap.check()
        finally:
            if self._sync:
                _guard_exit()
        return False


def sanitize_guard() -> Optional[_SanitizeScope]:
    """A fresh sanitizer scope for one span body, or None when sanitizer
    mode is off (scopes are single-use, so every span asks for its
    own)."""
    if not _sanitizing:
        return None
    return _SanitizeScope()


class _SanitizeHandle:
    """Returned by ``sanitize()``: already active; usable as a context
    manager for scoped enabling, or kept for the process lifetime."""

    def __init__(self, prev_on: bool, prev_lockcheck):
        self._prev_on = prev_on
        self._prev_lockcheck = prev_lockcheck

    def __enter__(self) -> "_SanitizeHandle":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        global _sanitizing
        _sanitizing = self._prev_on
        set_lockcheck(self._prev_lockcheck)


def sanitize(enable: bool = True) -> _SanitizeHandle:
    """Turn sanitizer mode on (default) or off; see the section comment
    above for what it checks.  Returns a handle whose ``close()`` (or
    ``with``-exit) restores the previous state.  Sanitizing also turns
    on lock-order enforcement (``lockcheck_enabled``) — an AB/BA
    inversion under sanitize raises instead of warning.

    Across threads the sync guard is one setting of the process, where
    the JAX package's transfer guard is per thread: while any thread is
    inside a sanitized span body, a synchronizing call on every thread
    raises, a client thread's own host read included; and while a
    sanctioned transfer runs on one thread (``sync_allowed``), the guard
    is lifted for all of them.  So sanitizing while a serving session
    or a host pipeline runs its worker threads warns once: a client that
    reads the card beside a served window may fail, and a hidden sync on
    one thread can pass while another reads.  The NaN trap is per
    thread."""
    global _sanitizing
    prev_on = _sanitizing
    _sanitizing = bool(enable)
    prev_lockcheck = set_lockcheck(True if enable else None)
    with _guard_lock:
        threaded = len(_workers) > 0
    if enable and threaded:
        _warn_shared_guard()
    return _SanitizeHandle(prev_on, prev_lockcheck)


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
