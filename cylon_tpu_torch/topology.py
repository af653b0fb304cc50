"""Elastic mesh topology: shard-loss bookkeeping + survivor contexts.

The port of ``cylon_tpu/topology.py``.  A context's world is fixed at
construction; this module is the process-level record of a shard slot
dying mid-query.  When the escalation ladder's TOPOLOGY rung fires
(plan/executor.py) it calls :func:`mark_lost`, which builds a **survivor
context** — ``CylonContext(world=P − lost, device=ctx.device)`` carrying
the parent's config map — registers it here, and bumps the topology
epoch.  Everything that starts new work afterwards resolves its context
through :func:`effective` (``plan.run``), so the whole process converges
onto the survivor world: degraded throughput, identical answers.

The JAX package's roster is the device list of the original mesh; the
port's is the **shard slots** of the simulated world, ``(device, 0) ..
(device, P − 1)``: every shard lives on one card, so a slot is what a
device is there.  The LAST ``lost`` slots of the current world are the
casualties, and the survivors are always a prefix of the roster — the
slot order of the original full world, recorded at the first loss and
append-only thereafter — so lose 2 → rejoin 1 → lose 1 walks prefixes
of one fixed order.

The inverse event, a repaired slot RETURNING, goes through
:func:`mark_joined`, which grows the live world back along the same
roster.  Rejoins are flap-damped: within ``CYLON_REMESH_COOLDOWN_MS`` of
the last transition a join is held *pending* and applied by the next
:func:`mark_joined` call outside the window (the executor's stage
boundaries poll with ``joined=0``).  ``reset()`` restores the full
world (test isolation; operationally, the repaired-fleet restart).

:func:`axis_split` is the ``(slow, fast)`` factorization the
hierarchical exchange lowerings price and run on; a survivor world that
the configured shape no longer tiles falls back to flat.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, Tuple

from . import trace

__all__ = ["effective", "mark_lost", "mark_joined", "pending_joins",
           "epoch", "degraded", "reset", "axis_split", "slots"]

# id(ctx) -> (ctx, survivor_ctx): the value pins BOTH contexts so an id()
# key can never be reused by the garbage collector while mapped
_lock = threading.Lock()
_survivors: Dict[int, Tuple[object, object]] = {}
# id(ctx) -> (ctx, roster): the append-only slot order of the ORIGINAL
# full world, recorded at the first loss
_rosters: Dict[int, Tuple[object, Tuple]] = {}
# roster -> the family's ORIGINAL full-world context (the full-restore
# collapse target), joins held back by the flap-damping window, and the
# monotonic time of the family's last applied transition
_origins: Dict[Tuple, object] = {}
_pending: Dict[Tuple, int] = {}
_last_change: Dict[Tuple, float] = {}
_epoch = 0


def _refuse(ctx, what: str) -> None:
    from .context import refuse_multiprocess
    refuse_multiprocess(what, ctx)


def slots(ctx) -> Tuple:
    """The shard slots of ``ctx``'s world, ``((device, s), ...)`` from
    its first slot on: what the JAX package's ``ctx.devices`` is to its
    roster.  Across processes, the slots of this process's own ranks,
    numbered by global rank (the JAX package's addressable devices)."""
    dev = str(ctx.device)
    if ctx.get_process_count() > 1:
        return tuple((dev, r) for r in ctx.local_ranks())
    s0 = ctx.first_slot
    return tuple((dev, s0 + i) for i in range(ctx.get_world_size()))


def effective(ctx):
    """The context work should actually run under: ``ctx`` itself while
    the world is whole, else the (chained) survivor context registered
    by :func:`mark_lost`.  One dict lookup per hop, lock-free."""
    cur = ctx
    while True:
        hit = _survivors.get(id(cur))
        if hit is None or hit[1] is cur:
            return cur
        cur = hit[1]


def degraded(ctx) -> bool:
    """Whether ``ctx`` currently resolves to a shrunken survivor world."""
    return effective(ctx) is not ctx


def epoch() -> int:
    """Monotone counter bumped by every :func:`mark_lost` /
    :func:`mark_joined` (and :func:`reset`)."""
    return _epoch


def pending_joins(ctx) -> int:
    """Rejoined slots held back by the flap-damping window for ``ctx``'s
    family (0 while none).  Lock-free read."""
    hit = _rosters.get(id(ctx)) or _rosters.get(id(effective(ctx)))
    if hit is None:
        return 0
    return _pending.get(hit[1], 0)


def _roster_locked(ctx, cur) -> Tuple:
    """The append-only slot roster of ``cur``'s family, recording
    ``slots(cur)`` as the family's fixed order on first sight.  Caller
    holds ``_lock``."""
    hit = _rosters.get(id(cur)) or _rosters.get(id(ctx))
    if hit is not None:
        return hit[1]
    roster = slots(cur)
    _rosters[id(ctx)] = (ctx, roster)
    _rosters[id(cur)] = (cur, roster)
    _origins.setdefault(roster, cur)
    return roster


def _register_locked(ctx, cur, new_ctx, roster) -> None:
    _survivors[id(ctx)] = (ctx, new_ctx)
    _survivors[id(cur)] = (cur, new_ctx)
    _survivors[id(new_ctx)] = (new_ctx, new_ctx)
    _rosters[id(new_ctx)] = (new_ctx, roster)


def mark_lost(ctx, lost: int = 1):
    """Record the loss of ``lost`` shard slots from ``ctx``'s (effective)
    world and return the survivor context.

    The survivors are the first ``P − lost`` slots of the family's
    roster.  ``lost`` is clamped so one slot survives; a world of one
    has no survivors to shrink onto and is returned UNCHANGED (the
    caller's topology rung degrades to a stage retry there).  Registers
    the mapping for every context that resolves through ``ctx``, bumps
    the epoch, starts the flap-damping window, and records the event
    (``recover.survivor_world`` gauge, a warning, a ``mesh_degraded``
    flight-recorder event)."""
    from .logging import warning as _warn
    from .observe import flightrec
    global _epoch
    _refuse(ctx, "a shard loss re-mesh (topology.mark_lost)")
    with _lock:
        cur = effective(ctx)
        world = cur.get_world_size()
        lost_eff = min(max(int(lost), 1), world - 1)
        if world <= 1 or lost_eff < 1:
            return cur
        roster = _roster_locked(ctx, cur)
        live = world - lost_eff
        new_ctx = cur.with_world(live)
        _register_locked(ctx, cur, new_ctx, roster)
        # a loss consumes any pending rejoin of the same family: the
        # flapper died again before its join was applied
        _pending.pop(roster, None)
        _last_change[roster] = time.monotonic()
        _epoch += 1
    trace.gauge("recover.survivor_world", live)
    _warn("mesh degraded: %d device(s) lost, re-meshing %d -> %d "
          "survivors (epoch %d)", lost_eff, world, live, _epoch)
    flightrec.note("mesh_degraded", lost=lost_eff, world=world,
                   survivor_world=live, epoch=_epoch)
    return new_ctx


def mark_joined(ctx, joined: int = 1):
    """Record the RETURN of ``joined`` slots to ``ctx``'s family and
    return the grown context — the inverse of :func:`mark_lost`.

    Rejoined slots re-attach in roster order, clamped so the world never
    grows past the family's full roster; a family that was never
    degraded has nothing to rejoin and the effective context is returned
    unchanged.  ``joined=0`` is the hysteresis flush: apply any joins a
    previous call held back, without registering new ones.

    Flap damping: when ``config.remesh_cooldown_ms()`` > 0 and the last
    transition of this family is within the window, the join is held
    *pending* (``recover.join_damped``, a ``mesh_join_damped`` event)
    and the current context is returned.

    On apply: a grown world that is the family's FULL roster collapses
    back onto the ORIGINAL context (``degraded(ctx)`` turns False and
    plans cached before the loss hit again).  Bumps the epoch, books
    ``recover.scaleups``, and notes a ``mesh_expanded`` event."""
    from . import config
    from .logging import warning as _warn
    from .observe import flightrec
    global _epoch
    _refuse(ctx, "a rejoin re-mesh (topology.mark_joined)")
    joined_eff = max(int(joined), 0)
    with _lock:
        cur = effective(ctx)
        hit = _rosters.get(id(cur)) or _rosters.get(id(ctx))
        if hit is None:
            return cur          # never degraded: nothing to rejoin
        roster = hit[1]
        world = cur.get_world_size()
        pend = min(_pending.get(roster, 0) + joined_eff,
                   len(roster) - world)
        if pend <= 0:
            _pending.pop(roster, None)
            return cur
        cooldown = config.remesh_cooldown_ms()
        now = time.monotonic()
        if cooldown > 0 and \
                (now - _last_change.get(roster, 0.0)) * 1e3 < cooldown:
            _pending[roster] = pend
            damped_new = joined_eff > 0
            applied = False
        else:
            live = world + pend
            anchor = _origins.get(roster)
            if live == len(roster) and anchor is not None \
                    and slots(anchor) == roster:
                new_ctx = anchor    # full restore: collapse the chain
            else:
                new_ctx = cur.with_world(live)
            _register_locked(ctx, cur, new_ctx, roster)
            _pending.pop(roster, None)
            _last_change[roster] = now
            _epoch += 1
            applied = True
    if not applied:
        if damped_new:
            trace.count("recover.join_damped")
            _warn("mesh join damped: %d device(s) pending rejoin "
                  "(flap window %d ms)", pend, cooldown)
            flightrec.note("mesh_join_damped", pending=pend,
                           cooldown_ms=cooldown, world=world)
        return cur
    trace.gauge("recover.survivor_world", live)
    trace.count("recover.scaleups")
    _warn("mesh expanded: %d device(s) rejoined, re-meshing %d -> %d "
          "(epoch %d)", pend, world, live, _epoch)
    flightrec.note("mesh_expanded", joined=pend, world=world,
                   new_world=live, epoch=_epoch)
    return new_ctx


def axis_split(ctx) -> Tuple[int, int]:
    """The ``(slow, fast)`` factorization of ``ctx``'s world.

    Resolution: explicit ``config.set_mesh_shape`` / ``CYLON_MESH_SHAPE``
    first, else the process grouping ``(nproc, L)`` of a world that spans
    processes (the JAX package's ``process_index`` grouping: the slow
    stage of a hierarchical exchange is then the cross-process one), else
    the flat ``(1, world)`` (one process holds every shard, so there is
    no host grouping to read).  A configured shape that does
    not tile the world keeps its FAST extent when that still divides,
    and otherwise degrades to flat.  Always a valid factorization of the
    world size, so a re-mesh onto survivors re-prices the hierarchy."""
    from . import config
    world = int(ctx.get_world_size())
    if world <= 0:
        return (1, 1)
    shape = config.mesh_shape()
    if shape is None:
        nproc = ctx.get_process_count()
        if nproc > 1:
            return (nproc, world // nproc)
        return (1, world)
    slow, fast = shape
    if slow * fast == world:
        return (slow, fast)
    if fast > 1 and world % fast == 0:
        return (world // fast, fast)
    return (1, world)


def reset() -> None:
    """Forget every degrade (test isolation / repaired-fleet restart).
    Tables already re-meshed in place stay on their survivor world —
    only the ROUTING of new work reverts."""
    global _epoch
    with _lock:
        _survivors.clear()
        _rosters.clear()
        _origins.clear()
        _pending.clear()
        _last_change.clear()
        _epoch += 1
