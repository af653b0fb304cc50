"""Elastic re-partition: move a DTable from a P-shard world onto a
P′-shard world.

The port of ``cylon_tpu/parallel/remesh.py``.  The pipeline is
direction-agnostic: P′ < P is the shrink the ladder's TOPOLOGY rung
takes after a ``mesh.device_lost`` fault, P′ > P the scale-up the
executor takes when ``mesh.device_joined`` grows the world back
mid-plan.  The move is a resharding lowered entirely through the HOST
tier, because the old world can no longer run a collective:

  1. **evacuate** — the table's leaves stage OUT through the spill
     pool's D2H boundary (``spill.pool.stage_out_arrays``, which orders
     the copy after the compute stream's queued work and keeps the
     source blocks out of the allocator until the copy has read them);
     a table already spilled reads its pooled host blocks instead — no
     device traffic;
  2. **re-block** — each old shard's valid rows are copied, shard-major,
     into P′ balanced blocks of a fresh ``next_bucket`` capacity, in
     page-locked host memory on the card (zero padding after each
     block's rows);
  3. **restage** — the new blocks stage IN on the new context
     (``stage_in_arrays``; its ``Staged.ready()`` makes the caller's
     stream wait for the copies before any kernel of the new world
     reads them).

The mutation is IN PLACE (fresh DColumn objects, the same DTable object):
execution-memo signatures and plan fingerprints key scan tables by
identity, so an in-place re-mesh lets checkpoints restore and plans
resume without re-capturing anything.  Derived tables sharing the old
device tensors keep them; only THIS handle moves, and its old-world
tensors go back to the caching allocator once nothing else holds them.

Priced like any exchange: ``cost.price_remesh`` — annotated
``remesh=P->P'`` on the plan (visible in EXPLAIN ANALYZE); the staged
bytes are booked as ``recover.evacuated_bytes``.
"""
from __future__ import annotations

from dataclasses import replace
from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import observe, trace
from ..ops.compact import next_bucket
from ..status import Code, CylonError, Status
from . import cost

__all__ = ["remesh_table", "ensure_current"]


def ensure_current(tables) -> int:
    """Migrate every table whose world has degraded (the topology
    registry resolves its context to a survivor) onto that survivor
    world, in place; returns the bytes evacuated.  The victim plan's
    rung re-meshes only the tables IT scans; a table untouched by it
    still lives on the old world, and ``plan.run`` calls this before
    wrapping so it moves exactly once.  Accepts a DTable, a dict of
    them, or any iterable; whole-world tables are a dict lookup."""
    from .. import topology
    if tables is None:
        return 0
    if hasattr(tables, "values"):
        tabs = list(tables.values())
    elif hasattr(tables, "ctx"):
        tabs = [tables]
    else:
        tabs = list(tables)
    evac = 0
    for dt in tabs:
        dctx = getattr(dt, "ctx", None)
        if dctx is None:
            continue
        eff = topology.effective(dctx)
        if eff is not dctx:
            evac += remesh_table(dt, eff)
    return evac


Pairs = List[Tuple[torch.Tensor, Optional[torch.Tensor]]]


def _host_leaves(dt) -> Tuple[Pairs, int]:
    """The table's leaves as host tensors, ``[(data, validity or None),
    ...]`` in column order: the pooled entry's blocks when spilled (no
    device read), else staged out through the D2H boundary.  Returns
    ``(pairs, staged_bytes)``."""
    from ..spill import pool as spill_pool
    entry = dt._spill_entry
    if entry is not None:
        # already evacuated: the host tier holds the sole copy — the
        # re-mesh consumes it and releases the pinned entry
        return list(entry.leaves), 0
    flat = []
    for c in dt._columns:
        flat.append(c.data)
        if c.validity is not None:
            flat.append(c.validity)
    hosts = iter(spill_pool.stage_out_arrays(flat))
    del flat
    pairs = [(next(hosts), None if c.validity is None else next(hosts))
             for c in dt._columns]
    staged = sum(int(h.numel()) * h.element_size()
                 for d, v in pairs for h in (d, v) if h is not None)
    return pairs, staged


def _reblock(h: torch.Tensor, counts: np.ndarray, cap_old: int,
             sizes: np.ndarray, cap_new: int, device) -> torch.Tensor:
    """One leaf's valid rows, shard-major, re-cut into ``len(sizes)``
    blocks of ``cap_new`` rows (zero padding after each block's rows):
    every old shard's rows are copied straight into the new blocks they
    overlap, so each row is copied once."""
    from ..spill.pool import pinned_empty
    p_new = len(sizes)
    tail = tuple(h.shape[1:])
    block = pinned_empty((p_new * cap_new,) + tail, h.dtype, device)
    new_offs = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    at = 0                            # global offset of old shard i
    for i, n in enumerate(counts.tolist()):
        lo, hi = at, at + n
        at = hi
        j = int(np.searchsorted(new_offs, lo, side="right")) - 1
        while lo < hi:
            take = min(hi, int(new_offs[j + 1])) - lo
            dst = j * cap_new + lo - int(new_offs[j])
            src = i * cap_old + lo - (hi - n)
            block[dst:dst + take].copy_(h[src:src + take])
            lo += take
            j += 1
    for j in range(p_new):
        block[j * cap_new + int(sizes[j]):(j + 1) * cap_new].zero_()
    return block


def remesh_table(dt, new_ctx) -> int:
    """Re-partition ``dt`` IN PLACE onto ``new_ctx``'s world; returns the
    bytes evacuated through the host boundary (0 when the table was
    already host-resident or already on the target context).  The row
    multiset is preserved exactly, and the re-block is deterministic:
    shard-major row order, balanced blocks (the first ``total % P′``
    shards hold one row more)."""
    from ..context import refuse_multiprocess
    refuse_multiprocess("parallel.remesh", dt.ctx)
    from ..analysis import plan_check
    from ..spill import pool as spill_pool
    if dt.ctx is new_ctx:
        return 0
    p_old = dt.ctx.get_world_size()
    p_new = new_ctx.get_world_size()
    dt._collapse_pending()
    counts = np.asarray(dt.counts_host()).astype(np.int64)
    if len(counts) != p_old:
        raise CylonError(Status(Code.ExecutionError,
            f"remesh: table counts span {len(counts)} shards but its "
            f"context world is {p_old} (corrupt layout)"))
    cap_old = dt.cap
    spilled_sig = (dt._spill_entry.sig
                   if dt._spill_entry is not None else None)
    pairs, staged = _host_leaves(dt)

    # pricing + the plan annotation: validity lanes are part of the moved
    # payload, so the full row width is priced
    leaves_flat = [a for d, v in pairs for a in (d, v) if a is not None]
    rbytes = max(observe.row_bytes(leaves_flat), 1)
    price = cost.price_remesh(p_old, p_new, counts, rbytes)
    plan_check.annotate_append(
        "remesh", f"{p_old}->{p_new}: {price.describe()}")

    total = int(counts.sum())
    base, rem = divmod(total, max(p_new, 1))
    sizes = np.array([base + (1 if i < rem else 0) for i in range(p_new)],
                     np.int32)
    cap_new = next_bucket(max(int(sizes.max(initial=0)), 1), minimum=8)
    blocks: List = []
    has_validity: List[bool] = []
    for d, v in pairs:
        for h in ((d,) if v is None else (d, v)):
            blocks.append(_reblock(h, counts, cap_old, sizes, cap_new,
                                   new_ctx.device))
        has_validity.append(v is not None)
    del pairs, leaves_flat
    blocks.append(sizes)
    devs = iter(spill_pool.stage_in_arrays(new_ctx, blocks))
    cols = []
    for c, hv in zip(dt._columns, has_validity):
        data = next(devs)
        cols.append(replace(c, data=data,
                            validity=next(devs) if hv else None))
    counts_dev = next(devs)
    # replicas cached from the old columns pin their tensors
    from . import broadcast
    broadcast.forget_replicas_of(dt._columns)
    # publish order mirrors the spill pool's: clear the spill linkage
    # FIRST so no reader takes a fault-in path against the consumed
    # entry, then land the new-world state
    dt._spill_entry = None
    dt._spill_sig = None
    dt.ctx = new_ctx
    dt._columns = cols
    dt.cap = int(cap_new)
    dt._counts = counts_dev
    dt._counts_host = sizes.copy()
    if spilled_sig is not None:
        # the old-world host copy was the pinned sole copy, consumed
        # now; dropping it returns its bytes to the host budget
        spill_pool.get_pool().drop_entry(spilled_sig)
    trace.count("recover.evacuated_bytes", staged)
    return staged
