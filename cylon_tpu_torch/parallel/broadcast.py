"""Replicated small tables: one all_gather in place of a shuffle.

Mirror of ``cylon_tpu/parallel/broadcast.py``'s ``rows_if_small`` and
``replicate_table``.  ``replicate_table`` gathers every leaf of a
(collapsed) DTable through the communicator's ``all_gather``, drops the
per-shard padding, and packs the rows into one block bucketed by
``next_bucket`` that every shard holds.  The counts say which shards own
the rows:

  ALL   ``counts[i] = total`` on every shard (the broadcast-join probe
        form);
  HEAD  ``counts = [total, 0, …]``: every shard holds the rows but only
        shard 0's copy is valid, so nothing is counted twice (the
        groupby's combine form).

``rows_if_small`` is the planner predicate: an upper bound on the rows
when it is at most the threshold and the replica fits the memory budget,
read from ingest-cached counts or else the capacity bound ``P * cap``,
never from the device.

The **replica cache** keys a replicated block by the identity of the
small side's tensors (plus names, dictionaries, layout and mode): a
dimension table joined several times per query (nation, region and
supplier in TPC-H Q5/Q7/Q9) is gathered once.  An entry pins its source
columns, so the identities stay unique while it is cached; the cache is
FIFO-bounded.  The groupby's one-shot combine passes ``cache=False``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import resilience, trace
from ..analysis import plan_check
from ..analysis._abstract import is_abstract
from ..config import broadcast_join_threshold
from ..observe.locks import OrderedLock
from ..observe.metrics import row_bytes
from ..ops import compact as ops_compact
from ..ops.gather import signed_view
from . import cost
from .dtable import DColumn, DTable

ALL = "all"
HEAD = "head"


def _leaves(dt: DTable):
    return [lf for c in dt.columns for lf in (c.data, c.validity)
            if lf is not None]


def rows_if_small(dt: DTable, threshold: Optional[int],
                  quiet: bool = False) -> Optional[int]:
    """Global-row upper bound if ``dt`` provably holds ≤ ``threshold`` rows
    AND its replica fits the memory budget, else None — with no device
    read.  ``threshold`` None reads the process-wide knob; ≤ 0 disables.
    A budget veto bumps ``broadcast.budget_veto`` and annotates the
    current plan node, unless ``quiet`` (an advisory pre-check that the
    authoritative one inside the join repeats)."""
    if threshold is None:
        threshold = broadcast_join_threshold()
    if threshold <= 0:
        return None
    ch = dt._counts_host
    if ch is not None and dt.pending_mask is None:
        n = int(ch.sum())
        rows = n if n <= threshold else None
    else:
        bound = dt.nparts * dt.cap
        rows = bound if bound <= threshold else None
    if rows is None:
        return None
    rbytes = max(row_bytes(_leaves(dt)), 1)
    outcap = ops_compact.next_bucket(max(rows, 1), minimum=8)
    # the replica is priced through the shared cost model, against the
    # budget the shuffle chooser reads (its fault point included)
    priced = cost.price_replicate(dt.nparts, dt.cap, outcap,
                                  rbytes).peak_bytes
    budget = resilience.exchange_budget(dt.ctx.device)
    if priced > budget:
        if not quiet:
            trace.count("broadcast.budget_veto")
            plan_check.annotate(
                broadcast_veto=f"replica would price {priced} B/device "
                               f"over the {budget} B budget")
        return None
    return rows


def small_side_reason(dt: DTable, rows: int) -> str:
    """Which evidence proved a side small (a ``rows_if_small`` hit)."""
    if dt._counts_host is not None and dt.pending_mask is None:
        return f"{rows} rows <= threshold (ingest-cached counts)"
    return f"capacity bound {dt.nparts}x{dt.cap} = {rows} <= threshold"


_replica_cache: dict = {}
_replica_lock = OrderedLock("broadcast.replica_cache")
_REPLICA_CACHE_MAX = 64

gathers = 0  # replica gathers run (cache misses), for tests


def clear_replica_cache() -> None:
    """Drop every cached replica (frees the pinned source columns)."""
    with _replica_lock:
        _replica_cache.clear()


def forget_replicas_of(columns) -> None:
    """Drop the cached replicas built from ``columns`` (a table whose
    device leaves are being dropped: the cache pins its source columns,
    which would keep those tensors alive)."""
    ids = {id(c.data) for c in columns}
    with _replica_lock:
        stale = [k for k, (_, cols, _) in _replica_cache.items()
                 if any(id(c.data) in ids for c in cols)]
        for k in stale:
            del _replica_cache[k]


def _cache_key(dt: DTable, mode: str) -> Tuple:
    # names and dictionary identity belong in the key: a rename or a
    # dictionary swap shares the device tensors and must not hit a
    # replica built under the old metadata; so does the process group (a
    # replica holds the rows of every process of its world)
    return (id(dt.ctx), dt.ctx.comm.group_key, mode, dt.cap,
            tuple((c.name, id(c.data), id(c.validity), id(c.dictionary))
                  for c in dt.columns))


@plan_check.instrument
def replicate_table(dt: DTable, mode: str = ALL,
                    span_name: str = "join.broadcast_gather",
                    cache: bool = True) -> DTable:
    """Gather ``dt``'s rows into a replicated DTable: every shard's block
    holds all rows, in shard order.  ``dt`` must carry no pending mask
    (callers collapse first).  Schema, dictionaries and column order are
    kept, so the result drops into any per-shard kernel.  ``cache=False``
    for one-shot intermediates (caching them would pin dead tensors).

    A gather (not a cache hit) counts ``span_name`` once and its wire
    volume, rows × (P − 1) × row width, as ``broadcast.rows_sent`` /
    ``broadcast.bytes_sent``; the groupby's combine gather
    (``span_name="groupby.broadcast_gather"``) also adds the bytes to
    ``groupby.bytes_moved``.  An abstract table (meta leaves, a plan
    check) is neither cached nor counted."""
    global gathers
    if dt.pending_mask is not None:
        raise ValueError("replicate_table: collapse the pending mask first")
    if mode not in (ALL, HEAD):
        raise ValueError(f"replicate_table: unknown mode {mode!r}")
    plan_check.note("replicate_table", dt, mode=mode)
    # an abstract plan run (meta leaves): the replica of a meta table is
    # meta — caching it would hand a later real run tensors without data
    # — and it moves zero bytes, like every other exchange path there
    abstract = any(is_abstract(c.data) for c in dt.columns)
    cache = cache and not abstract
    key = _cache_key(dt, mode) if cache else None
    if cache:
        with _replica_lock:
            hit = _replica_cache.get(key)
        if hit is not None:
            trace.count("join.broadcast_replica_hit")
            plan_check.annotate(decision="replica-cache hit")
            return hit[2]
    plan_check.annotate(decision="gather")
    P, cap = dt.nparts, dt.cap
    ch = dt._counts_host
    total_bound = int(ch.sum()) if ch is not None else P * cap
    outcap = ops_compact.next_bucket(max(total_bound, 1), minimum=8)
    if not abstract:
        gathers += 1
        moved = total_bound * max(P - 1, 0)
        moved_bytes = moved * row_bytes(_leaves(dt))
        trace.count("broadcast.rows_sent", moved)
        trace.count("broadcast.bytes_sent", moved_bytes)
        if span_name == "groupby.broadcast_gather":
            trace.count("groupby.bytes_moved", moved_bytes)
    with trace.span_sync(span_name) as sp:
        trace.count(span_name)  # the counter mirrors the span name
        rep = _gather(dt, mode, outcap)
        sp.sync([c.data for c in rep.columns])
    if cache:
        with _replica_lock:
            while len(_replica_cache) >= _REPLICA_CACHE_MAX:
                _replica_cache.pop(next(iter(_replica_cache)))
            # pin the context and the source columns: their ids are the key
            _replica_cache[key] = (dt.ctx, dt.columns, rep)
            size = len(_replica_cache)
        trace.gauge("broadcast.replica_cache_size", size)
    return rep


def _gather(dt: DTable, mode: str, outcap: int) -> DTable:
    """The replica of ``dt`` as a DTable of capacity ``outcap``: every
    local shard of every process holds the rows of all P shards."""
    comm = dt.ctx.comm
    P, L, cap = dt.nparts, dt.nlocal, dt.cap
    gcnts = comm.all_gather(dt.counts)                                # [P]
    valid = (torch.arange(cap, device=gcnts.device)[None, :]
             < gcnts[:, None]).reshape(-1)
    idx = ops_compact.compact_indices(valid, outcap, fill=0).long()
    total = torch.sum(gcnts).to(torch.int32)
    keep = torch.arange(outcap, device=gcnts.device) < total

    def gather(leaf: torch.Tensor) -> torch.Tensor:
        g = comm.all_gather(signed_view(leaf).view(L, cap)).reshape(-1)
        block = torch.where(keep, g[idx], 0).to(g.dtype)
        return block.repeat(L).view(leaf.dtype)      # one copy per shard

    cols = [DColumn(c.name, c.dtype, gather(c.data),
                    None if c.validity is None else gather(c.validity),
                    c.dictionary, c.arrow_type)
            for c in dt.columns]
    if mode == HEAD:
        # global rank 0 owns the rows: the first local shard of the
        # first process
        counts = torch.zeros(L, dtype=torch.int32, device=total.device)
        if comm.first_rank == 0:
            counts[0] = total
    else:
        counts = total.reshape(1).repeat(L)
    return DTable(dt.ctx, cols, outcap, counts)
