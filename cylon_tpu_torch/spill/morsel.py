"""Morsel-partitioned scans: stream an over-budget table through its
consumer in admission-priced morsels.

The port of ``cylon_tpu/spill/morsel.py``.  A resident operator assumes
its whole input block fits the device budget.  When it does not, the
morsel scan takes over: the table lives host-side in the spill pool, and
execution walks it in K row slices ("morsels"), each priced to fit.
Morsel k+1 is staged (a ``non_blocking`` host→device copy of each
shard's row slice, straight from the pinned pool blocks) on a
``HostPipeline`` worker while morsel k computes on the card, and
per-morsel PARTIALS fold through the combine-spec machinery:

  * :func:`morsel_groupby` — per morsel, the local partial aggregation
    (``dist_groupby(..., _local_only=True)`` over the decomposed aggs);
    partials fold pairwise (sum of sums, sum of counts, min of mins, max
    of maxes), then ONE partial exchange with the combine spec and a
    combining pass (``_combine_leaf_spec`` + ``_recompose_partials``, the
    tail of ``dist_groupby_fused``) give the result.  The card never
    holds more than one morsel plus the group-sized partial block.
  * :func:`morsel_join` — the probe side streams in morsels, each joined
    against the resident build side; the outputs concatenate (INNER /
    LEFT, the restriction of ``dist_join_streaming``).

The planner inserts a ``morsel_scan`` node over a scan priced over the
memory budget (``plan/rules.py``); its lowering prices again at execution
against the live budget and spills the table when it still does not fit.
The operators detect a spilled input and route here
(``parallel/dist_ops.py``, ``parallel/streaming.py``).
"""
from __future__ import annotations

from contextlib import closing
from typing import List, Optional, Sequence, Tuple

from .. import trace
from ..analysis import plan_check
from ..ops import compact as ops_compact
from . import pool

__all__ = ["plan_morsels", "stage_in_slice", "iter_morsels",
           "morsel_groupby", "morsel_join", "table_priced_bytes"]

_MIN_MORSEL_ROWS = 8


def table_priced_bytes(nparts: int, cap: int, rbytes: int) -> int:
    """The resident price of holding one table's padded blocks plus one
    single-shot exchange over them: what the morsel planner (and the plan
    rule's eligibility check) compares against the budget.  Capacity
    bound and host-side only."""
    from ..parallel import cost
    block = ops_compact.next_bucket(max(cap, 1), minimum=8)
    outcap = ops_compact.next_bucket(max(nparts * cap, 1), minimum=8)
    return cap * rbytes + cost.single_shot_bytes(nparts, (block, outcap),
                                                 rbytes)


def plan_morsels(nparts: int, cap: int, rbytes: int,
                 budget: int) -> Tuple[int, int, int]:
    """Admission-priced morsel sizing: the widest per-shard row slice
    ``w`` whose resident block + worst single-shot exchange prices within
    ``budget`` (halving from ``cap``, floored at ``_MIN_MORSEL_ROWS``:
    below that the scan cannot shrink and runs best-effort, like the
    chunked exchange's C = 1 floor).  Returns ``(morsels, w,
    per_morsel_bytes)``."""
    w = max(int(cap), 1)
    while w > _MIN_MORSEL_ROWS:
        if table_priced_bytes(nparts, w, rbytes) <= budget:
            break
        w = max(w // 2, _MIN_MORSEL_ROWS)
    k = -(-int(cap) // w)
    return k, w, table_priced_bytes(nparts, w, rbytes)


def _spilled_rbytes(dt) -> int:
    """Payload width of one row of a (possibly spilled) table, from
    metadata only: never faults the leaves in."""
    from ..dtypes import device_dtype
    total = 0
    for c in dt._columns:
        total += int(device_dtype(c.dtype.type).itemsize)
        if c.validity is not None:
            total += 1
    return max(total, 1)


def stage_in_slice(dt, lo: int, hi: int,
                   col_ids: Optional[Sequence[int]] = None, entry=None,
                   defer: bool = False):
    """Rows [lo, hi) of every shard's block of a SPILLED table, staged to
    the device as a narrower DTable (the morsel scan's unit of work).
    Each shard's slice is copied straight from its pooled block: the full
    table is never faulted in.  ``entry`` pins the host blocks the scan
    started from against a concurrent fault-in.  Returns ``(table,
    staged)``; with ``defer`` the consumer calls ``staged.ready()`` before
    it uses the table (see ``pool.stage_in_arrays``)."""
    from ..parallel.dtable import DColumn, DTable
    ids = list(range(dt.num_columns)) if col_ids is None else list(col_ids)
    blocks, counts, w = pool.get_pool().slice_blocks(dt, lo, hi, ids,
                                                     entry=entry)
    flat: List = []
    for d, v in blocks:
        flat.append(d)
        if v is not None:
            flat.append(v)
    flat.append(counts)
    devs = pool.stage_in_arrays(dt.ctx, flat, defer=defer)
    it = iter(devs)
    cols = []
    for i, (_, v) in zip(ids, blocks):
        meta = dt._columns[i]
        dd = next(it)
        vv = None if v is None else next(it)
        cols.append(DColumn(meta.name, meta.dtype, dd, vv,
                            meta.dictionary, meta.arrow_type))
    out = DTable(dt.ctx, cols, w, devs[-1])
    out._counts_host = counts   # sliced counts are host-known
    return out, devs


def iter_morsels(dt, entry, k: int, w: int, cap: int):
    """Yield the ``k`` staged morsel DTables of a spilled table, one per
    ``w``-row slice of its ``cap``-row blocks, staging morsel m+1 on a
    ``HostPipeline`` worker while the caller computes on morsel m (the
    morsel-scan loop shared by ``morsel_groupby``, ``morsel_join`` and the
    spilled branch of ``dist_groupby_sketch``).  Each morsel is ready on
    the caller's stream when yielded.  Counts ``spill.morsels``.  Drive it
    to completion or ``close()`` it; the worker joins either way."""
    from ..parallel.streaming import HostPipeline
    pipe = HostPipeline(name="spill-morsel")
    try:
        nxt = pipe.submit(lambda: stage_in_slice(dt, 0, min(w, cap),
                                                 entry=entry, defer=True))
        for m in range(k):
            cur, staged = nxt.wait()
            staged.ready()
            del staged
            if m + 1 < k:
                lo = (m + 1) * w
                hi = min(lo + w, cap)
                nxt = pipe.submit(lambda lo=lo, hi=hi: stage_in_slice(
                    dt, lo, hi, entry=entry, defer=True))
            trace.count("spill.morsels")
            yield cur
            del cur
    finally:
        pipe.close()


def _dense_engaged(dt_cap: int, key_meta, dense_key_range, world: int,
                   local: bool) -> bool:
    """Mirror of dist_groupby's dense-path guard at a given capacity: a
    dense hint that cannot engage at MORSEL width must be dropped
    (sort-path grouping is always correct), except under emit_empty,
    which requires it."""
    from ..dtypes import device_dtype, is_dictionary_encoded
    from ..parallel.dist_ops import _is_integer
    if dense_key_range is None or key_meta is None:
        return False
    lo, hi = int(dense_key_range[0]), int(dense_key_range[1])
    stride = 1 if (world == 1 or local) else world
    return (_is_integer(device_dtype(key_meta.dtype.type))
            and not is_dictionary_encoded(key_meta.dtype.type)
            and 0 < hi - lo + 1
            and -(-(hi - lo + 1) // stride) <= 4 * dt_cap)


def _morsel_plan(dt, morsels: Optional[int]):
    """(entry, cap, k, w, per-morsel bytes, budget) of one scan."""
    from ..resilience import exchange_budget
    entry = pool.get_pool().pin_for_scan(dt)
    cap = entry.cap
    rbytes = _spilled_rbytes(dt)
    budget = exchange_budget(dt.ctx.device)
    if morsels is None:
        k, w, per_bytes = plan_morsels(dt.nparts, cap, rbytes, budget)
    else:
        k = max(int(morsels), 1)
        w = -(-cap // k)
        per_bytes = table_priced_bytes(dt.nparts, w, rbytes)
    return entry, cap, k, w, per_bytes, budget


def morsel_groupby(dt, key_columns, aggregations, where=None,
                   dense_key_range=None, emit_empty: bool = False,
                   morsels: Optional[int] = None,
                   reason: "str | None" = None):
    """Out-of-core groupby-aggregate over a spilled table: K staged
    morsels × local partial aggregation, partials folded by key, one final
    partial exchange + combine (the fused aggregation's tail).  The result
    is row-identical to the resident ``dist_groupby_fused``."""
    from ..parallel import dist_ops
    from ..parallel.streaming import _concat_compact
    key_ids = [dt.column_index(c) for c in key_columns]
    K = len(key_ids)
    nparts = dt.nparts
    entry, cap, k, w, per_bytes, budget = _morsel_plan(dt, morsels)
    # note() without the table operand: summarizing a spilled table would
    # fault its leaves in just to describe them
    node = plan_check.note("morsel_groupby", keys=tuple(key_columns),
                           aggs=tuple(op for _, op in aggregations),
                           morsels=k, per_morsel_bytes=per_bytes)
    plan_check.annotate(
        node, decision="morsel-scan",
        reason=(reason or f"{k} morsels x {w} rows/shard "
                f"({per_bytes} B/morsel vs {budget} B budget)"))
    trace.count("groupby.pushdown")
    trace.count("spill.morsel_groupbys")
    partial, plan = dist_ops._decompose_aggs(dt, aggregations)
    key_meta = dt._columns[key_ids[0]] if len(key_ids) == 1 else None
    dkr = dense_key_range
    if dkr is not None and not emit_empty \
            and not _dense_engaged(w, key_meta, dkr, nparts, local=True):
        dkr = None   # cannot engage at morsel width; the sort path instead
    comb_aggs = [(K + j, dist_ops._COMBINE_OP[op])
                 for j, (_, op) in enumerate(partial)]
    acc = None
    acc_names = None
    with closing(iter_morsels(dt, entry, k, w, cap)) as scan:
        for m, cur in enumerate(scan):
            part_m = dist_ops.dist_groupby(
                cur, key_ids, partial, where=where, dense_key_range=dkr,
                pre_aggregate=False, _local_only=True,
                emit_empty=emit_empty and m == 0)
            del cur
            if acc is None:
                acc = part_m
                acc_names = acc.column_names
            else:
                cat = _concat_compact([acc, part_m])
                del acc, part_m
                acc = dist_ops.dist_groupby(
                    cat, list(range(K)), comb_aggs, pre_aggregate=False,
                    _local_only=True).rename(acc_names)
                del cat
    # the fused aggregation's tail (dist_groupby_fused's pre-aggregate
    # arm): ONE exchange of the folded partial-group table with the
    # combine spec, a combining pass, and the positional recompose
    spec = dist_ops._combine_leaf_spec(acc, K, [op for _, op in partial])
    with trace.span("groupby.shuffle"):
        sh = dist_ops._shuffle_by_keys(acc, K, combine=spec)
    del acc
    comb = dist_ops.dist_groupby(sh, list(range(K)), comb_aggs,
                                 pre_aggregate=False, _local_only=True)
    return dist_ops._recompose_partials(
        dist_ops._base_meta(dt, aggregations), plan, comb, K)


def morsel_join(left, right, config, morsels: Optional[int] = None,
                dense_key_range=None):
    """Out-of-core join: the spilled LEFT side streams in K staged
    morsels, each joined against the resident right side; the outputs
    concatenate and compact into one result (morsel-major row order; the
    DTable contract leaves the order within a shard undefined, as for
    ``dist_join_streaming``).  INNER and LEFT only: a right row is
    unmatched only against ALL left morsels, which no single morsel can
    decide, so RIGHT / FULL_OUTER fault the left side in and run the
    resident join."""
    from ..parallel import dist_ops
    from ..parallel.streaming import _concat_compact
    how = config.join_type.value
    if how in ("right", "full_outer"):
        left.ensure_device()
        return dist_ops.dist_join(left, right, config, dense_key_range)
    entry, cap, k, w, per_bytes, budget = _morsel_plan(left, morsels)
    node = plan_check.note("morsel_join", right, how=how, morsels=k,
                           per_morsel_bytes=per_bytes)
    plan_check.annotate(
        node, decision="morsel-scan",
        reason=f"{k} morsels x {w} rows/shard ({per_bytes} B/morsel "
               f"vs {budget} B budget)")
    trace.count("spill.morsel_joins")
    parts = []
    with closing(iter_morsels(left, entry, k, w, cap)) as scan:
        for cur in scan:
            parts.append(dist_ops.dist_join(cur, right, config,
                                            dense_key_range))
            del cur
    return _concat_compact(parts)
