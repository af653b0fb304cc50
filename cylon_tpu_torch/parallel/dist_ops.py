"""Distributed operators: partition → shuffle → masked local kernel.

Mirror of the join, sort, set-operation, select and groupby paths of
``cylon_tpu/parallel/dist_ops.py`` (reference:
cpp/src/cylon/table_api.cpp:299-352 DistributedJoinTables, :904-975
DoDistributedSetOperation, :214-297 Shuffle, :977-1005 Select,
:1007-1029 Project).  The pattern:

  partition   murmur3 row hash % P per row — the CUDA kernel of
              ops/hash_cuda.py on the card, its plain version on the CPU —
              for the HASH join and the set ops; or sampled-splitter range
              partitioning (sample-sort) for the SORT join and dist_sort;
  shuffle     the costed two-phase exchange (shuffle.shuffle_leaves);
  local op    the sort-plan join kernel (ops/join.py), the masked sorts
              (ops/sort.py), the set-op grouping (ops/setops.py) or the
              groupby (ops/groupby.py) per shard on its padded block,
              count-masked.

Before shuffling, a join replicates a side provably under the broadcast
threshold (``broadcast.replicate_table``, replica-cached) and probes it
with the other side in place; ``dense_key_range`` takes the FK → PK join
through a key→row map (one scatter, one gather), replicated or routed by
key residue.  The semi / anti joins probe presence: one merged sort per
shard after a hash shuffle, or presence bits over a dense key range.

Row filters (``dist_select``, and ``where`` on the groupby and the scalar
aggregate) evaluate a predicate over the flat ``[P*cap]`` columns with
SQL null semantics; ``dist_select(compact=False)`` defers the compaction
as a pending mask that mask-aware consumers fold.  The groupby
pre-aggregates per shard by default at world > 1 and combines the partial
groups by one all_gather (``broadcast.replicate_table``) when they are
provably few, else by a hash shuffle of the partials.

Everything stays on the device except the per-shard count vectors, which
the host reads to size each data-dependent output.  The splitters are
pooled through the communicator's ``all_gather`` and never reach the host.
"""
from __future__ import annotations

import threading
from collections import Counter
from contextlib import contextmanager
from dataclasses import replace
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import trace
from ..analysis import plan_check
from ..analysis._abstract import is_abstract
from ..compute import _agg_output_type
from ..config import (JoinAlgorithm, JoinConfig, JoinType,
                      broadcast_join_threshold)
from ..dtypes import (DataType, Type, device_dtype, extreme_value,
                      is_dictionary_encoded)
from ..observe.metrics import row_bytes
from ..ops import compact as ops_compact
from ..ops import gather as ops_gather
from ..ops import groupby as ops_groupby
from ..ops import join as ops_join
from ..ops import setops as ops_setops
from ..ops import sketch as ops_sketch
from ..ops import sort as ops_sort
from ..ops.hash_cuda import partition_ids_fused
from ..status import Code, CylonError, Status
from ..table import Column, Table, remap_codes, remap_dictionaries
from . import broadcast
from .dtable import DColumn, DTable
from .shuffle import shuffle_leaves

# Local kernel behind JoinAlgorithm.HASH.  The JAX package measured its
# dense-rank direct-address kernel (ops/hashjoin.py) slower than the fused
# sort plan and retired it behind this switch; the port carries only the
# sort plan.
HASH_LOCAL_KERNEL = "sort"

_SAMPLES_PER_SHARD = 64  # sample-sort oversampling factor

# The optimistic count protocol's size hints (ops/compact.py): the last
# bucketed output capacity per operator signature, so the next call of
# the same signature dispatches its phase 2 before the host has read the
# counts.  ``_capacity_hints``: the join (size-class caps + join kind);
# ``_group_cap_hints``: the groupby (keyed by the ``where`` predicate
# object too, so it is bounded — a fresh lambda per call would otherwise
# grow it and pin the closures forever); ``_select_cap_hints``: the row
# filters (select, semi / anti join), bounded the same way.
_capacity_hints: dict = {}
_group_cap_hints: dict = {}
_select_cap_hints: dict = {}
_GROUP_HINTS_MAX = 256


def _bounded(hints: dict) -> dict:
    """``hints`` with its oldest entries dropped past ``_GROUP_HINTS_MAX``
    (insertion order: FIFO)."""
    while len(hints) > _GROUP_HINTS_MAX:
        hints.pop(next(iter(hints)))
    return hints


def _size_class(per_shard: np.ndarray) -> Tuple[int]:
    """The optimistic protocol's ``need`` for one output block: the
    largest per-shard count, bucketed (``next_bucket``, at least 8)."""
    return (ops_compact.next_bucket(max(int(per_shard.max(initial=0)), 1),
                                    minimum=8),)


def clear_size_hints() -> None:
    """Forget every optimistic size hint of the distributed operators
    and the shuffle (test isolation; the next call of each signature
    waits for its counts)."""
    from . import shuffle
    _capacity_hints.clear()
    _group_cap_hints.clear()
    _select_cap_hints.clear()
    shuffle._block_hints.clear()

# Strategy taken by each distributed join / semi-join call since the last
# ``decisions.clear()``: "join.broadcast", "join.shuffle", "join.local",
# "join.fk-dense" (+ "+broadcast" / "+shuffle" at world > 1),
# "semi.broadcast", "semi.shuffle", "semi.local", each with ".dense" or
# ".sort" for the semi-join's probe; per probe of ``dist_multiway_join``
# "multiway.broadcast", "multiway.broadcast-fact", "multiway.shuffle" or
# "multiway.local"; per ``dist_groupby_fused`` call the mode it ran,
# "groupby.psum", "groupby.pre-aggregate", "groupby.shuffle" or
# "groupby.local" (the JAX package counts the same choices with its trace
# counters and plan annotations).
decisions: Counter = Counter()


# ---------------------------------------------------------------------------
# helpers: row masks, partition ids, dictionary unification across DTables
# ---------------------------------------------------------------------------

def _row_mask(dt: DTable) -> torch.Tensor:
    """counts [P] → valid-row mask [P*cap] (True for rows < shard count)."""
    ar = torch.arange(dt.cap, device=dt.counts.device)
    return (ar[None, :] < dt.counts[:, None]).reshape(-1)


def _resolve_ids(dt: DTable, cols: Sequence[Union[int, str]]) -> List[int]:
    return [dt.column_index(c) for c in cols]


def _shuffle_reason(node, default: str = "no side provably under the "
                                         "broadcast threshold") -> str:
    """The planner's reason for a shuffle decision: when the broadcast
    predicate was vetoed by the memory budget (``rows_if_small``
    annotated ``broadcast_veto`` on the node), the side WAS small."""
    if node is not None and "broadcast_veto" in node.info:
        return "broadcast replica vetoed by the memory budget"
    return default


def _cleared(dt: DTable) -> DTable:
    """A handle on the same blocks with the pending mask dropped, for
    callers that folded the mask into their partition ids."""
    return DTable(dt.ctx, dt.columns, dt.cap, dt.counts)


def _hash_pids(dt: DTable, key_ids: Sequence[int]) -> torch.Tensor:
    """Target shard per row by murmur3 row hash; padding rows → P (dropped).

    One call of the partition kernel over all P blocks: a row's id does
    not depend on its shard.  reference: HashPartition
    (table_api.cpp:461-528) + HashPartitionArrays.
    """
    P = dt.ctx.get_world_size()
    pid = partition_ids_fused(tuple(dt.columns[i].data for i in key_ids),
                              tuple(dt.columns[i].validity for i in key_ids),
                              P)
    return torch.where(_row_mask(dt), pid, P)


def _unify_dtable_dicts(a: DTable, b: DTable,
                        a_ids: Sequence[int], b_ids: Sequence[int]
                        ) -> Tuple[DTable, DTable]:
    """Re-encode paired dictionary columns onto shared dictionaries."""
    acols, bcols = list(a.columns), list(b.columns)
    changed = False
    for ai, bi in zip(a_ids, b_ids):
        ca, cb = acols[ai], bcols[bi]
        if not is_dictionary_encoded(ca.dtype.type):
            continue
        got = remap_dictionaries(ca.dictionary, cb.dictionary)
        if got is None:
            continue
        merged, map_a, map_b = got
        acols[ai] = replace(ca, data=remap_codes(ca.data, map_a),
                            dictionary=merged)
        bcols[bi] = replace(cb, data=remap_codes(cb.data, map_b),
                            dictionary=merged)
        changed = True
    if not changed:
        return a, b
    return (DTable(a.ctx, acols, a.cap, a.counts, a.pending_mask,
                   a.pending_cnts),
            DTable(b.ctx, bcols, b.cap, b.counts, b.pending_mask,
                   b.pending_cnts))


# ---------------------------------------------------------------------------
# shuffle_table (reference: Shuffle, table_api.cpp:214-297)
# ---------------------------------------------------------------------------

def _shuffle_by_pids(dt: DTable, pid: torch.Tensor, owner: str = "",
                     combine=None) -> DTable:
    """Exchange rows to their target shards; rebuild the DTable.
    ``owner="groupby"`` also counts the bytes as ``groupby.bytes_moved``;
    ``combine`` is the fold spec of a partial-group table
    (``_combine_leaf_spec``: ``groupby.partials_rows``, and the chunked
    and hierarchical lowerings fold rounds by key with it).  The
    lowering is the costed chooser's per-execution decision
    (``shuffle.shuffle_leaves``)."""
    if dt.pending_mask is not None:
        # ``pid`` was computed against THESE blocks: a deferred select must
        # have been folded into it (see ``_cleared``) or collapsed first
        raise CylonError(Status(Code.ExecutionError,
            "internal: shuffle of a mask-carrying DTable (fold the "
            "pending mask into the partition ids or collapse first)"))
    if dt.ctx.get_world_size() == 1:
        return dt  # one shard: every row is already home; no collective
    leaves: List[torch.Tensor] = []
    slots: List[Tuple[int, bool]] = []  # (column index, is_validity)
    for i, c in enumerate(dt.columns):
        leaves.append(c.data)
        slots.append((i, False))
        if c.validity is not None:
            leaves.append(c.validity)
            slots.append((i, True))
    new_leaves, newcounts, outcap = shuffle_leaves(dt.ctx, pid, leaves,
                                                   owner, combine)
    # structural exchange metric (host-side sizes, no read): the exchanged
    # slot capacity across shards, and the largest single exchange block
    P = dt.ctx.get_world_size()
    trace.count("shuffle.capacity_rows", P * outcap)
    trace.count("shuffle.capacity_cells", P * outcap * len(leaves))
    trace.count_max("shuffle.capacity_cells_max", P * outcap * len(leaves))
    data, validity = {}, {}
    for leaf, (i, is_v) in zip(new_leaves, slots):
        (validity if is_v else data)[i] = leaf
    cols = [DColumn(c.name, c.dtype, data[i], validity.get(i),
                    c.dictionary, c.arrow_type)
            for i, c in enumerate(dt.columns)]
    return DTable(dt.ctx, cols, outcap, newcounts)


def _shuffle_masked(dt: DTable, pid: torch.Tensor) -> DTable:
    """Shuffle with any deferred-select mask folded into the routing:
    masked-out rows go to the dropped partition and never cross the wire
    (the same pushdown ``dist_groupby``'s ``where`` rides)."""
    if dt.pending_mask is not None:
        pid = torch.where(dt.pending_mask, pid,
                          dt.ctx.get_world_size()).to(torch.int32)
        dt = _cleared(dt)
    return _shuffle_by_pids(dt, pid)


@plan_check.instrument
def shuffle_table(dt: DTable, key_columns: Sequence[Union[int, str]]
                  ) -> DTable:
    """Hash-repartition rows so equal keys co-locate on one shard."""
    plan_check.note("shuffle_table", dt, keys=tuple(key_columns),
                    decision="shuffle" if dt.ctx.get_world_size() > 1
                    else "local")
    dt._collapse_pending()
    return _shuffle_by_pids(dt, _hash_pids(dt, _resolve_ids(dt, key_columns)))


# ---------------------------------------------------------------------------
# distributed join (reference: DistributedJoinTables, table_api.cpp:299-352)
# ---------------------------------------------------------------------------

def _join_keys(dt: DTable, spec) -> List[int]:
    """Key spec → column-index list: an int/str, or a tuple/list of them."""
    if isinstance(spec, (tuple, list)):
        return [dt.column_index(c) for c in spec]
    return [dt.column_index(spec)]


def _join_setup(left: DTable, right: DTable, config: JoinConfig):
    """Key resolution + type check + dictionary unification.  The join's
    plan sorts want compacted inputs, so a deferred select collapses."""
    left._collapse_pending()
    right._collapse_pending()
    li_keys = _join_keys(left, config.left_column_idx)
    ri_keys = _join_keys(right, config.right_column_idx)
    if len(li_keys) != len(ri_keys):
        raise CylonError(Status(Code.Invalid,
            f"join key arity mismatch: {len(li_keys)} vs {len(ri_keys)}"))
    for li, ri in zip(li_keys, ri_keys):
        lt_k = left.columns[li].dtype.type
        rt_k = right.columns[ri].dtype.type
        if lt_k != rt_k:
            raise CylonError(Status(Code.TypeError,
                f"join key type mismatch {lt_k.name} vs {rt_k.name}"))
    left, right = _unify_dtable_dicts(left, right, li_keys, ri_keys)
    return left, right, li_keys, ri_keys


def _join_prologue(left: DTable, right: DTable, config: JoinConfig):
    """Setup + algorithm + sort splitters (None for HASH or one shard)."""
    left, right, li_keys, ri_keys = _join_setup(left, right, config)
    alg = "sort" if config.algorithm == JoinAlgorithm.SORT else "hash"
    if alg == "hash" or left.ctx.get_world_size() == 1:
        splitters = None
    else:
        # range partitioning samples the PRIMARY key column; equal primary
        # values land on one shard, and equal composite keys share their
        # primary value, so composite keys still co-locate
        with trace.span("join.sample"):
            splitters = _sample_splitters(
                [(left, li_keys[0]), (right, ri_keys[0])], ascending=True)
    return left, right, li_keys, ri_keys, alg, splitters


def _copartition(dt: DTable, key_is: Sequence[int], alg: str,
                 splitters) -> DTable:
    """Route rows to their join shard (hash or range partitioning)."""
    if dt.ctx.get_world_size() == 1:
        return dt  # one shard: co-partitioning is a no-op
    with trace.span_sync("join.partition") as sp:
        if alg == "sort":
            pid = _range_pids(dt, key_is[0], splitters, ascending=True)
        else:
            pid = _hash_pids(dt, key_is)
        sp.sync(pid)
    with trace.span("join.shuffle"):
        return _shuffle_by_pids(dt, pid)


def _shard(x, s: int, cap: int):
    return None if x is None else x[s * cap:(s + 1) * cap]


def _stacked(outs, k: int):
    """Column ``k`` of per-shard ``take_many`` outputs as flat tensors."""
    data = torch.cat([o[k][0] for o in outs])
    # validity presence depends on the inputs, not the shard's data
    vs = [o[k][1] for o in outs]
    return data, None if vs[0] is None else torch.cat(vs)


def _join_copartitioned(lsh: DTable, rsh: DTable, li_keys: Sequence[int],
                        ri_keys: Sequence[int], how: str, alg: str) -> DTable:
    """Masked local join of already co-partitioned sides, shard by shard.

    Phase 1 builds every shard's plan and output count; phase 2 expands
    each plan and gathers the output columns into one capacity for all
    shards, sized from the all-gathered counts through the optimistic
    count protocol (``_capacity_hints``, per join signature).
    """
    if alg == "hash" and HASH_LOCAL_KERNEL == "sort":
        alg = "sort"  # the retired rank kernel; see HASH_LOCAL_KERNEL
    if alg != "sort":
        raise CylonError(Status(Code.NotImplemented,
            f"dist_join: local kernel {alg!r} is not ported"))
    ctx = lsh.ctx
    L = ctx.get_local_world_size()
    lcap, rcap = lsh.cap, rsh.cap
    fill_left = how in ("right", "full_outer")
    fill_right = how in ("left", "full_outer")

    plans, totals = [], []
    with trace.span("join.count"):
        for s in range(L):
            lc, rc = lsh.counts[s], rsh.counts[s]
            plan = ops_join.sort_join_plan(
                tuple(_shard(lsh.columns[i].data, s, lcap) for i in li_keys),
                tuple(_shard(lsh.columns[i].validity, s, lcap)
                      for i in li_keys),
                tuple(_shard(rsh.columns[i].data, s, rcap) for i in ri_keys),
                tuple(_shard(rsh.columns[i].validity, s, rcap)
                      for i in ri_keys),
                how, l_count=lc, r_count=rc)
            plans.append(plan)
            totals.append(ops_join.plan_total(plan, how, l_count=lc,
                                              r_count=rc))

    cnts = ctx.comm.all_gather(torch.stack(totals))
    hint_key = (str(ctx.device), lcap, rcap, how, alg)

    def dispatch(sizes):
        capacity = sizes[0]
        louts, routs, counts = [], [], []
        for s, plan in enumerate(plans):
            lc, rc = lsh.counts[s], rsh.counts[s]
            li, ri, cnt = ops_join.plan_indices(plan, how, capacity,
                                                l_count=lc, r_count=rc)
            louts.append(ops_gather.take_many(
                [(_shard(c.data, s, lcap), _shard(c.validity, s, lcap))
                 for c in lsh.columns], li, fill_null=fill_left))
            routs.append(ops_gather.take_many(
                [(_shard(c.data, s, rcap), _shard(c.validity, s, rcap))
                 for c in rsh.columns], ri, fill_null=fill_right))
            counts.append(cnt)
        return louts, routs, counts

    with trace.span_sync("join.gather") as sp:
        (louts, routs, counts), used, per_shard = \
            ops_compact.optimistic_dispatch(_capacity_hints, hint_key,
                                            dispatch, cnts, _size_class)
        capacity = used[0]
        plans.clear()
        sp.sync((louts, routs))
    if per_shard is not None:  # None ⇒ deferred validation
        trace.count("join.out_rows", int(per_shard.sum()))

    cols = [DColumn("lt-" + c.name, c.dtype, *_stacked(louts, k),
                    c.dictionary, c.arrow_type)
            for k, c in enumerate(lsh.columns)]
    cols += [DColumn("rt-" + c.name, c.dtype, *_stacked(routs, k),
                     c.dictionary, c.arrow_type)
             for k, c in enumerate(rsh.columns)]
    return DTable(ctx, cols, capacity, torch.stack(counts))


def _dense_base(k: torch.Tensor, lo: int) -> torch.Tensor:
    """``key − lo`` as int32, exactly as the JAX package computes it: the
    subtraction wraps in the key's dtype, then narrows to int32 (an
    in-range key always yields a base that int32 holds; an int64 key past
    2^31 wraps instead of aliasing through a lossy cast first)."""
    d = (k.view(torch.int64) if k.dtype == torch.uint64
         else k.to(torch.int64)) - lo
    if k.element_size() < 4:
        d = d.to(k.dtype)  # wrap in the narrow type, then widen
    return d.to(torch.int32)


def _shard_ids(P: int, cap: int, device) -> torch.Tensor:
    """[P*cap] shard index of every flat row."""
    return torch.arange(P, device=device).repeat_interleave(cap)


def _valid_rows(dt: DTable, key: DColumn, mask=None):
    """(valid rows, non-null valid rows) of ``dt``'s flat blocks: the
    counts' prefix AND'ed with ``mask`` (a folded deferred select)."""
    rows = _row_mask(dt)
    if mask is not None:
        rows = rows & mask
    return rows, rows if key.validity is None else rows & key.validity


def _fk_probe(left: DTable, right: DTable, lkc: DColumn, rkc: DColumn,
              lo: int, hi: int, stride: int, lmask=None):
    """Dense-unique-key join probe, all shards at once: ONE scatter of the
    right rows into a key→row map over [lo, hi] per shard, ONE gather of
    the probe keys.  Returns (matched [L*cap_l], right row within its
    shard or −1, per-shard [matched, right out of range, right duplicate,
    right null] counts, all-gathered on the device).  The three violation
    counts do not
    depend on which of several duplicate writes wins the scatter: a
    duplicate is a valid right key whose slot holds another row."""
    L = left.nlocal
    dev = lkc.data.device
    R = -(-(hi - lo + 1) // stride)
    cap_l, cap_r = left.cap, right.cap
    lvalid, l_nonnull = _valid_rows(left, lkc, lmask)
    rvalid, r_nonnull = _valid_rows(right, rkc)
    r_in = (rkc.data >= lo) & (rkc.data <= hi)
    l_in = (lkc.data >= lo) & (lkc.data <= hi)
    r_base = _dense_base(rkc.data, lo)
    l_base = _dense_base(lkc.data, lo)
    if stride > 1:
        r_base = torch.div(r_base, stride, rounding_mode="floor")
        l_base = torch.div(l_base, stride, rounding_mode="floor")
    r_ok = r_nonnull & r_in
    r_shard = _shard_ids(L, cap_r, dev)
    slot = torch.where(r_ok, r_shard * R + r_base.long(), L * R)
    rows = torch.arange(cap_r, dtype=torch.int32, device=dev).repeat(L)
    amap = ops_compact.scatter_drop(L * R, slot, rows, fill=-1)
    occupied = (amap >= 0).view(L, R).sum(1)
    l_slot = (_shard_ids(L, cap_l, dev) * R
              + torch.clamp(l_base, 0, R - 1).long())
    m = amap[l_slot]
    matched = l_nonnull & l_in & (m >= 0)
    ri = torch.where(matched, m, -1)
    stats = torch.stack([
        matched.view(L, cap_l).sum(1),
        (r_nonnull & ~r_in).view(L, cap_r).sum(1),
        r_ok.view(L, cap_r).sum(1) - occupied,
        (rvalid & ~r_nonnull).view(L, cap_r).sum(1)], 1)
    return matched, ri, left.ctx.comm.all_gather(stats.to(torch.int64))


def _fk_violations(per_shard: np.ndarray) -> None:
    oob, dups, rnull = (int(per_shard[:, 1].sum()),
                        int(per_shard[:, 2].sum()),
                        int(per_shard[:, 3].sum()))
    if oob or dups or rnull:
        raise CylonError(Status(Code.Invalid,
            "dist_join dense_key_range contract violated on the right "
            f"side: {oob} keys out of range, {dups} duplicate keys, "
            f"{rnull} null keys (the hint promises unique non-null keys "
            "within the range)"))


def _fk_rgather(right: DTable, ri: torch.Tensor, cap_out: int,
                fill: bool):
    """Right-side output columns at per-output right rows ``ri`` (index
    within the row's shard; −1 ⇒ null when ``fill``)."""
    L = right.nlocal
    flat = _shard_ids(L, cap_out, ri.device) * right.cap + \
        torch.clamp(ri.long(), 0, right.cap - 1)
    if fill:
        flat = torch.where(ri >= 0, flat, -1)
    return ops_gather.take_many([(c.data, c.validity) for c in right.columns],
                                flat, fill_null=fill)


def _try_fk_join(left: DTable, right: DTable, config: JoinConfig,
                 dense_key_range, node=None) -> Optional[DTable]:
    """The dense-unique-right-key join if eligible, else None (the general
    path handles every shape).  The hint is advisory for dispatch, but its
    contract (unique, non-null, in-range right keys) is enforced."""
    how = config.join_type.value
    li_keys = _join_keys(left, config.left_column_idx)
    ri_keys = _join_keys(right, config.right_column_idx)
    if how not in ("inner", "left") or len(li_keys) != 1 \
            or len(ri_keys) != 1:
        return None
    lkc = left.columns[li_keys[0]]
    rkc = right.columns[ri_keys[0]]
    if (lkc.dtype.type != rkc.dtype.type or not _is_integer(lkc.data.dtype)
            or is_dictionary_encoded(lkc.dtype.type)):
        return None
    lo, hi = int(dense_key_range[0]), int(dense_key_range[1])
    world = left.ctx.get_world_size()
    if hi < lo:
        return None
    # a small build side is replicated instead of co-partitioned: the
    # probe side never moves, and every shard builds the full map
    # (stride 1), so the slot budget is checked against the replica
    r_rows = (broadcast.rows_if_small(right, config.broadcast_threshold)
              if world > 1 else None)
    stride = 1 if (world == 1 or r_rows is not None) else world
    R = -(-(hi - lo + 1) // stride)
    bcap_bound = (ops_compact.next_bucket(max(r_rows, 1), minimum=8)
                  if r_rows is not None else right.cap)
    if R > 4 * max(left.cap, bcap_bound):
        return None
    # a deferred select on the build side changes which keys exist:
    # compact it.  The probe side's mask fuses: INNER folds it into
    # ``matched``, LEFT passes it through to the zero-copy output.  The
    # decision's evidence is the table as the planner saw it, before
    # the collapse
    r_reason = (broadcast.small_side_reason(right, r_rows)
                if r_rows is not None else None)
    right._collapse_pending()
    if world > 1:
        if r_rows is not None:
            decisions["join.fk-dense+broadcast"] += 1
            trace.count("join.broadcast")
            plan_check.annotate(decision="fk-dense+broadcast",
                                reason=r_reason)
            right = broadcast.replicate_table(right)
        else:
            decisions["join.fk-dense+shuffle"] += 1
            trace.count("join.shuffle")
            plan_check.annotate(node, decision="fk-dense+shuffle",
                                reason=_shuffle_reason(
                                    node, "build side not provably "
                                          "small; modulo co-partition"))
            with trace.span("join.shuffle"):
                left = _shuffle_masked(left, _mod_pids(left, li_keys[0], lo,
                                                       world))
                right = _shuffle_by_pids(right, _mod_pids(right, ri_keys[0],
                                                          lo, world))
            lkc = left.columns[li_keys[0]]
        rkc = right.columns[ri_keys[0]]
    else:
        decisions["join.fk-dense"] += 1
        plan_check.annotate(decision="fk-dense", reason="world=1")
    lmask = left.pending_mask if how == "inner" else None
    with trace.span("join.count"):
        matched, ri, stats = _fk_probe(left, right, lkc, rkc, lo, hi,
                                       stride, lmask)
    ctx = left.ctx
    dev = str(ctx.device)
    if how == "left":
        # the probe side stays in place: every valid left row emits once,
        # so the capacity is static and the count protocol only carries
        # the contract check (its hint is seeded, so inside a deferred
        # region the check queues with the region's other validations)
        hint_key = ("fkleft", dev, left.cap, right.cap, lo, hi, stride)
        if not is_abstract(stats):  # a plan run leaves the hints alone
            _capacity_hints.setdefault(hint_key, ((1,), 0))

        def dispatch(sizes):
            with trace.span("join.gather"):
                return _fk_rgather(right, ri, left.cap, fill=True)

        def post(per_shard):
            _fk_violations(per_shard)
            return (1,)

        routs, _, _ = ops_compact.optimistic_dispatch(
            _capacity_hints, hint_key, dispatch, stats, post)
        cols = [DColumn("lt-" + c.name, c.dtype, c.data, c.validity,
                        c.dictionary, c.arrow_type) for c in left.columns]
        cols += [DColumn("rt-" + c.name, c.dtype, d, v, c.dictionary,
                         c.arrow_type)
                 for c, (d, v) in zip(right.columns, routs)]
        # a deferred select on the probe side stays deferred: the mask
        # still describes the output's rows
        return DTable(ctx, cols, left.cap, left.counts, left.pending_mask,
                      left.pending_cnts)
    # INNER: compact the matched probe rows with the right row riding as
    # one more column, then gather the right side at the compacted rows
    aug_cols = [DColumn("lt-" + c.name, c.dtype, c.data, c.validity,
                        c.dictionary, c.arrow_type) for c in left.columns]
    aug_cols.append(DColumn("__fk_ri", DataType(Type.INT32),
                            ri.to(torch.int32), None))
    aug = DTable(ctx, aug_cols, left.cap, left.counts)

    def post(per_shard):
        _fk_violations(per_shard)
        return _size_class(per_shard[:, 0])

    hint_key = ("fkinner", dev, left.cap, right.cap, lo, hi, stride,
                len(aug_cols), lmask is not None)
    out = _compact_survivors(aug, matched, stats, hint_key, "join.gather",
                             post=post)
    with trace.span("join.gather"):
        routs = _fk_rgather(right, out.columns[-1].data, out.cap,
                            fill=False)
    cols = list(out.columns[:-1])
    cols += [DColumn("rt-" + c.name, c.dtype, d, v, c.dictionary,
                     c.arrow_type)
             for c, (d, v) in zip(right.columns, routs)]
    return DTable(ctx, cols, out.cap, out.counts)


def _try_broadcast_join(left: DTable, right: DTable, config: JoinConfig
                        ) -> Optional[DTable]:
    """The replicated-small-side join if eligible, else None.

    A side qualifies when ``broadcast.rows_if_small`` proves it under the
    threshold (``config.broadcast_threshold``, else the process-wide
    knob) and its unmatched rows need no emission: INNER may replicate
    either side (the smaller bound wins, the right on a tie), LEFT only
    the right; RIGHT and FULL_OUTER shuffle (a replicated side's
    unmatched rows would be emitted once per shard).  The small side is
    all_gathered once (replica-cached) and the local kernel runs per
    shard against the unmoved large side, so the output keeps the large
    side's shard layout and SORT's global key order does not apply."""
    how = config.join_type.value
    if how not in ("inner", "left"):
        return None
    if left.ctx.get_world_size() == 1:
        return None  # co-partitioning is already a no-op
    thr = config.broadcast_threshold
    r_rows = broadcast.rows_if_small(right, thr)
    l_rows = broadcast.rows_if_small(left, thr) if how == "inner" else None
    if r_rows is None and l_rows is None:
        return None
    take_right = r_rows is not None and (l_rows is None or r_rows <= l_rows)
    # the decision's evidence is the tables as the planner saw them:
    # _join_setup may rebuild the handles and lose their ingest counts
    reason = (broadcast.small_side_reason(right, r_rows) if take_right
              else broadcast.small_side_reason(left, l_rows))
    left, right, li_keys, ri_keys = _join_setup(left, right, config)
    decisions["join.broadcast"] += 1
    trace.count("join.broadcast")
    plan_check.annotate(decision="broadcast",
                        side="right" if take_right else "left",
                        reason=reason)
    if take_right:
        return _join_copartitioned(left, broadcast.replicate_table(right),
                                   li_keys, ri_keys, how, "sort")
    return _join_copartitioned(broadcast.replicate_table(left), right,
                               li_keys, ri_keys, how, "sort")


@plan_check.instrument
def dist_join(left: DTable, right: DTable, config: JoinConfig,
              dense_key_range=None) -> DTable:
    """Distributed equi-join: co-partition both sides on the key (by hash
    for ``JoinAlgorithm.HASH``, by sampled key ranges for SORT, the
    default), then a masked local join per shard.  Output columns are
    ``lt-…`` / ``rt-…`` like the local join (reference
    join_utils.cpp:23-95).  Under SORT shard *i*'s keys all precede shard
    *i+1*'s.

    Before shuffling, a BROADCAST join is considered
    (``_try_broadcast_join``): a side provably under the broadcast
    threshold is replicated and neither side moves.

    ``dense_key_range=(lo, hi)``: the caller's promise that the RIGHT
    side's single integer key is unique, non-null and within [lo, hi]
    (the FK → PK shape).  Eligible INNER / LEFT joins then build a
    key→row map with one scatter and probe it with one gather: no sort,
    no pair expansion.  LEFT keeps the probe side in place (zero-copy).
    The build side is replicated when small, else both sides are routed
    by ``(key − lo) mod P``.  A duplicate, null or out-of-range right key
    raises.  Neither the broadcast nor the dense path keeps SORT's global
    key order.  The order of attempts is the JAX package's: FK, then
    broadcast, then the shuffle.

    A SPILLED left side of an INNER / LEFT join against a resident right
    side streams through the morsel scan (``spill.morsel.morsel_join``)
    instead of faulting the whole block in.
    """
    if left.is_spilled and config.join_type.value in ("inner", "left") \
            and not right.is_spilled:
        from ..spill import morsel as spill_morsel
        return spill_morsel.morsel_join(left, right, config,
                                        dense_key_range=dense_key_range)
    node = plan_check.note("dist_join", left, right,
                           how=config.join_type.value,
                           alg=config.algorithm.value,
                           dense=dense_key_range is not None or None)
    if dense_key_range is not None:
        out = _try_fk_join(left, right, config, dense_key_range, node)
        if out is not None:
            return out
    out = _try_broadcast_join(left, right, config)
    if out is not None:
        return out
    left, right, li_keys, ri_keys, alg, splitters = _join_prologue(
        left, right, config)
    if left.ctx.get_world_size() > 1:
        decisions["join.shuffle"] += 1
        trace.count("join.shuffle")
        plan_check.annotate(node, decision="shuffle",
                            reason=_shuffle_reason(node))
    else:
        decisions["join.local"] += 1
        plan_check.annotate(node, decision="local", reason="world=1")
    lsh = _copartition(left, li_keys, alg, splitters)
    rsh = _copartition(right, ri_keys, alg, splitters)
    return _join_copartitioned(lsh, rsh, li_keys, ri_keys,
                               config.join_type.value, alg)


# ---------------------------------------------------------------------------
# multiway (star) join: probe the fact side against every dimension
# ---------------------------------------------------------------------------

def _multiway_edges(edges) -> list:
    """Normalize and validate the per-dimension edge specs.  Each edge is
    ``(how, alg, fact_on, dim_on, dense_key_range, broadcast_threshold,
    rename)``: the join kind ("inner" / "left": the fact must be the
    preserved side), the algorithm, the key names on the running
    intermediate and on the dimension, the optional dense-FK hint, the
    optional per-edge threshold, and the ``(old, new)`` column renames
    applied to the probe's output."""
    out = []
    for e in edges:
        how, alg, fact_on, dim_on, dkr, thr, ren = e
        if how not in ("inner", "left"):
            raise CylonError(Status(Code.Invalid,
                f"dist_multiway_join: edge kind {how!r} unsupported — "
                "the fact side must be preserved (INNER, or LEFT with "
                "the fact on the left)"))
        if len(tuple(fact_on)) != len(tuple(dim_on)):
            raise CylonError(Status(Code.Invalid,
                "dist_multiway_join: edge key arity mismatch "
                f"{tuple(fact_on)} vs {tuple(dim_on)}"))
        out.append((how, alg, tuple(fact_on), tuple(dim_on),
                    None if dkr is None else (int(dkr[0]), int(dkr[1])),
                    thr, tuple((o, n) for o, n in ren)))
    return out


def _multiway_threshold(current: DTable, explicit, world: int) -> int:
    """Per-probe broadcast threshold: the edge's (or the process-wide)
    threshold raised to the re-exchange crossover ``I / (P − 1)``.
    Replicating a dimension of R rows moves R·(P−1) rows; co-partitioning
    moves the running intermediate (about I rows) again, so replication
    pays while R < I / (P − 1).  ``I`` comes from ingest-cached counts
    when the intermediate carries them, else the ``P·cap`` bound (no
    device read).  ``rows_if_small``'s memory budget keeps the last word.
    An explicit 0 (or a disabled knob) never broadcasts."""
    base = broadcast_join_threshold() if explicit is None else int(explicit)
    if base <= 0 or world <= 1:
        return base
    ch = current._counts_host
    if ch is not None and current.pending_mask is None:
        bound = int(np.asarray(ch).sum())
    else:
        bound = current.nparts * current.cap
    return max(base, bound // max(world - 1, 1))


def _multiway_rename(dt: DTable, ren) -> DTable:
    if not ren:
        return dt
    m = dict(ren)
    return dt.rename([m.get(n, n) for n in dt.column_names])


@plan_check.instrument
def dist_multiway_join(fact: DTable, dims: Sequence[DTable],
                       edges: Sequence) -> DTable:
    """Star join: probe ``fact`` against every dimension in turn
    (partition-once / probe-N), each probe a ``dist_join`` under the
    edge's effective broadcast threshold (``_multiway_threshold``), so a
    dimension under the re-exchange crossover is replicated and the
    running intermediate does not move.  Edges: see ``_multiway_edges``.
    Each probe's label ("broadcast", "broadcast-fact", "shuffle", or
    "local" at world 1) is counted in ``decisions`` as
    ``multiway.<label>``.  The labels and thresholds read global counts,
    so every process of a multi-process world probes alike."""
    edges = _multiway_edges(edges)
    if not edges or len(edges) != len(dims):
        raise CylonError(Status(Code.Invalid,
            f"dist_multiway_join: {len(dims)} dimension table(s) for "
            f"{len(edges)} edge spec(s)"))
    node = plan_check.note("dist_multiway_join", fact, *dims,
                           probes=len(edges))
    trace.count("join.multiway")
    world = fact.ctx.get_world_size()
    current = fact
    labels = []
    for dim, (how, alg, fact_on, dim_on, dkr, thr, ren) in zip(dims, edges):
        trace.count("join.multiway_probes")
        eff = _multiway_threshold(current, thr, world)
        if world > 1:
            # advisory label in the probe's strategy order (quiet: the
            # probe itself re-checks, veto annotation included)
            if broadcast.rows_if_small(dim, eff, quiet=True) is not None:
                label = "broadcast"
            elif how == "inner" and dkr is None \
                    and broadcast.rows_if_small(current, eff,
                                                quiet=True) is not None:
                label = "broadcast-fact"
            else:
                label = "shuffle"
            trace.count("join.multiway_dims_shuffled" if label == "shuffle"
                        else "join.multiway_dims_broadcast")
        else:
            label = "local"
        labels.append(label)
        decisions[f"multiway.{label}"] += 1
        cfg = JoinConfig(JoinType(how), JoinAlgorithm(alg),
                         fact_on[0] if len(fact_on) == 1 else fact_on,
                         dim_on[0] if len(dim_on) == 1 else dim_on,
                         broadcast_threshold=eff)
        current = _multiway_rename(dist_join(current, dim, cfg, dkr), ren)
    plan_check.annotate(node, dims="/".join(labels))
    return current


# ---------------------------------------------------------------------------
# distributed set ops (reference: DoDistributedSetOperation,
# table_api.cpp:904-975 — shuffle BOTH tables hashing on ALL columns)
# ---------------------------------------------------------------------------

def _setop_shard(a_leaves, b_leaves, a_cnt, b_cnt, cap_a: int, cap_b: int,
                 op: str, has_validity: Sequence[bool]):
    """One shard's set op over its padded A and B blocks: the per-shard
    kernel of the JAX package's ``_setop_fn``."""
    dev = a_cnt.device
    cols, vals = [], []
    for (ad, av), (bd, bv), has_v in zip(a_leaves, b_leaves, has_validity):
        cols.append(torch.cat([ad, bd]))
        if has_v:
            va = av if av is not None else torch.ones(cap_a, dtype=torch.bool,
                                                      device=dev)
            vb = bv if bv is not None else torch.ones(cap_b, dtype=torch.bool,
                                                      device=dev)
            vals.append(torch.cat([va, vb]))
        else:
            vals.append(None)
    valid_rows = torch.cat([torch.arange(cap_a, device=dev) < a_cnt,
                            torch.arange(cap_b, device=dev) < b_cnt])
    idx, count = ops_setops.set_op_indices(cols, vals, cap_a, op,
                                           valid=valid_rows)
    return ops_gather.take_many(list(zip(cols, vals)), idx,
                                fill_null=False), count


def _dist_set_op(a: DTable, b: DTable, op: str) -> DTable:
    plan_check.note(f"dist_{op.lower()}", a, b,
                    decision="shuffle" if a.ctx.get_world_size() > 1
                    else "local")
    a._collapse_pending()
    b._collapse_pending()
    a.verify_same_schema(b)
    a, b = _unify_dtable_dicts(a, b, range(a.num_columns),
                               range(b.num_columns))
    if a.ctx.get_world_size() == 1:
        ash, bsh = a, b
    else:
        with trace.span("setop.shuffle"):
            ash = _shuffle_by_pids(a, _hash_pids(a, range(a.num_columns)))
            bsh = _shuffle_by_pids(b, _hash_pids(b, range(b.num_columns)))
    has_validity = [ca.validity is not None or cb.validity is not None
                    for ca, cb in zip(ash.columns, bsh.columns)]
    L = a.nlocal
    outs, counts = [], []
    with trace.span_sync("setop.local") as sp:
        for s in range(L):
            got, cnt = _setop_shard(
                [(_shard(c.data, s, ash.cap), _shard(c.validity, s, ash.cap))
                 for c in ash.columns],
                [(_shard(c.data, s, bsh.cap), _shard(c.validity, s, bsh.cap))
                 for c in bsh.columns],
                ash.counts[s], bsh.counts[s], ash.cap, bsh.cap, op,
                has_validity)
            outs.append(got)
            counts.append(cnt)
        sp.sync(outs)
    capacity = ash.cap + bsh.cap if op == ops_setops.UNION else ash.cap
    cols = [DColumn(c.name, c.dtype, *_stacked(outs, k), c.dictionary,
                    c.arrow_type)
            for k, c in enumerate(ash.columns)]
    return DTable(a.ctx, cols, capacity, torch.stack(counts))


@plan_check.instrument
def dist_union(a: DTable, b: DTable) -> DTable:
    return _dist_set_op(a, b, ops_setops.UNION)


@plan_check.instrument
def dist_intersect(a: DTable, b: DTable) -> DTable:
    return _dist_set_op(a, b, ops_setops.INTERSECT)


@plan_check.instrument
def dist_subtract(a: DTable, b: DTable) -> DTable:
    return _dist_set_op(a, b, ops_setops.SUBTRACT)


# ---------------------------------------------------------------------------
# distributed sample-sort (absent in reference v0)
# ---------------------------------------------------------------------------

def _sample(dt: DTable, key_i: int, nsamples: int, ascending: bool):
    """Per shard: ``nsamples`` evenly spaced order statistics of the
    non-null valid rows, and a per-sample validity flag; ``[L, nsamples]``
    each.  The JAX package's ``_sample_fn`` rule, unchanged:
    ``q = arange(ns)·max(nn, 1) // ns`` and ``ok = arange(ns) < nn``, where
    ``nn`` counts the shard's non-null valid rows.

    Only the sampled values matter, so the block is not lexsorted on
    (padding, null, key) as in the JAX package: two stable sorts of all
    shards at once, by key and then by "not a sampled row", put each
    shard's non-null valid rows first in the same order.
    """
    L, cap = dt.nlocal, dt.cap
    c = dt.columns[key_i]
    rows = _row_mask(dt)
    if c.validity is not None:
        rows = rows & c.validity
    rows = rows.view(L, cap)
    nn = rows.sum(1)                                                   # [L]
    key = ops_join._ordered(c.data if ascending else ops_sort._invert(c.data))
    order = torch.sort(key.view(L, cap), dim=1, stable=True).indices
    rest = (~rows).gather(1, order).to(torch.uint8)
    order = order.gather(1, torch.sort(rest, dim=1, stable=True).indices)
    ar = torch.arange(nsamples, device=nn.device)
    q = (ar[None, :] * torch.clamp(nn, min=1)[:, None]) // nsamples
    pick = order.gather(1, q.clamp(0, cap - 1))
    data = ops_gather.signed_view(c.data).view(L, cap)
    vals = data.gather(1, pick).view(c.data.dtype)
    return vals, ar[None, :] < nn[:, None]


def _pool_splitters(vals, oks, nparts: int, ascending: bool) -> torch.Tensor:
    """Pool every side's all-gathered samples, sort the pool (invalid
    samples last) and pick the P−1 evenly spaced pivots
    ``(arange(1, P)·m) // P`` among the ``m`` valid samples.  With no valid
    sample the pivots are the dtype's extreme, so every non-null row goes
    to one end (the JAX package's rule)."""
    pv = torch.cat([v.reshape(-1) for v in vals])
    po = torch.cat([o.reshape(-1) for o in oks])
    key = pv if ascending else ops_sort._invert(pv)
    sv = ops_gather.signed_view(pv)[ops_join.lexsort([~po, key])]
    m = po.sum()
    ar = torch.arange(1, nparts, device=pv.device)
    pos = torch.clamp((ar * m) // nparts, 0, pv.shape[0] - 1)
    extreme = torch.full((), extreme_value(pv.dtype, largest=ascending),
                         dtype=pv.dtype, device=pv.device)
    return torch.where(m > 0, sv[pos], ops_gather.signed_view(extreme)
                       ).view(pv.dtype)


def _sample_splitters(sides: Sequence[Tuple[DTable, int]], ascending: bool
                      ) -> torch.Tensor:
    """Pool per-shard samples from every (table, key column) side and pick
    P−1 splitters: the sample-sort pivot selection, on the device."""
    ctx = sides[0][0].ctx
    comm = ctx.comm
    vals, oks = [], []
    for dt, key_i in sides:
        v, o = _sample(dt, key_i, _SAMPLES_PER_SHARD, ascending)
        vals.append(comm.all_gather(v))
        oks.append(comm.all_gather(o))
    return _pool_splitters(vals, oks, ctx.get_world_size(), ascending)


_FLOAT_BITS = {torch.float16: torch.int16, torch.float32: torch.int32,
               torch.float64: torch.int64}


def _total_order(x: torch.Tensor) -> torch.Tensor:
    """An integer key that orders ``x`` as ``lax.sort`` and
    ``jnp.searchsorted`` do: −0.0 equals 0.0 and every NaN is above +inf.
    (``torch.searchsorted`` orders NaN otherwise, so it may not see
    float keys.)  Integer and bool keys map through ``join._ordered``."""
    bits = _FLOAT_BITS.get(x.dtype)
    if bits is None:
        return ops_join._ordered(x)
    b = x.view(bits).to(torch.int64)
    # negative floats: flip the magnitude bits so that larger magnitudes
    # order lower; the sign bit keeps them below every positive float
    b = torch.where(b < 0, b ^ torch.iinfo(bits).max, b)
    b = torch.where(x == 0, 0, b)
    return torch.where(torch.isnan(x), torch.iinfo(torch.int64).max, b)


def _range_pids(dt: DTable, key_i: int, splitters: torch.Tensor,
                ascending: bool) -> torch.Tensor:
    """Target shard per row by range over ``splitters`` (P−1 values of the
    key's dtype): ascending, the count of splitters ≤ the value (``searchsorted(side="right")``, NaN largest); descending,
    the count of splitters > the value (an IEEE compare, so a NaN row goes
    to shard 0, as in the JAX package).  Null rows go to the last shard,
    padding rows to P (dropped)."""
    c = dt.columns[key_i]
    nparts = dt.ctx.get_world_size()
    if ascending:
        pid = torch.searchsorted(_total_order(splitters).contiguous(),
                                 _total_order(c.data), right=True)
    else:
        col, spk = ops_join._ordered(c.data), ops_join._ordered(splitters)
        pid = torch.zeros(col.shape, dtype=torch.int64, device=col.device)
        for j in range(spk.shape[0]):
            pid += spk[j] > col
    pid = pid.to(torch.int32)
    if c.validity is not None:
        pid = torch.where(c.validity, pid, nparts - 1)  # nulls last
    return torch.where(_row_mask(dt), pid, nparts).to(torch.int32)


def _sort_shards(sh: DTable, key_ids: Sequence[int],
                 ascending: Sequence[bool]) -> DTable:
    """Per shard, a masked multi-key sort of the block, then one gather
    of every column: the JAX package's ``_local_sort_fn`` /
    ``_local_sort_multi_fn`` (one key orders the same either way)."""
    L, cap = sh.nlocal, sh.cap
    keys = [sh.columns[i] for i in key_ids]
    outs = []
    with trace.span_sync("sort.local") as sp:
        for s in range(L):
            order = ops_sort.lexsort_indices_masked(
                [_shard(c.data, s, cap) for c in keys],
                [_shard(c.validity, s, cap) for c in keys], sh.counts[s],
                ascending)
            outs.append(ops_gather.take_many(
                [(_shard(c.data, s, cap), _shard(c.validity, s, cap))
                 for c in sh.columns], order, fill_null=False))
        sp.sync(outs)
    cols = [DColumn(c.name, c.dtype, *_stacked(outs, k), c.dictionary,
                    c.arrow_type)
            for k, c in enumerate(sh.columns)]
    out = DTable(sh.ctx, cols, cap, sh.counts)
    out._counts_host = sh._counts_host  # same rows per shard
    return out


def _range_shuffle(dt: DTable, key_i: int, ascending: bool) -> DTable:
    if dt.ctx.get_world_size() == 1:
        return dt  # one shard: a local sort is already globally ordered
    with trace.span("sort.sample"):
        splitters = _sample_splitters([(dt, key_i)], ascending)
    with trace.span("sort.shuffle"):
        return _shuffle_by_pids(dt, _range_pids(dt, key_i, splitters,
                                                ascending))


@plan_check.instrument
def dist_sort_multi(dt: DTable, sort_columns: Sequence[Union[int, str]],
                    ascending=True) -> DTable:
    """Distributed multi-key ORDER BY: range-partition on the PRIMARY
    column (equal primary values co-locate, so cross-shard lexicographic
    order holds), then a per-shard masked lexsort over all keys.
    ``ascending``: one bool or a per-column sequence."""
    plan_check.note("dist_sort_multi", dt, keys=tuple(sort_columns),
                    decision="shuffle" if dt.ctx.get_world_size() > 1
                    else "local")
    dt._collapse_pending()
    key_ids = _resolve_ids(dt, sort_columns)
    asc = ([ascending] * len(key_ids) if isinstance(ascending, bool)
           else [bool(a) for a in ascending])
    return _sort_shards(_range_shuffle(dt, key_ids[0], asc[0]), key_ids, asc)


@plan_check.instrument
def dist_sort(dt: DTable, sort_column: Union[int, str],
              ascending: bool = True) -> DTable:
    """Distributed sample-sort: sample splitters → range-partition shuffle →
    local sort per shard.  Shard *i*'s rows all precede shard *i+1*'s in the
    requested order, and rows within a shard are sorted (nulls last
    globally), so concatenating shards in order is the sorted table.
    """
    plan_check.note("dist_sort", dt, key=sort_column,
                    decision="shuffle" if dt.ctx.get_world_size() > 1
                    else "local")
    dt._collapse_pending()
    key_i = dt.column_index(sort_column)
    return _sort_shards(_range_shuffle(dt, key_i, ascending), [key_i],
                        [bool(ascending)])


@plan_check.instrument
def dist_head(dt: DTable, n: int) -> Table:
    """First ``n`` global rows (shard-major order) as a local Table — the
    small-result gather after a dist_sort (ORDER BY … LIMIT n)."""
    plan_check.note("dist_head", dt, n=n)
    return dt.head(n)


# ---------------------------------------------------------------------------
# row filters: predicates with SQL null semantics, select / project /
# with_column (reference: table_api.cpp:977-1029)
# ---------------------------------------------------------------------------

class _RecordingEnv(dict):
    """Column-name → data-tensor env that records which columns the
    predicate reads, so nulls in exactly those columns veto the row (SQL
    three-valued logic for conjunctions: a NULL comparand makes the row
    non-TRUE).  A predicate that must keep rows whose column is NULL (a
    disjunction, an IS NULL test) reads ``env.valid(name)`` and combines
    it itself; doing so waives the automatic veto for that column."""

    def __init__(self, items, validities):
        super().__init__(items)
        self._validities = validities
        self.accessed = set()
        self.null_handled = set()

    def __getitem__(self, k):
        self.accessed.add(k)
        return super().__getitem__(k)

    # every other read path records too, so no spelling of a predicate
    # bypasses the null veto
    def get(self, k, default=None):
        if k in self:
            return self[k]
        return default

    def items(self):
        self.accessed.update(self.keys())
        return [(k, super(_RecordingEnv, self).__getitem__(k))
                for k in self.keys()]

    def values(self):
        self.accessed.update(self.keys())
        return [super(_RecordingEnv, self).__getitem__(k)
                for k in self.keys()]

    def valid(self, k):
        """Per-row validity of column ``k`` (all True without nulls).
        Reading it hands NULL handling for ``k`` to the predicate."""
        self.null_handled.add(k)
        v = self._validities[k]
        data = super().__getitem__(k)
        return (torch.ones(data.shape[0], dtype=torch.bool,
                           device=data.device) if v is None else v)


def _env(columns: Sequence[DColumn]) -> dict:
    return {c.name: c.data for c in columns}


def _masked_predicate(names, predicate, base_mask, leaves, params=()):
    """The one definition of predicate semantics: the recording env's
    null veto, AND'ed with ``base_mask``.  ``params`` are extra device
    tensors handed to the predicate after the env (a threshold computed on
    the device needs no host read).  The predicate sees the flat
    ``[P*cap]`` columns and must be elementwise."""
    env = _RecordingEnv({n: d for n, (d, _) in zip(names, leaves)},
                        {n: v for n, (_, v) in zip(names, leaves)})
    mask = predicate(env, *params) & base_mask
    for n, (_, v) in zip(names, leaves):
        if n in env.accessed - env.null_handled and v is not None:
            mask = mask & v
    return mask


def _leaves(dt: DTable):
    return tuple((c.data, c.validity) for c in dt.columns)


def _predicate_mask(dt: DTable, predicate) -> torch.Tensor:
    """Row mask [P*cap] of ``predicate``, AND'ed with the valid rows (or
    the table's deferred-select mask)."""
    base = _row_mask(dt) if dt.pending_mask is None else dt.pending_mask
    return _masked_predicate(tuple(c.name for c in dt.columns), predicate,
                             base, _leaves(dt))


def _effective_mask(dt: DTable, where):
    """The row filter a mask-aware consumer applies: ``where`` AND the
    deferred-select mask; None when neither exists."""
    if where is not None:
        return _predicate_mask(dt, where)  # folds the pending mask itself
    return dt.pending_mask


def _shard_counts(dt: DTable, mask: torch.Tensor) -> torch.Tensor:
    """Per-shard True counts of a [L*cap] mask, gathered to every rank."""
    L = dt.nlocal
    return dt.ctx.comm.all_gather(
        mask.reshape(L, dt.cap).sum(1).to(torch.int32))


def _compact_survivors(dt: DTable, mask: torch.Tensor, cnts: torch.Tensor,
                       hint_key, span_name: str = "select.gather",
                       post=None) -> DTable:
    """Shared tail of the row filters (select, semi / anti join, the FK
    join's inner compaction, a deferred select's collapse): compact the
    rows ``mask`` keeps into a block bucketed to the largest per-shard
    survivor count, through the optimistic count protocol
    (``_select_cap_hints`` under ``hint_key``), under the span
    ``span_name``.  ``cnts`` is the all-gathered per-shard survivor count
    tensor; a custom ``post`` may validate extra per-shard fields riding
    it (the dense semi-join's overflow, the FK join's contract)."""
    cap = dt.cap

    def dispatch(sizes):
        outcap = sizes[0]
        outs, counts = [], []
        for s in range(dt.nlocal):
            idx, count = ops_compact.mask_to_indices(_shard(mask, s, cap),
                                                     outcap)
            outs.append(ops_gather.take_many(
                [(_shard(c.data, s, cap), _shard(c.validity, s, cap))
                 for c in dt.columns], idx, fill_null=False))
            counts.append(count)
        return outs, counts

    with trace.span_sync(span_name) as sp:
        (outs, counts), used, _ = ops_compact.optimistic_dispatch(
            _bounded(_select_cap_hints), hint_key, dispatch, cnts,
            post or _size_class)
        outcap = used[0]
        sp.sync(outs)
    cols = [DColumn(c.name, c.dtype, *_stacked(outs, k), c.dictionary,
                    c.arrow_type)
            for k, c in enumerate(dt.columns)]
    return DTable(dt.ctx, cols, outcap, torch.stack(counts))


@plan_check.instrument
def dist_select(dt: DTable, predicate, params=(), compact: bool = True
                ) -> DTable:
    """Distributed row filter: ``predicate(env, *params)`` maps {column
    name: data tensor} → bool mask, with SQL null semantics
    (``_RecordingEnv``).  Survivors compact into a block bucketed to the
    largest per-shard survivor count.  ``params`` are device tensors
    (e.g. a ``dist_aggregate`` result), so a data-dependent threshold
    needs no host read.

    ``compact=False`` defers the compaction: the result keeps the input
    blocks and carries the row mask (``DTable.pending_mask``); groupby,
    aggregate and further selects fold it, every other operator compacts
    on first touch."""
    plan_check.note("dist_select", dt, deferred=(not compact) or None)
    base = dt.pending_mask if dt.pending_mask is not None else _row_mask(dt)
    mask = _masked_predicate(tuple(c.name for c in dt.columns), predicate,
                             base, _leaves(dt), tuple(params))
    cnts = _shard_counts(dt, mask)
    if not compact:
        return DTable(dt.ctx, dt.columns, dt.cap, dt.counts,
                      pending_mask=mask, pending_cnts=cnts)
    names = tuple(c.name for c in dt.columns)
    return _compact_survivors(
        dt, mask, cnts, ("sel", str(dt.ctx.device), dt.cap, names, predicate),
        "select.gather")


@plan_check.instrument
def dist_project(dt: DTable, columns: Sequence[Union[int, str]]) -> DTable:
    """Column subset, zero-copy (reference table_api.cpp:1007-1029).  A
    deferred-select mask rides along."""
    plan_check.note("dist_project", dt, keep=len(columns))
    ids = _resolve_ids(dt, columns)
    out = DTable(dt.ctx, [dt.columns[i] for i in ids], dt.cap, dt.counts,
                 dt.pending_mask, dt.pending_cnts)
    out._counts_host = dt._counts_host  # same rows
    return out


@plan_check.instrument
def dist_with_column(dt: DTable, name: str, fn, out_type,
                     validity_from: Sequence[str] = ()) -> DTable:
    """Append a derived column ``name = fn({col name: data tensor})``,
    stored as ``out_type``'s device dtype.  Elementwise over the flat
    blocks.  ``validity_from`` names input columns whose nulls null the
    output.  A deferred-select mask rides along (the derived column holds
    garbage on masked-out rows, which stay masked)."""
    plan_check.note("dist_with_column", dt, name=name)
    out = fn(_env(dt.columns)).to(device_dtype(out_type))
    validity = None
    for n in validity_from:
        v = dt.column(n).validity
        if v is not None:
            validity = v if validity is None else (validity & v)
    cols = list(dt.columns) + [DColumn(name, DataType(out_type), out,
                                       validity)]
    return DTable(dt.ctx, cols, dt.cap, dt.counts, dt.pending_mask,
                  dt.pending_cnts)


# ---------------------------------------------------------------------------
# semi / anti joins (SQL EXISTS / NOT EXISTS; the reference spells them as
# join + dedup, table_api.cpp has no such operator)
# ---------------------------------------------------------------------------

def _semi_mask_dense(left: DTable, right: DTable, lkc: DColumn,
                     rkc: DColumn, lo: int, hi: int, anti: bool,
                     stride: int):
    """Dense-key semi/anti probe over all shards at once: presence bits
    over [lo, hi] per shard (ONE scatter of the right keys, writing only
    True) and ONE gather probe of the left keys; no sort.  Deferred-select
    masks fold into each side's valid rows.  Null == null as in the sort
    kernel: a null left key matches iff its shard's right side has a null
    key.  Returns (keep mask, per-shard [survivors, out-of-range keys of
    either side], all-gathered on the device)."""
    L = left.nlocal
    dev = lkc.data.device
    R = -(-(hi - lo + 1) // stride)
    cap_l, cap_r = left.cap, right.cap
    lvalid, l_nonnull = _valid_rows(left, lkc, left.pending_mask)
    rvalid, r_nonnull = _valid_rows(right, rkc, right.pending_mask)
    r_in = (rkc.data >= lo) & (rkc.data <= hi)
    l_in = (lkc.data >= lo) & (lkc.data <= hi)
    overflow = ((r_nonnull & ~r_in).view(L, cap_r).sum(1)
                + (l_nonnull & ~l_in).view(L, cap_l).sum(1))
    r_base = _dense_base(rkc.data, lo)
    l_base = _dense_base(lkc.data, lo)
    if stride > 1:
        r_base = torch.div(r_base, stride, rounding_mode="floor")
        l_base = torch.div(l_base, stride, rounding_mode="floor")
    slot = torch.where(r_nonnull & r_in,
                       _shard_ids(L, cap_r, dev) * R + r_base.long(), L * R)
    present = torch.zeros(L * R + 1, dtype=torch.bool, device=dev)
    # duplicates all write True: no race to lose
    present.index_fill_(0, slot, True)
    l_shard = _shard_ids(L, cap_l, dev)
    hit = l_nonnull & l_in & present[
        l_shard * R + torch.clamp(l_base, 0, R - 1).long()]
    if lkc.validity is not None or rkc.validity is not None:
        r_null = (rvalid & ~r_nonnull).view(L, cap_r).any(1)       # [L]
        hit = hit | ((lvalid & ~l_nonnull) & r_null[l_shard])
    keep = (lvalid & ~hit) if anti else hit
    stats = torch.stack([keep.view(L, cap_l).sum(1), overflow], 1)
    return keep, left.ctx.comm.all_gather(stats)


def _semi_mask_sorted(left: DTable, right: DTable, li_keys, ri_keys,
                      anti: bool):
    """Keep-mask of the sort-path semi/anti probe (``ops.join.semi_mask``
    per shard) and the per-shard survivor counts, all-gathered on the
    device."""
    L = left.nlocal
    lcap, rcap = left.cap, right.cap
    keeps = []
    for s in range(L):
        lc = left.counts[s]
        present = ops_join.semi_mask(
            tuple(_shard(left.columns[i].data, s, lcap) for i in li_keys),
            tuple(_shard(left.columns[i].validity, s, lcap) for i in li_keys),
            tuple(_shard(right.columns[i].data, s, rcap) for i in ri_keys),
            tuple(_shard(right.columns[i].validity, s, rcap)
                  for i in ri_keys),
            l_count=lc, r_count=right.counts[s])
        if anti:
            present = (torch.arange(lcap, device=lc.device) < lc) & ~present
        keeps.append(present)  # semi_mask is False on padding rows
    keep = torch.cat(keeps)
    return keep, _shard_counts(left, keep)


def _dist_semi_or_anti(left: DTable, right: DTable, left_on, right_on,
                       anti: bool, dense_key_range=None,
                       broadcast_threshold=None) -> DTable:
    node = plan_check.note("dist_anti_join" if anti else "dist_semi_join",
                           left, right,
                           dense=dense_key_range is not None or None)
    li_keys = _join_keys(left, left_on)
    ri_keys = _join_keys(right, right_on)
    if len(li_keys) != len(ri_keys):
        raise CylonError(Status(Code.Invalid,
            f"join key arity mismatch: {len(li_keys)} vs {len(ri_keys)}"))
    for li, ri in zip(li_keys, ri_keys):
        if left.columns[li].dtype.type != right.columns[ri].dtype.type:
            raise CylonError(Status(Code.TypeError,
                "semi-join key type mismatch "
                f"{left.columns[li].dtype.type.name} vs "
                f"{right.columns[ri].dtype.type.name}"))
    left, right = _unify_dtable_dicts(left, right, li_keys, ri_keys)
    # the probe reads only the right side's KEY columns: drop the rest
    # before any exchange
    right = dist_project(right, ri_keys)
    ri_keys = list(range(len(ri_keys)))
    world = left.ctx.get_world_size()
    # a small build side replicates its keys to every shard and the probe
    # runs against the unmoved left block (semi/anti emit left rows only,
    # so a replicated right is always sound)
    r_rows = (broadcast.rows_if_small(right, broadcast_threshold)
              if world > 1 else None)
    use_bcast = r_rows is not None
    if use_bcast:
        trace.count("join.broadcast")
        plan_check.annotate(
            node, decision="broadcast",
            reason=broadcast.small_side_reason(right, r_rows))
        right._collapse_pending()
        right = broadcast.replicate_table(right)
    elif world > 1:
        plan_check.annotate(node, decision="shuffle",
                            reason=_shuffle_reason(
                                node, "build-side keys not provably "
                                      "under the broadcast threshold"))
    else:
        plan_check.annotate(node, decision="local", reason="world=1")
    # presence bits cost R / stride bytes per shard: gate against the
    # larger side's capacity
    kc0 = left.columns[li_keys[0]]
    stride = 1 if (world == 1 or use_bcast) else world
    width = (int(dense_key_range[1]) - int(dense_key_range[0]) + 1
             if dense_key_range is not None else 0)
    use_dense = (dense_key_range is not None and len(li_keys) == 1
                 and _is_integer(kc0.data.dtype)
                 and not is_dictionary_encoded(kc0.dtype.type)
                 and 0 < width
                 and -(-width // stride) <= 4 * max(left.cap, right.cap))
    route = ("broadcast" if use_bcast else
             "shuffle" if world > 1 else "local")
    decisions[f"semi.{route}.{'dense' if use_dense else 'sort'}"] += 1
    if world > 1 and not use_bcast:
        trace.count("join.shuffle")
        # deferred-select masks fold into the routing (masked rows go to
        # the dropped partition)
        with trace.span("semijoin.shuffle"):
            if use_dense:
                lo0 = int(dense_key_range[0])
                left = _shuffle_masked(left, _mod_pids(left, li_keys[0],
                                                       lo0, world))
                right = _shuffle_masked(right, _mod_pids(right, ri_keys[0],
                                                         lo0, world))
            else:
                left = _shuffle_masked(left, _hash_pids(left, li_keys))
                right = _shuffle_masked(right, _hash_pids(right, ri_keys))
    dev = str(left.ctx.device)
    if use_dense:
        lo, hi = int(dense_key_range[0]), int(dense_key_range[1])
        hint_key = ("semid", dev, left.cap, right.cap, lo, hi, anti, stride,
                    left.pending_mask is not None,
                    right.pending_mask is not None)
        with trace.span("semijoin.mask"):
            mask, stats = _semi_mask_dense(
                left, right, left.columns[li_keys[0]],
                right.columns[ri_keys[0]], lo, hi, anti, stride)

        def post(per_shard):
            bad = int(per_shard[:, 1].sum())
            if bad > 0:
                raise CylonError(Status(Code.Invalid,
                    f"semi-join dense_key_range ({lo}, {hi}) violated: "
                    f"{bad} keys outside it"))
            return _size_class(per_shard[:, 0])

        return _compact_survivors(left, mask, stats, hint_key,
                                  "semijoin.gather", post=post)
    # the sort-path probe has no mask operand: compact a deferred select
    # first (world > 1 already folded it into the routing)
    left._collapse_pending()
    right._collapse_pending()
    with trace.span("semijoin.mask"):
        mask, cnts = _semi_mask_sorted(left, right, li_keys, ri_keys, anti)
    return _compact_survivors(
        left, mask, cnts,
        ("semi", dev, left.cap, right.cap, tuple(li_keys), anti),
        "semijoin.gather")


@plan_check.instrument
def dist_semi_join(left: DTable, right: DTable, left_on, right_on,
                   dense_key_range=None, broadcast_threshold=None) -> DTable:
    """Distributed LEFT SEMI join: the rows of ``left`` whose key has at
    least one match in ``right``, each emitted ONCE whatever the match
    multiplicity (SQL EXISTS / IN).  Output schema = left's schema.

    Co-partition both sides on the key hash, then the one-sort presence
    kernel (``ops.join.semi_mask``) and survivor compaction per shard.
    Null keys follow the join kernels (null == null).

    ``dense_key_range=(lo, hi)``: a single-integer-key hint switching the
    probe to presence bits over the range (one scatter + one gather
    instead of the merged sort), routed by ``(key − lo) mod P``; a key of
    either side outside the range raises.

    ``broadcast_threshold``: per-call override of the small-side row
    threshold (None → the process-wide knob, 0 → never broadcast); below
    it the right side's keys replicate to every shard and the left side
    does not move."""
    return _dist_semi_or_anti(left, right, left_on, right_on, anti=False,
                              dense_key_range=dense_key_range,
                              broadcast_threshold=broadcast_threshold)


@plan_check.instrument
def dist_anti_join(left: DTable, right: DTable, left_on, right_on,
                   dense_key_range=None, broadcast_threshold=None) -> DTable:
    """Distributed LEFT ANTI join: the rows of ``left`` whose key has NO
    match in ``right`` (SQL NOT EXISTS).  The complement of
    ``dist_semi_join`` over the valid left rows: a null left key equals a
    null right key, so with any null right key present the null-keyed left
    rows are dropped."""
    return _dist_semi_or_anti(left, right, left_on, right_on, anti=True,
                              dense_key_range=dense_key_range,
                              broadcast_threshold=broadcast_threshold)


# ---------------------------------------------------------------------------
# scalar aggregate (GROUP BY-less SELECT SUM(…))
# ---------------------------------------------------------------------------

def _is_integer(dtype: torch.dtype) -> bool:
    return not dtype.is_floating_point and not dtype.is_complex \
        and dtype != torch.bool


@plan_check.instrument
def dist_aggregate(dt: DTable,
                   aggregations: Sequence[Tuple[Union[int, str], str]],
                   where=None) -> Table:
    """Whole-table aggregate: a ONE-row local Table with columns
    ``{op}_{col}``.  Per shard a masked fold, then a sum (min, max) of
    the per-shard partials over the all-gathered values; no sort, no
    groups.  ``where`` follows ``dist_select``'s predicate protocol.
    Over zero rows, sum and count are 0 and min/max/mean are null."""
    plan_check.note("dist_aggregate", dt,
                    aggs=tuple(op for _, op in aggregations),
                    where=where is not None or None)
    with trace.span_sync("aggregate.scalar") as sp:
        cols = _aggregate_columns(dt, aggregations, where)
        sp.sync([c.data for c in cols])
    return Table(dt.ctx, cols)


def _aggregate_columns(dt: DTable, aggregations, where) -> List[Column]:
    """``dist_aggregate``'s one-row output columns."""
    comm = dt.ctx.comm
    L, cap = dt.nlocal, dt.cap
    pmask = _effective_mask(dt, where)
    base = pmask if pmask is not None else _row_mask(dt)
    cols = []
    for cref, op in aggregations:
        c = dt.columns[dt.column_index(cref)]
        d = c.data
        m = base if c.validity is None else (base & c.validity)
        cnt = comm.all_gather(m.reshape(L, cap).sum(1).to(torch.int32)).sum()
        if op in ("sum", "mean"):
            acc = d.to(torch.int64) if _is_integer(d.dtype) else d
            z = torch.where(m, acc, torch.zeros((), dtype=acc.dtype,
                                                device=acc.device))
            s = comm.all_gather(z.reshape(L, cap).sum(1)).sum()
        if op == "sum":
            val = s
        elif op == "count":
            val = cnt
        elif op == "mean":
            # a float column's mean divides in its own dtype, an integer
            # column's in float64 (the JAX package's promotion)
            fdt = d.dtype if d.dtype.is_floating_point else torch.float64
            val = s.to(fdt) / torch.clamp(cnt, min=1).to(fdt)
        elif op in ("min", "max"):
            fill = torch.full((), extreme_value(d.dtype,
                                                largest=(op == "min")),
                              dtype=d.dtype, device=d.device)
            folded = torch.where(m, ops_join._ordered(d),
                                 ops_join._ordered(fill)).reshape(L, cap)
            local = folded.amin(1) if op == "min" else folded.amax(1)
            g = comm.all_gather(local)
            val = ops_groupby._from_ordered(
                (g.amin() if op == "min" else g.amax()).reshape(1), d.dtype)
        else:
            raise ValueError(f"unknown aggregation {op!r}")
        t_out = _agg_output_type(c.dtype.type, op)
        validity = None if op in ("sum", "count") else (cnt > 0).reshape(1)
        cols.append(Column(f"{op}_{c.name}", DataType(t_out),
                           val.reshape(1).to(device_dtype(t_out)), validity))
    return cols


# ---------------------------------------------------------------------------
# distributed groupby-aggregate (BASELINE config 3; absent in reference v0)
# ---------------------------------------------------------------------------

def _leaf_pairs(dt: DTable, ids: Sequence[int], s: int):
    return [(_shard(dt.columns[i].data, s, dt.cap),
             _shard(dt.columns[i].validity, s, dt.cap)) for i in ids]


def _shard_rows(sh: DTable, pmask, s: int) -> torch.Tensor:
    """Rows of shard ``s`` the groupby reads: the folded filter mask, or
    the valid prefix."""
    if pmask is not None:
        return _shard(pmask, s, sh.cap)
    return torch.arange(sh.cap, device=sh.counts.device) < sh.counts[s]


def _groupby_output(dt: DTable, sh: DTable, key_ids, aggregations, outs,
                    counts, out_cap: int) -> DTable:
    """Per-shard ``[(key leaves…, agg leaves…)]`` → the output DTable:
    the key columns, then ``{op}_{col}`` per aggregation."""
    cols = [DColumn(sh.columns[i].name, sh.columns[i].dtype,
                    *_stacked(outs, k), sh.columns[i].dictionary,
                    sh.columns[i].arrow_type)
            for k, i in enumerate(key_ids)]
    K = len(key_ids)
    for j, (cref, op) in enumerate(aggregations):
        base = sh.columns[dt.column_index(cref)]
        cols.append(DColumn(f"{op}_{base.name}",
                            DataType(_agg_output_type(base.dtype.type, op)),
                            *_stacked(outs, K + j)))
    return DTable(dt.ctx, cols, out_cap, torch.stack(counts))


def _groupby_sorted(dt: DTable, sh: DTable, key_ids, uniq_ids, slot_map,
                    aggs, aggregations, pmask, where=None) -> DTable:
    """The sort path per shard: phase 1 sorts (values carried) and counts
    groups; phase 2 aggregates into one output block for all shards,
    sized from the all-gathered group counts through the optimistic
    count protocol (``_group_cap_hints``), and gathers the keys."""
    L = dt.nlocal
    phase1 = []
    with trace.span("groupby.count"):
        for s in range(L):
            kl = _leaf_pairs(sh, key_ids, s)
            vl = _leaf_pairs(sh, uniq_ids, s)
            st = ops_groupby.group_structure(
                tuple(d for d, _ in kl), tuple(v for _, v in kl),
                _shard_rows(sh, pmask, s),
                ops_groupby.carry_pack(tuple(d for d, _ in vl),
                                       tuple(v for _, v in vl)))
            phase1.append((st, kl, vl))
        ngs = dt.ctx.comm.all_gather(torch.stack(
            [ops_groupby.num_groups_of(st) for st, _, _ in phase1]))
    # key-column identity and the filter decide the group count, so they
    # belong in the hint key — two different groupbys sharing one hint
    # would mis-hint each other into redundant redispatches / replays
    hint_key = (str(dt.ctx.device), sh.cap, aggs, tuple(key_ids), where,
                pmask is not None)

    def dispatch(sizes):
        out_cap = sizes[0]
        outs, counts = [], []
        for st, kl, vl in phase1:
            ucols, uvals = ops_groupby.carry_unpack(st[3],
                                                    tuple(v for _, v in vl))
            vcols = tuple(ucols[j] for j in slot_map)
            vvals = tuple(uvals[j] for j in slot_map)
            key_idx, aouts, avals, ng = ops_groupby.groupby_aggregate(
                tuple(d for d, _ in kl), tuple(v for _, v in kl), vcols,
                vvals, aggs, structure=st, out_capacity=out_cap,
                sorted_values=(vcols, vvals))
            outs.append(ops_gather.take_many(kl, key_idx, fill_null=False)
                        + list(zip(aouts, avals)))
            counts.append(ng)
        return outs, counts

    with trace.span_sync("groupby.local") as sp:
        (outs, counts), used, _ = ops_compact.optimistic_dispatch(
            _bounded(_group_cap_hints), hint_key, dispatch, ngs,
            _size_class)
        out_cap = used[0]
        phase1.clear()
        sp.sync([o[len(key_ids):] for o in outs])  # the aggregates
    return _groupby_output(dt, sh, key_ids, aggregations, outs, counts,
                           out_cap)


def _mod_pids(dt: DTable, key_id: int, lo: int, nparts: int) -> torch.Tensor:
    """Modulo partitioner for dense integer keys: shard = (key − lo) mod P.
    Each shard then holds one residue class, so its dense slot space
    shrinks by P.  Nulls and keys below ``lo`` go to shard 0 (an
    out-of-range key fails in phase 1), padding rows to P."""
    kc = dt.columns[key_id]
    base = _dense_base(kc.data, lo)
    pid = torch.where(base >= 0, base % nparts, 0)
    if kc.validity is not None:
        pid = torch.where(kc.validity, pid, 0)
    return torch.where(_row_mask(dt), pid, nparts).to(torch.int32)


def _groupby_dense(dt: DTable, sh: DTable, key_id: int, uniq_ids, slot_map,
                   aggs, aggregations, dense, pmask,
                   emit_empty: bool, where=None) -> DTable:
    """The direct-address path (``dense_key_range``): phase 1 slots and
    slot counts per shard, plus each shard's [groups, out-of-range rows];
    phase 2 reduces per slot and rebuilds the keys, sized through the
    optimistic count protocol, whose validation also raises on a range
    violation."""
    lo, hi, stride = dense
    L = dt.nlocal
    r0 = dt.ctx.get_rank()
    kc = sh.columns[key_id]
    phase1, stats = [], []
    with trace.span("groupby.count"):
        for s in range(L):
            slot, counts, ng, ov = ops_groupby.dense_group_structure(
                _shard(kc.data, s, sh.cap), _shard(kc.validity, s, sh.cap),
                _shard_rows(sh, pmask, s), lo, hi, stride=stride)
            phase1.append((slot, counts))
            stats.append(torch.stack([ng, ov]))
        stats = dt.ctx.comm.all_gather(torch.stack(stats))
    hint_key = (str(dt.ctx.device), sh.cap, aggs,
                ("dense", key_id, lo, hi, stride), where, pmask is not None,
                emit_empty)
    hints = _bounded(_group_cap_hints)
    floor = None
    if emit_empty:
        # every slot of the range emits, occupied or not: the group count
        # is R/stride (+1 null) by construction, so the first dispatch
        # can be sized exactly
        floor = ops_compact.next_bucket(-(-(hi - lo + 1) // stride) + 1,
                                        minimum=8)
        if not is_abstract(stats):  # a plan run leaves the hints alone
            hints.setdefault(hint_key, ((floor,), 0))

    def dispatch(sizes):
        out_cap = sizes[0]
        outs, counts = [], []
        for s, (slot, cnts) in enumerate(phase1):
            vl = _leaf_pairs(sh, uniq_ids, s)
            kd, kv, aouts, avals, ng = ops_groupby.dense_groupby_aggregate(
                slot, cnts, tuple(vl[j][0] for j in slot_map),
                tuple(vl[j][1] for j in slot_map), aggs, out_cap, lo,
                kc.data.dtype, kc.validity is not None, stride=stride,
                phase=r0 + s if stride > 1 else 0, emit_empty=emit_empty,
                hi=hi)
            outs.append([(kd, kv)] + list(zip(aouts, avals)))
            counts.append(ng)
        return outs, counts

    def post(per_shard):
        bad = int(per_shard[:, 1].sum())
        if bad > 0:
            raise CylonError(Status(Code.Invalid,
                f"dense_key_range ({lo}, {hi}) violated: {bad} rows carry "
                "keys outside it"))
        need, = _size_class(per_shard[:, 0])
        if floor is not None:
            # emit_empty's capacity is STRUCTURAL (every slot emits),
            # while per_shard counts only the occupied groups: reporting
            # the occupancy would let the shrink-slow policy walk the
            # hint below the slot count, and an under-floor dispatch
            # truncates the emitted range silently
            need = max(need, floor)
        return (need,)

    with trace.span_sync("groupby.local") as sp:
        (outs, counts), used, _ = ops_compact.optimistic_dispatch(
            hints, hint_key, dispatch, stats, post)
        out_cap = used[0]
        phase1.clear()
        sp.sync([o[1:] for o in outs])  # the aggregates
    return _groupby_output(dt, sh, [key_id], aggregations, outs, counts,
                           out_cap)


@plan_check.instrument
def dist_groupby(dt: DTable, key_columns: Sequence[Union[int, str]],
                 aggregations: Sequence[Tuple[Union[int, str], str]],
                 where=None, dense_key_range=None, pre_aggregate=None,
                 emit_empty: bool = False,
                 _local_only: bool = False) -> DTable:
    """Distributed groupby-aggregate: equal keys meet on one shard (hash
    shuffle), then the local sort-and-segment kernel per shard.  Aggs:
    sum/count/mean/min/max.  Output columns: the keys, then
    ``{op}_{col}``; on each shard the groups in key order, the null-key
    group last; output blocks bucketed to the per-shard GROUP count.

    ``where``: a row predicate (``dist_select``'s protocol) pushed down:
    at world > 1 failing rows never enter the shuffle, locally they are
    masked out of the aggregation.

    ``dense_key_range=(lo, hi)``: a hint that the single integer,
    non-dictionary key lies in [lo, hi].  The groupby then runs direct
    address (slots, no sort) and routes rows by ``(key − lo) mod P``
    instead of the hash.  A key outside the range raises; the hint is
    ignored when the slot space would exceed 4× the shard capacity or the
    key does not qualify.  ``emit_empty=True`` (needs the dense path)
    emits every key of the range, zero-count keys included.

    ``pre_aggregate`` (default: on at world > 1 unless the dense range is
    wider than a shard): each shard aggregates its own rows first and only
    the partial groups move.  They combine by one all_gather onto shard 0
    when ``broadcast.rows_if_small`` proves them few, else by a hash
    shuffle of the partials."""
    node = None
    if not _local_only:
        node = plan_check.note("dist_groupby", dt, keys=tuple(key_columns),
                               aggs=tuple(op for _, op in aggregations),
                               dense=dense_key_range is not None or None,
                               where=where is not None or None)
    key_ids = _resolve_ids(dt, key_columns)
    val_ids = [dt.column_index(c) for c, _ in aggregations]
    # distinct value columns ride the sort ONCE; slot_map re-expands them
    uniq_ids = list(dict.fromkeys(val_ids))
    slot_map = tuple(uniq_ids.index(i) for i in val_ids)
    aggs = tuple(op for _, op in aggregations)
    for op in aggs:
        if op not in ops_groupby.AGG_OPS:
            raise CylonError(Status(Code.Invalid,
                                    f"unknown aggregation {op!r}"))
    world = dt.ctx.get_world_size()
    dense = None
    if dense_key_range is not None and len(key_ids) == 1:
        kc0 = dt.columns[key_ids[0]]
        lo, hi = int(dense_key_range[0]), int(dense_key_range[1])
        stride = 1 if (world == 1 or _local_only) else world
        if (_is_integer(kc0.data.dtype)
                and not is_dictionary_encoded(kc0.dtype.type)
                and 0 < hi - lo + 1
                and -(-(hi - lo + 1) // stride) <= 4 * dt.cap):
            dense = (lo, hi, stride)
    if emit_empty and dense is None:
        raise CylonError(Status(Code.Invalid,
            "emit_empty requires an engaged dense_key_range (integer "
            "non-dictionary single key, slot space within 4x capacity) — "
            "the zero-count groups only exist on the direct-address path"))
    near_unique = False
    explicit = pre_aggregate is not None
    if pre_aggregate is None:
        # a dense range wider than a shard means near-unique keys per
        # shard: the partial pass could not shrink the exchange
        near_unique = (dense_key_range is not None and len(key_ids) == 1
                       and (int(dense_key_range[1])
                            - int(dense_key_range[0]) + 1) > dt.cap)
        pre_aggregate = world > 1 and not _local_only and not near_unique
    if node is not None:
        decision, reason = _groupby_decision(
            world, pre_aggregate, explicit, dense, near_unique,
            dense_key_range, dt.cap)
        plan_check.annotate(node, decision=decision, reason=reason)
    if world > 1 and pre_aggregate and not _local_only:
        return _dist_groupby_preagg(dt, key_ids, aggregations, where,
                                    dense_key_range, emit_empty)
    pmask = _effective_mask(dt, where)
    if world == 1 or _local_only:
        sh = dt
    else:
        with trace.span("groupby.shuffle"):
            if dense is not None:
                pid = _mod_pids(dt, key_ids[0], dense[0], world)
            else:
                pid = _hash_pids(dt, key_ids)
            if pmask is not None:
                # filter pushdown: failing rows never enter the exchange
                pid = torch.where(pmask, pid, world)
                pmask = None
            sh = _shuffle_by_pids(_cleared(dt), pid, owner="groupby")
    if dense is not None:
        return _groupby_dense(dt, sh, key_ids[0], uniq_ids, slot_map, aggs,
                              aggregations, dense, pmask, emit_empty, where)
    return _groupby_sorted(dt, sh, key_ids, uniq_ids, slot_map, aggs,
                           aggregations, pmask, where)


def _groupby_decision(world: int, pre_aggregate: bool, explicit: bool,
                      dense, near_unique: bool, dense_key_range,
                      cap: int) -> Tuple[str, str]:
    """``dist_groupby``'s plan annotation: the path it takes and why."""
    if world > 1 and pre_aggregate:
        return "pre-aggregate", (
            "explicit pre_aggregate=True" if explicit else
            "decomposable aggs: per-shard partials replace rows on the wire")
    if world == 1:
        return ("dense-local" if dense is not None else "local",
                "world=1: every group is already local")
    if near_unique:
        width = int(dense_key_range[1]) - int(dense_key_range[0]) + 1
        reason = (f"near_unique-skip: dense key range {width} > shard "
                  f"capacity {cap} — the partial pass could not shrink "
                  "the exchange")
    else:
        reason = "explicit pre_aggregate=False"
    return "dense+shuffle" if dense is not None else "shuffle", reason


# partial op → the aggregation that combines two partials of it
_COMBINE_OP = {"sum": "sum", "count": "sum", "min": "min", "max": "max"}


def _decompose_aggs(dt: DTable, aggregations):
    """Two-level decomposition: one partial per distinct (column, partial
    op) — mean → sum + count, count → sum of counts, min/max idempotent —
    plus each output's recomposition plan ``(op, partial ref[, count
    ref])``."""
    partial: List[Tuple[int, str]] = []
    ppos: dict = {}

    def _p(ci: int, op: str) -> int:
        if (ci, op) not in ppos:
            ppos[(ci, op)] = len(partial)
            partial.append((ci, op))
        return ppos[(ci, op)]

    plan = []
    for cref, op in aggregations:
        ci = dt.column_index(cref)
        if op == "mean":
            plan.append((op, _p(ci, "sum"), _p(ci, "count")))
        elif op == "count":
            plan.append((op, _p(ci, "count")))
        else:
            plan.append((op, _p(ci, op)))
    return partial, plan


def _recompose_partials(base_meta, plan, comb: DTable, K: int) -> DTable:
    """Final columns from the combined partials: mean = Σsum / Σcount,
    everything else forwards its combined partial (partial j is column
    K + j of ``comb``).  ``base_meta``: per output ``(base column name,
    base DataType, op)`` (``_base_meta``)."""
    cols = list(comb.columns[:K])
    for (name, dtype, op), spec in zip(base_meta, plan):
        t_out = DataType(_agg_output_type(dtype.type, op))
        if op == "mean":
            s, c = comb.columns[K + spec[1]], comb.columns[K + spec[2]]
            data = (s.data.to(torch.float64)
                    / torch.clamp(c.data, min=1).to(torch.float64))
            cols.append(DColumn(f"{op}_{name}", t_out, data, c.data > 0))
        else:
            src = comb.columns[K + spec[1]]
            cols.append(DColumn(f"{op}_{name}", t_out, src.data,
                                src.validity))
    return DTable(comb.ctx, cols, comb.cap, comb.counts)


def _dist_groupby_preagg(dt: DTable, key_ids: List[int], aggregations,
                         where, dense_key_range,
                         emit_empty: bool = False) -> DTable:
    """Two-level aggregation: a local groupby per shard (no exchange), then
    the combining groupby of the partial groups (sum of sums, sum of
    counts, min of mins, max of maxes), then mean = Σsum / Σcount."""
    K = len(key_ids)
    partial, plan = _decompose_aggs(dt, aggregations)
    # emit_empty rides the local pass only: every key then reaches the
    # combine as at least one partial row
    part = dist_groupby(dt, key_ids, partial, where=where,
                        dense_key_range=dense_key_range, pre_aggregate=False,
                        _local_only=True, emit_empty=emit_empty)
    comb_aggs = [(K + j, _COMBINE_OP[op]) for j, (_, op) in enumerate(partial)]
    if broadcast.rows_if_small(part, None) is not None:
        # few partial groups: one all_gather in place of the shuffle;
        # shard 0 owns every partial row (HEAD) and combines them alone
        trace.count("groupby.broadcast_combine")
        part_rep = broadcast.replicate_table(
            part, mode=broadcast.HEAD, span_name="groupby.broadcast_gather",
            cache=False)
        comb = dist_groupby(part_rep, list(range(K)), comb_aggs,
                            dense_key_range=dense_key_range,
                            pre_aggregate=False, _local_only=True)
    else:
        comb = dist_groupby(part, list(range(K)), comb_aggs,
                            dense_key_range=dense_key_range,
                            pre_aggregate=False)
    _note_plain_state(dt, aggregations, partial, plan, comb, K,
                      dense_key_range)
    return _recompose_partials(_base_meta(dt, aggregations), plan, comb, K)


# ---------------------------------------------------------------------------
# aggregation-state capture and merge: every mergeable aggregation tail
# holds a combined partial-group table (plain partials) or a merged
# sketch-state table right before recomposition.  Under
# ``collect_agg_state()`` that state is handed to a thread-local sink at
# no extra device cost, so a materialized view can later fold an appended
# delta's state into it and re-finalize without reading the base table.
# ---------------------------------------------------------------------------

_matview_tls = threading.local()


class AggState:
    """One captured mergeable aggregation state.

    ``kind``       "plain" (sum / count / min / max partials; mean =
                   Σsum / Σcount) or "sketch" (HLL / bottom-k lanes).
    ``state``      the partial DTable: ``K`` key columns, then the partial
                   or sketch-lane columns, by position (the
                   ``_recompose_partials`` contract).
    ``base_meta``  per aggregation ``(base column name, base DataType,
                   op)``: what finalizing needs from the base table.
    """

    __slots__ = ("kind", "state", "K", "partial", "plan", "base_meta",
                 "dense_key_range", "kinds", "qs")

    def __init__(self, kind: str, state: DTable, K: int, *, partial=None,
                 plan=None, base_meta=None, dense_key_range=None,
                 kinds=None, qs=None) -> None:
        self.kind = kind
        self.state = state
        self.K = K
        self.partial = partial
        self.plan = plan
        self.base_meta = base_meta
        self.dense_key_range = dense_key_range
        self.kinds = kinds
        self.qs = qs


@contextmanager
def collect_agg_state():
    """Collect every mergeable aggregation state produced on THIS thread
    while the context is open (yields the sink list).  Nestable: the
    inner collector wins and restores the outer one on exit."""
    prev = getattr(_matview_tls, "sink", None)
    sink: List[AggState] = []
    _matview_tls.sink = sink
    try:
        yield sink
    finally:
        _matview_tls.sink = prev


def _base_meta(dt: DTable, aggregations):
    # metadata only: a spilled table answers without a fault-in
    return [(c.name, c.dtype, op) for c, op in
            ((dt._columns[dt.column_index(cref)], op)
             for cref, op in aggregations)]


def _note_plain_state(dt: DTable, aggregations, partial, plan, comb: DTable,
                      K: int, dense_key_range) -> None:
    sink = getattr(_matview_tls, "sink", None)
    if sink is None:
        return
    sink.append(AggState("plain", comb, K, partial=list(partial),
                         plan=list(plan),
                         base_meta=_base_meta(dt, aggregations),
                         dense_key_range=dense_key_range))


def _note_sketch_state(dt: DTable, aggregations, sh: DTable, K: int, kinds,
                       qs) -> None:
    sink = getattr(_matview_tls, "sink", None)
    if sink is None:
        return
    # the shuffled partial table co-locates each group's rows: one local
    # merge gives the one-row-per-group state
    sink.append(AggState("sketch", _sketch_merge_local(sh, K, kinds, qs), K,
                         base_meta=_base_meta(dt, aggregations),
                         kinds=tuple(kinds), qs=tuple(qs)))


def _shuffle_by_keys(dt: DTable, K: int, combine=None) -> DTable:
    """Hash-shuffle a partial table on its first ``K`` (key) columns
    (``combine``: its fold spec, see ``_shuffle_by_pids``)."""
    if dt.ctx.get_world_size() == 1:
        return dt  # one shard: every group is already home
    return _shuffle_by_pids(dt, _hash_pids(dt, list(range(K))),
                            owner="groupby", combine=combine)


def merge_agg_state(a: AggState, b: AggState) -> AggState:
    """Merge two captured states of the SAME aggregation (base ∪ delta):
    key dictionaries are unified first (an append may grow a dictionary),
    then plain partials re-combine through the combining groupby and
    sketch lanes through the sketch merge."""
    from .streaming import _concat_compact
    K = a.K
    sa, sb = _unify_dtable_dicts(a.state, b.state, list(range(K)),
                                 list(range(K)))
    cc = _concat_compact([sa, sb])
    if a.kind == "sketch":
        merged = _sketch_merge_local(_shuffle_by_keys(cc, K), K, a.kinds,
                                     a.qs)
        return AggState("sketch", merged, K, base_meta=a.base_meta,
                        kinds=a.kinds, qs=a.qs)
    comb_aggs = [(K + j, _COMBINE_OP[op])
                 for j, (_, op) in enumerate(a.partial)]
    merged = dist_groupby(cc, list(range(K)), comb_aggs,
                          dense_key_range=a.dense_key_range,
                          pre_aggregate=False)
    return AggState("plain", merged, K, partial=a.partial, plan=a.plan,
                    base_meta=a.base_meta,
                    dense_key_range=a.dense_key_range)


def finalize_agg_state(st: AggState) -> DTable:
    """The result table of a (merged) captured state: local arithmetic
    for plain partials, a shuffle and the finalizing sketch combine for
    sketches.  Names and types come from ``base_meta``."""
    comb, K = st.state, st.K
    if st.kind == "plain":
        return _recompose_partials(st.base_meta, st.plan, comb, K)
    sh = _shuffle_by_keys(comb, K)
    keys_out, outs, counts = _sketch_combine(sh, K, st.kinds, st.qs, True)
    return _sketch_result(sh, sh.columns[:K], keys_out, st.base_meta, outs,
                          st.kinds, counts)


# ---------------------------------------------------------------------------
# the planner-lowered fused groupby: psum / partial exchange / shuffle
# ---------------------------------------------------------------------------

def _combine_leaf_spec(part: DTable, K: int, partial_ops) -> Tuple:
    """Leaf-layout combiner spec of a partial-group table: the wire leaf
    positions (data, then validity if any, per column, in
    ``_shuffle_by_pids`` order) of the key slots and of the value slots
    with their combine ops.  The chunked and hierarchical-combine
    exchange lowerings fold rounds by key with it; the single-shot
    exchange ignores it (the local combine downstream handles the
    concatenated partials)."""
    idx = 0
    key_slots, val_slots = [], []
    for i, c in enumerate(part.columns):
        d = idx
        idx += 1
        v = None
        if c.validity is not None:
            v = idx
            idx += 1
        if i < K:
            key_slots.append((d, v))
        else:
            val_slots.append((d, v, _COMBINE_OP[partial_ops[i - K]]))
    return (tuple(key_slots), tuple(val_slots))


# dense slot spaces up to this size combine as ONE all-reduce: the psum
# moves R slot-rows per rank whatever their occupancy, so a sparse domain
# must stay small to beat the partial exchange
_PSUM_SLOT_CAP = 4096


def _psum_combine(dt: DTable, key_ids, partial, lanes, domains, pmask,
                  out_cap: int):
    """The fused groupby over a dense composite key space: every shard
    scatter-adds its partial lanes into ``[R+1]`` slots (R real + 1
    dropped), ONE ``all_reduce`` combines the shards, and the present
    slots decode into an output block every shard holds identically
    (global rank 0 owns the rows).  ``domains``: ``(size, nullable)`` per
    key, ``size`` counting the null code ``size − 1``.  ``lanes``:
    "count", "isum" or "fsum" per partial, after the implicit lane 0 of
    rows per group.  Returns (key leaves, value lanes, counts [L]), over
    this process's L shards."""
    P, cap = dt.nlocal, dt.cap
    dev = dt.counts.device
    R = 1
    for size, _ in domains:
        R *= size
    row_valid = pmask if pmask is not None else _row_mask(dt)
    slot = torch.zeros(P * cap, dtype=torch.int64, device=dev)
    for i, (size, nullable) in zip(key_ids, domains):
        c = dt.columns[i]
        code = c.data.to(torch.int64)
        if nullable:
            code = torch.where(c.validity, code, size - 1)
        slot = slot * size + code
    slot = torch.where(row_valid, slot, R)
    # every row of a slot would add into the same few addresses, and the
    # card serializes atomics on one address: each slot gets B copies
    # (row mod B), summed back after the scatter.  B follows the WORLD's
    # shard count, so a world that spans processes sums in the same
    # groups as the single-process world
    B = max(1, min(1024, (1 << 22) // (dt.nparts * (R + 1))))
    flat = ((_shard_ids(P, cap, dev) * (R + 1) + slot) * B
            + torch.arange(P * cap, device=dev) % B)
    ilanes = [row_valid.to(torch.int64)]
    flanes = []
    where_lane = []   # per partial: (is_float, lane index)
    for (ci, _), kind in zip(partial, lanes):
        c = dt.columns[ci]
        vmask = row_valid if c.validity is None else (row_valid & c.validity)
        if kind == "count":
            where_lane.append((False, len(ilanes)))
            ilanes.append(vmask.to(torch.int64))
        elif kind == "isum":
            where_lane.append((False, len(ilanes)))
            ilanes.append(torch.where(vmask, c.data.to(torch.int64), 0))
        else:
            where_lane.append((True, len(flanes)))
            flanes.append(torch.where(vmask, c.data.to(torch.float64), 0.0))

    def combined(lanes_, dtype):
        pack = torch.zeros((P * (R + 1) * B, len(lanes_)), dtype=dtype,
                           device=dev)
        pack.index_add_(0, flat, torch.stack(lanes_, 1))
        return dt.ctx.comm.all_reduce(
            pack.view(P, R + 1, B, len(lanes_)).sum(2))[:R]

    itot = combined(ilanes, torch.int64)
    ftot = combined(flanes, torch.float64) if flanes else None
    present = itot[:, 0] > 0
    starts = ops_compact.compact_indices(present, out_cap, fill=-1)
    ngroups = torch.sum(present).to(torch.int32)
    safe = torch.clamp(starts, 0, R - 1).to(torch.int64)
    keys_out = []
    rem = safe
    for i, (size, nullable) in reversed(list(zip(key_ids, domains))):
        code = rem % size
        rem = rem // size
        valid = None
        if nullable:
            valid = code != size - 1
            code = torch.where(valid, code, 0)
        keys_out.append((code.to(dt.columns[i].data.dtype).repeat(P),
                         None if valid is None else valid.repeat(P)))
    keys_out.reverse()
    vals_out = [(ftot if is_f else itot)[:, j][safe].repeat(P)
                for is_f, j in where_lane]
    counts = torch.zeros(P, dtype=torch.int32, device=dev)
    if dt.ctx.get_rank() == 0:
        counts[0] = ngroups
    return keys_out, vals_out, counts


def _fused_psum_groupby(dt: DTable, key_ids: List[int], aggregations,
                        where, node=None, reason=None) -> Optional[DTable]:
    """The combine-in-the-collective arm of ``dist_groupby_fused`` if the
    table qualifies at execution time, else None: world > 1, every key
    dictionary-encoded with integer codes (structurally in range, so no
    host read), the composite domain within ``_PSUM_SLOT_CAP``, and every
    aggregation sum / count / mean (min and max have no sum all-reduce)."""
    if dt.ctx.get_world_size() <= 1:
        return None
    domains = []
    for i in key_ids:
        c = dt.columns[i]
        if (c.dictionary is None or len(c.dictionary) == 0
                or not _is_integer(c.data.dtype)):
            return None
        nullable = c.validity is not None
        domains.append((len(c.dictionary) + int(nullable), nullable))
    R = 1
    for size, _ in domains:
        R *= size
    if not 0 < R + 1 <= _PSUM_SLOT_CAP:
        return None
    if any(op not in ("sum", "count", "mean") for _, op in aggregations):
        return None
    partial, plan = _decompose_aggs(dt, aggregations)
    lanes = ["count" if op == "count" else
             "fsum" if dt.columns[ci].data.dtype.is_floating_point else
             "isum" for ci, op in partial]
    # wire accounting, as the JAX package prices it: the all_reduce
    # combines [R+1, lanes] packs (8-byte lanes plus the rows-per-group
    # lane) replicated to the other P − 1 shards (an abstract plan run
    # moves zero bytes, like every other exchange path)
    trace.count("groupby.psum_combine")
    plan_check.annotate(node, decision="psum-combine", reason=reason)
    if not any(is_abstract(dt.columns[i].data) for i in key_ids):
        moved = (R + 1) * (dt.ctx.get_world_size() - 1)
        moved_bytes = moved * 8 * (1 + len(lanes))
        trace.count("broadcast.rows_sent", moved)
        trace.count("broadcast.bytes_sent", moved_bytes)
        trace.count("groupby.bytes_moved", moved_bytes)
    out_cap = ops_compact.next_bucket(R, minimum=8)
    pmask = _effective_mask(dt, where)
    with trace.span_sync("groupby.psum_combine") as sp:
        keys_out, vals_out, counts = _psum_combine(
            dt, key_ids, partial, lanes, domains, pmask, out_cap)
        sp.sync(vals_out)
    cols = []
    for i, (kd, kv) in zip(key_ids, keys_out):
        c = dt.columns[i]
        cols.append(DColumn(c.name, c.dtype, kd, kv, c.dictionary,
                            c.arrow_type))
    # the lanes ARE the combined partials: a partial-table view lets the
    # shared recompose apply (float sums back in the column's dtype)
    for (ci, op), lane in zip(partial, vals_out):
        base = dt.columns[ci]
        if op == "sum" and base.data.dtype.is_floating_point:
            lane = lane.to(base.data.dtype)
        cols.append(DColumn(f"{op}_{base.name}",
                            DataType(_agg_output_type(base.dtype.type, op)),
                            lane, None))
    comb = DTable(dt.ctx, cols, out_cap, counts)
    _note_plain_state(dt, aggregations, partial, plan, comb, len(key_ids),
                      None)
    return _recompose_partials(_base_meta(dt, aggregations), plan, comb,
                               len(key_ids))


@plan_check.instrument
def dist_groupby_fused(dt: DTable, key_columns: Sequence[Union[int, str]],
                       aggregations: Sequence[Tuple[Union[int, str], str]],
                       where=None, dense_key_range=None,
                       emit_empty: bool = False,
                       mode: str = "pre-aggregate", reason=None) -> DTable:
    """The planner-lowered aggregation: per-shard partials → exchange of
    the partial-group table → combining aggregation, with the strategy
    decided at plan time; the same results as ``dist_groupby``.

      * ``"psum"``: dictionary keys with a small domain and only
        sum / count / mean: the combine runs inside ONE ``all_reduce``
        over the dense slot space (no count read, no sort).  Re-checked
        here; a table that does not qualify (or ``emit_empty``) takes
        ``"pre-aggregate"``.
      * ``"pre-aggregate"``: local partials, then a hash shuffle of the
        partial table (each partial row moves once) and the combine.
      * ``"shuffle"``: near-unique keys, so raw rows move once and
        aggregate in place (``pre_aggregate=False``).

    The mode that ran is counted in ``decisions`` ("groupby.<mode>", or
    "groupby.local" at world 1).  ``reason`` is the planner's note on why
    it chose ``mode``; the plan report shows it beside the decision.

    A SPILLED input (every mode but ``emit_empty``, which needs the
    resident dense hint) streams through the morsel scan
    (``spill.morsel.morsel_groupby``), row-identical to the resident
    path."""
    if mode not in ("psum", "pre-aggregate", "shuffle"):
        raise CylonError(Status(Code.Invalid,
            f"dist_groupby_fused: unknown mode {mode!r}"))
    if dt.is_spilled and not emit_empty:
        from ..spill import morsel as spill_morsel
        return spill_morsel.morsel_groupby(
            dt, list(key_columns), list(aggregations), where=where,
            dense_key_range=dense_key_range, emit_empty=emit_empty,
            reason=reason)
    node = plan_check.note("dist_groupby_fused", dt,
                           keys=tuple(key_columns),
                           aggs=tuple(op for _, op in aggregations),
                           mode=mode, where=where is not None or None)
    trace.count("groupby.pushdown")
    key_ids = _resolve_ids(dt, key_columns)
    world = dt.ctx.get_world_size()
    for _, op in aggregations:
        if op not in ops_groupby.AGG_OPS:
            raise CylonError(Status(Code.Invalid,
                                    f"unknown aggregation {op!r}"))
    if mode == "psum" and not emit_empty:
        out = _fused_psum_groupby(dt, key_ids, aggregations, where, node,
                                  reason)
        if out is not None:
            decisions["groupby.psum"] += 1
            return out
        mode = "pre-aggregate"
        reason = "psum re-check failed at execution; partial exchange"
    if world <= 1 or mode == "shuffle":
        decisions["groupby.local" if world <= 1 else "groupby.shuffle"] += 1
        plan_check.annotate(node, decision=("local" if world <= 1
                                            else "shuffle"),
                            reason=reason)
        return dist_groupby(dt, key_ids, list(aggregations), where=where,
                            dense_key_range=dense_key_range,
                            pre_aggregate=False, emit_empty=emit_empty)
    decisions["groupby.pre-aggregate"] += 1
    plan_check.annotate(node, decision="pre-aggregate", reason=reason)
    K = len(key_ids)
    partial, plan = _decompose_aggs(dt, aggregations)
    part = dist_groupby(dt, key_ids, partial, where=where,
                        dense_key_range=dense_key_range, pre_aggregate=False,
                        _local_only=True, emit_empty=emit_empty)
    comb_aggs = [(K + j, _COMBINE_OP[op]) for j, (_, op) in enumerate(partial)]
    with trace.span("groupby.shuffle"):
        sh = _shuffle_by_keys(
            part, K, combine=_combine_leaf_spec(part, K,
                                                [op for _, op in partial]))
    comb = dist_groupby(sh, list(range(K)), comb_aggs,
                        dense_key_range=dense_key_range, pre_aggregate=False,
                        _local_only=True)
    _note_plain_state(dt, aggregations, partial, plan, comb, K,
                      dense_key_range)
    return _recompose_partials(_base_meta(dt, aggregations), plan, comb, K)


# ---------------------------------------------------------------------------
# sketch-based approximate groupby: per-group mergeable sketches ARE the
# partials, so the combine exchange moves constant bytes per group
# ---------------------------------------------------------------------------

def _parse_sketch_op(op: str) -> Tuple[str, Optional[float]]:
    """``approx_distinct`` | ``approx_quantile[:<q>]`` (q defaults to
    0.5) → ``(kind, q)``; anything else raises."""
    if op == "approx_distinct":
        return "distinct", None
    if op == "approx_quantile" or op.startswith("approx_quantile:"):
        q = 0.5
        if ":" in op:
            try:
                q = float(op.split(":", 1)[1])
            except ValueError:
                raise CylonError(Status(Code.Invalid,
                    f"bad quantile in sketch op {op!r}")) from None
        if not 0.0 <= q <= 1.0:
            raise CylonError(Status(Code.Invalid,
                f"quantile must be in [0, 1], got {q} ({op!r})"))
        return "quantile", q
    raise CylonError(Status(Code.Invalid,
        f"unknown sketch aggregation {op!r} (expected approx_distinct "
        "or approx_quantile:<q>)"))


def sketch_output_name(col_name: str, op: str) -> str:
    kind, q = _parse_sketch_op(op)
    if kind == "distinct":
        return f"approx_distinct_{col_name}"
    return f"p{int(round(q * 100))}_{col_name}"


def _group_keys(kl, idxS, keep_first, out_cap: int, cap: int):
    """The key rows of the first ``out_cap`` groups of a sorted shard
    (−1 past the last group), and the group count."""
    starts = ops_compact.compact_indices(keep_first, out_cap, fill=-1)
    key_idx = torch.where(starts >= 0,
                          idxS[torch.clamp(starts, 0, cap - 1).long()], -1)
    return (ops_gather.take_many(kl, key_idx, fill_null=False),
            torch.sum(keep_first).to(torch.int32))


def _sketch_state_table(ctx, key_meta_cols, keys_out, sk_outs, kinds,
                        cap: int, counts) -> DTable:
    """A sketch partial-state DTable: the keys, then per aggregation
    ``__hll{j}`` ([rows, M] int32) or ``__bkv{j}`` / ``__bkp{j}`` ([rows,
    K] float32 values / uint32 priorities)."""
    cols = [DColumn(meta.name, meta.dtype, kd, kv, meta.dictionary,
                    meta.arrow_type)
            for meta, (kd, kv) in zip(key_meta_cols, keys_out)]
    for j, (leaves, kind) in enumerate(zip(sk_outs, kinds)):
        if kind == "distinct":
            cols.append(DColumn(f"__hll{j}", DataType(Type.INT32),
                                leaves[0]))
        else:
            cols.append(DColumn(f"__bkv{j}", DataType(Type.FLOAT),
                                leaves[0]))
            cols.append(DColumn(f"__bkp{j}", DataType(Type.UINT32),
                                leaves[1]))
    return DTable(ctx, cols, cap, counts)


def _sketch_state_groups(part: DTable, K: int, kinds) -> List[List[int]]:
    """Column indices of each aggregation's sketch lanes in the
    ``_sketch_state_table`` layout."""
    groups, ci = [], K
    for kind in kinds:
        width = 1 if kind == "distinct" else 2
        groups.append(list(range(ci, ci + width)))
        ci += width
    return groups


class _ShardBlocks:
    """Per-shard output leaves written into ``[L·cap, …]`` blocks as each
    shard finishes, so a shard's outputs are freed before the next shard
    runs (``[groups, 256]`` sketch lanes are too large to hold twice).
    ``put(s, groups)`` takes one tuple of leaves (or None) per output;
    ``blocks`` is the same structure over all shards."""

    def __init__(self, nparts: int, cap: int):
        self.nparts, self.cap = nparts, cap
        self.blocks = None

    def put(self, s: int, groups) -> None:
        if self.blocks is None:
            self.blocks = [tuple(
                None if lf is None else
                torch.empty((self.nparts * self.cap,) + tuple(lf.shape[1:]),
                            dtype=lf.dtype, device=lf.device) for lf in g)
                for g in groups]
        lo = s * self.cap
        for bg, g in zip(self.blocks, groups):
            for b, lf in zip(bg, g):
                if b is not None:
                    b[lo:lo + self.cap] = lf


def _sketch_partial_table(dt: DTable, key_ids, val_ids, kinds, where,
                          off: int, total_cap: int) -> DTable:
    """Each shard's sketch partials as a DTable (phase A, no exchange):
    sort-group the rows and build one fixed-size sketch per (group,
    aggregation).  A row's global id, which seeds its sample priority, is
    ``shard·total_cap + off + row``.  The partial blocks are sized by the
    largest per-shard GROUP count (one host read), not by the input
    capacity: ``[groups, 256]`` lanes, where the input capacity would need
    ``[rows, 256]``.  ``shard`` is the GLOBAL rank (this process's L
    shards are ranks ``get_rank() … + L − 1``), so ids do not collide
    between processes."""
    P, cap = dt.nlocal, dt.cap
    r0 = dt.ctx.get_rank()
    dev = dt.counts.device
    pmask = _effective_mask(dt, where)
    nv = len(val_ids)
    has_v = [dt.columns[i].validity is not None for i in val_ids]
    phase1 = []
    for s in range(P):
        kl = _leaf_pairs(dt, key_ids, s)
        vl = _leaf_pairs(dt, val_ids, s)
        gidx = ((r0 + s) * total_cap + off
                + torch.arange(cap, dtype=torch.int64, device=dev)) \
            & 0xFFFFFFFF
        carry = tuple(d for d, _ in vl) + tuple(v for _, v in vl
                                                if v is not None) + (gidx,)
        phase1.append((kl, ops_groupby.group_structure(
            tuple(d for d, _ in kl), tuple(v for _, v in kl),
            _shard_rows(dt, pmask, s), carry)))
    ngs = dt.ctx.comm.all_gather(torch.stack(
        [ops_groupby.num_groups_of(st) for _, st in phase1]))
    out_cap = ops_compact.next_bucket(
        max(int(ops_compact.read_host(ngs).max(initial=0)), 1), minimum=8)
    keys, sks, counts = _ShardBlocks(P, out_cap), _ShardBlocks(P, out_cap), []
    for s in range(P):
        kl, (idxS, is_first, rvS, carried) = phase1[s]
        phase1[s] = None  # this shard's sorted rows are not needed after
        vals_s = carried[:nv]
        it = iter(carried[nv:-1])
        valids_s = [next(it) if hv else None for hv in has_v]
        gidx_s = carried[-1]
        slot, keep_first = ops_sketch.sorted_slots(is_first, rvS, out_cap)
        ko, ng = _group_keys(kl, idxS, keep_first, out_cap, cap)
        outs = []
        for col_s, valid_s, kind in zip(vals_s, valids_s, kinds):
            vmask = rvS if valid_s is None else (rvS & valid_s)
            bits = ops_sketch.value_bits32(col_s)
            if kind == "distinct":
                outs.append((ops_sketch.hll_build(slot, out_cap, bits,
                                                  vmask),))
            else:
                outs.append(ops_sketch.bottomk_build(slot, out_cap, col_s,
                                                     bits, gidx_s, vmask))
        keys.put(s, ko)
        sks.put(s, outs)
        counts.append(ng)
    return _sketch_state_table(dt.ctx, [dt.columns[i] for i in key_ids],
                               keys.blocks, sks.blocks, kinds, out_cap,
                               torch.stack(counts))


def _sketch_combine(part: DTable, K: int, kinds, qs, finalize: bool):
    """Phase B per shard: re-group the partial rows by key and MERGE each
    group's sketches (register max / bottom-k of the union) into a block
    of ``part.cap`` groups.  With ``finalize`` the merged sketches become
    result lanes (HLL estimate int32 with no validity; sample quantile
    float32 with a non-empty mask); without it, the merged state in the
    partial-table layout.  Returns (key leaves, lane tuples, counts),
    over this process's L shards."""
    P, cap = part.nlocal, part.cap
    dev = part.counts.device
    kl_all = list(range(K))
    groups = _sketch_state_groups(part, K, kinds)
    keys, outs_all, counts = _ShardBlocks(P, cap), _ShardBlocks(P, cap), []
    for s in range(P):
        kl = _leaf_pairs(part, kl_all, s)
        row_valid = torch.arange(cap, device=dev) < part.counts[s]
        idxS, is_first, rvS, _ = ops_groupby.group_structure(
            tuple(d for d, _ in kl), tuple(v for _, v in kl), row_valid)
        rows = idxS.long()
        slot, keep_first = ops_sketch.sorted_slots(is_first, rvS, cap)
        ko, ng = _group_keys(kl, idxS, keep_first, cap, cap)
        outs = []
        for kind, q, cols in zip(kinds, qs, groups):
            lanes = [ops_gather.signed_view(_shard(part.columns[c].data, s,
                                                   cap))[rows]
                     .view(part.columns[c].data.dtype) for c in cols]
            if kind == "distinct":
                regs = ops_sketch.hll_merge_rows(slot, cap, lanes[0], rvS)
                outs.append((ops_sketch.hll_estimate(regs), None)
                            if finalize else (regs,))
            else:
                mv, mp = ops_sketch.bottomk_merge_rows(slot, cap, lanes[0],
                                                       lanes[1], rvS)
                outs.append(ops_sketch.bottomk_quantile(mv, mp, q)
                            if finalize else (mv, mp))
        keys.put(s, ko)
        outs_all.put(s, outs)
        counts.append(ng)
    return keys.blocks, outs_all.blocks, torch.stack(counts)


def _sketch_merge_local(part: DTable, K: int, kinds, qs) -> DTable:
    """Merge same-group rows of a partial-state table in place (no
    exchange)."""
    keys_out, outs, counts = _sketch_combine(part, K, kinds, qs, False)
    return _sketch_state_table(part.ctx, part.columns[:K], keys_out, outs,
                               kinds, part.cap, counts)


def _sketch_result(sh: DTable, key_meta_cols, keys_out, base_meta, outs,
                   kinds, counts) -> DTable:
    """The finalized sketch groupby's table: the keys, then
    ``approx_distinct_{col}`` (int64) or ``p{q·100}_{col}`` (float32,
    null for a group whose values are all null) per aggregation."""
    cols = [DColumn(meta.name, meta.dtype, kd, kv, meta.dictionary,
                    meta.arrow_type)
            for meta, (kd, kv) in zip(key_meta_cols, keys_out)]
    for (name, _, op), (est, valid), kind in zip(base_meta, outs, kinds):
        out_name = sketch_output_name(name, op)
        if kind == "distinct":
            cols.append(DColumn(out_name, DataType(Type.INT64),
                                est.to(torch.int64), None))
        else:
            cols.append(DColumn(out_name, DataType(Type.FLOAT), est, valid))
    return DTable(sh.ctx, cols, sh.cap, counts)


def _sketch_spilled_partials(dt: DTable, key_ids, val_ids, kinds, qs, where,
                             node) -> DTable:
    """The sketch partials of a SPILLED table: per staged morsel (rows
    ``[m·w, (m+1)·w)`` of each shard, so ``off = m·w``), merged into the
    accumulator as they come (retaining every morsel's partials would
    scale device memory with the input × the sketch width)."""
    from contextlib import closing

    from ..resilience import exchange_budget
    from ..spill import morsel as spill_morsel
    from ..spill import pool as spill_pool
    from .streaming import _concat_compact
    entry = spill_pool.get_pool().pin_for_scan(dt)
    cap = entry.cap
    k, w, per = spill_morsel.plan_morsels(
        dt.nparts, cap, spill_morsel._spilled_rbytes(dt),
        exchange_budget(dt.ctx.device))
    plan_check.annotate(node, decision="morsel-scan",
                        reason=f"{k} morsels x {w} rows/shard "
                               f"({per} B/morsel)")
    K = len(key_ids)
    acc = None
    with closing(spill_morsel.iter_morsels(dt, entry, k, w, cap)) as scan:
        for m, sl in enumerate(scan):
            part_m = _sketch_partial_table(sl, key_ids, val_ids, kinds,
                                           where, m * w, cap)
            del sl
            if acc is None:
                acc = part_m
                continue
            cat = _concat_compact([acc, part_m])
            del acc, part_m
            acc = _fit_groups(_sketch_merge_local(cat, K, kinds, qs))
            del cat
    return acc


def _fit_groups(part: DTable) -> DTable:
    """``part`` in blocks of the size class of its largest shard's group
    count (one host read), as ``_sketch_partial_table`` sizes them: a
    merge writes its groups into blocks as wide as its input, and the
    morsel fold would otherwise widen the accumulator every morsel."""
    cap = ops_compact.next_bucket(max(int(part.counts_host().max(initial=0)),
                                      1), minimum=8)
    if cap >= part.cap:
        return part
    P = part.nlocal

    def cut(x):
        tail = tuple(x.shape[1:])
        return x.reshape((P, part.cap) + tail)[:, :cap].reshape(
            (P * cap,) + tail)

    cols = [DColumn(c.name, c.dtype, cut(c.data),
                    None if c.validity is None else cut(c.validity),
                    c.dictionary, c.arrow_type) for c in part.columns]
    out = DTable(part.ctx, cols, cap, part.counts)
    out._counts_host = part._counts_host
    return out


@plan_check.instrument
def dist_groupby_sketch(dt: DTable, key_columns: Sequence[Union[int, str]],
                        aggregations: Sequence[Tuple[Union[int, str], str]],
                        where=None) -> DTable:
    """Sketch-based approximate groupby: per group, ``approx_distinct``
    estimates a column's distinct count from HLL registers and
    ``approx_quantile:<q>`` its q-quantile from a bottom-k uniform sample
    (within ``ops/sketch.py``'s ``HLL_ERROR_BOUND`` /
    ``QUANTILE_RANK_ERROR_BOUND``).  The sketches are the partials: each
    shard builds one per (group, aggregation), a hash shuffle of the
    partial table co-locates each group's sketches, and the combine merges
    and finalizes them.

    Output columns: the keys, then ``approx_distinct_{col}`` (int64) /
    ``p{q·100}_{col}`` (float32, null for all-null groups) in aggregation
    order.  ``where`` follows ``dist_select``'s predicate protocol.

    A SPILLED input builds its partials per staged morsel (the sample
    priorities seed from the morsel's row offset, so they equal the
    resident run's) and merges them into the accumulator morsel by
    morsel: it holds one state row per group seen so far."""
    node = plan_check.note("dist_groupby_sketch", dt,
                           keys=tuple(key_columns),
                           aggs=tuple(op for _, op in aggregations))
    trace.count("sketch.groupbys")
    key_ids = _resolve_ids(dt, key_columns)
    K = len(key_ids)
    val_ids = [dt.column_index(c) for c, _ in aggregations]
    parsed = [_parse_sketch_op(op) for _, op in aggregations]
    kinds = tuple(kind for kind, _ in parsed)
    qs = tuple(-1.0 if q is None else q for _, q in parsed)
    if dt.is_spilled:
        part = _sketch_spilled_partials(dt, key_ids, val_ids, kinds, qs,
                                        where, node)
    else:
        part = _sketch_partial_table(dt, key_ids, val_ids, kinds, where, 0,
                                     dt.cap)
    prows = int(part.counts_host().sum())
    trace.count("sketch.partial_rows", prows)
    sk_leaves = [lf for c in part.columns[K:]
                 for lf in (c.data, c.validity) if lf is not None]
    trace.count("sketch.register_bytes", prows * max(row_bytes(sk_leaves), 1))
    with trace.span("sketch.shuffle"):
        sh = _shuffle_by_keys(part, K)
    del part  # the shuffled copy replaces it before the merge's transients
    with trace.span_sync("sketch.combine") as sp:
        keys_out, outs, counts = _sketch_combine(sh, K, kinds, qs, True)
        sp.sync(outs)
    _note_sketch_state(dt, aggregations, sh, K, kinds, qs)
    return _sketch_result(sh, [dt._columns[i] for i in key_ids], keys_out,
                          _base_meta(dt, aggregations), outs, kinds, counts)
