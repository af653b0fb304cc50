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
  shuffle     the single-shot two-phase all_to_all (shuffle.shuffle_leaves);
  local op    the sort-plan join kernel (ops/join.py), the masked sorts
              (ops/sort.py), the set-op grouping (ops/setops.py) or the
              groupby (ops/groupby.py) per shard on its padded block,
              count-masked.

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

from dataclasses import replace
from typing import List, Sequence, Tuple, Union

import torch

from ..compute import _agg_output_type
from ..config import JoinAlgorithm, JoinConfig
from ..dtypes import DataType, device_dtype, extreme_value, is_dictionary_encoded
from ..ops import compact as ops_compact
from ..ops import gather as ops_gather
from ..ops import groupby as ops_groupby
from ..ops import join as ops_join
from ..ops import setops as ops_setops
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


# ---------------------------------------------------------------------------
# helpers: row masks, partition ids, dictionary unification across DTables
# ---------------------------------------------------------------------------

def _row_mask(dt: DTable) -> torch.Tensor:
    """counts [P] → valid-row mask [P*cap] (True for rows < shard count)."""
    ar = torch.arange(dt.cap, device=dt.counts.device)
    return (ar[None, :] < dt.counts[:, None]).reshape(-1)


def _resolve_ids(dt: DTable, cols: Sequence[Union[int, str]]) -> List[int]:
    return [dt.column_index(c) for c in cols]


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

def _shuffle_by_pids(dt: DTable, pid: torch.Tensor) -> DTable:
    """Exchange rows to their target shards; rebuild the DTable."""
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
    new_leaves, newcounts, outcap = shuffle_leaves(dt.ctx, pid, leaves)
    data, validity = {}, {}
    for leaf, (i, is_v) in zip(new_leaves, slots):
        (validity if is_v else data)[i] = leaf
    cols = [DColumn(c.name, c.dtype, data[i], validity.get(i),
                    c.dictionary, c.arrow_type)
            for i, c in enumerate(dt.columns)]
    return DTable(dt.ctx, cols, outcap, newcounts)


def shuffle_table(dt: DTable, key_columns: Sequence[Union[int, str]]
                  ) -> DTable:
    """Hash-repartition rows so equal keys co-locate on one shard."""
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
        splitters = _sample_splitters(
            [(left, li_keys[0]), (right, ri_keys[0])], ascending=True)
    return left, right, li_keys, ri_keys, alg, splitters


def _copartition(dt: DTable, key_is: Sequence[int], alg: str,
                 splitters) -> DTable:
    """Route rows to their join shard (hash or range partitioning)."""
    if dt.ctx.get_world_size() == 1:
        return dt  # one shard: co-partitioning is a no-op
    if alg == "sort":
        pid = _range_pids(dt, key_is[0], splitters, ascending=True)
    else:
        pid = _hash_pids(dt, key_is)
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

    Phase 1 builds every shard's plan and output count; the host reads the
    counts (all-gathered) and sizes one capacity for all shards; phase 2
    expands each plan and gathers the output columns into it.
    """
    if alg == "hash" and HASH_LOCAL_KERNEL == "sort":
        alg = "sort"  # the retired rank kernel; see HASH_LOCAL_KERNEL
    if alg != "sort":
        raise CylonError(Status(Code.NotImplemented,
            f"dist_join: local kernel {alg!r} is not ported"))
    ctx = lsh.ctx
    P = ctx.get_world_size()
    lcap, rcap = lsh.cap, rsh.cap
    fill_left = how in ("right", "full_outer")
    fill_right = how in ("left", "full_outer")

    plans, totals = [], []
    for s in range(P):
        lc, rc = lsh.counts[s], rsh.counts[s]
        plan = ops_join.sort_join_plan(
            tuple(_shard(lsh.columns[i].data, s, lcap) for i in li_keys),
            tuple(_shard(lsh.columns[i].validity, s, lcap) for i in li_keys),
            tuple(_shard(rsh.columns[i].data, s, rcap) for i in ri_keys),
            tuple(_shard(rsh.columns[i].validity, s, rcap) for i in ri_keys),
            how, l_count=lc, r_count=rc)
        plans.append(plan)
        totals.append(ops_join.plan_total(plan, how, l_count=lc, r_count=rc))
    per_shard = ctx.comm.all_gather(torch.stack(totals)).cpu().numpy()
    capacity = ops_compact.next_bucket(max(int(per_shard.max(initial=0)), 1),
                                       minimum=8)

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
    plans.clear()

    cols = [DColumn("lt-" + c.name, c.dtype, *_stacked(louts, k),
                    c.dictionary, c.arrow_type)
            for k, c in enumerate(lsh.columns)]
    cols += [DColumn("rt-" + c.name, c.dtype, *_stacked(routs, k),
                     c.dictionary, c.arrow_type)
             for k, c in enumerate(rsh.columns)]
    return DTable(ctx, cols, capacity, torch.stack(counts))


def dist_join(left: DTable, right: DTable, config: JoinConfig) -> DTable:
    """Distributed equi-join: co-partition both sides on the key (by hash
    for ``JoinAlgorithm.HASH``, by sampled key ranges for SORT, the
    default), then a masked local join per shard.  Output columns are
    ``lt-…`` / ``rt-…`` like the local join (reference
    join_utils.cpp:23-95).  Under SORT shard *i*'s keys all precede shard
    *i+1*'s.
    """
    left, right, li_keys, ri_keys, alg, splitters = _join_prologue(
        left, right, config)
    lsh = _copartition(left, li_keys, alg, splitters)
    rsh = _copartition(right, ri_keys, alg, splitters)
    return _join_copartitioned(lsh, rsh, li_keys, ri_keys,
                               config.join_type.value, alg)


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
    a._collapse_pending()
    b._collapse_pending()
    a.verify_same_schema(b)
    a, b = _unify_dtable_dicts(a, b, range(a.num_columns),
                               range(b.num_columns))
    if a.ctx.get_world_size() == 1:
        ash, bsh = a, b
    else:
        ash = _shuffle_by_pids(a, _hash_pids(a, range(a.num_columns)))
        bsh = _shuffle_by_pids(b, _hash_pids(b, range(b.num_columns)))
    has_validity = [ca.validity is not None or cb.validity is not None
                    for ca, cb in zip(ash.columns, bsh.columns)]
    P = a.ctx.get_world_size()
    outs, counts = [], []
    for s in range(P):
        got, cnt = _setop_shard(
            [(_shard(c.data, s, ash.cap), _shard(c.validity, s, ash.cap))
             for c in ash.columns],
            [(_shard(c.data, s, bsh.cap), _shard(c.validity, s, bsh.cap))
             for c in bsh.columns],
            ash.counts[s], bsh.counts[s], ash.cap, bsh.cap, op, has_validity)
        outs.append(got)
        counts.append(cnt)
    capacity = ash.cap + bsh.cap if op == ops_setops.UNION else ash.cap
    cols = [DColumn(c.name, c.dtype, *_stacked(outs, k), c.dictionary,
                    c.arrow_type)
            for k, c in enumerate(ash.columns)]
    return DTable(a.ctx, cols, capacity, torch.stack(counts))


def dist_union(a: DTable, b: DTable) -> DTable:
    return _dist_set_op(a, b, ops_setops.UNION)


def dist_intersect(a: DTable, b: DTable) -> DTable:
    return _dist_set_op(a, b, ops_setops.INTERSECT)


def dist_subtract(a: DTable, b: DTable) -> DTable:
    return _dist_set_op(a, b, ops_setops.SUBTRACT)


# ---------------------------------------------------------------------------
# distributed sample-sort (absent in reference v0)
# ---------------------------------------------------------------------------

def _sample(dt: DTable, key_i: int, nsamples: int, ascending: bool):
    """Per shard: ``nsamples`` evenly spaced order statistics of the
    non-null valid rows, and a per-sample validity flag; ``[P, nsamples]``
    each.  The JAX package's ``_sample_fn`` rule, unchanged:
    ``q = arange(ns)·max(nn, 1) // ns`` and ``ok = arange(ns) < nn``, where
    ``nn`` counts the shard's non-null valid rows.

    Only the sampled values matter, so the block is not lexsorted on
    (padding, null, key) as in the JAX package: two stable sorts of all
    shards at once, by key and then by "not a sampled row", put each
    shard's non-null valid rows first in the same order.
    """
    P, cap = dt.ctx.get_world_size(), dt.cap
    c = dt.columns[key_i]
    rows = _row_mask(dt)
    if c.validity is not None:
        rows = rows & c.validity
    rows = rows.view(P, cap)
    nn = rows.sum(1)                                                   # [P]
    key = ops_join._ordered(c.data if ascending else ops_sort._invert(c.data))
    order = torch.sort(key.view(P, cap), dim=1, stable=True).indices
    rest = (~rows).gather(1, order).to(torch.uint8)
    order = order.gather(1, torch.sort(rest, dim=1, stable=True).indices)
    ar = torch.arange(nsamples, device=nn.device)
    q = (ar[None, :] * torch.clamp(nn, min=1)[:, None]) // nsamples
    pick = order.gather(1, q.clamp(0, cap - 1))
    data = ops_gather.signed_view(c.data).view(P, cap)
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
    extreme = torch.tensor(extreme_value(pv.dtype, largest=ascending),
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
    P, cap = sh.ctx.get_world_size(), sh.cap
    keys = [sh.columns[i] for i in key_ids]
    outs = []
    for s in range(P):
        order = ops_sort.lexsort_indices_masked(
            [_shard(c.data, s, cap) for c in keys],
            [_shard(c.validity, s, cap) for c in keys], sh.counts[s],
            ascending)
        outs.append(ops_gather.take_many(
            [(_shard(c.data, s, cap), _shard(c.validity, s, cap))
             for c in sh.columns], order, fill_null=False))
    cols = [DColumn(c.name, c.dtype, *_stacked(outs, k), c.dictionary,
                    c.arrow_type)
            for k, c in enumerate(sh.columns)]
    out = DTable(sh.ctx, cols, cap, sh.counts)
    out._counts_host = sh._counts_host  # same rows per shard
    return out


def _range_shuffle(dt: DTable, key_i: int, ascending: bool) -> DTable:
    if dt.ctx.get_world_size() == 1:
        return dt  # one shard: a local sort is already globally ordered
    splitters = _sample_splitters([(dt, key_i)], ascending)
    return _shuffle_by_pids(dt, _range_pids(dt, key_i, splitters, ascending))


def dist_sort_multi(dt: DTable, sort_columns: Sequence[Union[int, str]],
                    ascending=True) -> DTable:
    """Distributed multi-key ORDER BY: range-partition on the PRIMARY
    column (equal primary values co-locate, so cross-shard lexicographic
    order holds), then a per-shard masked lexsort over all keys.
    ``ascending``: one bool or a per-column sequence."""
    dt._collapse_pending()
    key_ids = _resolve_ids(dt, sort_columns)
    asc = ([ascending] * len(key_ids) if isinstance(ascending, bool)
           else [bool(a) for a in ascending])
    return _sort_shards(_range_shuffle(dt, key_ids[0], asc[0]), key_ids, asc)


def dist_sort(dt: DTable, sort_column: Union[int, str],
              ascending: bool = True) -> DTable:
    """Distributed sample-sort: sample splitters → range-partition shuffle →
    local sort per shard.  Shard *i*'s rows all precede shard *i+1*'s in the
    requested order, and rows within a shard are sorted (nulls last
    globally), so concatenating shards in order is the sorted table.
    """
    dt._collapse_pending()
    key_i = dt.column_index(sort_column)
    return _sort_shards(_range_shuffle(dt, key_i, ascending), [key_i],
                        [bool(ascending)])


def dist_head(dt: DTable, n: int) -> Table:
    """First ``n`` global rows (shard-major order) as a local Table — the
    small-result gather after a dist_sort (ORDER BY … LIMIT n)."""
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
    """Per-shard True counts of a [P*cap] mask, gathered to every rank."""
    P = dt.ctx.get_world_size()
    return dt.ctx.comm.all_gather(
        mask.reshape(P, dt.cap).sum(1).to(torch.int32))


def _compact_survivors(dt: DTable, mask: torch.Tensor,
                       cnts: torch.Tensor) -> DTable:
    """Shared tail of the row filters: compact the rows ``mask`` keeps
    into a block bucketed to the largest per-shard survivor count
    (``cnts``, read by the host)."""
    per_shard = cnts.cpu().numpy()
    outcap = ops_compact.next_bucket(max(int(per_shard.max(initial=0)), 1),
                                     minimum=8)
    cap = dt.cap
    outs, counts = [], []
    for s in range(dt.ctx.get_world_size()):
        idx, count = ops_compact.mask_to_indices(_shard(mask, s, cap), outcap)
        outs.append(ops_gather.take_many(
            [(_shard(c.data, s, cap), _shard(c.validity, s, cap))
             for c in dt.columns], idx, fill_null=False))
        counts.append(count)
    cols = [DColumn(c.name, c.dtype, *_stacked(outs, k), c.dictionary,
                    c.arrow_type)
            for k, c in enumerate(dt.columns)]
    return DTable(dt.ctx, cols, outcap, torch.stack(counts))


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
    base = dt.pending_mask if dt.pending_mask is not None else _row_mask(dt)
    mask = _masked_predicate(tuple(c.name for c in dt.columns), predicate,
                             base, _leaves(dt), tuple(params))
    cnts = _shard_counts(dt, mask)
    if not compact:
        return DTable(dt.ctx, dt.columns, dt.cap, dt.counts,
                      pending_mask=mask, pending_cnts=cnts)
    return _compact_survivors(dt, mask, cnts)


def dist_project(dt: DTable, columns: Sequence[Union[int, str]]) -> DTable:
    """Column subset, zero-copy (reference table_api.cpp:1007-1029).  A
    deferred-select mask rides along."""
    ids = _resolve_ids(dt, columns)
    out = DTable(dt.ctx, [dt.columns[i] for i in ids], dt.cap, dt.counts,
                 dt.pending_mask, dt.pending_cnts)
    out._counts_host = dt._counts_host  # same rows
    return out


def dist_with_column(dt: DTable, name: str, fn, out_type,
                     validity_from: Sequence[str] = ()) -> DTable:
    """Append a derived column ``name = fn({col name: data tensor})``,
    stored as ``out_type``'s device dtype.  Elementwise over the flat
    blocks.  ``validity_from`` names input columns whose nulls null the
    output.  A deferred-select mask rides along (the derived column holds
    garbage on masked-out rows, which stay masked)."""
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
# scalar aggregate (GROUP BY-less SELECT SUM(…))
# ---------------------------------------------------------------------------

def _is_integer(dtype: torch.dtype) -> bool:
    return not dtype.is_floating_point and not dtype.is_complex \
        and dtype != torch.bool


def dist_aggregate(dt: DTable,
                   aggregations: Sequence[Tuple[Union[int, str], str]],
                   where=None) -> Table:
    """Whole-table aggregate: a ONE-row local Table with columns
    ``{op}_{col}``.  Per shard a masked fold, then a sum (min, max) of
    the per-shard partials over the all-gathered values; no sort, no
    groups.  ``where`` follows ``dist_select``'s predicate protocol.
    Over zero rows, sum and count are 0 and min/max/mean are null."""
    comm = dt.ctx.comm
    P, cap = dt.ctx.get_world_size(), dt.cap
    pmask = _effective_mask(dt, where)
    base = pmask if pmask is not None else _row_mask(dt)
    cols = []
    for cref, op in aggregations:
        c = dt.columns[dt.column_index(cref)]
        d = c.data
        m = base if c.validity is None else (base & c.validity)
        cnt = comm.all_gather(m.reshape(P, cap).sum(1).to(torch.int32)).sum()
        if op in ("sum", "mean"):
            acc = d.to(torch.int64) if _is_integer(d.dtype) else d
            z = torch.where(m, acc, torch.zeros((), dtype=acc.dtype,
                                                device=acc.device))
            s = comm.all_gather(z.reshape(P, cap).sum(1)).sum()
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
            fill = torch.tensor(extreme_value(d.dtype, largest=(op == "min")),
                                dtype=d.dtype, device=d.device)
            folded = torch.where(m, ops_join._ordered(d),
                                 ops_join._ordered(fill)).reshape(P, cap)
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
    return Table(dt.ctx, cols)


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
                    aggs, aggregations, pmask) -> DTable:
    """The sort path per shard: phase 1 sorts (values carried) and counts
    groups; the host reads the all-gathered counts and sizes one output
    block; phase 2 aggregates into it and gathers the keys."""
    P = dt.ctx.get_world_size()
    phase1 = []
    for s in range(P):
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
    out_cap = ops_compact.next_bucket(
        max(int(ngs.cpu().numpy().max(initial=0)), 1), minimum=8)
    outs, counts = [], []
    for st, kl, vl in phase1:
        ucols, uvals = ops_groupby.carry_unpack(st[3],
                                                tuple(v for _, v in vl))
        vcols = tuple(ucols[j] for j in slot_map)
        vvals = tuple(uvals[j] for j in slot_map)
        key_idx, aouts, avals, ng = ops_groupby.groupby_aggregate(
            tuple(d for d, _ in kl), tuple(v for _, v in kl), vcols, vvals,
            aggs, structure=st, out_capacity=out_cap,
            sorted_values=(vcols, vvals))
        outs.append(ops_gather.take_many(kl, key_idx, fill_null=False)
                    + list(zip(aouts, avals)))
        counts.append(ng)
    phase1.clear()
    return _groupby_output(dt, sh, key_ids, aggregations, outs, counts,
                           out_cap)


def _mod_pids(dt: DTable, key_id: int, lo: int, nparts: int) -> torch.Tensor:
    """Modulo partitioner for dense integer keys: shard = (key − lo) mod P.
    Each shard then holds one residue class, so its dense slot space
    shrinks by P.  Nulls and keys below ``lo`` go to shard 0 (an
    out-of-range key fails in phase 1), padding rows to P."""
    kc = dt.columns[key_id]
    base = kc.data.to(torch.int64) - lo
    pid = torch.where(base >= 0, base % nparts, 0)
    if kc.validity is not None:
        pid = torch.where(kc.validity, pid, 0)
    return torch.where(_row_mask(dt), pid, nparts).to(torch.int32)


def _groupby_dense(dt: DTable, sh: DTable, key_id: int, uniq_ids, slot_map,
                   aggs, aggregations, dense, pmask,
                   emit_empty: bool) -> DTable:
    """The direct-address path (``dense_key_range``): phase 1 slots and
    slot counts per shard, plus each shard's [groups, out-of-range rows];
    a range violation raises; phase 2 reduces per slot and rebuilds the
    keys."""
    lo, hi, stride = dense
    P = dt.ctx.get_world_size()
    kc = sh.columns[key_id]
    phase1, stats = [], []
    for s in range(P):
        slot, counts, ng, ov = ops_groupby.dense_group_structure(
            _shard(kc.data, s, sh.cap), _shard(kc.validity, s, sh.cap),
            _shard_rows(sh, pmask, s), lo, hi, stride=stride)
        phase1.append((slot, counts))
        stats.append(torch.stack([ng, ov]))
    per_shard = dt.ctx.comm.all_gather(torch.stack(stats)).cpu().numpy()
    bad = int(per_shard[:, 1].sum())
    if bad > 0:
        raise CylonError(Status(Code.Invalid,
            f"dense_key_range ({lo}, {hi}) violated: {bad} rows carry keys "
            "outside it"))
    out_cap = ops_compact.next_bucket(max(int(per_shard[:, 0].max()), 1),
                                      minimum=8)
    if emit_empty:
        # every slot of the range emits, occupied or not
        out_cap = max(out_cap, ops_compact.next_bucket(
            -(-(hi - lo + 1) // stride) + 1, minimum=8))
    outs, counts = [], []
    for s, (slot, cnts) in enumerate(phase1):
        vl = _leaf_pairs(sh, uniq_ids, s)
        kd, kv, aouts, avals, ng = ops_groupby.dense_groupby_aggregate(
            slot, cnts, tuple(vl[j][0] for j in slot_map),
            tuple(vl[j][1] for j in slot_map), aggs, out_cap, lo,
            kc.data.dtype, kc.validity is not None, stride=stride,
            phase=s if stride > 1 else 0, emit_empty=emit_empty, hi=hi)
        outs.append([(kd, kv)] + list(zip(aouts, avals)))
        counts.append(ng)
    phase1.clear()
    return _groupby_output(dt, sh, [key_id], aggregations, outs, counts,
                           out_cap)


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
    if pre_aggregate is None:
        # a dense range wider than a shard means near-unique keys per
        # shard: the partial pass could not shrink the exchange
        near_unique = (dense_key_range is not None and len(key_ids) == 1
                       and (int(dense_key_range[1])
                            - int(dense_key_range[0]) + 1) > dt.cap)
        pre_aggregate = world > 1 and not _local_only and not near_unique
    if world > 1 and pre_aggregate and not _local_only:
        return _dist_groupby_preagg(dt, key_ids, aggregations, where,
                                    dense_key_range, emit_empty)
    pmask = _effective_mask(dt, where)
    if world == 1 or _local_only:
        sh = dt
    else:
        if dense is not None:
            pid = _mod_pids(dt, key_ids[0], dense[0], world)
        else:
            pid = _hash_pids(dt, key_ids)
        if pmask is not None:
            # filter pushdown: failing rows never enter the exchange
            pid = torch.where(pmask, pid, world)
            pmask = None
        sh = _shuffle_by_pids(_cleared(dt), pid)
    if dense is not None:
        return _groupby_dense(dt, sh, key_ids[0], uniq_ids, slot_map, aggs,
                              aggregations, dense, pmask, emit_empty)
    return _groupby_sorted(dt, sh, key_ids, uniq_ids, slot_map, aggs,
                           aggregations, pmask)


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


def _recompose_partials(dt: DTable, aggregations, plan, comb: DTable,
                        K: int) -> DTable:
    """Final columns from the combined partials: mean = Σsum / Σcount,
    everything else forwards its combined partial (partial j is column
    K + j of ``comb``)."""
    cols = list(comb.columns[:K])
    for (cref, op), spec in zip(aggregations, plan):
        base = dt.columns[dt.column_index(cref)]
        t_out = DataType(_agg_output_type(base.dtype.type, op))
        name = f"{op}_{base.name}"
        if op == "mean":
            s, c = comb.columns[K + spec[1]], comb.columns[K + spec[2]]
            data = (s.data.to(torch.float64)
                    / torch.clamp(c.data, min=1).to(torch.float64))
            cols.append(DColumn(name, t_out, data, c.data > 0))
        else:
            src = comb.columns[K + spec[1]]
            cols.append(DColumn(name, t_out, src.data, src.validity))
    return DTable(dt.ctx, cols, comb.cap, comb.counts)


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
        part_rep = broadcast.replicate_table(part, mode=broadcast.HEAD)
        comb = dist_groupby(part_rep, list(range(K)), comb_aggs,
                            dense_key_range=dense_key_range,
                            pre_aggregate=False, _local_only=True)
    else:
        comb = dist_groupby(part, list(range(K)), comb_aggs,
                            dense_key_range=dense_key_range,
                            pre_aggregate=False)
    return _recompose_partials(dt, aggregations, plan, comb, K)
