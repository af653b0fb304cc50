"""Distributed operators: partition → shuffle → masked local kernel.

Mirror of the join, sort and set-operation paths of
``cylon_tpu/parallel/dist_ops.py`` (reference:
cpp/src/cylon/table_api.cpp:299-352 DistributedJoinTables, :904-975
DoDistributedSetOperation, :214-297 Shuffle).  The pattern:

  partition   murmur3 row hash % P per row — the CUDA kernel of
              ops/hash_cuda.py on the card, its plain version on the CPU —
              for the HASH join and the set ops; or sampled-splitter range
              partitioning (sample-sort) for the SORT join and dist_sort;
  shuffle     the single-shot two-phase all_to_all (shuffle.shuffle_leaves);
  local op    the sort-plan join kernel (ops/join.py), the masked sorts
              (ops/sort.py) or the set-op grouping (ops/setops.py) per
              shard on its padded block, count-masked.

Everything stays on the device except the per-shard count vectors, which
the host reads to size each data-dependent output.  The splitters are
pooled through the communicator's ``all_gather`` and never reach the host.
"""
from __future__ import annotations

from dataclasses import replace
from typing import List, Sequence, Tuple, Union

import torch

from ..config import JoinAlgorithm, JoinConfig
from ..dtypes import extreme_value, is_dictionary_encoded
from ..ops import compact as ops_compact
from ..ops import gather as ops_gather
from ..ops import join as ops_join
from ..ops import setops as ops_setops
from ..ops import sort as ops_sort
from ..ops.hash_cuda import partition_ids_fused
from ..status import Code, CylonError, Status
from ..table import Table, remap_codes, remap_dictionaries
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
    return (DTable(a.ctx, acols, a.cap, a.counts),
            DTable(b.ctx, bcols, b.cap, b.counts))


# ---------------------------------------------------------------------------
# shuffle_table (reference: Shuffle, table_api.cpp:214-297)
# ---------------------------------------------------------------------------

def _shuffle_by_pids(dt: DTable, pid: torch.Tensor) -> DTable:
    """Exchange rows to their target shards; rebuild the DTable."""
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
    """Key resolution + type check + dictionary unification."""
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
    key_i = dt.column_index(sort_column)
    return _sort_shards(_range_shuffle(dt, key_i, ascending), [key_i],
                        [bool(ascending)])


def dist_head(dt: DTable, n: int) -> Table:
    """First ``n`` global rows (shard-major order) as a local Table — the
    small-result gather after a dist_sort (ORDER BY … LIMIT n)."""
    return dt.head(n)
