"""Local (single-device) table operations: join, set ops, sort, select,
partitioning, merge and groupby-aggregate.

Mirror of ``cylon_tpu/compute.py`` (reference: cpp/src/cylon/table_api.cpp
JoinTables → join/join.cpp, set ops :530-902, Sort :404-459,
HashPartition :461-528, Merge :404-423, Select :977-1005; the groupby is
new in the JAX package).  Data-dependent output sizes are handled by
count-then-materialize with size-class capacity bucketing
(ops/compact.next_bucket).
"""
from __future__ import annotations

from dataclasses import replace
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .config import JoinAlgorithm, JoinConfig
from .dtypes import DataType, Type, is_dictionary_encoded
from .ops import compact as ops_compact
from .ops import gather as ops_gather
from .ops import groupby as ops_groupby
from .ops import join as ops_join
from .ops import setops as ops_setops
from .ops import sort as ops_sort
from .ops.hash_cuda import partition_ids_fused
from .status import Code, CylonError, Status
from .table import Column, Table, unify_dictionaries, unify_tables


def _gather_columns(tb: Table, indices: torch.Tensor, fill_null: bool,
                    prefix: str = "") -> List[Column]:
    out = []
    for c in tb.columns:
        data, validity = ops_gather.take(c.data, c.validity, indices,
                                         fill_null=fill_null)
        out.append(Column(prefix + c.name, c.dtype, data, validity,
                          dictionary=c.dictionary, arrow_type=c.arrow_type))
    return out


def _slice_columns(cols: List[Column], count: int) -> List[Column]:
    # slicing keeps a prefix, so the host copies slice along (a full-length
    # copy must never survive a shape change)
    return [replace(c, data=c.data[:count],
                    validity=None if c.validity is None else c.validity[:count],
                    host_data=None if c.host_data is None
                    else c.host_data[:count],
                    host_validity=None if c.host_validity is None
                    else c.host_validity[:count])
            for c in cols]


def _concat_columns(a: Column, b: Column, name: Optional[str] = None) -> Column:
    ca, cb = unify_dictionaries(a, b)
    data = torch.cat([ca.data, cb.data])
    if ca.validity is None and cb.validity is None:
        validity = None
    else:
        ones = lambda c: torch.ones(c.length, dtype=torch.bool,  # noqa: E731
                                    device=c.data.device)
        validity = torch.cat([ca.validity if ca.validity is not None else ones(ca),
                              cb.validity if cb.validity is not None else ones(cb)])
    return Column(name or ca.name, ca.dtype, data, validity,
                  dictionary=ca.dictionary, arrow_type=ca.arrow_type)


def _join_key_ranks(left: Table, right: Table,
                    left_idx: Sequence[Union[int, str]],
                    right_idx: Sequence[Union[int, str]]
                    ) -> Tuple[Table, Table, torch.Tensor, torch.Tensor]:
    """Type-check + dictionary-unify key columns, then dense-rank them."""
    l_ids = [left.column_names.index(i) if isinstance(i, str) else i
             for i in left_idx]
    r_ids = [right.column_names.index(i) if isinstance(i, str) else i
             for i in right_idx]
    for li, ri in zip(l_ids, r_ids):
        lt, rt = left.columns[li].dtype.type, right.columns[ri].dtype.type
        if lt != rt:
            raise CylonError(Status(Code.TypeError,
                f"join key type mismatch {lt.name} vs {rt.name}"))
    if any(is_dictionary_encoded(left.columns[i].dtype.type) for i in l_ids):
        left, right = unify_tables(left, right, l_ids, r_ids)
    lcols = [left.columns[i] for i in l_ids]
    rcols = [right.columns[i] for i in r_ids]
    lrank, rrank = ops_join.dense_ranks(
        tuple(c.data for c in lcols), tuple(c.validity for c in lcols),
        tuple(c.data for c in rcols), tuple(c.validity for c in rcols))
    return left, right, lrank, rrank


def join(left: Table, right: Table, config: JoinConfig) -> Table:
    """Local equi-join; output columns renamed ``lt-…`` / ``rt-…``
    (reference: join/join_utils.cpp:23-95 build_final_table)."""
    return join_on(left, right, [config.left_column_idx],
                   [config.right_column_idx], config.join_type.value,
                   config.algorithm)


def join_on(left: Table, right: Table,
            left_on: Sequence[Union[int, str]],
            right_on: Sequence[Union[int, str]],
            how: str = "inner",
            algorithm: JoinAlgorithm = JoinAlgorithm.SORT) -> Table:
    """Multi-column equi-join (composite keys via dense_ranks).

    Both algorithms run the same rank kernel locally; ``algorithm`` only
    changes the distributed strategy (parallel/dist_ops.py).
    """
    left, right, lk, rk = _join_key_ranks(left, right, left_on, right_on)
    total = int(ops_join.join_count(lk, rk, how))
    cap = ops_compact.next_bucket(total)
    li, ri, _ = ops_join.join_indices(lk, rk, how, cap)
    fill_left = how in ("right", "full_outer")
    fill_right = how in ("left", "full_outer")
    cols = (_gather_columns(left, li, fill_left, prefix="lt-")
            + _gather_columns(right, ri, fill_right, prefix="rt-"))
    return Table(left.ctx, _slice_columns(cols, total))


def _split_by_pids(t: Table, pid: torch.Tensor, n: int) -> List[Table]:
    """Rows → ``n`` tables by per-row partition id: one mask-compact per
    partition (the distributed path exchanges in one collective instead;
    parallel/shuffle.py)."""
    outs = []
    for p in range(n):
        idx, count = ops_compact.mask_to_indices(pid == p, t.num_rows)
        cols = _gather_columns(t, idx, fill_null=False)
        outs.append(Table(t.ctx, _slice_columns(cols, int(count))))
    return outs


def select(t: Table,
           predicate: Callable[[Dict[str, torch.Tensor]], torch.Tensor]
           ) -> Table:
    """Row filter: ``predicate`` maps {name: data tensor} → bool mask.
    The local select reads raw data (no null veto; the distributed
    ``dist_select`` applies SQL null semantics), as in the JAX package."""
    env = {c.name: c.data for c in t.columns}
    mask = predicate(env)
    if tuple(mask.shape) != (t.num_rows,):
        raise CylonError(Status(Code.Invalid,
            f"predicate mask shape {tuple(mask.shape)} != ({t.num_rows},)"))
    idx, count = ops_compact.mask_to_indices(mask, t.num_rows)
    out = _gather_columns(t, idx, fill_null=False)
    return Table(t.ctx, _slice_columns(out, int(count)))


def hash_partition(t: Table, hash_columns: Sequence[Union[int, str]],
                   no_of_partitions: int) -> List[Table]:
    """Split a local table into ``n`` tables by murmur3 row hash of
    ``hash_columns`` — the partitioner the distributed shuffle uses, through
    the same kernel wrapper, so co-partitioned outputs join shard-for-shard.
    reference: HashPartition (cpp/src/cylon/table_api.cpp:461-528)."""
    kcs = [t.column(c) for c in hash_columns]
    pid = partition_ids_fused(tuple(c.data for c in kcs),
                              tuple(c.validity for c in kcs), no_of_partitions)
    return _split_by_pids(t, pid, no_of_partitions)


def round_robin_partition(t: Table, no_of_partitions: int) -> List[Table]:
    """Split a local table into ``n`` similar-sized tables, row i →
    partition i mod n (reference Java surface: Table.java:166)."""
    pid = torch.arange(t.num_rows, dtype=torch.int32,
                       device=t.ctx.device) % no_of_partitions
    return _split_by_pids(t, pid, no_of_partitions)


def merge(tables: Sequence[Table]) -> Table:
    """Concatenate tables with identical schemas (reference Merge,
    table_api.cpp:404-423)."""
    if not tables:
        raise CylonError(Status(Code.Invalid, "merge of zero tables"))
    head = tables[0]
    for other in tables[1:]:
        head.verify_same_schema(other)
    cols = list(head.columns)
    for other in tables[1:]:
        cols = [_concat_columns(ca, cb) for ca, cb in zip(cols, other.columns)]
    return Table(head.ctx, cols)


# ---------------------------------------------------------------------------
# set ops (reference: table_api.cpp:530-902)
# ---------------------------------------------------------------------------

def _set_op(a: Table, b: Table, op: str) -> Table:
    a.verify_same_schema(b)
    n_a, n_b = a.num_rows, b.num_rows
    if n_a + n_b == 0:
        return a
    if n_a == 0:
        if op == ops_setops.UNION:
            return unique(b).rename(a.column_names)
        return a  # intersect/subtract of empty A is empty
    if n_b == 0 and op != ops_setops.UNION:
        if op == ops_setops.INTERSECT:
            return Table(a.ctx, _slice_columns(list(a.columns), 0))
        return unique(a)  # subtract: distinct rows of A

    concat = [_concat_columns(ca, cb)
              for ca, cb in zip(a.columns, b.columns)]
    idx, count = ops_setops.set_op_indices(
        tuple(c.data for c in concat), tuple(c.validity for c in concat),
        n_a, op)
    out = _gather_columns(Table(a.ctx, concat), idx, fill_null=False)
    return Table(a.ctx, _slice_columns(out, int(count)))


def union(a: Table, b: Table) -> Table:
    return _set_op(a, b, ops_setops.UNION)


def intersect(a: Table, b: Table) -> Table:
    return _set_op(a, b, ops_setops.INTERSECT)


def subtract(a: Table, b: Table) -> Table:
    return _set_op(a, b, ops_setops.SUBTRACT)


def unique(t: Table) -> Table:
    """Distinct rows of one table (union with an empty right side)."""
    if t.num_rows == 0:
        return t
    idx, count = ops_setops.set_op_indices(
        tuple(c.data for c in t.columns), tuple(c.validity for c in t.columns),
        t.num_rows, ops_setops.UNION)
    out = _gather_columns(t, idx, fill_null=False)
    return Table(t.ctx, _slice_columns(out, int(count)))


# ---------------------------------------------------------------------------
# sort (reference: table_api.cpp:404-459)
# ---------------------------------------------------------------------------

def sort(t: Table, sort_column: Union[int, str], ascending: bool = True) -> Table:
    """Order by one column, nulls last.  (Applies its indices — the
    reference's local Sort forgets to, table_api.cpp:446.)"""
    col = t.column(sort_column)
    order = ops_sort.sort_indices(col.data, col.validity, ascending)
    return Table(t.ctx, _gather_columns(t, order, fill_null=False))


def sort_multi(t: Table, sort_columns: Sequence[Union[int, str]],
               ascending=True) -> Table:
    """Stable multi-key local sort; ``ascending`` is one bool or a
    per-column sequence (ORDER BY mixed ASC/DESC), nulls last per key.

    When every column carries its host copy (a table just exported from a
    DTable, the ORDER-BY-then-return tail of most queries), the sort runs
    on those copies on the host: the result's host copies ride along, so
    its export reads nothing back.  The order is ``ops/sort
    .lexsort_indices``'s exactly (stable, per-key ASC/DESC, nulls last
    per key)."""
    cols = [t.column(c) for c in sort_columns]
    if all(c.host_data is not None
           and (c.validity is None or c.host_validity is not None)
           for c in t.columns):
        order = _host_lexsort(cols, ascending)
        idx = torch.from_numpy(order).to(t.ctx.device)
        out = []
        for c in t.columns:
            data, validity = ops_gather.take(c.data, c.validity, idx,
                                             fill_null=False)
            out.append(Column(
                c.name, c.dtype, data, validity, dictionary=c.dictionary,
                arrow_type=c.arrow_type,
                host_data=np.asarray(c.host_data)[order],
                host_validity=(None if c.validity is None else
                               np.asarray(c.host_validity, bool)[order])))
        return Table(t.ctx, out)
    order = ops_sort.lexsort_indices([c.data for c in cols],
                                     [c.validity for c in cols], ascending)
    return Table(t.ctx, _gather_columns(t, order, fill_null=False))


def _host_lexsort(cols: Sequence[Column], ascending) -> np.ndarray:
    """Stable lexsort order of the columns' host copies (int64): per key
    ASC/DESC, a null flag outranking its key value (nulls last)."""
    asc = ([ascending] * len(cols) if isinstance(ascending, bool)
           else list(ascending))
    flat = []
    for i, c in reversed(list(enumerate(cols))):
        k = np.asarray(c.host_data)
        if not asc[i]:
            # the order-inverting transform of ops/sort (negation would
            # wrap INT64_MIN and uint64 values past 2^63)
            if k.dtype.kind == "i" or k.dtype == np.bool_:
                k = ~k
            elif k.dtype.kind == "u":
                k = np.iinfo(k.dtype).max - k
            else:
                k = -k.astype(np.float64)
        flat.append(k)
        if c.validity is not None:
            flat.append(~np.asarray(c.host_validity, bool))
    return np.lexsort(tuple(flat)).astype(np.int64)


# ---------------------------------------------------------------------------
# groupby-aggregate (BASELINE.json config 3; absent in reference v0)
# ---------------------------------------------------------------------------

def groupby(t: Table, key_columns: Sequence[Union[int, str]],
            aggregations: Sequence[Tuple[Union[int, str], str]]) -> Table:
    """Group by key columns and aggregate: ``aggregations = [(col, op),
    ...]`` with op ∈ {sum, count, mean, min, max}.  Output columns: the key
    columns, then ``{op}_{col}`` per aggregation (pandas naming).  Groups
    come out in key order, the null-key group last."""
    if t.num_rows == 0:
        # the JAX package's empty branch: aggregation columns keep the
        # INPUT column's type here (not ``_agg_output_type``)
        kcols = [t.column(c) for c in key_columns]
        acols = []
        for c, op in aggregations:
            base = t.column(c)
            acols.append(Column(f"{op}_{base.name}", base.dtype,
                                base.data[:0]))
        return Table(t.ctx, [k.with_data(k.data[:0], validity=None)
                             for k in kcols] + acols)
    kcols = [t.column(c) for c in key_columns]
    vcols = [t.column(c) for c, _ in aggregations]
    aggs = tuple(op for _, op in aggregations)
    for op in aggs:
        if op not in ops_groupby.AGG_OPS:
            raise CylonError(Status(Code.Invalid,
                                    f"unknown aggregation {op!r}"))
    key_idx, outs, out_valids, count = ops_groupby.groupby_aggregate(
        tuple(c.data for c in kcols), tuple(c.validity for c in kcols),
        tuple(c.data for c in vcols), tuple(c.validity for c in vcols), aggs)
    total = int(count)
    out_cols = _slice_columns(
        _gather_columns(Table(t.ctx, kcols), key_idx, fill_null=False), total)
    for (cref, op), arr, validity in zip(aggregations, outs, out_valids):
        base = t.column(cref)
        out_cols.append(Column(
            f"{op}_{base.name}", DataType(_agg_output_type(base.dtype.type, op)),
            arr[:total], None if validity is None else validity[:total]))
    return Table(t.ctx, out_cols)


def _agg_output_type(in_type: Type, op: str) -> Type:
    """Logical type of an aggregation's output column."""
    if op == "count":
        return Type.INT64
    if op == "mean":
        return Type.DOUBLE
    if op == "sum" and in_type not in (Type.FLOAT, Type.DOUBLE,
                                       Type.HALF_FLOAT):
        return Type.INT64
    return in_type
