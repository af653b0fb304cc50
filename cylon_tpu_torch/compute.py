"""Local (single-device) table operations: join, set ops, sort and hash
partition.

Mirror of that part of ``cylon_tpu/compute.py`` (reference:
cpp/src/cylon/table_api.cpp JoinTables → join/join.cpp, set ops
:530-902, Sort :404-459, HashPartition :461-528).  Data-dependent output sizes are handled by
count-then-materialize with size-class capacity bucketing
(ops/compact.next_bucket).
"""
from __future__ import annotations

from dataclasses import replace
from typing import List, Optional, Sequence, Tuple, Union

import torch

from .config import JoinAlgorithm, JoinConfig
from .dtypes import is_dictionary_encoded
from .ops import compact as ops_compact
from .ops import gather as ops_gather
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
    return [replace(c, data=c.data[:count],
                    validity=None if c.validity is None else c.validity[:count])
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
    per-column sequence (ORDER BY mixed ASC/DESC), nulls last per key."""
    cols = [t.column(c) for c in sort_columns]
    order = ops_sort.lexsort_indices([c.data for c in cols],
                                     [c.validity for c in cols], ascending)
    return Table(t.ctx, _gather_columns(t, order, fill_null=False))
