"""pycylon.data.table over the port — source-compatible Table + csv_reader.

reference: python/pycylon/data/table.pyx:37-350 and docs/docs/python.md:12-58.
Same signatures, dispatching to cylon_tpu_torch: local ops run the port's
local kernels; ``distributed_*`` ops block-distribute the table over the
context's row shards (``DTable.from_table``), run the distributed
operator (the HASH join and the set ops through the partition-hash
kernel) and gather back (``to_table``).

The uuid registry mirrors the reference's id-addressed table registry
(cpp/src/cylon/table_api.cpp:45-73, python/table_cython.cpp:38-325), which
exists to serve FFI boundaries; nothing inside the engine uses ids.
"""
from __future__ import annotations

import uuid
import weakref
from typing import Optional

from ... import compute as _compute
from ...io import CSVReadOptions, read_csv, write_csv
from ...parallel import (DTable, dist_intersect, dist_join, dist_sort,
                         dist_subtract, dist_union)
from ...status import Code, CylonError
from ...table import Table as _Table
from ..common.join_config import resolve as _resolve_jc
from ..common.status import Status
from ..ctx.context import CylonContext

# Weak-valued so tables free when their last handle drops — the
# reference's registry needs explicit RemoveTable calls; device-resident
# columns must not leak on the id path.
_registry: "weakref.WeakValueDictionary[str, _Table]" = \
    weakref.WeakValueDictionary()
_default_ctx: Optional[CylonContext] = None


def _get_default_ctx() -> CylonContext:
    """Module-global local context on the card, mirroring the reference's
    context cache (cpp/src/cylon/python/table_cython.cpp:36
    ``context_map``)."""
    global _default_ctx
    if _default_ctx is None:
        _default_ctx = CylonContext(None)
    return _default_ctx


def get_table(table_id: str) -> "_Table":
    """Registry lookup (reference: table_api.cpp:45-57 GetTable)."""
    try:
        return _registry[table_id]
    except KeyError:
        raise CylonError(Status(Code.KeyError, f"no table {table_id!r}"))


class Table:
    """Compat handle: a uuid + the backing device-resident table."""

    def __init__(self, backing, table_id: Optional[str] = None):
        if isinstance(backing, (str, bytes)):
            # reference-style Table(id) ctor: resolve through the registry
            tid = backing.decode() if isinstance(backing, bytes) else backing
            self._t = get_table(tid)
            self._id = tid
            return
        self._t = backing
        self._id = table_id or str(uuid.uuid4())
        _registry[self._id] = backing

    # -- metadata (table.pyx:141-190) ----------------------------------------

    @property
    def id(self) -> str:
        return self._id

    @property
    def columns(self) -> int:
        return self._t.num_columns

    @property
    def rows(self) -> int:
        return self._t.num_rows

    @property
    def column_names(self):
        return self._t.column_names

    def row(self, i: int):
        """Typed per-cell accessor (reference Row, cpp/src/cylon/row.hpp)."""
        return self._t.row(i)

    def show(self):
        self._t.show()

    def show_by_range(self, row1: int, row2: int, col1: int, col2: int):
        self._t.show(row1, row2, col1, col2)

    def to_csv(self, path: str) -> Status:
        try:
            write_csv(self._t, path)
            return Status(Code.OK)
        except (OSError, CylonError) as e:
            return Status(Code.IOError, str(e))

    # -- local relational ops (table.pyx:193-306) ----------------------------

    def join(self, ctx: CylonContext, table: "Table", join_type: str = "inner",
             algorithm: str = "hash", left_col: int = 0, right_col: int = 0
             ) -> "Table":
        cfg = _resolve_jc(join_type, algorithm, left_col, right_col)
        return Table(_compute.join(self._t, table._t, cfg))

    def union(self, ctx: CylonContext, table: "Table") -> "Table":
        return Table(_compute.union(self._t, table._t))

    def intersect(self, ctx: CylonContext, table: "Table") -> "Table":
        return Table(_compute.intersect(self._t, table._t))

    def subtract(self, ctx: CylonContext, table: "Table") -> "Table":
        return Table(_compute.subtract(self._t, table._t))

    def sort(self, ctx: CylonContext, column) -> "Table":
        return Table(_compute.sort(self._t, column))

    # -- distributed ops ------------------------------------------------------

    def _dist(self, ctx: CylonContext) -> DTable:
        return DTable.from_table(ctx, self._t)

    def distributed_join(self, ctx: CylonContext, table: "Table",
                         join_type: str = "inner", algorithm: str = "hash",
                         left_col: int = 0, right_col: int = 0) -> "Table":
        cfg = _resolve_jc(join_type, algorithm, left_col, right_col)
        out = dist_join(self._dist(ctx), table._dist(ctx), cfg)
        return Table(out.to_table())

    def distributed_union(self, ctx: CylonContext, table: "Table") -> "Table":
        return Table(dist_union(self._dist(ctx), table._dist(ctx)).to_table())

    def distributed_intersect(self, ctx: CylonContext, table: "Table"
                              ) -> "Table":
        return Table(dist_intersect(self._dist(ctx),
                                    table._dist(ctx)).to_table())

    def distributed_subtract(self, ctx: CylonContext, table: "Table"
                             ) -> "Table":
        return Table(dist_subtract(self._dist(ctx),
                                   table._dist(ctx)).to_table())

    def distributed_sort(self, ctx: CylonContext, column) -> "Table":
        return Table(dist_sort(self._dist(ctx), column).to_table())

    # -- interop (table.pyx:308-341) -----------------------------------------

    @staticmethod
    def from_arrow(obj, ctx: Optional[CylonContext] = None) -> "Table":
        return Table(_Table.from_arrow(ctx or _get_default_ctx(), obj))

    @staticmethod
    def to_arrow(tx_table: "Table"):
        return tx_table._t.to_arrow()

    @staticmethod
    def from_pandas(df, ctx: Optional[CylonContext] = None) -> "Table":
        return Table(_Table.from_pandas(ctx or _get_default_ctx(), df))

    def to_pandas(self):
        return self._t.to_pandas()

    @property
    def backing(self) -> "_Table":
        """The underlying cylon_tpu_torch.Table (escape hatch, not in the
        reference)."""
        return self._t


class csv_reader:
    """reference: python/pycylon/data/table.pyx:343-350 (cdef class
    csv_reader with a static ``read``)."""

    @staticmethod
    def read(ctx: CylonContext, path: str, delimiter: str = ",") -> Table:
        return Table(read_csv(ctx, path,
                              CSVReadOptions().WithDelimiter(delimiter)))
