"""Row accessor: typed per-cell reads of one table row.

Mirror of ``cylon_tpu/row.py`` (reference: cpp/src/cylon/row.hpp:22-50 — a
(table id, row index) pair with one GetXxx per data type, resolved through
the global table registry).  Here the row holds the Table object itself,
and a cell read is a single-element device fetch (or a read of the
column's host copy, when it carries one) — Row is a debugging / interop
convenience, not a compute path; columnar ops are the unit of work.

Python is dynamically typed, so one ``get`` suffices; the typed GetXxx
aliases are kept source-compatible with the reference and verify the
column's logical type before returning.
"""
from __future__ import annotations

from typing import Any, Union

import numpy as np

from .dtypes import Type, is_dictionary_encoded
from .status import Code, CylonError, Status


class Row:
    """One row of a local Table; cells fetch lazily per access."""

    def __init__(self, table, row_index: int):
        n = table.num_rows
        if not -n <= row_index < n:
            raise CylonError(Status(Code.IndexError,
                f"row {row_index} out of range for {n}-row table"))
        self._table = table
        self._i = row_index % n if n else 0

    def row_index(self) -> int:
        return self._i

    RowIndex = row_index  # reference spelling (row.hpp:29)

    # -- generic access ------------------------------------------------------

    def get(self, col: Union[int, str]) -> Any:
        """Cell value as a Python scalar; None for a null cell; strings
        decode through the column dictionary."""
        c = self._table.column(col)
        # a per-cell accessor IS a host read by contract: the one place
        # the blocking transfer is the requested behaviour
        if c.validity is not None:
            ok = (c.host_validity[self._i] if c.host_validity is not None
                  else c.validity[self._i].item())
            if not bool(ok):
                return None
        v = (c.host_data[self._i] if c.host_data is not None
             else c.data[self._i].cpu().numpy())
        if is_dictionary_encoded(c.dtype.type):
            s = c.dictionary[int(v)]
            return s.decode() if isinstance(s, bytes) else str(s)
        return np.asarray(v)[()].item()

    def __getitem__(self, col: Union[int, str]) -> Any:
        return self.get(col)

    def values(self) -> tuple:
        return tuple(self.get(i) for i in range(self._table.num_columns))

    def __repr__(self) -> str:
        return f"Row({self._i}: {self.values()!r})"

    # -- typed accessors (reference row.hpp:30-49) ---------------------------

    def _typed(self, col, *types):
        c = self._table.column(col)
        if c.dtype.type not in types:
            raise CylonError(Status(Code.TypeError,
                f"column {c.name!r} is {c.dtype.type.name}, expected "
                f"{'/'.join(t.name for t in types)}"))
        return self.get(col)

    def get_bool(self, col):
        return self._typed(col, Type.BOOL)

    def get_int8(self, col):
        return self._typed(col, Type.INT8)

    def get_uint8(self, col):
        return self._typed(col, Type.UINT8)

    def get_int16(self, col):
        return self._typed(col, Type.INT16)

    def get_uint16(self, col):
        return self._typed(col, Type.UINT16)

    def get_int32(self, col):
        return self._typed(col, Type.INT32)

    def get_uint32(self, col):
        return self._typed(col, Type.UINT32)

    def get_int64(self, col):
        return self._typed(col, Type.INT64, Type.INT32)

    def get_uint64(self, col):
        return self._typed(col, Type.UINT64, Type.UINT32)

    def get_half_float(self, col):
        return self._typed(col, Type.HALF_FLOAT)

    def get_float(self, col):
        return self._typed(col, Type.FLOAT)

    def get_double(self, col):
        return self._typed(col, Type.DOUBLE, Type.FLOAT)

    def get_string(self, col):
        return self._typed(col, Type.STRING)

    def get_binary(self, col):
        return self._typed(col, Type.BINARY)

    def get_date32(self, col):
        return self._typed(col, Type.DATE32)

    def get_date64(self, col):
        return self._typed(col, Type.DATE64)

    def get_timestamp(self, col):
        return self._typed(col, Type.TIMESTAMP)

    def get_time32(self, col):
        return self._typed(col, Type.TIME32)

    def get_time64(self, col):
        return self._typed(col, Type.TIME64)
