"""Device-resident columnar Table.

A Table is a plain Python object holding **device tensors**: per column a
fixed-width data tensor + optional bool validity tensor (reference:
cpp/src/cylon/table.hpp:39-278 keeps ``arrow::Table`` in host RAM instead).

Strings/binary are **dictionary-encoded at ingest** (host side): the device
stores int32 codes, the host stores the dictionary.  The dictionary is sorted,
so code order == lexical order — sorts and comparisons work directly on codes.
Cross-table ops on string columns first *unify* dictionaries (sorted union +
code remap) so equal strings have equal codes in both tables.

Null semantics follow the reference: hash of null is 0 and a −1 gather index
appends null (reference: arrow/arrow_partition_kernels.hpp:55-57,93-95,
util/copy_arrray.cpp:38-43).

``from_columns`` builds a table from numpy arrays with no pyarrow;
``from_arrow`` / ``from_pandas`` / ``to_arrow`` / ``to_pandas`` import
pyarrow (and pandas) only when called.

A column may carry host copies of its data and validity
(``host_data`` / ``host_validity``) when its producer already holds them
(Arrow ingest, a DTable export): ``to_arrow`` reads those instead of
pulling the device tensors back.  Every site that derives a column with
new contents goes through ``Column.with_data``, which drops the copies.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .context import CylonContext
from .dtypes import (DataType, Type, from_arrow_type, is_dictionary_encoded,
                     numpy_dtype, to_arrow_type)
from .status import Code, CylonError, Status


# "keep the current value" marker of Column.with_data, compared by
# identity (the real operands are tensors and arrays)
_SAME = object()


@dataclass
class Column:
    """One column: logical type + device data (+ validity, + host dictionary).

    reference: cpp/src/cylon/column.hpp:163-193 — but data lives on device.
    """

    name: str
    dtype: DataType
    data: torch.Tensor                       # [n] (codes for strings)
    validity: Optional[torch.Tensor] = None  # [n] bool; None = all valid
    dictionary: Optional[np.ndarray] = None  # host payload for STRING/BINARY
    arrow_type: Any = None                   # original pyarrow type
    # host copies of data / validity when the producer already paid the
    # transfer (ingest, a DTable export): to_arrow reads these instead of
    # pulling the device tensors back
    host_data: Optional[np.ndarray] = None
    host_validity: Optional[np.ndarray] = None

    def __post_init__(self):
        if is_dictionary_encoded(self.dtype.type) and self.dictionary is None:
            self.dictionary = np.empty((0,), dtype=object)

    @property
    def length(self) -> int:
        return int(self.data.shape[0])

    def has_nulls(self) -> bool:
        return self.validity is not None

    def with_data(self, data, validity=_SAME, dictionary=_SAME) -> "Column":
        """THE way to derive a column with new contents: the host copies
        are dropped, so ``to_arrow`` can never export a copy of the old
        contents (``to_arrow`` also checks this on every export)."""
        v = self.validity if validity is _SAME else validity
        d = self.dictionary if dictionary is _SAME else dictionary
        return replace(self, data=data, validity=v, dictionary=d,
                       host_data=None, host_validity=None)


def host_batch(tensors: Sequence[torch.Tensor]) -> List[np.ndarray]:
    """Host numpy copies of ``tensors`` in ONE batched transfer: on the
    card every copy is queued ``non_blocking`` into page-locked memory and
    the host waits once; CPU tensors are read in place."""
    if not tensors:
        return []
    dev = tensors[0].device
    if dev.type != "cuda":
        return [t.numpy() for t in tensors]
    hosts = [t.to("cpu", non_blocking=True) for t in tensors]
    torch.cuda.current_stream(dev).synchronize()
    return [h.numpy() for h in hosts]


def _to_device(npv: np.ndarray, device: torch.device) -> torch.Tensor:
    npv = np.ascontiguousarray(npv)
    if not npv.flags.writeable:  # zero-copy Arrow buffers are read-only
        npv = npv.copy()
    return torch.from_numpy(npv).to(device)


def _encode_values(values: np.ndarray, null: np.ndarray
                   ) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """Sorted-dictionary encode of host values; ``null`` marks null rows.

    Returns (codes int32, dictionary, validity-or-None).  Sorted dictionary ⇒
    code order == lexical order.  Null rows get code 0.
    """
    valid_values = values[~null]
    if len(valid_values):
        dictionary, codes_valid = np.unique(valid_values, return_inverse=True)
    else:
        dictionary = np.empty((0,), object)
        codes_valid = np.empty((0,), np.int32)
    codes = np.zeros(len(values), dtype=np.int32)
    codes[~null] = codes_valid.astype(np.int32)
    validity = None if not null.any() else ~null
    return codes, dictionary.astype(object), validity


def _encode_dictionary(arr):
    """Host-side sorted-dictionary encode of a string/binary arrow array."""
    values = arr.to_numpy(zero_copy_only=False)  # object ndarray, None for null
    null = ~np.asarray(arr.is_valid().to_numpy(zero_copy_only=False), dtype=bool)
    return _encode_values(values, null)


def _typed_numpy(arr, npd: np.dtype) -> np.ndarray:
    """Arrow array -> numpy of exactly ``npd`` without lossy intermediates.

    Temporal arrays come back as datetime64/timedelta64; reinterpret the
    underlying int64 rather than casting.  time32/time64 come back as object
    arrays of datetime.time — cast those to their integer storage inside
    arrow first.
    """
    import pyarrow as pa

    npv = arr.to_numpy(zero_copy_only=False)
    if npv.dtype.kind in "mM":
        npv = npv.view(np.int64)
    elif npv.dtype.kind == "O":
        target = pa.int64() if npd.itemsize == 8 else pa.int32()
        npv = arr.cast(target).to_numpy(zero_copy_only=False)
    return np.ascontiguousarray(npv).astype(npd, copy=False)


def host_columns_from_arrow(atable):
    """Arrow table → ``[(name, Type, np data, np validity|None,
    dictionary|None, arrow value type), …]``, decoded, null-filled and
    dictionary-encoded on the host.  64-bit types stay 64-bit."""
    import pyarrow as pa
    import pyarrow.compute as pc

    out = []
    for fld, col in zip(atable.schema, atable.columns):
        t = from_arrow_type(fld.type)
        arr = col
        if isinstance(col, pa.ChunkedArray):
            # one chunk is used as it is: combine_chunks would copy it
            arr = col.chunk(0) if col.num_chunks == 1 else col.combine_chunks()
        ftype = fld.type
        if pa.types.is_dictionary(ftype):
            arr = arr.cast(ftype.value_type)
            ftype = ftype.value_type
        if is_dictionary_encoded(t):
            codes, dictionary, validity = _encode_dictionary(arr)
            out.append((fld.name, t, codes, validity, dictionary, ftype))
            continue
        npd = numpy_dtype(t)
        if arr.null_count:
            mask = np.asarray(
                arr.is_valid().to_numpy(zero_copy_only=False), dtype=bool)
            fill = False if t == Type.BOOL else 0
            filled = pc.fill_null(arr, pa.scalar(fill, type=arr.type))
            out.append((fld.name, t, _typed_numpy(filled, npd), mask, None,
                        ftype))
        else:
            out.append((fld.name, t, _typed_numpy(arr, npd), None, None,
                        ftype))
    return out


_TYPE_OF_NUMPY = {
    "bool": Type.BOOL,
    "uint8": Type.UINT8, "int8": Type.INT8,
    "uint16": Type.UINT16, "int16": Type.INT16,
    "uint32": Type.UINT32, "int32": Type.INT32,
    "uint64": Type.UINT64, "int64": Type.INT64,
    "float16": Type.HALF_FLOAT, "float32": Type.FLOAT, "float64": Type.DOUBLE,
}


def _host_column_from_numpy(name: str, npa: np.ndarray):
    """One numpy column → (Type, np data, np validity|None, dictionary|None).

    Object arrays of str (or bytes) and numpy unicode (bytes) arrays are
    dictionary-encoded, with ``None`` as null."""
    if npa.dtype.kind in "US":
        npa = npa.astype(object)
    if npa.dtype == object:
        null = np.array([v is None for v in npa], dtype=bool)
        kinds = {type(v) for v in npa[~null]}
        if kinds <= {str}:
            t = Type.STRING
        elif kinds <= {bytes}:
            t = Type.BINARY
        else:
            raise CylonError(Status(Code.NotImplemented,
                f"column {name!r}: object values of types "
                f"{sorted(k.__name__ for k in kinds)} (only str or bytes)"))
        codes, dictionary, validity = _encode_values(npa, null)
        return t, codes, validity, dictionary
    try:
        t = _TYPE_OF_NUMPY[np.dtype(npa.dtype).name]
    except KeyError:
        raise CylonError(Status(Code.NotImplemented,
            f"column {name!r}: unsupported numpy dtype {npa.dtype!r} "
            "(use from_arrow for temporal/other types)")) from None
    return t, npa.astype(numpy_dtype(t), copy=False), None, None


class Table:
    """Columnar table on device; ops produce new Tables.

    reference: cpp/src/cylon/table.hpp:39-278 (handle façade)
    """

    def __init__(self, ctx: CylonContext, columns: List[Column]):
        if columns:
            n = columns[0].length
            for c in columns:
                if c.length != n:
                    raise CylonError(Status(Code.Invalid,
                        f"column {c.name!r} length {c.length} != {n}"))
        self.ctx = ctx
        self.columns: List[Column] = columns

    # -- shape ---------------------------------------------------------------

    @property
    def num_rows(self) -> int:
        return self.columns[0].length if self.columns else 0

    @property
    def num_columns(self) -> int:
        return len(self.columns)

    @property
    def column_names(self) -> List[str]:
        return [c.name for c in self.columns]

    def column(self, i: Union[int, str]) -> Column:
        if isinstance(i, str):
            for c in self.columns:
                if c.name == i:
                    return c
            raise CylonError(Status(Code.KeyError, f"no column {i!r}"))
        return self.columns[i]

    def row(self, i: int):
        """Typed accessor for one row (reference: row.hpp:22-50)."""
        from .row import Row

        return Row(self, i)

    def iter_rows(self):
        for i in range(self.num_rows):
            yield self.row(i)

    # -- construction --------------------------------------------------------

    @staticmethod
    def _from_host(ctx: CylonContext, host_cols, keep_host: bool = False
                   ) -> "Table":
        """Host tuples → device columns; ``keep_host`` caches the host
        values on each column, so an export pulls nothing back."""
        cols = []
        for name, t, npv, mask, dictionary, ftype in host_cols:
            cols.append(Column(
                name, DataType(t), _to_device(npv, ctx.device),
                None if mask is None else _to_device(mask, ctx.device),
                dictionary=dictionary, arrow_type=ftype,
                host_data=np.asarray(npv) if keep_host else None,
                host_validity=(np.asarray(mask) if keep_host
                               and mask is not None else None)))
        return Table(ctx, cols)

    @staticmethod
    def from_columns(ctx: CylonContext, data: Dict[str, Any]) -> "Table":
        """Build from a dict of name -> numpy array (no pyarrow needed)."""
        host = []
        for name, arr in data.items():
            t, npv, mask, dictionary = _host_column_from_numpy(
                name, np.asarray(arr))
            host.append((name, t, npv, mask, dictionary, None))
        return Table._from_host(ctx, host)

    @staticmethod
    def from_arrow(ctx: CylonContext, atable) -> "Table":
        """Ingest a pyarrow Table (host→device transfer happens here).

        reference: table.cpp (FromArrowTable) + type validation
        arrow/arrow_types.cpp:57-114.
        """
        return Table._from_host(ctx, host_columns_from_arrow(atable),
                                keep_host=True)

    @staticmethod
    def from_pandas(ctx: CylonContext, df) -> "Table":
        import pyarrow as pa

        return Table.from_arrow(ctx, pa.Table.from_pandas(df, preserve_index=False))

    # -- export --------------------------------------------------------------

    def to_arrow(self):
        """Device→host; decode dictionaries; reattach nulls.

        Columns that carry host copies transfer nothing; every column
        missing one is pulled in ONE batched transfer."""
        import pyarrow as pa

        for c in self.columns:
            # host-cache staleness guard, always on: a cache may only sit
            # beside the tensor it was copied from (every contents change
            # goes through Column.with_data, which drops it); a length
            # mismatch is the cheap observable of a violation
            if c.host_data is not None \
                    and c.host_data.shape[0] != c.length:
                raise CylonError(Status(Code.ExecutionError,
                    f"stale host_data cache on column {c.name!r} "
                    f"({c.host_data.shape[0]} host vs {c.length} device "
                    "rows) — derive columns via Column.with_data"))
            if c.host_validity is not None and (
                    c.validity is None
                    or c.host_validity.shape[0] != c.length):
                raise CylonError(Status(Code.ExecutionError,
                    f"stale host_validity cache on column {c.name!r} — "
                    "derive columns via Column.with_data"))
        pulls, slots = [], []
        for i, c in enumerate(self.columns):
            if c.host_data is None:
                pulls.append(c.data)
                slots.append((i, False))
            if c.validity is not None and c.host_validity is None:
                pulls.append(c.validity)
                slots.append((i, True))
        got = dict(zip(slots, host_batch(pulls)))

        arrays, names = [], []
        for i, c in enumerate(self.columns):
            host = (c.host_data if c.host_data is not None
                    else got[(i, False)])
            if c.validity is None:
                mask = None
            else:
                hv = (c.host_validity if c.host_validity is not None
                      else got[(i, True)])
                mask = ~np.asarray(hv, dtype=bool)
            if is_dictionary_encoded(c.dtype.type):
                vals = (c.dictionary[np.clip(host, 0, max(len(c.dictionary) - 1, 0))]
                        if len(c.dictionary)
                        else np.full(len(host), None, dtype=object))
                arrays.append(pa.array(vals, type=to_arrow_type(
                    c.dtype.type, orig=c.arrow_type), mask=mask))
            elif c.dtype.type == Type.BOOL:
                arrays.append(pa.array(host.astype(bool), type=pa.bool_(),
                                       mask=mask))
            else:
                at = to_arrow_type(c.dtype.type, orig=c.arrow_type)
                arrays.append(pa.array(host, type=at, mask=mask))
            names.append(c.name)
        return pa.table(arrays, names=names)

    def _verify_host_caches(self) -> None:
        """Content check of every host copy against its device tensor
        (the device is the truth): a copy that disagrees is a contents
        change that bypassed ``Column.with_data``.  Costs a full pull."""
        checks = []
        for c in self.columns:
            if c.host_data is not None:
                checks.append((c.name, "host_data", c.host_data, c.data))
            if c.host_validity is not None:
                checks.append((c.name, "host_validity", c.host_validity,
                               c.validity))
        fresh = host_batch([d for _, _, _, d in checks])
        for (name, kind, cached, _), dev in zip(checks, fresh):
            if not np.array_equal(np.asarray(cached), dev):
                raise CylonError(Status(Code.ExecutionError,
                    f"{kind} cache on column {name!r} disagrees with the "
                    "device tensor — a contents change bypassed "
                    "Column.with_data"))

    def to_pandas(self):
        return self.to_arrow().to_pandas()

    # -- schema --------------------------------------------------------------

    def schema_types(self) -> List[Type]:
        return [c.dtype.type for c in self.columns]

    def verify_same_schema(self, other: "Table") -> None:
        """Column-count + per-column logical type equality.

        reference: table_api.cpp:566 (VerifyTableSchema)
        """
        if self.num_columns != other.num_columns:
            raise CylonError(Status(Code.Invalid,
                f"column count mismatch {self.num_columns} vs {other.num_columns}"))
        for a, b in zip(self.columns, other.columns):
            if a.dtype.type != b.dtype.type:
                raise CylonError(Status(Code.TypeError,
                    f"type mismatch {a.name}:{a.dtype.type.name} vs "
                    f"{b.name}:{b.dtype.type.name}"))

    # -- convenience ---------------------------------------------------------

    def project(self, indices: Sequence[Union[int, str]]) -> "Table":
        """Zero-copy column subset (reference: table_api.cpp:1007-1026)."""
        return Table(self.ctx, [self.column(i) for i in indices])

    def rename(self, names: Sequence[str]) -> "Table":
        return Table(self.ctx, [replace(c, name=n)
                                for c, n in zip(self.columns, names)])

    def rename_column(self, old: str, new: str) -> "Table":
        return self.rename([new if c.name == old else c.name
                            for c in self.columns])

    def to_string(self, row1: int = 0, row2: Optional[int] = None,
                  col1: int = 0, col2: Optional[int] = None) -> str:
        """A window of the table, formatted (reference: table_api.cpp
        PrintToOStream, the stringify behind Print / WriteCSV)."""
        df = self.to_pandas()
        row2 = df.shape[0] if row2 is None else row2
        col2 = df.shape[1] if col2 is None else col2
        return df.iloc[row1:row2, col1:col2].to_string(index=False)

    def show(self, row1: int = 0, row2: Optional[int] = None,
             col1: int = 0, col2: Optional[int] = None) -> None:
        """Print a window of the table (reference: table_api.cpp Print*)."""
        print(self.to_string(row1, row2, col1, col2))

    def __repr__(self) -> str:
        cols = ", ".join(f"{c.name}:{c.dtype.type.name}" for c in self.columns)
        return f"Table[{self.num_rows} x {self.num_columns}]({cols})"


# ---------------------------------------------------------------------------
# dictionary unification (cross-table string ops)
# ---------------------------------------------------------------------------

def remap_dictionaries(da: np.ndarray, db: np.ndarray):
    """Two sorted dictionaries → (merged, code map of a, code map of b) or
    None when they are already the same dictionary."""
    if da is db or (len(da) == len(db) and bool(np.all(da == db))):
        return None
    merged = np.unique(np.concatenate([da, db]))
    return (merged, np.searchsorted(merged, da).astype(np.int32),
            np.searchsorted(merged, db).astype(np.int32))


def remap_codes(codes: torch.Tensor, code_map: np.ndarray) -> torch.Tensor:
    """Apply a dictionary's code map on device (no-op for an empty map)."""
    if not len(code_map):
        return codes
    m = torch.from_numpy(code_map).to(codes.device)
    return m[codes.long()]


def unify_dictionaries(a: Column, b: Column) -> Tuple[Column, Column]:
    """Re-encode two dictionary columns onto one shared sorted dictionary.

    Equal strings get equal codes in both columns, and code order stays
    lexical — after this, joins treat the column as plain int32.
    """
    if not (is_dictionary_encoded(a.dtype.type)
            and is_dictionary_encoded(b.dtype.type)):
        return a, b
    got = remap_dictionaries(a.dictionary, b.dictionary)
    if got is None:
        return a, b
    merged, map_a, map_b = got
    return (a.with_data(remap_codes(a.data, map_a), dictionary=merged),
            b.with_data(remap_codes(b.data, map_b), dictionary=merged))


def unify_tables(left: Table, right: Table,
                 left_cols: Sequence[int], right_cols: Sequence[int]
                 ) -> Tuple[Table, Table]:
    """Unify dictionaries for the given column pairs across two tables."""
    lcols, rcols = list(left.columns), list(right.columns)
    for li, ri in zip(left_cols, right_cols):
        lcols[li], rcols[ri] = unify_dictionaries(lcols[li], rcols[ri])
    return Table(left.ctx, lcols), Table(right.ctx, rcols)

