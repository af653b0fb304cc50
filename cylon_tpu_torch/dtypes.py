"""Logical column types, independent of both Arrow and PyTorch.

Mirrors the reference's Arrow-independent type enum + layout
(reference: cpp/src/cylon/data_types.hpp:89-192) and adds the device-side
physical mapping each logical type uses:

* fixed-width numerics map 1:1 to a torch dtype; 64-bit types stay 64-bit;
* BOOL is stored as int8 on device (the JAX package's layout, kept so the
  two packages hash and compare the same bytes);
* STRING / BINARY are dictionary-encoded at ingest: the device holds int32
  codes whose order equals lexical order (dictionary is sorted at encode
  time), the host holds the dictionary payload.  See table.py.

pyarrow is imported only inside the Arrow interop functions: the package
runs without it.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass

import numpy as np
import torch


class Layout(enum.IntEnum):
    """reference: cpp/src/cylon/data_types.hpp (Layout)."""

    FIXED_WIDTH = 1
    VARIABLE_WIDTH = 2


class Type(enum.IntEnum):
    """Logical types (reference: cpp/src/cylon/data_types.hpp:89-192)."""

    BOOL = 0
    UINT8 = 1
    INT8 = 2
    UINT16 = 3
    INT16 = 4
    UINT32 = 5
    INT32 = 6
    UINT64 = 7
    INT64 = 8
    HALF_FLOAT = 9
    FLOAT = 10
    DOUBLE = 11
    STRING = 12
    BINARY = 13
    FIXED_SIZE_BINARY = 14
    DATE32 = 15
    DATE64 = 16
    TIMESTAMP = 17
    TIME32 = 18
    TIME64 = 19
    INTERVAL = 20
    DECIMAL = 21
    LIST = 22
    EXTENSION = 23
    DURATION = 24


@dataclass(frozen=True)
class DataType:
    """A logical type + its storage layout.

    reference: cpp/src/cylon/data_types.hpp (DataType / Make*)
    """

    type: Type

    @property
    def layout(self) -> Layout:
        if self.type in (Type.STRING, Type.BINARY, Type.LIST):
            return Layout.VARIABLE_WIDTH
        return Layout.FIXED_WIDTH


# ---------------------------------------------------------------------------
# physical (device) dtype mapping
# ---------------------------------------------------------------------------

_NUMPY_OF = {
    Type.BOOL: np.int8,  # byte mask on device; re-boxed to bool at to_arrow
    Type.UINT8: np.uint8,
    Type.INT8: np.int8,
    Type.UINT16: np.uint16,
    Type.INT16: np.int16,
    Type.UINT32: np.uint32,
    Type.INT32: np.int32,
    Type.UINT64: np.uint64,
    Type.INT64: np.int64,
    Type.HALF_FLOAT: np.float16,
    Type.FLOAT: np.float32,
    Type.DOUBLE: np.float64,
    Type.STRING: np.int32,  # dictionary codes
    Type.BINARY: np.int32,  # dictionary codes
    Type.DATE32: np.int32,
    Type.DATE64: np.int64,
    Type.TIMESTAMP: np.int64,
    Type.TIME32: np.int32,
    Type.TIME64: np.int64,
    Type.DURATION: np.int64,
}

_INTEGRAL = {
    Type.BOOL, Type.UINT8, Type.INT8, Type.UINT16, Type.INT16, Type.UINT32,
    Type.INT32, Type.UINT64, Type.INT64, Type.STRING, Type.BINARY,
    Type.DATE32, Type.DATE64, Type.TIMESTAMP, Type.TIME32, Type.TIME64,
    Type.DURATION,
}
_FLOATING = {Type.HALF_FLOAT, Type.FLOAT, Type.DOUBLE}

_TORCH_OF_NUMPY = {
    np.dtype(np.bool_): torch.bool,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.uint16): torch.uint16,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.uint32): torch.uint32,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.uint64): torch.uint64,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.float16): torch.float16,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
}


def extreme_value(dtype: torch.dtype, largest: bool):
    """The dtype's largest (or smallest) ordered value, as a Python scalar.

    The shared sentinel picker for padding sort keys (sorts last) — one
    definition so a dtype addition updates every kernel at once.
    """
    if dtype.is_floating_point:
        return float("inf") if largest else float("-inf")
    if dtype == torch.bool:
        return bool(largest)
    info = torch.iinfo(dtype)
    return info.max if largest else info.min


def numpy_dtype(t: Type) -> np.dtype:
    """numpy dtype of this logical type's storage (host side)."""
    try:
        return np.dtype(_NUMPY_OF[t])
    except KeyError:
        raise NotImplementedError(f"no device storage for logical type {t!r}")


def device_dtype(t: Type) -> torch.dtype:
    """torch dtype used for this logical type's device storage."""
    return _TORCH_OF_NUMPY[numpy_dtype(t)]


def is_integral(t: Type) -> bool:
    return t in _INTEGRAL


def is_floating(t: Type) -> bool:
    return t in _FLOATING


def is_dictionary_encoded(t: Type) -> bool:
    return t in (Type.STRING, Type.BINARY)


# ---------------------------------------------------------------------------
# Arrow interop (type validation mirror of reference arrow/arrow_types.cpp)
# ---------------------------------------------------------------------------

def from_arrow_type(at) -> Type:
    """Map a pyarrow DataType to our logical Type.

    reference: cpp/src/cylon/arrow/arrow_types.cpp:57-114 (supported set)
    """
    import pyarrow as pa

    checks = (
        (pa.types.is_boolean, Type.BOOL),
        (pa.types.is_uint8, Type.UINT8),
        (pa.types.is_int8, Type.INT8),
        (pa.types.is_uint16, Type.UINT16),
        (pa.types.is_int16, Type.INT16),
        (pa.types.is_uint32, Type.UINT32),
        (pa.types.is_int32, Type.INT32),
        (pa.types.is_uint64, Type.UINT64),
        (pa.types.is_int64, Type.INT64),
        (pa.types.is_float16, Type.HALF_FLOAT),
        (pa.types.is_float32, Type.FLOAT),
        (pa.types.is_float64, Type.DOUBLE),
        (pa.types.is_string, Type.STRING),
        (pa.types.is_large_string, Type.STRING),
        (pa.types.is_binary, Type.BINARY),
        (pa.types.is_large_binary, Type.BINARY),
        (pa.types.is_date32, Type.DATE32),
        (pa.types.is_date64, Type.DATE64),
        (pa.types.is_timestamp, Type.TIMESTAMP),
        (pa.types.is_time32, Type.TIME32),
        (pa.types.is_time64, Type.TIME64),
        (pa.types.is_duration, Type.DURATION),
    )
    for pred, t in checks:
        if pred(at):
            return t
    if pa.types.is_dictionary(at):
        # arrow dictionary arrays (e.g. pandas Categorical) land on the
        # framework's native dictionary-encoded representation
        return from_arrow_type(at.value_type)
    if pa.types.is_null(at):
        # the typeless column (pandas infers pa.null() for empty or
        # all-None object columns): ingest as an all-null string column
        return Type.STRING
    raise NotImplementedError(f"unsupported arrow type {at!r}")


def to_arrow_type(t: Type, *, orig=None):
    """Map logical Type back to a pyarrow DataType.

    ``orig`` preserves parametrized arrow types (timestamp unit, etc.) captured
    at ingest.
    """
    import pyarrow as pa

    if orig is not None:
        return orig
    return {
        Type.BOOL: pa.bool_(),
        Type.UINT8: pa.uint8(),
        Type.INT8: pa.int8(),
        Type.UINT16: pa.uint16(),
        Type.INT16: pa.int16(),
        Type.UINT32: pa.uint32(),
        Type.INT32: pa.int32(),
        Type.UINT64: pa.uint64(),
        Type.INT64: pa.int64(),
        Type.HALF_FLOAT: pa.float16(),
        Type.FLOAT: pa.float32(),
        Type.DOUBLE: pa.float64(),
        Type.STRING: pa.string(),
        Type.BINARY: pa.binary(),
        Type.DATE32: pa.date32(),
        Type.DATE64: pa.date64(),
        Type.TIMESTAMP: pa.timestamp("us"),
        Type.TIME32: pa.time32("ms"),
        Type.TIME64: pa.time64("us"),
        Type.DURATION: pa.duration("us"),
    }[t]
