"""The data-model surfaces of ``Table`` / ``Column`` and ``Row``: the
port's ``row`` / ``iter_rows`` / typed getters, ``project``,
``schema_types``, ``to_string`` / ``show``, ``has_nulls`` and
``with_data``, and the ``dtypes`` predicates, against the JAX package's
(``cylon_tpu/row.py``, ``cylon_tpu/table.py``) on the same numpy-seeded
tables.  A column derived through ``with_data`` never exports a stale
host copy; a table exported from a DTable reads its cells from the host
copies."""
import numpy as np
import pyarrow as pa
import pytest
import torch

import cylon_tpu as ct
from cylon_tpu import dtypes as jdtypes
from cylon_tpu.parallel import DTable as JDTable

import cylon_tpu_torch as pt
from cylon_tpu_torch import dtypes as tdtypes
from cylon_tpu_torch.parallel import DTable as TDTable
from cylon_tpu_torch.status import CylonError as TCylonError

from test_torch_common import jax_trace_shim  # noqa: F401


@pytest.fixture
def tctx():
    return pt.CylonContext(device="cpu")


def _typed_arrow(n: int = 6):
    rng = np.random.default_rng(17)
    mask = np.zeros(n, bool)
    mask[2] = True
    return pa.table({
        "b": pa.array(rng.random(n) < 0.5),
        "i8": pa.array(rng.integers(-100, 100, n, dtype=np.int8)),
        "u8": pa.array(rng.integers(0, 200, n, dtype=np.uint8)),
        "i16": pa.array(rng.integers(-3000, 3000, n, dtype=np.int16)),
        "u16": pa.array(rng.integers(0, 60000, n, dtype=np.uint16)),
        "i32": pa.array(rng.integers(-2**31, 2**31, n, dtype=np.int32),
                        mask=mask),
        "u32": pa.array(rng.integers(0, 2**32, n, dtype=np.uint32)),
        "i64": pa.array(rng.integers(-2**62, 2**62, n)),
        "u64": pa.array(rng.integers(0, 2**63, n, dtype=np.uint64)),
        "f16": pa.array(rng.standard_normal(n).astype(np.float16)),
        "f32": pa.array(rng.standard_normal(n).astype(np.float32)),
        "f64": pa.array(rng.standard_normal(n), mask=mask),
        "s": pa.array(rng.choice(["ab", "cd", "é"], n), mask=mask),
        "bin": pa.array([b"x", b"yz", b"", b"q", b"x", b"\x00"][:n],
                        pa.binary()),
        "d32": pa.array(np.arange(n, dtype=np.int32), pa.date32()),
        "ts": pa.array(np.arange(n, dtype=np.int64) * 1000,
                       pa.timestamp("us")),
    })


GETTERS = {"b": "get_bool", "i8": "get_int8", "u8": "get_uint8",
           "i16": "get_int16", "u16": "get_uint16", "i32": "get_int32",
           "u32": "get_uint32", "i64": "get_int64", "u64": "get_uint64",
           "f16": "get_half_float", "f32": "get_float", "f64": "get_double",
           "s": "get_string", "bin": "get_binary", "d32": "get_date32",
           "ts": "get_timestamp"}


def _row_values(t):
    return [r.values() for r in t.iter_rows()]


@pytest.mark.parametrize("source", ["arrow", "export"])
def test_rows_and_typed_getters_equal_jax(ctx, dctx, jax_trace_shim,
                                          tctx, source):
    at = _typed_arrow()
    if source == "arrow":
        got, want = pt.Table.from_arrow(tctx, at), ct.Table.from_arrow(ctx, at)
    else:  # an export reads its cells from the host copies
        got = TDTable.from_arrow(pt.CylonContext(device="cpu", world=4),
                                 at).to_table()
        want = JDTable.from_arrow(dctx, at).to_table()
        assert all(c.host_data is not None for c in got.columns)
    assert _row_values(got) == _row_values(want)
    for name, getter in GETTERS.items():
        for i in range(got.num_rows):
            g = getattr(got.row(i), getter)(name)
            w = getattr(want.row(i), getter)(name)
            assert g == w and type(g) is type(w), (name, i, g, w)
    r, jr = got.row(-1), want.row(-1)
    assert r.row_index() == r.RowIndex() == jr.row_index() == 5
    assert r["s"] == jr["s"] and r[12] == jr[12]
    assert repr(r) == repr(jr)
    assert got.row(2).get("i32") is None and got.row(2)["s"] is None


def test_typed_getter_rejects_another_type_and_range(ctx, tctx):
    got = pt.Table.from_arrow(tctx, _typed_arrow())
    want = ct.Table.from_arrow(ctx, _typed_arrow())
    with pytest.raises(TCylonError, match="expected FLOAT"):
        got.row(0).get_float("i32")
    with pytest.raises(Exception, match="expected FLOAT"):
        want.row(0).get_float("i32")
    # the reference's widening accessors accept the narrow type too
    assert got.row(1).get_int64("i32") == want.row(1).get_int64("i32")
    assert got.row(0).get_double("f32") == want.row(0).get_double("f32")
    for i in (6, -7):
        with pytest.raises(TCylonError):
            got.row(i)


def test_project_schema_types_and_predicates(ctx, tctx):
    at = _typed_arrow()
    got, want = pt.Table.from_arrow(tctx, at), ct.Table.from_arrow(ctx, at)
    assert [int(t) for t in got.schema_types()] == \
        [int(t) for t in want.schema_types()]
    p, jp = got.project(["s", 0, "f64"]), want.project(["s", 0, "f64"])
    assert p.column_names == jp.column_names == ["s", "b", "f64"]
    assert p.columns[0] is got.columns[12]   # zero-copy
    assert _row_values(p) == _row_values(jp)
    assert [c.has_nulls() for c in got.columns] == \
        [c.has_nulls() for c in want.columns]
    for t in tdtypes.Type:
        jt = jdtypes.Type(int(t))
        assert tdtypes.is_integral(t) == jdtypes.is_integral(jt)
        assert tdtypes.is_floating(t) == jdtypes.is_floating(jt)


@pytest.mark.parametrize("window", [(0, None, 0, None), (1, 4, 2, 9),
                                    (3, 3, 0, 2)])
def test_to_string_and_show_equal_jax(ctx, tctx, capsys, window):
    at = _typed_arrow()
    got, want = pt.Table.from_arrow(tctx, at), ct.Table.from_arrow(ctx, at)
    assert got.to_string(*window) == want.to_string(*window)
    got.show(*window)
    want.show(*window)
    out = capsys.readouterr().out.split("\n")
    half = len(out) // 2
    assert out[:half] == out[half:2 * half]


def test_with_data_never_exports_a_stale_host_copy(tctx):
    """Every derivation through ``with_data`` drops the host copies (the
    export reads the new device contents), a rename keeps them (same
    contents), and the dictionary unification routes through it."""
    from cylon_tpu_torch.table import unify_dictionaries
    t = TDTable.from_arrow(pt.CylonContext(device="cpu", world=2),
                           _typed_arrow()).to_table()
    c = t.column("i64")
    d = c.with_data(c.data * 2)
    assert d.host_data is None and d.host_validity is None
    assert pt.Table(tctx, [d]).to_arrow().column(0).to_pylist() == \
        [2 * v for v in t.to_arrow().column("i64").to_pylist()]
    v = t.column("i32")
    nv = v.with_data(v.data, validity=torch.ones_like(v.validity))
    assert pt.Table(tctx, [nv]).to_arrow().column(0).null_count == 0
    assert nv.validity is not v.validity and nv.dictionary is v.dictionary
    renamed = t.rename([f"x{i}" for i in range(t.num_columns)])
    assert renamed.columns[0].host_data is t.columns[0].host_data
    s2 = pt.Table.from_arrow(tctx, pa.table({"s": ["zz", "ab"]})).columns[0]
    a, b = unify_dictionaries(t.column("s"), s2)
    assert a.host_data is None and b.host_data is None
    assert pt.Table(tctx, [a]).to_arrow().column(0).to_pylist() == \
        t.to_arrow().column("s").to_pylist()
    assert pt.Table(tctx, [b]).to_arrow().column(0).to_pylist() == \
        ["zz", "ab"]
