"""Local sort parity: the port's sort kernels (ops/sort.py) and
``compute.sort`` / ``sort_multi`` against the JAX package's, on the same
numpy inputs.  Index arrays must be equal element for element, the
descending transform bit for bit, and sorted tables row for row."""
import numpy as np
import pyarrow as pa
import pytest
import torch

import jax.numpy as jnp

import cylon_tpu as ct
from cylon_tpu import compute as jcompute
from cylon_tpu.ops import sort as js

import cylon_tpu_torch as pt
from cylon_tpu_torch import compute as tcompute
from cylon_tpu_torch.ops import sort as ts

from test_torch_common import jax_rows, port_rows, schema

DTYPES = ["int32", "int64", "uint32", "uint64", "bool", "float32", "float64"]


def _column(rng, dtype, n):
    """Few distinct values (ties), the type's extremes, and for floats
    NaN and ±0.0."""
    dt = np.dtype(dtype)
    if dt == np.bool_:
        return rng.random(n) < 0.5
    if dt.kind == "f":
        pool = np.array([np.nan, -0.0, 0.0, 1.5, -2.5, np.inf, -np.inf, 7.0],
                        dt)
    else:
        info = np.iinfo(dt)
        pool = np.array([info.min, info.max, 0, 1, 2, 5, info.max - 1], dt)
    return rng.choice(pool, n)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _eq(got, want):
    np.testing.assert_array_equal(_np(got), np.asarray(want))


def _both(*arrays):
    return ([None if a is None else jnp.asarray(a) for a in arrays],
            [None if a is None else torch.from_numpy(np.ascontiguousarray(a))
             for a in arrays])


def _jax_invert(x, jx):
    """The JAX package's ``_invert``.  For uint64 it raises on this JAX
    (the Python scalar ``iinfo.max`` overflows when ``max - x`` is traced),
    so its formula is evaluated in numpy instead."""
    if x.dtype == np.uint64:
        return np.iinfo(np.uint64).max - x
    return np.asarray(js._invert(jx))


# uint64 descending is left out where the JAX package's _invert is reached
ASC_ONLY_U64 = {"uint64": [True]}


@pytest.mark.parametrize("dtype", DTYPES)
def test_invert_is_bit_exact(dtype):
    x = _column(np.random.default_rng(50), dtype, 200)
    (jx,), (tx,) = _both(x)
    want = _jax_invert(x, jx)
    got = ts._invert(tx).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))


def test_jax_invert_overflows_on_uint64():
    """The reference-side quirk behind ASC_ONLY_U64: a descending uint64
    sort raises in the JAX package; the port's sorts it."""
    x = np.array([0, 2**64 - 1, 5], np.uint64)
    with pytest.raises(OverflowError):
        js._invert(jnp.asarray(x))
    order = ts.sort_indices(torch.from_numpy(x), None, ascending=False)
    assert order.tolist() == [1, 2, 0]


@pytest.mark.parametrize("dtype", DTYPES)
def test_sort_indices(dtype):
    rng = np.random.default_rng(51)
    x, v = _column(rng, dtype, 300), rng.random(300) > 0.2
    (jx, jv), (tx, tv) = _both(x, v)
    for ascending in ASC_ONLY_U64.get(dtype, [True, False]):
        _eq(ts.sort_indices(tx, None, ascending),
            js.sort_indices(jx, None, ascending))
        _eq(ts.sort_indices(tx, tv, ascending),
            js.sort_indices(jx, jv, ascending))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("count", [0, 137, 256])
def test_sort_indices_masked(dtype, count):
    rng = np.random.default_rng(52)
    x, v = _column(rng, dtype, 256), rng.random(256) > 0.3
    (jx, jv), (tx, tv) = _both(x, v)
    for ascending in ASC_ONLY_U64.get(dtype, [True, False]):
        for jval, tval in ((None, None), (jv, tv)):
            _eq(ts.sort_indices_masked(tx, tval, count, ascending),
                js.sort_indices_masked(jx, jval, count, ascending))


@pytest.mark.parametrize("ascending", [True, False, (True, False, True),
                                       (False, True, False)])
def test_lexsort_indices_mixed_types_and_directions(ascending):
    """Three keys of different types (float with NaN/±0, int64 with its
    minimum, uint32 past 2^31), with and without nulls per key."""
    rng = np.random.default_rng(53)
    n = 400
    cols = [_column(rng, "float64", n), _column(rng, "int64", n),
            _column(rng, "uint32", n)]
    vals = [rng.random(n) > 0.2, None, rng.random(n) > 0.1]
    jc, tc = _both(*cols)
    jv, tv = _both(*vals)
    _eq(ts.lexsort_indices(tc, tv, ascending), js.lexsort_indices(jc, jv, ascending))
    _eq(ts.lexsort_indices(tc, None, ascending), js.lexsort_indices(jc, None, ascending))
    for count in (0, 250, n):
        _eq(ts.lexsort_indices_masked(tc, tv, count, ascending),
            js.lexsort_indices_masked(jc, jv, count, ascending))


def _table(rng, n):
    k = rng.integers(-5, 5, n).astype(np.int64)
    k[:3] = np.iinfo(np.int64).min
    f = rng.choice(np.array([np.nan, -0.0, 0.0, 1.0, -1.0]), n)
    return pa.table({
        "k": pa.array(k, pa.int64(), mask=rng.random(n) < 0.15),
        "f": pa.array(f, pa.float64(), mask=rng.random(n) < 0.1),
        "u": pa.array(rng.integers(0, 2**64 - 1, n, dtype=np.uint64,
                                   endpoint=True), pa.uint64()),
        "s": pa.array([f"s{v % 6}" for v in rng.integers(0, 99, n)]),
        "b": pa.array(rng.random(n) < 0.5),
    })


@pytest.mark.parametrize("column,ascending", [
    ("k", True), ("k", False), ("f", True), ("f", False), ("u", True),
    ("s", True), ("s", False), ("b", True), ("b", False)])
def test_compute_sort_matches_jax(ctx, column, ascending):
    at = _table(np.random.default_rng(54), 160)
    want = jcompute.sort(ct.Table.from_arrow(ctx, at), column, ascending)
    tctx = pt.CylonContext(device="cpu")
    got = tcompute.sort(pt.Table.from_arrow(tctx, at), column, ascending)
    assert schema(got) == schema(want)
    assert port_rows(got, ordered=True) == jax_rows(want, ordered=True)


@pytest.mark.parametrize("columns,ascending", [
    (["k", "f"], True), (["f", "k"], [False, True]),
    (["s", "u", "k"], [True, True, False]), (["b", "f", "s"], False)])
def test_compute_sort_multi_matches_jax(ctx, columns, ascending):
    at = _table(np.random.default_rng(55), 180)
    want = jcompute.sort_multi(ct.Table.from_arrow(ctx, at), columns, ascending)
    tctx = pt.CylonContext(device="cpu")
    got = tcompute.sort_multi(pt.Table.from_arrow(tctx, at), columns, ascending)
    assert schema(got) == schema(want)
    assert port_rows(got, ordered=True) == jax_rows(want, ordered=True)
