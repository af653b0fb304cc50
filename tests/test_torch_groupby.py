"""Local groupby parity: the port's ``ops/groupby.py`` and
``compute.groupby`` against the JAX package's on the same numpy inputs.
Groups must come out in the same order (key order, the null-key group
last) with the same column names and types; keys, counts, integer
aggregates and validity exactly, float64 aggregates within 1e-12 relative
and float32 sums within 1e-6."""
import numpy as np
import pyarrow as pa
import pytest
import torch

import cylon_tpu as ct
from cylon_tpu import compute as jcompute

import cylon_tpu_torch as pt
from cylon_tpu_torch import compute as tcompute
from cylon_tpu_torch.ops import groupby as tgb

from test_torch_common import (assert_rows_close, float_rtols, jax_rows,
                               port_rows, schema)


def _both(ctx, at):
    return (ct.Table.from_arrow(ctx, at),
            pt.Table.from_arrow(pt.CylonContext(device="cpu"), at))


def _same_groupby(ctx, at, keys, aggs):
    jt, tt = _both(ctx, at)
    want = jcompute.groupby(jt, keys, aggs)
    got = tcompute.groupby(tt, keys, aggs)
    assert schema(got) == schema(want)
    assert_rows_close(port_rows(got, ordered=True),
                      jax_rows(want, ordered=True), float_rtols(got))
    return got


def test_groupby_aggregate_matches_jax(ctx):
    """Two integer keys, every aggregation (test_local_ops.py:177)."""
    rng = np.random.default_rng(60)
    at = pa.table({"g": rng.integers(0, 6, 60), "h": rng.integers(0, 2, 60),
                   "v": rng.normal(size=60), "w": rng.integers(0, 10, 60)})
    _same_groupby(ctx, at, ["g", "h"],
                  [("v", "sum"), ("v", "mean"), ("w", "max"), ("w", "min"),
                   ("v", "count")])


def test_groupby_with_null_values_matches_jax(ctx):
    """Null values are skipped (test_local_ops.py:193)."""
    at = pa.table({"g": pa.array([1, 1, 2, 2, 2]),
                   "v": pa.array([1.0, None, 3.0, None, 5.0])})
    got = _same_groupby(ctx, at, ["g"], [("v", "sum"), ("v", "count"),
                                         ("v", "mean")])
    assert port_rows(got, ordered=True) == [(1, 1.0, 1, 1.0),
                                            (2, 8.0, 2, 4.0)]


def test_groupby_float32_precision_small_group_after_large():
    """Float sums accumulate per group (test_local_ops.py:331): a tiny
    group after a huge one must not inherit the global prefix's rounding
    (float32 eps at 1e10 is about 1024)."""
    n_big = 1_000_000
    keys = torch.cat([torch.zeros(n_big, dtype=torch.int32),
                      torch.ones(2, dtype=torch.int32)])
    vals = torch.cat([torch.full((n_big,), 1.0e4, dtype=torch.float32),
                      torch.tensor([1.0, 2.0], dtype=torch.float32)])
    _, outs, _, ngroups = tgb.groupby_aggregate((keys,), (None,), (vals,),
                                                (None,), ("sum",))
    assert int(ngroups) == 2
    assert outs[0].dtype == torch.float32
    assert abs(float(outs[0][1]) - 3.0) < 1e-3
    assert float(outs[0][0]) == 1.0e10


def test_groupby_blocked_scan_spanning_groups_matches_jax(ctx):
    """Groups spanning many 128-row blocks of the blocked scan, every
    aggregation, nulls (test_local_ops.py:355)."""
    rng = np.random.default_rng(5)
    n = 4000
    v = rng.normal(size=n)
    at = pa.table({"g": pa.array(np.sort(rng.integers(0, 7, n))),
                   "v": pa.array(v, mask=rng.random(n) < 0.1),
                   "w": pa.array(rng.integers(-50, 50, n))})
    _same_groupby(ctx, at, ["g"],
                  [("v", "sum"), ("v", "mean"), ("v", "min"), ("v", "max"),
                   ("w", "min"), ("w", "max"), ("w", "count")])


def test_groupby_nan_and_signed_zero_keys(ctx):
    """Each NaN-keyed row is its own group after every number; −0.0 and
    0.0 form one group keyed by its first row, which is positive zero
    here (the JAX probe's answer).  A group whose only value is NaN has
    NaN sum/min/max and count 1."""
    at = pa.table({"k": pa.array([0.0, -0.0, np.nan, 1.0, np.nan, 0.0, -0.0]),
                   "v": pa.array([1.0, 2.0, np.nan, 4.0, 5.0, 6.0, 7.0])})
    got = _same_groupby(ctx, at, ["k"],
                        [("v", "sum"), ("v", "min"), ("v", "max"),
                         ("v", "count")])
    keys = got.column("k").data.numpy()
    assert keys[:2].tolist() == [0.0, 1.0] and np.isnan(keys[2:]).all()
    assert not np.signbit(keys[0])
    assert port_rows(got, ordered=True) == [
        (0.0, 16.0, 1.0, 7.0, 4), (1.0, 4.0, 4.0, 4.0, 1),
        ("NaN", "NaN", "NaN", "NaN", 1), ("NaN", 5.0, 5.0, 5.0, 1)]


def test_groupby_nan_values_propagate(ctx):
    rng = np.random.default_rng(61)
    n = 600
    v = rng.normal(size=n)
    v[rng.random(n) < 0.05] = np.nan
    at = pa.table({"k": rng.integers(0, 30, n),
                   "v": pa.array(v, mask=rng.random(n) < 0.1)})
    _same_groupby(ctx, at, ["k"], [("v", "sum"), ("v", "mean"),
                                   ("v", "min"), ("v", "max"),
                                   ("v", "count")])


def test_groupby_dictionary_string_keys(ctx):
    """Dictionary-string keys group in lexical order, the null key last."""
    rng = np.random.default_rng(62)
    n = 500
    words = np.array(["pear", "apple", "fig", "kiwi", "date"], dtype=object)
    s = words[rng.integers(0, 5, n)]
    at = pa.table({"s": pa.array(s, mask=rng.random(n) < 0.1),
                   "k": pa.array(rng.integers(0, 3, n).astype(np.int32)),
                   "v": pa.array(rng.random(n).astype(np.float32))})
    got = _same_groupby(ctx, at, ["s", "k"], [("v", "sum"), ("v", "max"),
                                              ("k", "count")])
    firsts = [r[0] for r in port_rows(got, ordered=True)]
    named = [f for f in firsts if f is not None]
    assert firsts[len(named):] == [None] * 3 and named == sorted(named)


@pytest.mark.parametrize("dtype", ["int8", "int16", "int32", "uint8",
                                   "uint16", "uint32", "float32"])
def test_groupby_value_dtypes_match_jax(ctx, dtype):
    """Sum, mean, min and max over every narrow value type (unsigned min
    and max go through the order-preserving view)."""
    rng = np.random.default_rng(63)
    n = 400
    info = (np.iinfo(dtype) if dtype != "float32" else None)
    if info is not None:
        v = rng.integers(info.min, info.max, n, dtype=np.int64,
                         endpoint=True).astype(dtype)
    else:
        v = rng.normal(size=n).astype(np.float32)
    at = pa.table({"k": pa.array(rng.integers(0, 9, n), mask=rng.random(n) < 0.1),
                   "v": pa.array(v, mask=rng.random(n) < 0.1)})
    _same_groupby(ctx, at, ["k"], [("v", "sum"), ("v", "mean"),
                                   ("v", "min"), ("v", "max")])


def test_groupby_empty_table_matches_jax(ctx):
    """The empty-table branch keeps the input columns' types for the
    aggregation columns, as the JAX package does."""
    at = pa.table({"k": pa.array([], pa.int64()),
                   "v": pa.array([], pa.int32()),
                   "s": pa.array([], pa.string())})
    jt, tt = _both(ctx, at)
    aggs = [("v", "sum"), ("v", "mean"), ("v", "count")]
    want = jcompute.groupby(jt, ["k", "s"], aggs)
    got = tcompute.groupby(tt, ["k", "s"], aggs)
    assert schema(got) == schema(want)
    assert got.num_rows == want.num_rows == 0


def test_groupby_unknown_aggregation_raises():
    ctx = pt.CylonContext(device="cpu")
    t = pt.Table.from_columns(ctx, {"k": np.arange(4), "v": np.arange(4)})
    with pytest.raises(pt.CylonError):
        tcompute.groupby(t, ["k"], [("v", "median")])


def test_group_structure_carry_matches_jax():
    """The sort carries value columns into sorted order, and the operands
    are ``~row_valid``, then per key ``~validity`` and the raw values (the
    data under a null key is not zeroed)."""
    import jax.numpy as jnp
    from cylon_tpu.ops import groupby as jgb

    rng = np.random.default_rng(64)
    n = 300
    k = rng.integers(0, 12, n)
    kv = rng.random(n) < 0.85
    rv = np.arange(n) < 260
    val = rng.normal(size=n)
    vv = rng.random(n) < 0.9
    jidx, jfirst, jrv, jcar = jgb.group_structure(
        (jnp.asarray(k),), (jnp.asarray(kv),), jnp.asarray(rv),
        jgb.carry_pack((jnp.asarray(val),), (jnp.asarray(vv),)))
    t = torch.from_numpy
    tidx, tfirst, trv, tcar = tgb.group_structure(
        (t(k),), (t(kv),), t(rv), tgb.carry_pack((t(val),), (t(vv),)))
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(tfirst.numpy(), np.asarray(jfirst))
    np.testing.assert_array_equal(trv.numpy(), np.asarray(jrv))
    for a, b in zip(tcar, jcar):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert int(tgb.num_groups_of((tidx, tfirst, trv))) == \
        int(jgb.num_groups_of((jidx, jfirst, jrv)))
    cols, vals = tgb.carry_unpack(tcar, (t(vv),))
    assert torch.equal(cols[0], tcar[0]) and torch.equal(vals[0], tcar[1])


@pytest.mark.parametrize("n", [5, 256, 257, 1000])
def test_seg_scan_matches_jax(n):
    """The blocked segmented scan, flat and blocked, add / min / max."""
    import jax.numpy as jnp
    from cylon_tpu.ops import groupby as jgb

    rng = np.random.default_rng(65 + n)
    vals = rng.normal(size=(n, 2))
    vals[rng.random((n, 2)) < 0.02] = np.nan
    first = rng.random(n) < 0.05
    first[0] = True
    for jop, top in ((jnp.add, torch.add), (jnp.minimum, torch.minimum),
                     (jnp.maximum, torch.maximum)):
        want = np.asarray(jgb._seg_scan(jnp.asarray(vals), jnp.asarray(first),
                                        jop))
        got = tgb._seg_scan(torch.from_numpy(vals), torch.from_numpy(first),
                            top).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-12, equal_nan=True)
