"""Distributed groupby parity: the port's ``dist_groupby`` on every path it
takes (pre-aggregation with the broadcast combine, the shuffle combine,
the raw-row shuffle, ``where`` pushdown, the dense-key path), its scalar
``dist_aggregate`` and ``broadcast.replicate_table``, against the JAX
package's at world 1 and on the 8 virtual CPU devices, on the same numpy
inputs.  Every shard must hold the same groups in the same order with the
same ``cap`` and ``counts``: keys, counts, integer aggregates and validity
exactly, float64 aggregates within 1e-12 relative, float32 sums within
1e-6.  The port must also take the same path: the partition kernel's
wrapper is called once on a shuffle and never on the broadcast combine or
the dense path."""
import numpy as np
import pyarrow as pa
import pytest
import torch

import cylon_tpu as ct
from cylon_tpu import config as jconfig
from cylon_tpu.parallel import broadcast as jbroadcast
from cylon_tpu.parallel import dist_aggregate as jdist_aggregate
from cylon_tpu.parallel import dist_groupby as jdist_groupby

import cylon_tpu_torch as pt
from cylon_tpu_torch import config as tconfig
from cylon_tpu_torch.parallel import broadcast as tbroadcast
from cylon_tpu_torch.parallel import dist_aggregate as tdist_aggregate
from cylon_tpu_torch.parallel import dist_groupby as tdist_groupby
from cylon_tpu_torch.parallel import dist_ops as tdist_ops

from test_torch_common import (assert_rows_close, float_rtols, jax_rows,
                               jax_trace_shim, port_rows, schema)  # noqa: F401
from test_torch_dist_join import _both_dtables

AGGS = [("v", "sum"), ("v", "mean"), ("w", "min"), ("w", "max"),
        ("v", "count"), ("w", "sum"), ("f", "sum"), ("f", "mean")]


def _table(rng, n, key="int"):
    """``k``: int64 in [0, 40) with 10% nulls (``key="float"``: float64
    with NaN, −0.0 and nulls); ``s``: a dictionary string; ``v``: float64
    with nulls; ``w``: int32; ``f``: float32."""
    if key == "int":
        k = pa.array(rng.integers(0, 40, n), mask=rng.random(n) < 0.1)
    else:
        kf = rng.integers(-6, 6, n).astype(np.float64)
        kf[rng.random(n) < 0.1] = np.nan
        kf[rng.random(n) < 0.1] = -0.0
        k = pa.array(kf, mask=rng.random(n) < 0.05)
    return pa.table({
        "k": k,
        "s": pa.array([f"s{v}" for v in rng.integers(0, 3, n)]),
        "v": pa.array(rng.normal(size=n), mask=rng.random(n) < 0.1),
        "w": pa.array(rng.integers(-99, 99, n).astype(np.int32)),
        "f": pa.array(rng.random(n).astype(np.float32)),
    })


def _same_close(got, want):
    assert schema(got) == schema(want)
    assert got.cap == want.cap
    np.testing.assert_array_equal(got.counts_host(), want.counts_host())
    assert_rows_close(port_rows(got, ordered=True),
                      jax_rows(want, ordered=True), float_rtols(got))


@pytest.fixture
def pid_calls(monkeypatch):
    """Counts the partition-kernel wrapper's calls on the groupby path
    (on CPU tensors it runs the plain version, which does not count as a
    launch)."""
    calls = []
    real = tdist_ops.partition_ids_fused

    def counted(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(tdist_ops, "partition_ids_fused", counted)
    return calls


class _threshold:
    """Set the broadcast threshold in both packages; restore on exit."""

    def __init__(self, n):
        self.n = n

    def __enter__(self):
        self.prev = (jconfig.set_broadcast_join_threshold(self.n),
                     tconfig.set_broadcast_join_threshold(self.n))

    def __exit__(self, *exc):
        jconfig.set_broadcast_join_threshold(self.prev[0])
        tconfig.set_broadcast_join_threshold(self.prev[1])


def where_w(env):
    return env["w"] > -20


# mode → (kwargs, shuffle calls at world 8)
MODES = {
    "broadcast_combine": ({}, 0),
    "shuffle_combine": ({}, 1),
    "raw_shuffle": ({"pre_aggregate": False}, 1),
    "where": ({"where": where_w}, 0),
}


@pytest.mark.parametrize("world", [1, 8])
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("keys", [["k"], ["s", "k"]])
def test_dist_groupby_matches_jax(ctx, dctx, jax_trace_shim, pid_calls,
                                  world, mode, keys):
    at = _table(np.random.default_rng(80), 1500)
    jt, tt = _both_dtables(ctx, dctx, world, at)
    kwargs, calls = MODES[mode]
    # the shuffle combine: partial tables over 8 rows take the shuffle
    with _threshold(8 if mode == "shuffle_combine" else
                    jconfig.DEFAULT_BROADCAST_JOIN_THRESHOLD):
        want = jdist_groupby(jt, keys, AGGS, **kwargs)
        got = tdist_groupby(tt, keys, AGGS, **kwargs)
    _same_close(got, want)
    assert len(pid_calls) == (calls if world > 1 else 0)
    if world > 1 and mode in ("broadcast_combine", "where"):
        assert list(got.counts_host()[1:]) == [0] * (world - 1)


@pytest.mark.parametrize("world", [1, 8])
@pytest.mark.parametrize("pre_aggregate", [None, False])
def test_dist_groupby_float_keys_match_jax(ctx, dctx, jax_trace_shim,
                                           world, pre_aggregate):
    """NaN keys (one group per row), −0.0 with 0.0, null keys: the same
    groups on the same shards."""
    at = _table(np.random.default_rng(81), 1200, key="float")
    jt, tt = _both_dtables(ctx, dctx, world, at)
    _same_close(tdist_groupby(tt, ["k"], AGGS, pre_aggregate=pre_aggregate),
                jdist_groupby(jt, ["k"], AGGS, pre_aggregate=pre_aggregate))


@pytest.mark.parametrize("world", [1, 8])
def test_dist_groupby_cap_is_group_bucket(ctx, dctx, jax_trace_shim, world):
    """The output block is bucketed to the GROUP count, not the input
    capacity (test_dist_ops.py:572)."""
    rng = np.random.default_rng(82)
    at = pa.table({"g": rng.integers(0, 3, 4000), "v": rng.normal(size=4000)})
    jt, tt = _both_dtables(ctx, dctx, world, at)
    got = tdist_groupby(tt, ["g"], [("v", "sum")])
    _same_close(got, jdist_groupby(jt, ["g"], [("v", "sum")]))
    assert got.cap <= 64


# ---------------------------------------------------------------------------
# the dense-key path (test_dist_ops.py:725-860)
# ---------------------------------------------------------------------------

DENSE_AGGS = [("v", "sum"), ("v", "mean"), ("w", "count"), ("w", "min"),
              ("v", "max"), ("f", "sum")]


@pytest.mark.parametrize("world", [1, 8])
@pytest.mark.parametrize("pre_aggregate", [None, False])
@pytest.mark.parametrize("where", [None, where_w])
def test_dist_groupby_dense_matches_jax(ctx, dctx, jax_trace_shim, pid_calls,
                                        world, pre_aggregate, where):
    """Null keys, ``where``, pre-aggregated and raw: the direct-address
    path routes by ``(key − lo) mod P``, so the kernel never runs."""
    at = _table(np.random.default_rng(83), 900)
    jt, tt = _both_dtables(ctx, dctx, world, at)
    kw = dict(dense_key_range=(0, 39), pre_aggregate=pre_aggregate,
              where=where)
    _same_close(tdist_groupby(tt, ["k"], DENSE_AGGS, **kw),
                jdist_groupby(jt, ["k"], DENSE_AGGS, **kw))
    assert pid_calls == []


@pytest.mark.parametrize("world", [1, 8])
@pytest.mark.parametrize("pre_aggregate", [None, False])
def test_dist_groupby_dense_emit_empty_matches_jax(ctx, dctx, jax_trace_shim,
                                                   world, pre_aggregate):
    rng = np.random.default_rng(84)
    n = 300
    at = pa.table({"k": pa.array(rng.choice([2, 3, 5, 7, 11, 13], n),
                                 mask=rng.random(n) < 0.1),
                   "v": rng.normal(size=n)})
    jt, tt = _both_dtables(ctx, dctx, world, at)
    kw = dict(dense_key_range=(1, 15), emit_empty=True,
              pre_aggregate=pre_aggregate)
    aggs = [("v", "count"), ("v", "sum"), ("v", "min")]
    got = tdist_groupby(tt, ["k"], aggs, **kw)
    _same_close(got, jdist_groupby(jt, ["k"], aggs, **kw))
    assert got.num_rows == 16  # 15 keys and the null group


@pytest.mark.parametrize("world", [1, 8])
def test_dist_groupby_dense_keys_past_int32(ctx, dctx, jax_trace_shim, world):
    base = 2**31 - 20
    rng = np.random.default_rng(85)
    at = pa.table({"k": rng.integers(base, base + 41, 300),
                   "v": rng.normal(size=300)})
    jt, tt = _both_dtables(ctx, dctx, world, at)
    kw = dict(dense_key_range=(base, base + 40))
    got = tdist_groupby(tt, ["k"], [("v", "sum"), ("v", "count")], **kw)
    _same_close(got, jdist_groupby(jt, ["k"], [("v", "sum"), ("v", "count")],
                                   **kw))
    keys = got.to_table().column("k").data
    assert int(keys.min()) >= base and int(keys.max()) <= base + 40


@pytest.mark.parametrize("world", [1, 8])
def test_dist_groupby_dense_range_violation_raises(ctx, dctx, jax_trace_shim,
                                                   world):
    rng = np.random.default_rng(86)
    at = pa.table({"k": rng.integers(0, 100, 50), "v": rng.normal(size=50)})
    jt, tt = _both_dtables(ctx, dctx, world, at)
    with pytest.raises(ct.CylonError, match="dense_key_range"):
        jdist_groupby(jt, ["k"], [("v", "sum")], dense_key_range=(0, 10))
    with pytest.raises(pt.CylonError, match="dense_key_range"):
        tdist_groupby(tt, ["k"], [("v", "sum")], dense_key_range=(0, 10))


@pytest.mark.parametrize("world", [1, 8])
def test_dist_groupby_dense_hint_ignored(ctx, dctx, jax_trace_shim, world):
    """A slot space over 4× the capacity falls back to the sort path; a
    float key ignores the hint; emit_empty without the dense path raises."""
    at = _table(np.random.default_rng(87), 200, key="float")
    jt, tt = _both_dtables(ctx, dctx, world, at)
    for key, rng_ in (("w", (-99, 10_000_000)), ("k", (-6, 6))):
        _same_close(
            tdist_groupby(tt, [key], [("v", "sum")], dense_key_range=rng_),
            jdist_groupby(jt, [key], [("v", "sum")], dense_key_range=rng_))
    with pytest.raises(ct.CylonError, match="emit_empty"):
        jdist_groupby(jt, ["w"], [("v", "sum")], emit_empty=True)
    with pytest.raises(pt.CylonError, match="emit_empty"):
        tdist_groupby(tt, ["w"], [("v", "sum")], emit_empty=True)


# ---------------------------------------------------------------------------
# scalar aggregate (test_dist_ops.py:606,630)
# ---------------------------------------------------------------------------

def _same_local(got, want):
    """A float32 column's scalar mean divides in float32 (stored as a
    float64 column), so it takes the float32 tolerance."""
    assert schema(got) == schema(want)
    rtols = [1e-6 if c.name == "mean_f" else r
             for c, r in zip(got.columns, float_rtols(got))]
    assert_rows_close(port_rows(got, ordered=True),
                      jax_rows(want, ordered=True), rtols)


@pytest.mark.parametrize("world", [1, 8])
def test_dist_aggregate_matches_jax(ctx, dctx, jax_trace_shim, world):
    at = _table(np.random.default_rng(88), 2000)
    jt, tt = _both_dtables(ctx, dctx, world, at)
    aggs = [("v", "sum"), ("v", "count"), ("v", "mean"), ("v", "min"),
            ("v", "max"), ("w", "sum"), ("w", "mean"), ("w", "min"),
            ("f", "sum"), ("f", "mean"), ("f", "max")]
    got = tdist_aggregate(tt, aggs)
    _same_local(got, jdist_aggregate(jt, aggs))
    assert got.num_rows == 1
    pred = lambda env: env["k"] >= 20  # noqa: E731
    _same_local(tdist_aggregate(tt, aggs[:3], where=pred),
                jdist_aggregate(jt, aggs[:3], where=pred))


@pytest.mark.parametrize("world", [1, 8])
def test_dist_aggregate_empty_filter(ctx, dctx, jax_trace_shim, world):
    """Over zero rows: sum and count 0, min / max / mean null."""
    at = _table(np.random.default_rng(89), 100)
    jt, tt = _both_dtables(ctx, dctx, world, at)
    aggs = [("v", "sum"), ("v", "count"), ("v", "min"), ("v", "max"),
            ("v", "mean"), ("w", "sum")]
    pred = lambda env: env["v"] > 1e9  # noqa: E731
    got = tdist_aggregate(tt, aggs, where=pred)
    _same_local(got, jdist_aggregate(jt, aggs, where=pred))
    assert port_rows(got) == [(0.0, 0, None, None, None, 0)]


# ---------------------------------------------------------------------------
# replicate_table (parallel/broadcast.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["all", "head"])
def test_replicate_table_matches_jax(ctx, dctx, jax_trace_shim, mode):
    at = _table(np.random.default_rng(90), 300)
    jt, tt = _both_dtables(ctx, dctx, 8, at)
    # a derived table (no ingest counts): the capacity bound sizes it
    jt = jdist_groupby(jt, ["k"], [("v", "sum")], pre_aggregate=False)
    tt = tdist_groupby(tt, ["k"], [("v", "sum")], pre_aggregate=False)
    assert tbroadcast.rows_if_small(tt, None) == \
        jbroadcast.rows_if_small(jt, None)
    assert tbroadcast.rows_if_small(tt, 8) is None
    _same_close(tbroadcast.replicate_table(tt, mode=mode),
                jbroadcast.replicate_table(jt, mode=mode, cache=False))


def test_rows_if_small_budget_veto():
    """A replica over the memory budget is refused."""
    tctx = pt.CylonContext(device="cpu", world=4)
    t = pt.Table.from_columns(tctx, {"k": np.arange(1000)})
    dt = pt.parallel.DTable.from_table(tctx, t)
    assert tbroadcast.rows_if_small(dt, None) == 1000
    prev = tconfig.set_device_memory_budget(1024)
    try:
        assert tbroadcast.rows_if_small(dt, None) is None
    finally:
        tconfig.set_device_memory_budget(prev)
    with pytest.raises(pt.CylonError):
        tconfig.set_broadcast_join_threshold(0)


def _edge_table(case):
    rng = np.random.default_rng(91)
    if case == "empty":
        return pa.table({"k": pa.array([], pa.int64()),
                         "v": pa.array([], pa.float64())}), ["k"]
    if case == "null_keys":
        return pa.table({"k": pa.array([None] * 50, pa.int64()),
                         "v": pa.array(np.arange(50.0))}), ["k"]
    return pa.table({
        "b": pa.array(rng.random(300) < 0.5),
        "k": pa.array(rng.integers(0, 5, 300).astype(np.uint32)),
        "v": pa.array(rng.integers(0, 1000, 300).astype(np.uint16)),
        "h": pa.array(rng.normal(size=300).astype(np.float16))}), ["b", "k"]


@pytest.mark.parametrize("world", [1, 8])
@pytest.mark.parametrize("case", ["empty", "null_keys", "bool_uint"])
@pytest.mark.parametrize("kw", [{}, {"pre_aggregate": False},
                                {"dense_key_range": (0, 9)}],
                         ids=["default", "raw", "dense"])
def test_dist_groupby_edge_tables_match_jax(ctx, dctx, jax_trace_shim,
                                            world, case, kw):
    """No rows, only null keys, bool + uint32 keys with uint16 / float16
    values (unsigned min / max through the order-preserving view)."""
    at, keys = _edge_table(case)
    jt, tt = _both_dtables(ctx, dctx, world, at)
    aggs = ([("v", "sum"), ("v", "min"), ("v", "max"), ("h", "max"),
             ("b", "sum")] if case == "bool_uint" else
            [("v", "sum"), ("v", "mean"), ("v", "min"), ("v", "count")])
    _same_close(tdist_groupby(tt, keys, aggs, **kw),
                jdist_groupby(jt, keys, aggs, **kw))
