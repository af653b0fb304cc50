"""Select / project / with_column parity and the deferred select: the
port's ``compute.select`` / ``merge`` / ``round_robin_partition`` and
``dist_select`` / ``dist_project`` / ``dist_with_column`` against the JAX
package's on the same numpy inputs, at world 1 and on the 8 virtual CPU
devices.  The same predicate lambda runs in both packages (on jnp arrays
in one, on torch tensors in the other).  ``compact=False`` must give what
compacting first gives, whether the consumer folds the mask (select,
groupby, aggregate, with_column) or collapses it (join, sort, set op,
export)."""
import numpy as np
import pyarrow as pa
import pytest
import torch

import cylon_tpu as ct
from cylon_tpu import compute as jcompute
from cylon_tpu.dtypes import Type as JType
from cylon_tpu.parallel import dist_aggregate as jdist_aggregate
from cylon_tpu.parallel import dist_groupby as jdist_groupby
from cylon_tpu.parallel import dist_project as jdist_project
from cylon_tpu.parallel import dist_select as jdist_select
from cylon_tpu.parallel import dist_with_column as jdist_with_column

import cylon_tpu_torch as pt
from cylon_tpu_torch import compute as tcompute
from cylon_tpu_torch.parallel import (dist_aggregate, dist_groupby, dist_join,
                                      dist_project, dist_select, dist_sort,
                                      dist_union, dist_with_column)

from test_torch_common import (assert_rows_close, float_rtols, jax_rows,
                               jax_trace_shim, port_rows, schema)  # noqa: F401
from test_torch_dist_join import _both_dtables, _same


def _table(rng, n):
    return pa.table({
        "k": pa.array(rng.integers(1, 60, n)),
        "v": pa.array(rng.normal(size=n)),
        "w": pa.array(rng.integers(0, 9, n).astype(np.float64),
                      mask=rng.random(n) < 0.15),
        "s": pa.array([f"s{x}" for x in rng.integers(0, 4, n)]),
    })


def pred(env):
    return env["v"] > 0.0


def pred2(env):
    return env["k"] % 2 == 0


def pred_w(env):
    return env["w"] < 5.0


# ---------------------------------------------------------------------------
# local: select, merge, round_robin_partition
# ---------------------------------------------------------------------------

def _local_pair(ctx, at):
    return (ct.Table.from_arrow(ctx, at),
            pt.Table.from_arrow(pt.CylonContext(device="cpu"), at))


@pytest.mark.parametrize("predicate", [pred, pred2, pred_w])
def test_select_matches_jax(ctx, predicate):
    """The local select reads raw data: no null veto (a null ``w`` holds
    0, which passes ``w < 5``), as in the JAX package."""
    jt, tt = _local_pair(ctx, _table(np.random.default_rng(100), 300))
    want = jcompute.select(jt, predicate)
    got = tcompute.select(tt, predicate)
    assert schema(got) == schema(want)
    assert port_rows(got, ordered=True) == jax_rows(want, ordered=True)


def test_select_bad_mask_shape_raises():
    tctx = pt.CylonContext(device="cpu")
    t = pt.Table.from_columns(tctx, {"k": np.arange(5)})
    with pytest.raises(pt.CylonError):
        tcompute.select(t, lambda env: env["k"][:2] > 0)


def test_merge_matches_jax(ctx):
    rng = np.random.default_rng(101)
    a, b = _table(rng, 40), _table(rng, 25)
    ja, ta = _local_pair(ctx, a)
    jb, tb = _local_pair(ctx, b)
    want = jcompute.merge([ja, jb, ja])
    got = tcompute.merge([ta, tb, ta])
    assert schema(got) == schema(want)
    assert port_rows(got, ordered=True) == jax_rows(want, ordered=True)
    with pytest.raises(pt.CylonError):
        tcompute.merge([])


@pytest.mark.parametrize("n", [0, 7, 100])
def test_round_robin_partition_matches_jax(ctx, n):
    jt, tt = _local_pair(ctx, _table(np.random.default_rng(102), n))
    want = jcompute.round_robin_partition(jt, 3)
    got = tcompute.round_robin_partition(tt, 3)
    assert [port_rows(p, ordered=True) for p in got] == \
        [jax_rows(p, ordered=True) for p in want]


# ---------------------------------------------------------------------------
# dist_select: SQL null semantics, env.valid, params, capacity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", [1, 8])
def test_dist_select_null_semantics(ctx, dctx, jax_trace_shim, world):
    """A NULL in a column the predicate reads drops the row, though its
    0-filled slot would pass (test_dist_ops.py:401); a predicate on a
    null-free column keeps rows whose other columns are null."""
    at = pa.table({"x": pa.array([1.0, None, 10.0, -3.0, None]),
                   "y": pa.array(np.arange(5, dtype=np.int64))})
    jt, tt = _both_dtables(ctx, dctx, world, at)
    lt = lambda env: env["x"] < 5.0  # noqa: E731
    got = dist_select(tt, lt)
    _same(got, jdist_select(jt, lt))
    assert sorted(r[1] for r in got.to_table().to_pandas().itertuples(
        index=False)) == [0, 3]
    ge = lambda env: env["y"] >= 3  # noqa: E731
    _same(dist_select(tt, ge), jdist_select(jt, ge))


@pytest.mark.parametrize("world", [1, 8])
def test_dist_select_null_or_predicate(ctx, dctx, jax_trace_shim, world):
    """``env.valid(name)`` hands NULL handling to the predicate
    (test_dist_ops.py:419)."""
    at = pa.table({"x": pa.array([1.0, None, 10.0, None]),
                   "y": pa.array(np.array([0, 10, 0, 1], dtype=np.int64))})
    jt, tt = _both_dtables(ctx, dctx, world, at)
    p = lambda env: ((env["x"] < 5.0) & env.valid("x")) | (env["y"] > 3)  # noqa: E731
    got = dist_select(tt, p)
    _same(got, jdist_select(jt, p))
    assert sorted(got.to_table().column("y").data.tolist()) == [0, 10]


@pytest.mark.parametrize("world", [1, 8])
def test_dist_select_env_reads_all_columns(ctx, dctx, jax_trace_shim, world):
    """Every read path of the env records its columns (``items``,
    ``values``, ``get``), so no spelling bypasses the null veto."""
    at = _table(np.random.default_rng(103), 400)
    jt, tt = _both_dtables(ctx, dctx, world, at)
    for p in (lambda env: env.get("w") > 2.0,
              lambda env: [v for k, v in env.items() if k == "w"][0] > 2.0,
              lambda env: list(env.values())[2] > 2.0):
        _same(dist_select(tt, p), jdist_select(jt, p))


def test_dist_select_device_scalar_params(ctx, dctx, jax_trace_shim):
    """A ``dist_aggregate`` result feeds a select as a device tensor
    (test_dist_ops.py:941); re-running on new data honours the new
    value."""
    p = lambda env, v: env["x"] > v  # noqa: E731
    for shift in (0.0, 100.0):
        rng = np.random.default_rng(104)
        at = pa.table({"x": rng.normal(size=150) + shift})
        jt, tt = _both_dtables(ctx, dctx, 8, at)
        javg = jdist_aggregate(jt, [("x", "mean")]).column("mean_x").data[0]
        tavg = dist_aggregate(tt, [("x", "mean")]).column("mean_x").data[0]
        assert isinstance(tavg, torch.Tensor) and tavg.dim() == 0
        got = dist_select(tt, p, params=(tavg,))
        _same(got, jdist_select(jt, p, params=(javg,)))
        x = at.column("x").to_numpy()
        assert got.num_rows == int((x > x.mean()).sum())


@pytest.mark.parametrize("world", [1, 8])
def test_dist_select_compacts_capacity(ctx, dctx, jax_trace_shim, world):
    """A selective filter shrinks the block to a bucket of the largest
    per-shard survivor count (test_dist_ops.py:588)."""
    rng = np.random.default_rng(105)
    at = pa.table({"k": rng.integers(0, 1000, 4000), "v": rng.normal(size=4000)})
    jt, tt = _both_dtables(ctx, dctx, world, at)
    p = lambda env: env["k"] < 10  # noqa: E731
    got = dist_select(tt, p)
    _same(got, jdist_select(jt, p))
    assert got.cap < tt.cap // 8


# ---------------------------------------------------------------------------
# dist_project / dist_with_column
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", [1, 8])
def test_dist_project_and_with_column(ctx, dctx, jax_trace_shim, world):
    at = _table(np.random.default_rng(106), 500)
    jt, tt = _both_dtables(ctx, dctx, world, at)
    _same(dist_project(tt, ["s", "v"]), jdist_project(jt, ["s", "v"]))
    assert dist_project(tt, [0, 2]).column_names == ["k", "w"]
    fn = lambda env: env["v"] * 2.0 + env["w"]  # noqa: E731
    got = dist_with_column(tt, "x", fn, pt.Type.DOUBLE, validity_from=["w"])
    _same(got, jdist_with_column(jt, "x", fn, JType.DOUBLE,
                                 validity_from=["w"]))
    fk = lambda env: env["k"] * 3  # noqa: E731
    got = dist_with_column(tt, "k3", fk, pt.Type.INT32)
    assert got.column("k3").data.dtype == torch.int32
    _same(got, jdist_with_column(jt, "k3", fk, JType.INT32))


# ---------------------------------------------------------------------------
# the deferred select (test_pending_mask.py:60-214)
# ---------------------------------------------------------------------------

def _deferred_pair(ctx, dctx, world, at, predicate=pred):
    jt, tt = _both_dtables(ctx, dctx, world, at)
    jd = jdist_select(jt, predicate, compact=False)
    td = dist_select(tt, predicate, compact=False)
    assert td.pending_mask is not None and td.cap == tt.cap
    return jt, tt, jd, td


@pytest.mark.parametrize("world", [1, 8])
def test_deferred_select_collapses_on_export(ctx, dctx, jax_trace_shim, world):
    at = _table(np.random.default_rng(107), 600)
    jt, tt, jd, td = _deferred_pair(ctx, dctx, world, at)
    want = dist_select(_both_dtables(ctx, dctx, world, at)[1], pred)
    assert port_rows(td.to_table(), ordered=True) == \
        port_rows(want.to_table(), ordered=True)
    assert td.pending_mask is None  # collapsed in place
    jd.to_table()
    _same(td, jd)
    _same(td, want)


@pytest.mark.parametrize("world", [1, 8])
def test_deferred_select_chain_folds(ctx, dctx, jax_trace_shim, world):
    at = _table(np.random.default_rng(108), 600)
    jt, tt, jd, td = _deferred_pair(ctx, dctx, world, at)
    got = dist_select(td, pred2, compact=False)
    assert got.pending_mask is not None
    _same(got, jdist_select(jd, pred2, compact=False))
    _same(dist_select(dist_select(tt, pred), pred2),
          jdist_select(jdist_select(jt, pred), pred2))


@pytest.mark.parametrize("world", [1, 8])
@pytest.mark.parametrize("dense", [None, (1, 59)])
def test_deferred_into_groupby(ctx, dctx, jax_trace_shim, world, dense):
    at = _table(np.random.default_rng(109), 600)
    jt, tt, jd, td = _deferred_pair(ctx, dctx, world, at)
    aggs = [("v", "sum"), ("w", "count"), ("w", "max")]
    got = dist_groupby(td, ["k"], aggs, dense_key_range=dense)
    want = jdist_groupby(jd, ["k"], aggs, dense_key_range=dense)
    first = dist_groupby(dist_select(tt, pred), ["k"], aggs,
                         dense_key_range=dense)
    assert schema(got) == schema(want) and got.cap == want.cap
    assert_rows_close(port_rows(got, ordered=True),
                      jax_rows(want, ordered=True), float_rtols(got))
    # compact-first gives the same groups (placement may differ: the
    # compacted input has other shard capacities)
    flat = lambda rows: sorted((r for s in rows for r in s), key=repr)  # noqa: E731
    assert_rows_close(flat(port_rows(got)), flat(port_rows(first)),
                      float_rtols(got))


@pytest.mark.parametrize("world", [1, 8])
def test_deferred_into_groupby_with_where(ctx, dctx, jax_trace_shim, world):
    at = _table(np.random.default_rng(110), 600)
    jt, tt, jd, td = _deferred_pair(ctx, dctx, world, at)
    got = dist_groupby(td, ["k"], [("v", "sum")], where=pred2)
    want = jdist_groupby(jd, ["k"], [("v", "sum")], where=pred2)
    assert schema(got) == schema(want) and got.cap == want.cap
    assert_rows_close(port_rows(got, ordered=True),
                      jax_rows(want, ordered=True), float_rtols(got))


@pytest.mark.parametrize("world", [1, 8])
def test_deferred_into_scalar_aggregate_and_with_column(ctx, dctx,
                                                        jax_trace_shim, world):
    at = _table(np.random.default_rng(111), 600)
    jt, tt, jd, td = _deferred_pair(ctx, dctx, world, at)
    aggs = [("v", "sum"), ("v", "count"), ("w", "max")]
    got = dist_aggregate(td, aggs)
    want = jdist_aggregate(jd, aggs)
    assert_rows_close(port_rows(got), jax_rows(want), float_rtols(got))
    fn = lambda env: env["v"] * 2.0  # noqa: E731
    tw = dist_with_column(td, "v2", fn, pt.Type.DOUBLE)
    jw = jdist_with_column(jd, "v2", fn, JType.DOUBLE)
    assert tw.pending_mask is not None
    got = dist_aggregate(tw, [("v2", "sum")])
    assert_rows_close(port_rows(got),
                      jax_rows(jdist_aggregate(jw, [("v2", "sum")])), [1e-12])
    assert_rows_close(port_rows(got), [(2.0 * port_rows(dist_aggregate(
        dist_select(tt, pred), [("v", "sum")]))[0][0],)], [1e-12])


@pytest.mark.parametrize("world", [1, 8])
def test_deferred_collapses_before_join_sort_setop(ctx, dctx, jax_trace_shim,
                                                   world):
    """The join, the sorts and the set ops compact a pending mask first:
    the result equals compacting in ``dist_select``."""
    rng = np.random.default_rng(112)
    at = _table(rng, 500)
    bt = pa.table({"k": pa.array(rng.integers(1, 60, 80)),
                   "b": pa.array(rng.normal(size=80))})
    _, tt = _both_dtables(ctx, dctx, world, at)
    _, tb = _both_dtables(ctx, dctx, world, bt)
    cfg = pt.JoinConfig.InnerJoin("k", "k")
    _same(dist_join(dist_select(tt, pred, compact=False), tb, cfg),
          dist_join(dist_select(tt, pred), tb, cfg))
    _same(dist_sort(dist_select(tt, pred, compact=False), "v"),
          dist_sort(dist_select(tt, pred), "v"))
    proj = dist_project(dist_select(tt, pred, compact=False), ["k", "v"])
    assert proj.pending_mask is not None
    _same(dist_union(proj, dist_project(tt, ["k", "v"])),
          dist_union(dist_project(dist_select(tt, pred), ["k", "v"]),
                     dist_project(tt, ["k", "v"])))
    d = dist_select(tt, pred, compact=False)
    assert d.num_rows == dist_select(tt, pred).num_rows
    assert d.pending_mask is None
    d = dist_select(tt, pred, compact=False)
    assert port_rows(d.head(7)) == port_rows(dist_select(tt, pred).head(7))
    assert port_rows(dist_select(tt, pred, compact=False).partition(0)) == \
        port_rows(dist_select(tt, pred).partition(0))


def test_shuffle_of_pending_table_raises():
    from cylon_tpu_torch.parallel import dist_ops
    tctx = pt.CylonContext(device="cpu", world=2)
    dt = pt.parallel.DTable.from_table(
        tctx, pt.Table.from_columns(tctx, {"k": np.arange(10)}))
    d = dist_select(dt, lambda env: env["k"] > 3, compact=False)
    with pytest.raises(pt.CylonError):
        dist_ops._shuffle_by_pids(d, dist_ops._hash_pids(d, [0]))
