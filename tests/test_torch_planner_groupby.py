"""Groupby pushdown under the port's planner (``plan/rules.py`` lowering
``dist_groupby`` to ``dist_groupby_fused``) against the JAX package's
planner, at world 1 and on 8 shards, on the same numpy inputs: parity
over integer, dictionary, nullable and composite keys with every
aggregation, the planned modes (psum over dictionary keys, never for
min / max; the raw shuffle for near-unique keys), a shuffle absorbed
below the groupby, a select folded into the aggregation mask,
``emit_empty``, and a plan-cache replay of the fused plan (the shapes of
``tests/test_groupby_pushdown.py``).

Every planned result equals the JAX planner's (the same rows on the same
shards; keys, counts and integers exact, float64 within 1e-12 and float32
within 1e-6 relative) and the port's eager ``dist_groupby`` (float64
within 1e-9), with the same rule fires and planned row bytes."""
import numpy as np
import pyarrow as pa
import pytest

from cylon_tpu_torch import trace
from cylon_tpu_torch.parallel import broadcast as tbroadcast
from cylon_tpu_torch.parallel import dist_ops as tdist_ops

from test_torch_common import jax_trace_shim  # noqa: F401
from test_torch_dist_join import _both_dtables
from test_torch_planner import (_both, _check_parity, _fires,  # noqa: F401
                                _planner_isolation, _run_pair, _same_rows)

ALL_AGGS = [("v", "sum"), ("v", "mean"), ("w", "min"), ("w", "max"),
            ("v", "count")]
N = 6000
WORLDS = (1, 8)


def _flavors():
    """One table per key flavour: ``v`` float64, ``w`` int64 with every
    11th row null."""
    rng = np.random.default_rng(5)
    v = rng.random(N)
    w = pa.array(rng.integers(0, 1000, N), mask=np.arange(N) % 11 == 0)
    intk = (np.arange(N) % 37).astype(np.int64)
    return {
        "int": pa.table({"k": intk, "v": v, "w": w}),
        "dict-string": pa.table({
            "k": np.take(np.array([f"g{i:02d}" for i in range(23)]),
                         rng.integers(0, 23, N)), "v": v, "w": w}),
        "null": pa.table({"k": pa.array(intk, mask=np.arange(N) % 13 == 0),
                          "v": v, "w": w}),
        "composite": pa.table({
            "k": intk % 6,
            "k2": np.take(np.array(["x", "y", "z"]), rng.integers(0, 3, N)),
            "v": v, "w": w}),
    }


@pytest.fixture(scope="module")
def flavors(ctx, dctx):
    """{world: ({flavour: JAX DTable}, {flavour: port DTable})}."""
    out = {}
    for world in WORLDS:
        pairs = {name: _both_dtables(ctx, dctx, world, at)
                 for name, at in _flavors().items()}
        out[world] = ({n: p[0] for n, p in pairs.items()},
                      {n: p[1] for n, p in pairs.items()})
    return out


def _exchanges(c: dict) -> int:
    """Whole exchanges of one counter window (shuffles and gathers run;
    a replica-cache hit moves nothing)."""
    return (c.get("shuffle.exchanges", 0) + c.get("join.broadcast_gather", 0)
            + c.get("groupby.broadcast_gather", 0)
            + c.get("groupby.psum_combine", 0))


def _pair(flavors, world, flavour, op):
    """Both planners on ``flavour`` (parity checked), then the port's
    eager and planned legs: (eager bytes, planned bytes, eager counters,
    planned counters, port planner stats)."""
    got, want, ts, js = _both(flavors, world, op, names=(flavour,),
                              single=True)
    _check_parity(got, want, ts, js)
    dt = flavors[world][1][flavour]
    eager, opt, eb, ob, ec, oc = _run_pair(
        dt.ctx, lambda t: op(tdist_ops, t), dt)
    _same_rows(opt, eager)
    return eb, ob, ec, oc, ts


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("flavour", ["int", "dict-string", "null",
                                     "composite"])
def test_fused_parity(flavors, jax_trace_shim, flavour, world):
    keys = ["k", "k2"] if flavour == "composite" else ["k"]

    def op(d, t):
        return d.dist_groupby(t, keys, ALL_AGGS)

    eb, ob, _, oc, ts = _pair(flavors, world, flavour, op)
    if world > 1:
        assert oc.get("groupby.pushdown", 0) >= 1, oc
        assert _fires(ts, "groupby-pushdown")
        assert ob < eb, f"{flavour}: the fused exchange must beat the " \
            "combine gather"
    else:
        assert not ts["fires"]  # one shard: nothing to push below


def test_fused_direct_call_modes(flavors):
    """``dist_groupby_fused`` called directly: every mode agrees with the
    eager groupby; psum over integer keys degrades at execution."""
    dt = flavors[8][1]["int"]
    want = tdist_ops.dist_groupby(dt, ["k"], ALL_AGGS)
    for mode in ("pre-aggregate", "shuffle"):
        got = tdist_ops.dist_groupby_fused(dt, ["k"], ALL_AGGS, mode=mode,
                                           reason="a test")
        _same_rows(got, want)
    trace.reset()
    got = tdist_ops.dist_groupby_fused(dt, ["k"], ALL_AGGS, mode="psum")
    _same_rows(got, want)
    assert trace.counters().get("groupby.psum_combine", 0) == 0
    assert trace.counters().get("groupby.pushdown", 0) == 1
    with pytest.raises(Exception):
        tdist_ops.dist_groupby_fused(dt, ["k"], ALL_AGGS, mode="nope")


def _psum_op(d, t):
    return d.dist_groupby(t, ["k"], [("v", "sum"), ("v", "mean"),
                                     ("w", "sum"), ("v", "count")])


def test_psum_combine_dict_keys(flavors, jax_trace_shim):
    """Dictionary keys with sum / count / mean lower to the
    one-all_reduce combine: no exchange of rows, fewer bytes than the
    eager combine gather."""
    eb, ob, _, oc, ts = _pair(flavors, 8, "dict-string", _psum_op)
    assert oc.get("groupby.psum_combine", 0) == 1, oc
    assert oc.get("groupby.broadcast_gather", 0) == 0, oc
    assert oc.get("shuffle.exchanges", 0) == 0, oc
    assert 0 < ob < eb
    assert [f for f in _fires(ts, "groupby-pushdown") if "psum" in f]


def _composite_nullable():
    rng = np.random.default_rng(9)
    n = 3000
    a = np.take(np.array(["p", "q", "r"]), rng.integers(0, 3, n))
    b = np.take(np.array(["u", "vv"]), rng.integers(0, 2, n))
    return pa.table({"a": pa.array(a, mask=np.arange(n) % 17 == 0),
                     "b": pa.array(b, mask=np.arange(n) % 23 == 0),
                     "v": rng.random(n)})


@pytest.mark.parametrize("world", WORLDS)
def test_psum_combine_composite_nullable_keys(ctx, dctx, jax_trace_shim,
                                              world):
    """Composite dictionary keys with nulls: each column contributes its
    own null code, so null == null grouping composes."""
    jt, tt = _both_dtables(ctx, dctx, world, _composite_nullable())

    def op(d, t):
        return d.dist_groupby(t, ["a", "b"], [("v", "sum"), ("v", "count")])

    got, want, ts, js = _both({world: ({"t": jt}, {"t": tt})}, world, op,
                              names=("t",), single=True)
    _check_parity(got, want, ts, js)
    eager, opt, _, _, _, oc = _run_pair(tt.ctx, lambda t: op(tdist_ops, t),
                                        tt)
    _same_rows(opt, eager)
    assert oc.get("groupby.psum_combine", 0) == (world > 1), oc


def test_min_max_never_psum(flavors, jax_trace_shim):
    """min / max have no sum all_reduce: dictionary keys still take the
    partial exchange."""
    def op(d, t):
        return d.dist_groupby(t, ["k"], [("w", "min")])

    _, _, _, oc, ts = _pair(flavors, 8, "dict-string", op)
    assert oc.get("groupby.psum_combine", 0) == 0, oc
    assert oc.get("groupby.pushdown", 0) == 1, oc
    assert [f for f in _fires(ts, "groupby-pushdown")
            if "pre-aggregate decided" in f]


def test_near_unique_planned_from_ingest_counts(ctx, dctx, jax_trace_shim):
    """A dense key range wider than the ingest row count plans the raw
    shuffle (the partial pass cannot shrink the exchange)."""
    n = 2000
    jt, tt = _both_dtables(ctx, dctx, 8, pa.table({
        "k": np.arange(n, dtype=np.int64), "v": np.ones(n)}))

    def op(d, t):
        return d.dist_groupby(t, ["k"], [("v", "sum")],
                              dense_key_range=(0, 3 * n))

    got, want, ts, js = _both({8: ({"t": jt}, {"t": tt})}, 8, op,
                              names=("t",), single=True)
    _check_parity(got, want, ts, js)
    assert [f for f in _fires(ts, "groupby-pushdown") if "near-unique" in f]
    eager, opt, eb, ob, _, _ = _run_pair(tt.ctx, lambda t: op(tdist_ops, t),
                                         tt)
    _same_rows(opt, eager)
    assert ob <= eb


def _shuffled_groupby(d, t):
    return d.dist_groupby(d.shuffle_table(t, ["k"]), ["k"], [("v", "sum")])


def test_shuffle_below_groupby_absorbed(flavors, jax_trace_shim):
    """A single-consumer ``shuffle_table`` below the groupby is redundant
    (the fused exchange re-partitions the partials on the group keys):
    the planned run takes fewer exchanges."""
    eb, ob, ec, oc, ts = _pair(flavors, 8, "int", _shuffled_groupby)
    assert ob < eb
    assert _exchanges(oc) < _exchanges(ec), (oc, ec)
    assert _fires(ts, "absorbed the shuffle")


def _pred_v(env):
    return env["v"] > 0.25


def _selected_groupby(d, t):
    return d.dist_groupby(d.dist_select(t, _pred_v), ["k"], ALL_AGGS)


@pytest.mark.parametrize("world", WORLDS)
def test_select_folds_into_groupby_mask(flavors, jax_trace_shim, world):
    """A single-consumer parameterless select below the groupby becomes
    its row mask: the same rows, no standalone compaction, SQL null
    semantics kept."""
    eb, ob, _, _, ts = _pair(flavors, world, "null", _selected_groupby)
    assert ob <= eb
    assert bool(_fires(ts, "select folded")) == (world > 1)


def test_emit_empty_dense_parity(ctx, dctx, jax_trace_shim):
    """The q13 shape: a dense ``emit_empty`` groupby (zero-count keys
    included) through the fused exchange."""
    n = 4000
    rng = np.random.default_rng(3)
    k = rng.integers(1, 301, n)
    k = np.where((k >= 120) & (k < 140), 7, k).astype(np.int64)
    jt, tt = _both_dtables(ctx, dctx, 8, pa.table({"k": k,
                                                   "v": rng.random(n)}))

    def op(d, t):
        return d.dist_groupby(t, ["k"], [("k", "count")],
                              dense_key_range=(1, 300), emit_empty=True)

    got, want, ts, js = _both({8: ({"t": jt}, {"t": tt})}, 8, op,
                              names=("t",), single=True)
    _check_parity(got, want, ts, js)
    assert got.num_rows == 300
    eager, opt, eb, ob, _, oc = _run_pair(tt.ctx,
                                          lambda t: op(tdist_ops, t), tt)
    _same_rows(opt, eager)
    assert oc.get("groupby.pushdown", 0) == 1
    assert ob <= eb


def test_plan_cache_replays_fused_plan(flavors):
    dt = flavors[8][1]["int"]

    def op(t):
        return tdist_ops.dist_groupby(t, ["k"], [("v", "sum")])

    tbroadcast.clear_replica_cache()
    first = dt.ctx.optimize(op, dt)
    trace.reset()
    second = dt.ctx.optimize(op, dt)
    c = trace.counters()
    assert c.get("plan.cache_hit", 0) == 1
    assert c.get("groupby.pushdown", 0) == 1
    _same_rows(second, first)

