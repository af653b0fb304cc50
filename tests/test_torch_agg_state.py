"""Aggregation-state capture parity: ``collect_agg_state`` /
``merge_agg_state`` / ``finalize_agg_state`` of the port against the JAX
package's at world 1 and on the 8 virtual CPU devices, on the same numpy
inputs.  The captured state (the combined partial table of a plain
groupby tail, or the merged sketch lanes), the merged state of a base and
a delta whose key dictionaries differ, and the finalized tables must hold
the same rows on the same shards: keys, counts, integer partials and
sketch lanes exactly, float64 partials within 1e-12 relative.  On the port
alone, the plain merge of a base and a delta equals the groupby of the
whole table, and an HLL merge gives the whole table's estimates exactly."""
import numpy as np
import pyarrow as pa
import pytest

from cylon_tpu import config as jconfig
from cylon_tpu.parallel import dist_ops as jdist_ops

import cylon_tpu_torch as pt
from cylon_tpu_torch import config as tconfig
from cylon_tpu_torch.parallel import DTable as TDTable
from cylon_tpu_torch.parallel import dist_ops as tdist_ops

from test_torch_common import (assert_rows_close, float_rtols, jax_rows,
                               jax_trace_shim, port_rows, schema)  # noqa: F401
from test_torch_dist_groupby import _threshold
from test_torch_dist_join import _both_dtables

AGGS = [("v", "sum"), ("v", "mean"), ("w", "count"), ("w", "min"),
        ("w", "max"), ("f", "sum")]
SUMS = [("v", "sum"), ("v", "mean"), ("w", "count"), ("f", "sum")]
SKETCH = [("ids", "approx_distinct"), ("x", "approx_quantile:0.5")]


def _table(rng, n, labels=range(5)):
    labels = list(labels)
    return pa.table({
        "s": pa.array([f"s{labels[i]}" for i in
                       rng.integers(0, len(labels), n)]),
        "k": pa.array(rng.integers(0, 30, n), mask=rng.random(n) < 0.1),
        "v": pa.array(rng.normal(size=n), mask=rng.random(n) < 0.1),
        "w": pa.array(rng.integers(-99, 99, n).astype(np.int32)),
        "f": pa.array(rng.random(n).astype(np.float32)),
        "ids": pa.array(rng.integers(0, 500, n)),
        "x": pa.array(rng.standard_normal(n)),
    })


def _same(got, want, cap=True):
    assert schema(got) == schema(want)
    if cap:
        assert got.cap == want.cap
    np.testing.assert_array_equal(got.counts_host(), want.counts_host())
    assert_rows_close(port_rows(got, ordered=True),
                      jax_rows(want, ordered=True), float_rtols(got))


def _same_state(got, want, cap=True):
    assert (got.kind, got.K) == (want.kind, want.K)
    assert [(n, int(t.type), op) for n, t, op in got.base_meta] \
        == [(n, int(t.type), op) for n, t, op in want.base_meta]
    if got.kind == "plain":
        assert list(got.partial) == list(want.partial)
        assert [tuple(p) for p in got.plan] == [tuple(p) for p in want.plan]
    else:
        assert tuple(got.kinds) == tuple(want.kinds)
        assert tuple(got.qs) == tuple(want.qs)
    _same(got.state, want.state, cap)


# path → (call, kwargs) for both packages; "eager-shuffle" lowers the
# broadcast threshold so the combine shuffles
PATHS = {
    "eager-broadcast": ("dist_groupby", {}),
    "eager-shuffle": ("dist_groupby", {}),
    "fused-psum": ("dist_groupby_fused", {"mode": "psum"}),
    "fused-pre-aggregate": ("dist_groupby_fused", {"mode": "pre-aggregate"}),
}


def _capture(pkg, dt, path, keys, aggs):
    name, kw = PATHS[path]
    with pkg.collect_agg_state() as sink:
        out = getattr(pkg, name)(dt, keys, aggs, **kw)
    return out, sink


@pytest.mark.parametrize("world", [1, 8])
@pytest.mark.parametrize("path", list(PATHS))
def test_plain_state_capture_matches_jax(ctx, dctx, jax_trace_shim, world,
                                         path):
    jt, tt = _both_dtables(ctx, dctx, world,
                           _table(np.random.default_rng(60), 1200))
    aggs = SUMS if path == "fused-psum" else AGGS
    with _threshold(8 if path == "eager-shuffle" else
                    jconfig.DEFAULT_BROADCAST_JOIN_THRESHOLD):
        want, jsink = _capture(jdist_ops, jt, path, ["s"], aggs)
        got, tsink = _capture(tdist_ops, tt, path, ["s"], aggs)
    _same(got, want)
    # world 1 aggregates locally: no partial tail, nothing to capture
    assert len(tsink) == len(jsink) == (1 if world > 1 else 0)
    for g, w in zip(tsink, jsink):
        _same_state(g, w)
        _same(tdist_ops.finalize_agg_state(g), jdist_ops.finalize_agg_state(w))


@pytest.mark.parametrize("world", [1, 8])
def test_sketch_state_capture_matches_jax(ctx, dctx, jax_trace_shim, world):
    jt, tt = _both_dtables(ctx, dctx, world,
                           _table(np.random.default_rng(61), 1500))
    assert tt.cap == jt.cap
    with jdist_ops.collect_agg_state() as jsink:
        want = jdist_ops.dist_groupby_sketch(jt, ["s", "k"], SKETCH)
    with tdist_ops.collect_agg_state() as tsink:
        got = tdist_ops.dist_groupby_sketch(tt, ["s", "k"], SKETCH)
    assert port_rows(got, ordered=True) == jax_rows(want, ordered=True)
    assert len(tsink) == len(jsink) == 1
    # at world 1 no shuffle re-sizes the partial block, which the port
    # sizes by groups and the JAX package by input rows
    _same_state(tsink[0], jsink[0], cap=world > 1)
    fin = tdist_ops.finalize_agg_state(tsink[0])
    assert port_rows(fin, ordered=True) == jax_rows(
        jdist_ops.finalize_agg_state(jsink[0]), ordered=True)
    # finalizing the captured state gives the groupby's own answer
    assert port_rows(fin) == port_rows(got)


def _parts(ctx, dctx, world, seed):
    """A base and a delta whose ``s`` dictionaries differ (s0..s4 and
    s3..s7), each as a JAX and a port DTable."""
    base = _table(np.random.default_rng(seed), 1000, range(5))
    delta = _table(np.random.default_rng(seed + 1), 300, range(3, 8))
    return (_both_dtables(ctx, dctx, world, base),
            _both_dtables(ctx, dctx, world, delta))


# a plain groupby at world 1 aggregates locally and captures nothing
@pytest.mark.parametrize("world,path", [(8, "fused-psum"),
                                        (8, "fused-pre-aggregate"),
                                        (8, "sketch"), (1, "sketch")])
def test_merge_and_finalize_match_jax(ctx, dctx, jax_trace_shim, world, path):
    (jb, tb), (jd, td) = _parts(ctx, dctx, world, 62)
    states = {}
    for pkg, b, d in ((jdist_ops, jb, jd), (tdist_ops, tb, td)):
        got = []
        for dt in (b, d):
            with pkg.collect_agg_state() as sink:
                if path == "sketch":
                    pkg.dist_groupby_sketch(dt, ["s"], SKETCH)
                else:
                    name, kw = PATHS[path]
                    getattr(pkg, name)(dt, ["s"], SUMS, **kw)
            got.append(sink[0])
        states[pkg] = pkg.merge_agg_state(*got)
    _same_state(states[tdist_ops], states[jdist_ops], cap=world > 1)
    fin_t = tdist_ops.finalize_agg_state(states[tdist_ops])
    fin_j = jdist_ops.finalize_agg_state(states[jdist_ops])
    if path == "sketch":
        assert port_rows(fin_t, ordered=True) == jax_rows(fin_j, ordered=True)
    else:
        _same(fin_t, fin_j)


def _host_rows(dt):
    return sorted(r for shard in port_rows(dt) for r in shard)


@pytest.mark.parametrize("path", ["eager-shuffle", "fused-psum",
                                  "fused-pre-aggregate"])
def test_plain_merge_of_base_and_delta_equals_whole(path):
    """merge(base, delta), finalized == the groupby over base ∪ delta."""
    rng = np.random.default_rng(63)
    whole = _table(rng, 2000)
    tctx = pt.CylonContext(device="cpu", world=4)
    t = TDTable.from_table(tctx, pt.Table.from_arrow(tctx, whole))
    base = tdist_ops.dist_select(t, lambda env: env["ids"] < 400)
    delta = tdist_ops.dist_select(t, lambda env: env["ids"] >= 400)
    aggs = SUMS if path == "fused-psum" else AGGS
    prev = tconfig.set_broadcast_join_threshold(
        8 if path == "eager-shuffle" else
        tconfig.DEFAULT_BROADCAST_JOIN_THRESHOLD)
    try:
        states = [_capture(tdist_ops, dt, path, ["s"], aggs)[1][0]
                  for dt in (base, delta)]
        merged = tdist_ops.merge_agg_state(*states)
        want = tdist_ops.dist_groupby(t, ["s"], aggs)
    finally:
        tconfig.set_broadcast_join_threshold(prev)
    got = tdist_ops.finalize_agg_state(merged)
    assert schema(got) == schema(want)
    assert_rows_close(_host_rows(got), _host_rows(want), float_rtols(got))


def test_sketch_distinct_merge_equals_whole():
    """An HLL register merge is exact: merge(base, delta) gives the whole
    table's distinct estimates."""
    rng = np.random.default_rng(64)
    tctx = pt.CylonContext(device="cpu", world=4)
    t = TDTable.from_table(tctx, pt.Table.from_arrow(tctx,
                                                     _table(rng, 3000)))
    aggs = [("ids", "approx_distinct"), ("x", "approx_distinct")]
    states = []
    for dt in (tdist_ops.dist_select(t, lambda env: env["w"] < 0),
               tdist_ops.dist_select(t, lambda env: env["w"] >= 0)):
        with tdist_ops.collect_agg_state() as sink:
            tdist_ops.dist_groupby_sketch(dt, ["s"], aggs)
        states.append(sink[0])
    got = tdist_ops.finalize_agg_state(tdist_ops.merge_agg_state(*states))
    want = tdist_ops.dist_groupby_sketch(t, ["s"], aggs)
    assert _host_rows(got) == _host_rows(want)


def test_collectors_nest_and_restore():
    tctx = pt.CylonContext(device="cpu", world=2)
    t = TDTable.from_table(tctx, pt.Table.from_arrow(
        tctx, _table(np.random.default_rng(65), 200)))
    with tdist_ops.collect_agg_state() as outer:
        tdist_ops.dist_groupby(t, ["s"], SUMS)
        with tdist_ops.collect_agg_state() as inner:
            tdist_ops.dist_groupby_sketch(t, ["s"], SKETCH)
        tdist_ops.dist_groupby_fused(t, ["s"], SUMS, mode="psum")
    assert [s.kind for s in outer] == ["plain", "plain"]
    assert [s.kind for s in inner] == ["sketch"]
    # outside any collector nothing is captured
    tdist_ops.dist_groupby(t, ["s"], SUMS)
    assert len(outer) == 2
