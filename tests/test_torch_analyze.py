"""EXPLAIN ANALYZE parity: the port's ``observe.analyze`` against the JAX
package's on the same numpy inputs at world 1 and 8.

The reports must list the same operators (``PlanNode.op``) in the same
order, each with the same ``depth``, ``decision``, ``bytes_moved`` and
``rows_out``, and the same ``rows_in`` wherever the JAX package's is not
None (it defers some counts the port reads at once); the run totals'
``bytes_moved`` and ``rows_sent`` are equal; a failing plan returns
``ok=False`` with the nodes measured before the failure kept; the trace
flags come back as they were.  Also: the table summary and checks of
``DTable.explain()``, ``ctx.analyze``, the rendered report, and the
compile attribution of an analyzed build.
"""
import dataclasses

import numpy as np
import pyarrow as pa
import pytest
import torch

import cylon_tpu as ct
from cylon_tpu import observe as jobserve
from cylon_tpu.parallel import DTable as JDTable
from cylon_tpu.parallel import broadcast as jbroadcast
from cylon_tpu.parallel import dist_ops as jops

import cylon_tpu_torch as pt
from cylon_tpu_torch import observe as tobserve
from cylon_tpu_torch import trace as ttrace
from cylon_tpu_torch.parallel import DTable as TDTable
from cylon_tpu_torch.parallel import broadcast as tbroadcast
from cylon_tpu_torch.parallel import dist_ops as tops
from cylon_tpu_torch.status import CylonError

from test_torch_common import jax_rows, jax_trace_shim, port_rows  # noqa: F401

WORLDS = (1, 8)
FIELDS = ("depth", "decision", "bytes_moved", "rows_out")


def assert_reports_match(got, want) -> None:
    """The port's analyzed report against the JAX package's."""
    assert got.ok == want.ok
    assert [n.op for n in got.nodes] == [n.op for n in want.nodes]
    for g, w in zip(got.nodes, want.nodes):
        for f in FIELDS:
            assert g.runtime[f] == w.runtime[f], (g.op, f, g.runtime[f],
                                                  w.runtime[f])
        if w.runtime["rows_in"] is not None:
            assert g.runtime["rows_in"] == w.runtime["rows_in"], g.op
    for k in ("bytes_moved", "rows_sent"):
        assert got.totals[k] == want.totals[k], k


def _tables(ctx, dctx, world, at):
    jctx = dctx if world == 8 else ct.CylonContext(
        {"backend": "tpu", "devices": dctx.devices[:world]})
    jt = JDTable.from_table(jctx, ct.Table.from_arrow(ctx, at))
    tctx = pt.CylonContext(device="cpu", world=world)
    tt = TDTable.from_table(tctx, pt.Table.from_arrow(tctx, at))
    return jt, tt


def _facts(seed, n=500):
    rng = np.random.default_rng(seed)
    return pa.table({
        "k": pa.array(rng.integers(0, 60, n), pa.int64(),
                      mask=rng.random(n) < 0.05),
        "g": pa.array(rng.integers(0, 7, n).astype(np.int32)),
        "v": pa.array(rng.random(n))})


def _dims(seed, n=60):
    rng = np.random.default_rng(seed)
    return pa.table({"k": pa.array(np.arange(n, dtype=np.int64)),
                     "w": pa.array(rng.integers(0, 100, n)
                                   .astype(np.int32))})


def _chain(ops, mk_cfg, threshold):
    """join → select (deferred) → groupby → sort, one plan callable."""
    def plan(t):
        j = ops.dist_join(t["f"], t["d"], mk_cfg(threshold))
        s = ops.dist_select(j, lambda e: e["rt-w"] > 20, compact=False)
        g = ops.dist_groupby(s, ["lt-g"], [("lt-v", "sum"),
                                           ("rt-w", "max")])
        return ops.dist_sort(g, "lt-g")
    return plan


def _jcfg(threshold):
    return dataclasses.replace(
        ct.JoinConfig(ct.JoinType.INNER, ct.JoinAlgorithm.HASH, "k", "k"),
        broadcast_threshold=threshold)


def _tcfg(threshold):
    return pt.JoinConfig(pt.JoinType.INNER, pt.JoinAlgorithm.HASH, "k", "k",
                         broadcast_threshold=threshold)


def _both(ctx, dctx, world):
    jf, tf = _tables(ctx, dctx, world, _facts(11))
    jd, td = _tables(ctx, dctx, world, _dims(12))
    jbroadcast.clear_replica_cache()
    tbroadcast.clear_replica_cache()
    return {"f": jf, "d": jd}, {"f": tf, "d": td}


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("threshold", [0, 1 << 20])
def test_join_groupby_chain_matches_jax(ctx, dctx, jax_trace_shim, world,
                                        threshold):
    jt, tt = _both(ctx, dctx, world)
    want = jobserve.analyze(_chain(jops, _jcfg, threshold), jt)
    got = tobserve.analyze(_chain(tops, _tcfg, threshold), tt)
    assert want.ok, want.error
    assert_reports_match(got, want)
    assert port_rows(got.output, ordered=True) == \
        jax_rows(want.output, ordered=True)
    ops = [n.op for n in got.nodes]
    assert ops[0] == "dist_join" and "dist_groupby" in ops
    if world == 8:
        decision = got.nodes[0].runtime["decision"]
        assert decision == ("broadcast" if threshold else "shuffle")
        assert got.totals["bytes_moved"] > 0
    # top-level nodes' bytes sum to the run's, which are the counters'
    top = sum(n.runtime["bytes_moved"] for n in got.nodes
              if n.runtime["depth"] == 1)
    c = got.totals["counters"]
    assert top == got.totals["bytes_moved"] == \
        c.get("shuffle.bytes_sent", 0) + c.get("broadcast.bytes_sent", 0)


@pytest.mark.parametrize("world", WORLDS)
def test_failing_plan_keeps_measured_nodes(ctx, dctx, jax_trace_shim, world):
    jt, tt = _both(ctx, dctx, world)

    def bad(ops, mk):
        def plan(t):
            j = ops.dist_join(t["f"], t["d"], mk(0))
            g = ops.dist_groupby(j, ["lt-g"], [("lt-v", "sum")])
            return ops.dist_groupby(g, ["no_such_column"], [("lt-g", "sum")])
        return plan

    want = jobserve.analyze(bad(jops, _jcfg), jt)
    got = tobserve.analyze(bad(tops, _tcfg), tt)
    assert not want.ok and not got.ok
    assert isinstance(got.error, CylonError)
    assert_reports_match(got, want)
    assert len(got.nodes) >= 2
    assert "[FAILED]" in str(got)


@pytest.mark.parametrize("enabled", [False, True])
def test_trace_flags_restored(enabled):
    tctx = pt.CylonContext(device="cpu", world=8)
    tf = TDTable.from_table(tctx, pt.Table.from_arrow(tctx, _facts(3)))
    (ttrace.enable if enabled else ttrace.disable)()
    try:
        rep = tctx.analyze(lambda t: tops.dist_sort(t, "k"), tf)
        assert rep.ok and ttrace.enabled() == enabled
        assert not ttrace.counters_enabled() or enabled
        # the run's spans stay readable after it
        assert "sort.local" in ttrace.phase_totals()
    finally:
        ttrace.disable()
        ttrace.reset()


def test_report_renders_and_explain_surfaces():
    tctx = pt.CylonContext(device="cpu", world=8)
    tf = TDTable.from_table(tctx, pt.Table.from_arrow(tctx, _facts(4)))
    td = TDTable.from_table(tctx, pt.Table.from_arrow(tctx, _dims(5)))
    tbroadcast.clear_replica_cache()
    rep = tf.explain(lambda t: tops.dist_join(t["f"], t["d"], _tcfg(0)),
                     tables={"f": tf, "d": td}, analyze=True)
    text = str(rep)
    assert text.startswith("EXPLAIN ANALYZE: 1 distributed op(s)")
    assert "dist_join(" in text and "*HOT*" in text
    assert rep.totals["syncs"] > 0 and rep.totals["host_reads"] > 0
    assert "join.gather" in rep.totals["phase_ms"]
    # the structural summary and the table checks
    assert tf.explain().startswith("DTable[500 rows over 8 shards, cap=64]")
    tf.explain(validate=True)
    broken = TDTable(tctx, tf.columns, tf.cap, tf.counts.to(torch.int64))
    with pytest.raises(CylonError, match="counts dtype"):
        broken.explain(validate=True)
    with pytest.raises(CylonError, match="not ported"):
        tf.explain(lambda t: t)
    with pytest.raises(CylonError, match="needs a plan"):
        tf.explain(analyze=True)


def test_analyze_attributes_builds():
    """A build inside the analyzed run is charged to its report."""
    @tobserve.kernel_factory
    def _scale_fn(factor: int):
        return lambda x: x * factor

    tctx = pt.CylonContext(device="cpu", world=1)
    tf = TDTable.from_table(tctx, pt.Table.from_arrow(tctx, _facts(6)))

    def plan(t):
        _scale_fn(3)(t.columns[1].data)
        return tops.dist_project(t, ["k"])

    rep = tobserve.analyze(plan, tf)
    assert rep.ok
    assert rep.totals["compiles"] == 1
    assert rep.totals["counters"]["compile.cache_misses"] == 1
    assert rep.totals["compile_ms"] >= 0.0
    rep2 = tobserve.analyze(plan, tf)  # same signature: no build
    assert rep2.totals["compiles"] == 0
    assert rep2.totals["counters"]["compile.cache_hits"] == 1


def test_rows_peek_does_not_cache_counts():
    tctx = pt.CylonContext(device="cpu", world=8)
    tf = TDTable.from_table(tctx, pt.Table.from_arrow(tctx, _facts(7)))
    seen = {}

    def plan(t):
        j = tops.dist_groupby(t, ["g"], [("v", "sum")])
        seen["j"] = j
        return tops.dist_sort(j, "g")

    rep = tobserve.analyze(plan, tf)
    assert rep.ok
    assert seen["j"]._counts_host is None
    assert rep.nodes[-1].runtime["rows_in"] == 7
