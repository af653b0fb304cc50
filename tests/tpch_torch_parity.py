"""Shared harness of the TPC-H query parity tests (a plain module, not a
test file): the JAX package's queries and the port's run on the same
``generate(0.002, seed=7)`` tables at world 1 and 8, both packages with
the broadcast threshold at 256 rows.  131,072 × 0.002 ≈ 262, so at this
scale nation, region and supplier broadcast while customer, part and
orders shuffle, as at SF 10 under the default threshold.

Every query result is compared with the JAX package's at the same world:
the same columns and types, the same rows in the same order (every query
ends in a sort), keys, counts and integers exactly, floats within
``float_rtols``.  Q9's ``sum_profit`` is held to a numpy oracle instead
(``q9_oracle``): it sums per-row amounts ``l_extendedprice·(1 −
l_discount) − ps_supplycost·l_quantity`` computed in float32, and XLA on
the CPU contracts that expression into a fused multiply-add (one rounding
fewer than the separate IEEE operations the port, numpy and pandas
perform).  So the port's group sums must equal numpy's IEEE amounts
summed exactly (``math.fsum``), and the JAX package's may differ from the
port's by at most one float32 ulp of each row's larger product, summed
over the group's rows (``test_q9_amount_is_separately_rounded`` pins the
port's per-row amount).
"""
from __future__ import annotations

import functools
import math

import numpy as np
import pytest

import cylon_tpu_torch as pt
from cylon_tpu_torch import config as tconfig
from cylon_tpu_torch import plan as tplan
from cylon_tpu_torch.parallel import DTable as TDTable
from cylon_tpu_torch.parallel import broadcast as tbroadcast
from cylon_tpu_torch.parallel import dist_ops as tdist_ops
from cylon_tpu_torch.tpch import queries as tqueries

from test_torch_common import (assert_rows_close, float_rtols, jax_rows,
                               port_rows, schema)

SCALE = 0.002
SEED = 7
THRESHOLD = 256
WORLDS = (1, 8)
# the parameters test_tpch.py runs the JAX queries with at this scale
KWARGS = {"q18": {"quantity": 120.0}, "q11": {"fraction_per_sf": 0.000002}}
# variants: a test name → (query, extra keyword arguments); Q9's
# streaming branch stages lineitem through dist_join_streaming in 3 slices
VARIANTS = {"q9_streaming": ("q9", {"streaming_chunks": 3})}
# results whose ``sum_profit`` is held to ``q9_oracle`` (see the module
# docstring)
Q9_PROFIT = ("q9", "q9_streaming")
NONEMPTY = ("q11", "q22")  # test_tpch.py asserts these cohorts exist


def _q17_kwargs(data):
    """The spec's (Brand#23, MED BOX) selects no part at this scale:
    test_tpch.py's rule, the most frequent (brand, container) pair."""
    p = data["part"]
    counts = p.groupby(["p_brand", "p_container"], observed=True).size()
    brand, container = counts.idxmax()
    return {"brand": str(brand), "container": str(container)}


def _clear_jax_state():
    from cylon_tpu.parallel import broadcast, dist_ops, shuffle
    shuffle._block_hints.clear()
    dist_ops._capacity_hints.clear()
    dist_ops._group_cap_hints.clear()
    dist_ops._select_cap_hints.clear()
    dist_ops._select_cache.clear()
    broadcast.clear_replica_cache()


def _sweep(names, run_one, scale=SCALE, seed=SEED, worlds=WORLDS):
    """``{(query, world): run_one(base query, kwargs, JAX context, JAX
    tables, port context, port tables)}`` for the queries ``names`` (a
    query or a ``VARIANTS`` name) at every world of ``worlds`` on
    ``tpch_data(scale, seed)``; JAX runs under the trace shim of
    ``test_torch_common.jax_trace_shim`` for the length of the call."""
    import jax
    from jax._src import core as jcore

    import cylon_tpu as ct
    from cylon_tpu import config as jconfig
    from cylon_tpu.parallel import DTable as JDTable

    data = tpch_data(scale, seed)
    kwargs = dict(KWARGS, q17=_q17_kwargs(data))
    cpus = jax.devices("cpu")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        if not hasattr(jax.core, "trace_state_clean"):
            mp.setattr(jax.core, "trace_state_clean",
                       jcore.trace_state_clean, raising=False)
        jprev = jconfig.set_broadcast_join_threshold(THRESHOLD)
        tprev = tconfig.set_broadcast_join_threshold(THRESHOLD)
        try:
            _clear_jax_state()
            tbroadcast.clear_replica_cache()
            for world in worlds:
                jctx = ct.CylonContext({"backend": "tpu",
                                        "devices": cpus[:world]})
                jt = {n: JDTable.from_pandas(jctx, df)
                      for n, df in data.items()}
                tctx = pt.CylonContext(device="cpu", world=world)
                tt = {n: TDTable.from_table(tctx,
                                            pt.Table.from_pandas(tctx, df))
                      for n, df in data.items()}
                for q in names:
                    base, extra = VARIANTS.get(q, (q, {}))
                    kw = dict(kwargs.get(base, {}), **extra)
                    out[(q, world)] = run_one(base, kw, jctx, jt, tctx, tt)
        finally:
            jconfig.set_broadcast_join_threshold(jprev)
            tconfig.set_broadcast_join_threshold(tprev)
            _clear_jax_state()
            tbroadcast.clear_replica_cache()
    return out


def _eager(base, kw, jctx, jt, tctx, tt):
    from cylon_tpu.tpch import queries as jqueries
    want = jqueries.QUERIES[base](jctx, jt, **kw)
    tdist_ops.decisions.clear()
    got = tqueries.QUERIES[base](tctx, tt, **kw)
    return got, want, dict(tdist_ops.decisions)


def run_both(names, scale=SCALE, seed=SEED, worlds=WORLDS):
    """``{(query, world): (port Table, JAX Table, port decisions)}``."""
    return _sweep(names, _eager, scale, seed, worlds)


def planned(plan_mod, ctx, op, tables):
    """``op(tables)`` through ``plan_mod``'s planner (either package's
    ``plan``), as ``plan.run`` does it, keeping the builder's statistics:
    ``(result, stats)``, the stats holding the rule-fire records
    (``fires``), the pre/post exchange row bytes and the cache hits and
    misses of this run."""
    b = plan_mod.Builder(ctx)
    with plan_mod.ir.capture(b):
        out = b.finish(op(b.wrap_tables(tables)))
    return out, b.stats


def _planned(base, kw, jctx, jt, tctx, tt):
    from cylon_tpu import plan as jplan
    from cylon_tpu.tpch import queries as jqueries
    want, jstats = planned(
        jplan, jctx, lambda t: jqueries.QUERIES[base](jctx, t, **kw), jt)
    eager = tqueries.QUERIES[base](tctx, tt, **kw)
    top = lambda t: tqueries.QUERIES[base](tctx, t, **kw)  # noqa: E731
    got, tstats = planned(tplan, tctx, top, tt)
    again, tstats2 = planned(tplan, tctx, top, tt)
    return {"got": got, "want": want, "eager": eager, "again": again,
            "stats": tstats, "jax_stats": jstats, "stats2": tstats2}


def run_planned(names):
    """``{(query, world): {...}}``: each query through the JAX package's
    planner (``want``), the port's eager run (``eager``), and the port's
    planner twice (``got``, a plan-cache miss, then ``again``), with the
    builders' statistics (``stats``, ``stats2``, ``jax_stats``).  Both
    packages' plan caches are cleared first."""
    from cylon_tpu import plan as jplan
    jplan.clear_plan_cache()
    tplan.clear_plan_cache()
    try:
        return _sweep(names, _planned)
    finally:
        jplan.clear_plan_cache()
        tplan.clear_plan_cache()


def check_query(results, q: str, world: int) -> None:
    got, want, _ = results[(q, world)]
    check_tables(q, got, want)


def check_tables(q: str, got, want) -> None:
    """The port's result ``got`` against the JAX package's ``want``."""
    assert schema(got) == schema(want)
    rows = port_rows(got, ordered=True)
    jrows = jax_rows(want, ordered=True)
    rtols = float_rtols(got)
    if q in Q9_PROFIT:
        check_q9_profit(got, want, q9_oracle(SCALE, SEED))
        j = got.column_names.index("sum_profit")
        rows = [r[:j] + r[j + 1:] for r in rows]
        jrows = [r[:j] + r[j + 1:] for r in jrows]
        del rtols[j]
    assert_rows_close(rows, jrows, rtols)
    if q in NONEMPTY:
        assert len(rows) > 0, f"{q}: empty result at the test scale"


@functools.lru_cache(maxsize=None)
def tpch_data(scale: float, seed: int):
    """The JAX package's pandas TPC-H tables (both packages ingest them)."""
    from cylon_tpu.tpch import generate
    return generate(scale, seed=seed)


@functools.lru_cache(maxsize=None)
def q9_oracle(scale: float, seed: int, color: str = "green"):
    """Q9 in numpy on ``tpch_data(scale, seed)``: ``{(nation, year):
    (exact sum of the IEEE float32 amounts, Σ of one float32 ulp of each
    row's larger product)}``."""
    from cylon_tpu_torch.tpch.datagen import days_to_year
    d = tpch_data(scale, seed)
    part = d["part"]
    keys = part.loc[part["p_name"].astype(str).str.contains(color, regex=False),
                    "p_partkey"]
    li = d["lineitem"]
    m = li[li["l_partkey"].isin(keys)].merge(
        d["partsupp"], left_on=["l_partkey", "l_suppkey"],
        right_on=["ps_partkey", "ps_suppkey"])
    m = m.merge(d["supplier"], left_on="l_suppkey", right_on="s_suppkey")
    m = m.merge(d["nation"], left_on="s_nationkey", right_on="n_nationkey")
    m = m.merge(d["orders"], left_on="l_orderkey", right_on="o_orderkey")
    f32 = {c: m[c].to_numpy(np.float32) for c in (
        "l_extendedprice", "l_discount", "ps_supplycost", "l_quantity")}
    x = f32["l_extendedprice"] * (np.float32(1) - f32["l_discount"])
    y = f32["ps_supplycost"] * f32["l_quantity"]
    amount = x - y
    ulp = np.spacing(np.maximum(np.abs(x), np.abs(y))).astype(np.float64)
    nation = m["n_name"].astype(str).to_numpy()
    year = days_to_year(m["o_orderdate"].to_numpy(np.int32))
    out = {}
    for key in sorted(set(zip(nation, year.tolist()))):
        rows = (nation == key[0]) & (year == key[1])
        out[key] = (math.fsum(amount[rows].astype(np.float64).tolist()),
                    float(ulp[rows].sum()))
    return out


def check_q9_profit(got, want, oracle) -> None:
    """Q9's ``sum_profit`` per (nation, year): the port's equals the
    oracle's exact sum; the JAX package's is within the group's summed
    per-row ulp bound of the port's."""
    rows = port_rows(got, ordered=True)
    jrows = jax_rows(want, ordered=True)
    names = got.column_names
    n, y, p = (names.index(c) for c in ("n_name", "o_year", "sum_profit"))
    assert len(rows) == len(jrows) == len(oracle)
    for r, jr in zip(rows, jrows):
        exact, bound = oracle[(r[n], r[y])]
        assert r[p] == exact, (r, exact)
        assert abs(jr[p] - r[p]) <= bound, (r, jr, bound)


# planned against eager on the port: a float32 column's mean at world > 1
# goes through float32 partial sums eagerly, and through the float64
# lanes of the psum combine when planned, so these carry float32
# precision
PLANNED_F32 = {"q1": {"mean_l_quantity", "mean_l_extendedprice",
                      "mean_l_discount"}}


def check_planned(results, q: str, world: int) -> None:
    """A planned query: the JAX planner's rows, the port's eager rows
    (keys, counts and integers exact, float64 within 1e-9 and float32
    within 1e-6 relative), the JAX planner's rule fires and planned row
    bytes, and a second run that hits the plan cache for every
    materialization and returns the same rows."""
    r = results[(q, world)]
    got, stats = r["got"], r["stats"]
    check_tables(q, got, r["want"])
    rtols = float_rtols(got, f64=1e-9)
    for j, c in enumerate(got.columns):
        if c.name in PLANNED_F32.get(q, ()):
            rtols[j] = 1e-6
    rows = port_rows(got, ordered=True)
    assert_rows_close(rows, port_rows(r["eager"], ordered=True), rtols)
    jstats = r["jax_stats"]
    assert stats["fires"] == jstats["fires"]
    assert stats["pre_exchange_row_bytes"] == \
        jstats["pre_exchange_row_bytes"]
    assert stats["post_exchange_row_bytes"] == \
        jstats["post_exchange_row_bytes"]
    assert stats["cache_misses"] >= 1
    again = r["stats2"]
    assert again["cache_misses"] == 0
    assert again["cache_hits"] >= 1
    assert again["fires"] == stats["fires"]
    assert port_rows(r["again"], ordered=True) == rows


def decisions(results, q: str, world: int) -> dict:
    return results[(q, world)][2]


def queries_param(names):
    return pytest.mark.parametrize(
        "q,world", [(q, w) for q in names for w in WORLDS])



# ---------------------------------------------------------------------------
# EXPLAIN ANALYZE of the queries (tests/test_torch_analyze_tpch_*.py)
# ---------------------------------------------------------------------------

ANALYZE_WORLDS = (8,)


def _analyzed(base, kw, jctx, jt, tctx, tt, optimize=False):
    """Both packages' ``analyze`` of one query (through each planner when
    ``optimize``, where the port's runs twice: a plan-cache miss, then a
    hit).  Replica caches are cleared first, so each query's wire bytes
    are its own."""
    from cylon_tpu import observe as jobserve
    from cylon_tpu.parallel import broadcast as jbroadcast
    from cylon_tpu.tpch import queries as jqueries

    from cylon_tpu_torch import observe as tobserve

    def jq(t):
        return jqueries.QUERIES[base](jctx, t, **kw)

    def tq(t):
        return tqueries.QUERIES[base](tctx, t, **kw)

    if optimize:
        # the DTable surface: explain(plan, tables=..., analyze=True,
        # optimize=True) routes the plan through the planner
        def jrun():
            return jt["lineitem"].explain(jq, tables=jt, analyze=True,
                                          optimize=True)

        def trun():
            return tt["lineitem"].explain(tq, tables=tt, analyze=True,
                                          optimize=True)
    else:
        def jrun():
            return jobserve.analyze(jq, jt)

        def trun():
            return tobserve.analyze(tq, tt)
    jbroadcast.clear_replica_cache()
    tbroadcast.clear_replica_cache()
    want = jrun()
    tbroadcast.clear_replica_cache()
    got = trun()
    again = None
    if optimize:
        tbroadcast.clear_replica_cache()
        again = trun()
    return {"got": got, "want": want, "again": again}


def run_analyzed(names, optimize=False):
    """``{(query, 8): {"got", "want", "again"}}``: the reports of
    ``analyze`` on both packages (plan caches cleared first)."""
    from cylon_tpu import plan as jplan
    jplan.clear_plan_cache()
    tplan.clear_plan_cache()
    try:
        return _sweep(names, functools.partial(_analyzed,
                                               optimize=optimize),
                      worlds=ANALYZE_WORLDS)
    finally:
        jplan.clear_plan_cache()
        tplan.clear_plan_cache()


ANALYZE_FIELDS = ("depth", "decision", "bytes_moved", "rows_out")


def check_analyzed(results, q: str, world: int) -> None:
    """The port's EXPLAIN ANALYZE of ``q`` against the JAX package's: the
    same result, the same operators in order with equal depth, decision,
    bytes moved, rows out and (where the JAX package has one) rows in;
    equal total bytes and rows sent; every counter in the catalogue; the
    top-level nodes' bytes summing to the totals."""
    from cylon_tpu_torch.observe import METRICS

    r = results[(q, world)]
    got, want = r["got"], r["want"]
    assert want.ok, want.error
    assert got.ok, got.error
    check_tables(q, got.output, want.output)
    assert [n.op for n in got.nodes] == [n.op for n in want.nodes]
    for g, w in zip(got.nodes, want.nodes):
        for f in ANALYZE_FIELDS:
            assert g.runtime[f] == w.runtime[f], (q, g.op, f, g.runtime[f],
                                                  w.runtime[f])
        if w.runtime["rows_in"] is not None:
            assert g.runtime["rows_in"] == w.runtime["rows_in"], (q, g.op)
    for k in ("bytes_moved", "rows_sent"):
        assert got.totals[k] == want.totals[k], (q, k)
    counters = got.totals["counters"]
    assert set(counters) <= set(METRICS), set(counters) - set(METRICS)
    top = sum(n.runtime["bytes_moved"] for n in got.nodes
              if n.runtime["depth"] == 1)
    assert top == got.totals["bytes_moved"]
    assert got.totals["syncs"] == counters.get("trace.sync", 0) > 0


def check_analyzed_optimized(results, q: str, world: int) -> None:
    """``check_analyzed`` through the planners, plus the optimizer totals:
    the JAX package's rule fires, row bytes and cache miss, then a rerun
    that hits the plan cache with the same rows."""
    check_analyzed(results, q, world)
    r = results[(q, world)]
    got, want, again = r["got"], r["want"], r["again"]
    opt, jopt = got.totals["optimizer"], want.totals["optimizer"]
    assert opt == jopt
    assert opt["cache_misses"] >= 1 and opt["cache_hits"] == 0
    aopt = again.totals["optimizer"]
    assert aopt["cache_misses"] == 0 and aopt["cache_hits"] >= 1
    assert aopt["rule_fires"] == opt["rule_fires"]
    assert port_rows(again.output, ordered=True) == \
        port_rows(got.output, ordered=True)
    assert got.stats_digests and again.stats_digests == got.stats_digests


def analyzed_param(names):
    return pytest.mark.parametrize(
        "q,world", [(q, w) for q in names for w in ANALYZE_WORLDS])
