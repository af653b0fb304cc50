"""TPC-H and the planner across processes: real processes over gloo on the
CPU.

``tests/torch_multiprocess_worker.py``'s ``tpch`` mode is launched once
per module for 2 processes × 4 local ranks (world 8, the JAX multi-host
worker's shape) and 2 × 1 (world 2, the MPI shape).  Each process joins
through ``CylonContext.InitMultiHost``, generates the TPC-H tables at SF
0.002 (seed 7) with ``generate_device`` and runs ``run_tpch``: the
queries eager and through ``ctx.optimize`` (a plan-cache miss, then a
hit), and at 2 × 4 also the planner-lowered operators on lineitem,
``plan_check.validate`` and ``run_pipeline`` of every query and EXPLAIN
ANALYZE of Q5, with the broadcast threshold at 256 rows (the parity
harness's setting).  The ``tpch-single`` mode runs the same
``run_tpch`` on the port's single-process world of the same P (in a
process of its own, beside the others), and every process's results must
equal it: the tables shard for shard, query rows in order (floats within
``float_rtols``), the same capacities, plan-cache traffic, plan-check
reports and pipeline replays.  At world 8 six queries are also held to
the JAX package on the same tables (the port's numpy mirror of the
generator, ingested by the JAX package), computed in this process
while the workers run.

A third pair of processes (2 × 1) runs a planned query under faults
(``planfault``).  Every worker wait is bounded, and a failure kills
every worker of the module.
"""
from __future__ import annotations

import math
import pickle

import numpy as np
import pytest

import torch_multiprocess_worker as W
from test_torch_common import assert_rows_close, jax_rows
from test_torch_multiprocess import WAIT_S, _launch, _load, _wait_all

LAYOUTS = {"2x4": (2, 4), "2x1": (2, 1)}
OPS = ["fused_psum", "fused_preagg", "fused_shuffle", "sketch", "multiway",
       "streaming"]
# the queries held to the JAX package at world 8 as well
JAX_QUERIES = ["q1", "q3", "q5", "q9", "q18", "q21"]


def _single(layout: str, out_dir: str):
    """The ``tpch-single`` worker: the layout's run on the single-process
    world of its P, in a process of its own."""
    n, L = LAYOUTS[layout]
    return _launch("tpch-single", 1, n * L, out_dir,
                   "full" if L > 1 else "small")


@pytest.fixture(scope="module")
def runs(tmp_path_factory, dctx):
    """Both layouts' workers, their single-process references and the
    fault pair, started together; the JAX package's world-8 queries are
    computed here while they run.  ``{"procs": {layout: [process
    results]}, "sim": {layout: result}, "fault": [process results],
    "jax": {query: rows}}``."""
    base = tmp_path_factory.mktemp("multiprocess_tpch")
    started = {name: _launch("tpch", n, L, str(base / name))
               for name, (n, L) in LAYOUTS.items()}
    singles = {name: _single(name, str(base / f"{name}_single"))
               for name in LAYOUTS}
    fault = _launch("planfault", 2, 1, str(base / "planfault"))
    everyone = [p for ps in list(started.values()) + list(singles.values())
                + [fault] for p in ps]
    try:
        jax_want = _jax_queries(dctx)
    except BaseException:
        for p in everyone:
            p.kill()
        raise
    for procs in list(started.values()) + list(singles.values()) + [fault]:
        _wait_all(procs, WAIT_S)

    def single(name):
        with open(str(base / f"{name}_single" / "single.pkl"), "rb") as f:
            return pickle.load(f)
    return {"sim": {name: single(name) for name in LAYOUTS},
            "procs": {name: _load(str(base / name), LAYOUTS[name][0])
                      for name in LAYOUTS},
            "fault": _load(str(base / "planfault"), 2), "jax": jax_want}


def _rtols(columns):
    """``float_rtols`` of a result from its recorded column dtypes."""
    return [1e-12 if d == "torch.float64" else 1e-6 if d == "torch.float32"
            else 0.0 for _, d in columns]


def _cat(results, get):
    return [x for r in results for x in get(r)]


# ---------------------------------------------------------------------------
# the tables and the queries: the single-process world of the same P
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_tables_equal_single_process_world(runs, layout):
    """``generate_device`` across processes: each process builds its own
    ranks' blocks; side by side they equal the single-process world's
    tables shard for shard (row counts and a digest of every column's
    valid rows and validity), with the same ``cap`` and the global counts
    in every process."""
    sim = runs["sim"][layout]["tables"]
    results = runs["procs"][layout]
    for name, want in sim.items():
        assert _cat(results, lambda r: r["tables"][name]["shards"]) == \
            want["shards"], name
        for r in results:
            assert r["tables"][name]["cap"] == want["cap"], name
            assert r["tables"][name]["counts"] == want["counts"], name


@pytest.mark.parametrize("q", W.tpch_names(True))
def test_eager_query_equals_single_process_world(runs, q):
    """Each of the 22 queries (and Q9's streaming variant) at 2 × 4:
    every process returns the single-process world 8's rows in order
    (keys and counts exactly, floats within ``float_rtols``) and took the
    same join and groupby decisions."""
    sim = runs["sim"]["2x4"]
    for r in runs["procs"]["2x4"]:
        assert r["columns"][q] == sim["columns"][q]
        assert_rows_close(r["eager"][q], sim["eager"][q],
                          _rtols(sim["columns"][q]))
        assert r["decisions"][q] == sim["decisions"][q]


def test_planned_queries_equal_single_process_world(runs):
    """The 22 queries through ``ctx.optimize`` at 2 × 4, twice: the first
    run misses the plan cache, the second hits it for every
    materialization, and both return the single-process world's planned
    rows in every process (the plan cache keys on the process split, and
    every process rewrote the plan alike)."""
    sim = runs["sim"]["2x4"]
    for q, (first, again) in sim["planned"].items():
        rtols = _rtols(sim["columns"][q])
        for r in runs["procs"]["2x4"]:
            got = r["planned"][q]
            assert_rows_close(got[0], first, rtols)
            assert got[1] == got[0], q
            assert r["plan_cache"][q] == sim["plan_cache"][q], q
            misses, hits = r["plan_cache"][q]
            assert misses >= 1 and hits >= 1, (q, misses, hits)


@pytest.mark.parametrize("op", OPS)
def test_lineitem_operator_equals_single_process_world(runs, op):
    """The planner-lowered operators on lineitem at 2 × 4 —
    ``dist_groupby_fused`` (psum over the dictionary keys, pre-aggregate
    and shuffle), ``dist_groupby_sketch`` (its estimates, and the merged
    sketch state it captures, lane for lane: the sample priorities seed
    from the GLOBAL rank), the Q5-shaped ``dist_multiway_join`` and
    ``dist_join_streaming`` in 3 slices — equal the single-process world
    8 shard for shard, rows in order, with the same ``cap``."""
    sim = runs["sim"]["2x4"]["ops"]
    results = runs["procs"]["2x4"]
    want = sim[op]
    assert _cat(results, lambda r: r["ops"][op]["shards"]) == want["shards"]
    for r in results:
        assert r["ops"][op]["cap"] == want["cap"]
        assert r["ops"][op]["names"] == want["names"]
    if op == "sketch":
        assert _cat(results, lambda r: r["ops"]["sketch_state"]) == \
            sim["sketch_state"]


def test_plan_check_makes_no_collective(runs):
    """``plan_check.validate`` of every query at 2 × 4 (nation and region
    concrete): the single-process world's verdict, operator list,
    boundary and result schema, with 0 host reads, 0 kernel launches and
    0 calls into ``torch.distributed`` in each process (the meta view's
    communicator returns meta tensors of the real collectives' shapes)."""
    sim = runs["sim"]["2x4"]["plan_check"]
    for r in runs["procs"]["2x4"]:
        for q, want in sim.items():
            got = r["plan_check"][q]
            assert (got["ok"], got["ops"], got["result"], got["boundary"]) \
                == (want["ok"], want["ops"], want["result"],
                    want["boundary"]), q
            assert (got["reads"], got["launches"], got["calls"]) == \
                (0, 0, 0), (q, got)
            assert got["ok"], q


def test_run_pipeline_replays_alike(runs):
    """``run_pipeline`` of every query at 2 × 4, twice: each process
    returns the eager rows and replays exactly as often as the other
    process and as the single-process world (every count the flush reads
    is replicated)."""
    sim = runs["sim"]["2x4"]
    a, b = runs["procs"]["2x4"]
    for q, want in sim["pipeline"].items():
        rtols = _rtols(sim["columns"][q])
        for r in (a, b):
            got = r["pipeline"][q]
            for rows in got["rows"]:
                assert_rows_close(rows, sim["eager"][q], rtols)
            assert got["pipeline.replays"] == want["pipeline.replays"], q
        assert a["pipeline"][q]["pipeline.replays"] == \
            b["pipeline"][q]["pipeline.replays"], q


def test_analyze_node_rows_are_global(runs):
    """EXPLAIN ANALYZE of Q5 at 2 × 4: every node's rows in and out equal
    the single-process world's in both processes (global rows), the
    report says it spans 2 processes (its bytes are this process's
    senders'), and its output is Q5's rows."""
    sim = runs["sim"]["2x4"]["analyze"]
    assert sim["processes"] == 1
    for r in runs["procs"]["2x4"]:
        got = r["analyze"]
        assert got["ok"] and got["processes"] == 2
        assert got["nodes"] == sim["nodes"]
        assert got["rows"] == sim["rows"]


def test_two_single_rank_processes(runs):
    """2 × 1 (one rank a process): the tables' global counts, Q1, Q5 and
    Q21 eager and Q5 through ``ctx.optimize`` (miss, then hit) equal the
    single-process world 2."""
    sim = runs["sim"]["2x1"]
    assert sorted(sim["eager"]) == sorted(W.TPCH_SMALL)
    for r in runs["procs"]["2x1"]:
        for q, want in sim["eager"].items():
            assert_rows_close(r["eager"][q], want, _rtols(sim["columns"][q]))
        assert r["planned"]["q5"] == sim["planned"]["q5"]
        assert r["plan_cache"]["q5"] == sim["plan_cache"]["q5"]


def test_plan_fault_raises_in_every_process(runs):
    """A planned Q5 under faults at 2 × 1.  The same injected transient
    fault (one seeded plan in both processes) raises in both — the
    recovery ladder does not engage across processes — and the next run
    succeeds in both.  An error only process 1 sees tears its group down,
    so process 0's pending collective fails at once (well inside the
    30 s group timeout) and classifies TOPOLOGY."""
    p0, p1 = runs["fault"]
    for r in (p0, p1):
        assert r["injected"] == "TransientFault", r
        assert r["after"] == p0["after"] and len(r["after"]) > 0
    assert p1["local"] == "RuntimeError"
    assert p0["local"] is not None and p0["local_class"] == "topology", p0
    assert p0["seconds"] < 10.0, p0


# ---------------------------------------------------------------------------
# world 8: the JAX package on the same tables
# ---------------------------------------------------------------------------

def _mirror_frames():
    """The generator's tables as pandas frames (the port's numpy mirror,
    strings decoded): what the JAX package ingests."""
    import pandas as pd

    from cylon_tpu_torch.tpch import datagen_device as dd
    cols, dicts = dd.generate_mirror(W.TPCH_SCALE, seed=W.TPCH_SEED)
    return {name: pd.DataFrame({
        c: (np.asarray(dicts[c], dtype=object)[v] if c in dicts else v)
        for c, v in tcols.items()}) for name, tcols in cols.items()}


def _q9_oracle(frames, color: str = "green"):
    """Q9 in numpy: ``{(nation, year): (exact sum of the IEEE float32
    amounts, Σ of one float32 ulp of each row's larger product)}``
    (``tests/tpch_torch_parity.q9_oracle`` on these frames)."""
    from cylon_tpu_torch.tpch.datagen import days_to_year
    part = frames["part"]
    keys = part.loc[part["p_name"].astype(str).str.contains(
        color, regex=False), "p_partkey"]
    li = frames["lineitem"]
    m = li[li["l_partkey"].isin(keys)].merge(
        frames["partsupp"], left_on=["l_partkey", "l_suppkey"],
        right_on=["ps_partkey", "ps_suppkey"])
    m = m.merge(frames["supplier"], left_on="l_suppkey", right_on="s_suppkey")
    m = m.merge(frames["nation"], left_on="s_nationkey",
                right_on="n_nationkey")
    m = m.merge(frames["orders"], left_on="l_orderkey", right_on="o_orderkey")
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


def _jax_queries(dctx):
    """``{query: rows}`` of :data:`JAX_QUERIES` through the JAX package at
    world 8 on the mirror's tables, under the trace shim of
    ``test_torch_common.jax_trace_shim`` (its hints cleared first)."""
    import jax
    from jax._src import core as jcore

    from cylon_tpu import config as jconfig
    from cylon_tpu.parallel import DTable as JDTable
    from cylon_tpu.tpch import queries as jqueries
    from tpch_torch_parity import _clear_jax_state
    frames = _mirror_frames()
    kwargs = W.tpch_kwargs()
    with pytest.MonkeyPatch.context() as mp:
        if not hasattr(jax.core, "trace_state_clean"):
            mp.setattr(jax.core, "trace_state_clean",
                       jcore.trace_state_clean, raising=False)
        prev = jconfig.set_broadcast_join_threshold(W.TPCH_THRESHOLD)
        _clear_jax_state()
        try:
            jt = {n: JDTable.from_pandas(dctx, df)
                  for n, df in frames.items()}
            return {q: jax_rows(W.tpch_call(jqueries, dctx, jt, q, kwargs),
                                ordered=True) for q in JAX_QUERIES}
        finally:
            jconfig.set_broadcast_join_threshold(prev)
            _clear_jax_state()


def test_world8_queries_equal_jax(runs):
    """Q1, Q3, Q5, Q9, Q18 and Q21 of the 2 × 4 processes equal the JAX
    package's queries at world 8 on the same tables, rows in order (keys
    and counts exactly, floats within ``float_rtols``).  Q9's
    ``sum_profit`` is held to a numpy oracle instead: the processes'
    equals the exact sum of the IEEE float32 amounts, the JAX package's is
    within the summed per-row ulp bound (XLA contracts the amount into a
    fused multiply-add)."""
    want = runs["jax"]
    sim = runs["sim"]["2x4"]
    oracle = _q9_oracle(_mirror_frames())
    for r in runs["procs"]["2x4"]:
        for q in JAX_QUERIES:
            got, jrows = r["eager"][q], want[q]
            rtols = _rtols(sim["columns"][q])
            if q == "q9":
                names = [n for n, _ in sim["columns"][q]]
                n, y, p = (names.index(c)
                           for c in ("n_name", "o_year", "sum_profit"))
                assert len(got) == len(jrows) == len(oracle)
                for g, j in zip(got, jrows):
                    exact, bound = oracle[(g[n], g[y])]
                    assert g[p] == exact, (g, exact)
                    assert abs(j[p] - g[p]) <= bound, (g, j, bound)
                got = [g[:p] + g[p + 1:] for g in got]
                jrows = [j[:p] + j[p + 1:] for j in jrows]
                del rtols[p]
            assert_rows_close(got, jrows, rtols)
