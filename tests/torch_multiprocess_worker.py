"""One process of a world that spans processes, for
``tests/test_torch_multiprocess.py`` (and by hand).

    python tests/torch_multiprocess_worker.py scenarios PROC NPROC LOCAL \
        INIT_URL OUT_DIR
    python tests/torch_multiprocess_worker.py peerloss PROC 2 1 INIT_URL OUT_DIR
    python tests/torch_multiprocess_worker.py tpch PROC NPROC LOCAL \
        INIT_URL OUT_DIR
    python tests/torch_multiprocess_worker.py tpch-single 0 1 WORLD \
        full|small OUT_DIR
    python tests/torch_multiprocess_worker.py planfault PROC 2 1 INIT_URL \
        OUT_DIR

``scenarios``: every process joins the world through
``CylonContext.InitMultiHost`` (gloo on the CPU, ``NPROC × LOCAL``
ranks), runs every scenario of :data:`SCENARIOS` on the same seeded
inputs (SPMD, as the reference's ranks do) and pickles, per scenario,
the rows of its OWN shards to ``OUT_DIR/proc<PROC>.pkl``; the test puts
the processes' shards side by side and holds them against the
single-process world of the same P and the JAX package.  ``peerloss``:
process 1 leaves before a collective that process 0 enters; process 0
records how ``resilience.classify`` sorts its error.  ``tpch``: the
TPC-H tables generated across processes, the queries eager and through
the planner, and (with several local ranks) the planner-lowered
operators, the plan check, ``run_pipeline`` and EXPLAIN ANALYZE
(:func:`run_tpch`); ``tpch-single`` runs the same on the
single-process world of the same P, in one process.  ``planfault``: a planned query under faults.

The scenario functions take an :class:`Env`, which names one package's
modules and ingest paths alike, so the test runs the same functions
through the port's simulated world and the JAX package.  No JAX import
here: the worker runs the port only.
"""
from __future__ import annotations

import os
import pickle
import sys
import time
import traceback

import numpy as np
import pyarrow as pa

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

N_LEFT, N_RIGHT = 2400, 1800
STRATEGIES = ("single-shot", "chunked", "ring", "allgather", "hierarchical")
# per-shard budget that cuts the chunked lowering into several rounds
CHUNKED_BUDGET = 48 << 10


# ---------------------------------------------------------------------------
# inputs (seeded with numpy; the same in every process)
# ---------------------------------------------------------------------------

def inputs(P: int, seed: int = 5):
    rng = np.random.default_rng(seed)
    kl = rng.integers(0, 60, N_LEFT)
    kr = rng.integers(0, 60, N_RIGHT)
    left = pa.table({
        "k": pa.array(kl, pa.int64(), mask=rng.random(N_LEFT) < 0.05),
        "v": pa.array(rng.random(N_LEFT)),
        "s": pa.array([f"g{x % 5}" for x in kl])})
    right = pa.table({
        "k": pa.array(kr, pa.int64(), mask=rng.random(N_RIGHT) < 0.05),
        "w": pa.array(rng.integers(-99, 99, N_RIGHT).astype(np.int32))})
    sa = pa.table({"a": pa.array(rng.integers(0, 30, 900).astype(np.int32)),
                   "b": pa.array([f"x{c}" for c in
                                  rng.integers(0, 4, 900)])})
    sb = pa.table({"a": pa.array(rng.integers(10, 40, 700).astype(np.int32)),
                   "b": pa.array([f"x{c}" for c in
                                  rng.integers(1, 5, 700)])})
    # dimension keys 0..199, unique: the dense FK join's right side
    dim = pa.table({"d": pa.array(rng.permutation(200).astype(np.int64)),
                    "x": pa.array(rng.integers(0, 1000, 200)
                                  .astype(np.int32))})
    fact = pa.table({"d": pa.array(rng.integers(0, 200, 1500)
                                   .astype(np.int64)),
                     "y": pa.array(rng.random(1500).astype(np.float32))})
    # one partition per rank: sizes and string dictionaries differ
    parts = []
    for r in range(P):
        n = 40 + 17 * r
        parts.append(pa.table({
            "k": pa.array(rng.integers(0, 25, n).astype(np.int32)),
            "s": pa.array([f"r{r % 3}-{c}" for c in
                           rng.integers(0, 3 + r % 4, n)])}))
    return {"left": left, "right": right, "sa": sa, "sb": sb, "dim": dim,
            "fact": fact, "parts": parts}


class Env:
    """One package's modules and ingest paths under neutral names:
    ``pk`` is ``cylon_tpu`` or ``cylon_tpu_torch``, ``ctx`` the
    distributed context, ``table_ctx`` the context local tables are built
    on (the JAX package's local context; the port's own)."""

    def __init__(self, pk, ctx, table_ctx, data):
        import importlib
        self.pk = pk
        self.ctx = ctx
        self.table_ctx = table_ctx
        self.data = data
        self.dops = importlib.import_module(pk.__name__ + ".parallel.dist_ops")
        self.config = importlib.import_module(pk.__name__ + ".config")
        self.faults = importlib.import_module(pk.__name__ + ".faults")
        self.DTable = importlib.import_module(
            pk.__name__ + ".parallel.dtable").DTable
        self.P = ctx.get_world_size()
        self.r0 = ctx.get_rank()
        self.L = len(ctx.local_ranks())

    def dtable(self, name: str):
        return self.DTable.from_table(
            self.ctx, self.pk.Table.from_arrow(self.table_ctx,
                                               self.data[name]))

    def join_config(self, how: str, alg: str, lkey="k", rkey="k",
                    threshold=0):
        pk = self.pk
        return pk.JoinConfig(pk.JoinType(how), pk.JoinAlgorithm(alg), lkey,
                             rkey, broadcast_threshold=threshold)


# ---------------------------------------------------------------------------
# scenarios: each returns a DTable (its shards are compared) or, for the
# host-side checks, a plain picklable value
# ---------------------------------------------------------------------------

def sc_from_table(e):
    return e.dtable("left")


def sc_from_pandas(e):
    return e.DTable.from_pandas(e.ctx, e.data["left"].to_pandas())


def sc_from_partitions(e):
    mine = e.data["parts"][e.r0:e.r0 + e.L]
    return e.DTable.from_partitions(
        e.ctx, [e.pk.Table.from_arrow(e.table_ctx, t) for t in mine])


def sc_shuffle(e):
    return e.dops.shuffle_table(e.dtable("left"), ["k"])


def _join(how, alg):
    def sc(e):
        return e.dops.dist_join(e.dtable("left"), e.dtable("right"),
                                e.join_config(how, alg))
    return sc


def _sort(ascending):
    def sc(e):
        return e.dops.dist_sort(e.dtable("left"), "v", ascending=ascending)
    return sc


def _setop(op):
    def sc(e):
        return getattr(e.dops, f"dist_{op}")(e.dtable("sa"), e.dtable("sb"))
    return sc


AGGS = [("v", "sum"), ("v", "mean"), ("v", "min"), ("v", "max"),
        ("v", "count")]


def sc_groupby_default(e):
    return e.dops.dist_groupby(e.dtable("left"), ["k"], AGGS)


def sc_groupby_shuffle(e):
    return e.dops.dist_groupby(e.dtable("left"), ["k", "s"], AGGS,
                               pre_aggregate=False)


def _lowering(strategy):
    """``shuffle_table`` under one forced lowering (hierarchical at the
    split ``(2, L)`` of a 2-process world; the single-process runs set the
    same split as the mesh shape)."""
    def sc(e):
        budget = CHUNKED_BUDGET if strategy == "chunked" else None
        shape = (2, e.P // 2) if strategy == "hierarchical" and e.P > 2 \
            else None
        e.config.set_exchange_strategy(strategy)
        e.config.set_device_memory_budget(budget)
        if getattr(e.ctx, "get_process_count", lambda: 1)() == 1:
            e.config.set_mesh_shape(shape)
        try:
            return e.dops.shuffle_table(e.dtable("left"), ["k", "s"])
        finally:
            e.config.set_exchange_strategy(None)
            e.config.set_device_memory_budget(None)
            e.config.set_mesh_shape(None)
    return sc


def sc_groupby_chunked_combine(e):
    """The pre-aggregated groupby's partial exchange forced chunked under
    a small budget: the rounds fold BY KEY (the by-key accumulator is
    sized from all-gathered group counts)."""
    e.config.set_exchange_strategy("chunked")
    e.config.set_device_memory_budget(CHUNKED_BUDGET // 4)
    prev = e.config.set_broadcast_join_threshold(None)  # shuffle combine
    try:
        return e.dops.dist_groupby(e.dtable("left"), ["k"], AGGS)
    finally:
        e.config.set_broadcast_join_threshold(prev)
        e.config.set_exchange_strategy(None)
        e.config.set_device_memory_budget(None)


def sc_undersized_hint(e):
    """A HASH join run twice: the second under a fault plan that quarters
    the capacity hint, so the join's validation redoes its dispatch."""
    f = e.faults
    cfg = e.join_config("inner", "hash")
    e.dops.dist_join(e.dtable("left"), e.dtable("right"), cfg)
    plan = f.FaultPlan(0, [f.FaultRule("compact.hint", kind="value",
                                       probability=1.0,
                                       mutate=f.undersize_hint)])
    with f.active(plan):
        return e.dops.dist_join(e.dtable("left"), e.dtable("right"), cfg)


def sc_broadcast_join(e):
    return e.dops.dist_join(e.dtable("left"), e.dtable("right"),
                            e.join_config("inner", "sort", threshold=10**6))


def sc_fk_join(e):
    return e.dops.dist_join(e.dtable("fact"), e.dtable("dim"),
                            e.join_config("inner", "hash", "d", "d"),
                            dense_key_range=(0, 199))


def sc_semi_join(e):
    return e.dops.dist_semi_join(e.dtable("left"), e.dtable("right"),
                                 "k", "k", broadcast_threshold=0)


def sc_anti_join(e):
    return e.dops.dist_anti_join(e.dtable("left"), e.dtable("right"),
                                 "k", "k", broadcast_threshold=0)


def sc_select(e):
    dt = e.dtable("left")
    kept = e.dops.dist_select(dt, lambda env: env["v"] > 0.5)
    return e.dops.dist_groupby(kept, ["s"], [("k", "count")],
                               pre_aggregate=False)


def sc_export(e):
    """Host-side: the global rows every process exports."""
    dt = e.dops.dist_sort(e.dtable("left"), "v")
    return {"num_rows": dt.num_rows,
            "to_table": dt.to_table().to_arrow().to_pydict(),
            "head": dt.head(7).to_arrow().to_pydict()}


# JAX-compared at world 8 (every other one against the port's single-
# process world only)
JAX_SCENARIOS = (
    ["from_table", "from_pandas", "from_partitions", "shuffle"]
    + [f"join_{alg}_{how}" for alg in ("hash", "sort")
       for how in ("inner", "left", "right", "full_outer")]
    + ["sort_asc", "sort_desc", "union", "intersect", "subtract",
       "groupby_default", "groupby_shuffle"]
    + [f"lowering_{s}" for s in STRATEGIES])

SCENARIOS = {
    "from_table": sc_from_table,
    "from_pandas": sc_from_pandas,
    "from_partitions": sc_from_partitions,
    "shuffle": sc_shuffle,
    **{f"join_{alg}_{how}": _join(how, alg) for alg in ("hash", "sort")
       for how in ("inner", "left", "right", "full_outer")},
    "sort_asc": _sort(True),
    "sort_desc": _sort(False),
    "union": _setop("union"),
    "intersect": _setop("intersect"),
    "subtract": _setop("subtract"),
    "groupby_default": sc_groupby_default,
    "groupby_shuffle": sc_groupby_shuffle,
    **{f"lowering_{s}": _lowering(s) for s in STRATEGIES},
    "groupby_chunked_combine": sc_groupby_chunked_combine,
    "undersized_hint": sc_undersized_hint,
    "broadcast_join": sc_broadcast_join,
    "fk_join": sc_fk_join,
    "semi_join": sc_semi_join,
    "anti_join": sc_anti_join,
    "select": sc_select,
    "export": sc_export,
}


# ---------------------------------------------------------------------------
# reading a result's rows (the format of test_torch_common.port_rows)
# ---------------------------------------------------------------------------

def _cell(v, valid, dictionary):
    if not valid:
        return None
    if dictionary is not None:
        return dictionary[v]
    if isinstance(v, float) and v != v:
        return "NaN"
    return v


def shard_rows(dt, counts, cap):
    """Rows per shard of ``dt``'s own blocks (``counts``: one per
    block): tuples of Python values, ``None`` for a null, the decoded
    string of a dictionary column, ``"NaN"`` for a float NaN."""
    from cylon_tpu_torch.dtypes import Type
    cols = []
    for c in dt.columns:
        data = np.asarray(c.data.cpu().numpy() if hasattr(c.data, "cpu")
                          else c.data)
        valid = None if c.validity is None else np.asarray(
            c.validity.cpu().numpy() if hasattr(c.validity, "cpu")
            else c.validity, dtype=bool)
        d = c.dictionary if c.dictionary is not None and int(
            c.dtype.type) in (int(Type.STRING), int(Type.BINARY)) else None
        cols.append((data, valid, d))
    shards = []
    for s, n in enumerate(counts):
        lo = s * cap
        lists = []
        for data, valid, d in cols:
            vals = data[lo:lo + n].tolist()
            ok = [True] * n if valid is None else valid[lo:lo + n].tolist()
            lists.append([_cell(x, v, d) for x, v in zip(vals, ok)])
        shards.append(list(zip(*lists)) if lists else [[]] * 0)
    return shards


def local_result(out):
    """A scenario's result as this process's picklable part."""
    if hasattr(out, "cap") and hasattr(out, "counts"):
        counts = [int(x) for x in out.counts.cpu().numpy()]
        return {"shards": shard_rows(out, counts, out.cap), "cap": out.cap,
                "names": out.column_names}
    return {"value": out}


# ---------------------------------------------------------------------------
# TPC-H and the planner across processes (tests/test_torch_multiprocess_tpch.py)
# ---------------------------------------------------------------------------

# the parity harness's setting (tests/tpch_torch_parity.py): SF 0.002 with
# the broadcast threshold at 256 rows, so nation, region and supplier
# broadcast while customer, part and orders shuffle, as at SF 10
TPCH_SCALE, TPCH_SEED, TPCH_THRESHOLD = 0.002, 7, 256
TPCH_VARIANTS = {"q9_streaming": ("q9", {"streaming_chunks": 3})}
# what a 2 × 1 world runs (the MPI shape): eager, and Q5 planned
TPCH_SMALL = ("q1", "q5", "q21")
FUSED_AGGS = [("l_extendedprice", "sum"), ("l_extendedprice", "mean"),
              ("l_quantity", "count"), ("l_quantity", "min"),
              ("l_quantity", "max")]
PSUM_AGGS = [("l_extendedprice", "sum"), ("l_extendedprice", "mean"),
             ("l_quantity", "count")]
SKETCH_AGGS = [("l_partkey", "approx_distinct"),
               ("l_extendedprice", "approx_quantile:0.5")]


def tpch_kwargs(scale=TPCH_SCALE, seed=TPCH_SEED) -> dict:
    """The queries' parameters at the test scale: the parity harness's
    Q18 / Q11 settings and, for Q17, the most frequent (brand, container)
    pair of the generated parts (the spec's pair selects none)."""
    from cylon_tpu_torch.tpch import datagen_device as dd
    cols, dicts = dd.generate_mirror(scale, seed=seed, tables=["part"])
    b, c = cols["part"]["p_brand"], cols["part"]["p_container"]
    pairs, n = np.unique(b.astype(np.int64) * 4096 + c, return_counts=True)
    top = int(pairs[int(np.argmax(n))])
    return {"q18": {"quantity": 120.0}, "q11": {"fraction_per_sf": 0.000002},
            "q17": {"brand": str(dicts["p_brand"][top // 4096]),
                    "container": str(dicts["p_container"][top % 4096])}}


def tpch_call(queries, ctx, tables, name: str, kwargs: dict):
    """Query (or variant) ``name`` of ``queries`` (either package's
    ``tpch.queries`` module) on ``tables``."""
    base, extra = TPCH_VARIANTS.get(name, (name, {}))
    return queries.QUERIES[base](ctx, tables, **dict(kwargs.get(base, {}),
                                                     **extra))


def table_rows(t):
    """A local Table's rows (the :func:`shard_rows` cell format)."""
    return shard_rows(t, [t.num_rows], t.num_rows)[0]


def shard_digests(dt):
    """Per local shard of ``dt``: (row count, sha1 of every column's
    valid rows' bytes and validity)."""
    import hashlib
    out = []
    for s, n in enumerate(int(x) for x in dt.counts.cpu().numpy()):
        lo = s * dt.cap
        h = hashlib.sha1()
        for c in dt.columns:
            h.update(c.data[lo:lo + n].contiguous().cpu().numpy().tobytes())
            if c.validity is not None:
                h.update(c.validity[lo:lo + n].cpu().numpy().tobytes())
        out.append((n, h.hexdigest()))
    return out


def _dt_result(dt):
    counts = [int(x) for x in dt.counts.cpu().numpy()]
    return {"shards": shard_rows(dt, counts, dt.cap), "cap": dt.cap,
            "names": dt.column_names}


def _lineitem_ops(pt, tables):
    """The planner-lowered operators on lineitem: the fused groupby in
    its three modes, the sketch groupby (its result and its captured
    sketch state), the Q5-shaped multiway join and a streaming join."""
    from cylon_tpu_torch import JoinAlgorithm, JoinConfig, JoinType
    from cylon_tpu_torch.parallel import dist_ops, dist_project
    from cylon_tpu_torch.parallel.streaming import dist_join_streaming
    li = tables["lineitem"]
    out = {
        "fused_psum": dist_ops.dist_groupby_fused(
            li, ["l_returnflag", "l_linestatus"], PSUM_AGGS, mode="psum"),
        "fused_preagg": dist_ops.dist_groupby_fused(
            li, ["l_orderkey"], FUSED_AGGS, mode="pre-aggregate"),
        "fused_shuffle": dist_ops.dist_groupby_fused(
            li, ["l_suppkey"], FUSED_AGGS, mode="shuffle"),
    }
    with dist_ops.collect_agg_state() as sink:
        out["sketch"] = dist_ops.dist_groupby_sketch(li, ["l_suppkey"],
                                                     SKETCH_AGGS)
    state = shard_digests(sink[-1].state)
    fact = dist_project(li, ["l_orderkey", "l_partkey", "l_suppkey",
                             "l_extendedprice"])
    dims = [dist_project(tables["orders"], ["o_orderkey", "o_orderdate"]),
            dist_project(tables["supplier"], ["s_suppkey", "s_nationkey"]),
            dist_project(tables["part"], ["p_partkey", "p_size"])]
    specs = [("l_orderkey", "o_orderkey", (1, tables["orders"].num_rows)),
             ("l_suppkey", "s_suppkey", None),
             ("l_partkey", "p_partkey", (1, tables["part"].num_rows))]
    names, edges = list(fact.column_names), []
    for dim, (fk, pk, dkr) in zip(dims, specs):
        joined = (["lt-" + n for n in names]
                  + ["rt-" + n for n in dim.column_names])
        names = [n[3:] for n in joined]
        edges.append(("inner", "sort", (fk,), (pk,), dkr, None,
                      tuple(zip(joined, names))))
    out["multiway"] = dist_ops.dist_multiway_join(fact, dims, edges)
    cfg = JoinConfig(JoinType.INNER, JoinAlgorithm.HASH, "l_orderkey",
                     "o_orderkey", broadcast_threshold=0)
    out["streaming"] = dist_join_streaming(fact, dims[0], cfg, chunks=3)
    res = {k: _dt_result(v) for k, v in out.items()}
    res["sketch_state"] = state
    return res


def _counted(ctx, fn):
    """``fn()``'s result and what it cost this process: host reads,
    partition-kernel launches and calls into torch.distributed."""
    from cylon_tpu_torch import trace
    from cylon_tpu_torch.ops import hash_cuda
    r0 = trace.counters().get("host.read", 0)
    l0 = hash_cuda.launches
    c0 = getattr(ctx.comm, "calls", 0)
    out = fn()
    return out, {"reads": trace.counters().get("host.read", 0) - r0,
                 "launches": hash_cuda.launches - l0,
                 "calls": getattr(ctx.comm, "calls", 0) - c0}


def run_tpch(ctx, names, planned, full: bool) -> dict:
    """TPC-H on ``ctx`` (a process world or the single-process world it
    is compared with): the generated tables' shard digests, the queries
    ``names`` eager, the queries ``planned`` through ``ctx.optimize``
    twice (a plan-cache miss, then a hit); with ``full`` also the
    lineitem operators, ``plan_check.validate`` and ``run_pipeline`` of
    every query and EXPLAIN ANALYZE of Q5.  Plain picklable values."""
    import cylon_tpu_torch as pt
    from cylon_tpu_torch import config, plan, trace
    from cylon_tpu_torch.analysis import plan_check
    from cylon_tpu_torch.ops import compact
    from cylon_tpu_torch.parallel import broadcast, dist_ops
    from cylon_tpu_torch.tpch import generate_device, queries
    prev = config.set_broadcast_join_threshold(TPCH_THRESHOLD)
    clear_hints(pt)
    broadcast.clear_replica_cache()
    plan.clear_plan_cache()
    trace.enable_counters()
    kwargs = tpch_kwargs()
    res = {"eager": {}, "decisions": {}, "planned": {}, "plan_cache": {}}
    try:
        tables = generate_device(ctx, TPCH_SCALE, seed=TPCH_SEED)
        res["tables"] = {n: {"cap": dt.cap, "counts": [
            int(c) for c in dt.counts_host()], "shards": shard_digests(dt)}
            for n, dt in tables.items()}
        res["columns"] = {}
        for q in names:
            dist_ops.decisions.clear()
            out = tpch_call(queries, ctx, tables, q, kwargs)
            res["eager"][q] = table_rows(out)
            res["columns"][q] = [(c.name, str(c.data.dtype))
                                 for c in out.columns]
            res["decisions"][q] = dict(dist_ops.decisions)
        for q in planned:
            op = lambda t, q=q: tpch_call(queries, ctx, t, q, kwargs)  # noqa
            c0 = trace.counters()
            got = [table_rows(ctx.optimize(op, tables)) for _ in range(2)]
            c1 = trace.counters()
            res["planned"][q] = got
            res["plan_cache"][q] = tuple(
                c1.get(k, 0) - c0.get(k, 0)
                for k in ("plan.cache_miss", "plan.cache_hit"))
        if not full:
            return res
        res["ops"] = _lineitem_ops(pt, tables)
        res["plan_check"], res["pipeline"] = {}, {}
        for q in names:
            op = lambda t, q=q: tpch_call(queries, ctx, t, q, kwargs)  # noqa
            rep, cost = _counted(ctx, lambda: plan_check.validate(
                op, tables, concrete=("nation", "region")))
            res["plan_check"][q] = dict(
                cost, ok=rep.ok, ops=[n.op for n in rep.nodes],
                result=rep.result, boundary=rep.boundary)
        for q in names:
            run = lambda q=q: tpch_call(queries, ctx, tables, q, kwargs)  # noqa
            c0 = trace.counters()
            rows = [table_rows(compact.run_pipeline(run)) for _ in range(2)]
            c1 = trace.counters()
            res["pipeline"][q] = {
                "rows": rows, **{k: c1.get(k, 0) - c0.get(k, 0) for k in
                                 ("pipeline.replays", "host.read")}}
        rep = ctx.analyze(lambda t: tpch_call(queries, ctx, t, "q5", kwargs),
                          tables)
        if rep.error is not None:
            raise rep.error
        res["analyze"] = {
            "ok": rep.ok, "processes": rep.totals.get("processes"),
            "nodes": [(n.op, n.runtime["rows_in"], n.runtime["rows_out"])
                      for n in rep.nodes],
            "rows": table_rows(rep.output)}
        trace.enable_counters()   # analyze resets the trace state
        return res
    finally:
        config.set_broadcast_join_threshold(prev)
        clear_hints(pt)
        broadcast.clear_replica_cache()
        plan.clear_plan_cache()
        trace.disable_counters()
        trace.reset()


def tpch_names(full: bool):
    from cylon_tpu_torch.tpch.queries import QUERIES
    return (list(QUERIES) + list(TPCH_VARIANTS)) if full else list(TPCH_SMALL)


def tpch_planned(full: bool):
    from cylon_tpu_torch.tpch.queries import QUERIES
    return list(QUERIES) if full else ["q5"]


def run_tpch_mode(proc, nproc, local, init, out_dir,
                  single: bool = False) -> None:
    """:func:`run_tpch` in process ``proc`` of the ``nproc × local``
    world (the whole run with several local ranks, the 2 × 1 subset with
    one); with ``single`` (``nproc`` 1), on the single-process world of
    ``local`` ranks a process world is compared with (``single.pkl``),
    ``init`` naming the run ("full" or "small")."""
    import torch
    torch.set_num_threads(2)
    import cylon_tpu_torch as pt
    if single:
        ctx = pt.CylonContext(device="cpu", world=nproc * local)
    else:
        ctx = pt.CylonContext.InitMultiHost(init, nproc, proc, world=local,
                                            device="cpu", timeout=60)
    full = init == "full" if single else local > 1
    t0 = time.monotonic()
    res = run_tpch(ctx, tpch_names(full), tpch_planned(full), full)
    res["seconds"] = time.monotonic() - t0
    ctx.barrier()
    ctx.finalize()
    name = "single.pkl" if single else f"proc{proc}.pkl"
    with open(os.path.join(out_dir, name), "wb") as f:
        pickle.dump(res, f)


def run_planfault(proc, nproc, local, init, out_dir) -> None:
    """A planned query under faults across processes: the same injected
    transient fault in both processes (both raise it, the ladder does not
    engage, the next run succeeds), then an error only process 1 sees
    (a RuntimeError at its first stage): process 1 tears the group down,
    and process 0's pending collective fails at once."""
    import torch
    torch.set_num_threads(2)
    import cylon_tpu_torch as pt
    from cylon_tpu_torch import config, faults, resilience
    from cylon_tpu_torch.tpch import generate_device, queries
    ctx = pt.CylonContext.InitMultiHost(init, nproc, proc, world=local,
                                        device="cpu", timeout=30)
    config.set_broadcast_join_threshold(TPCH_THRESHOLD)
    tables = generate_device(ctx, TPCH_SCALE, seed=TPCH_SEED)
    kwargs = tpch_kwargs()
    op = lambda t: tpch_call(queries, ctx, t, "q5", kwargs)  # noqa: E731
    got = {}
    plan = faults.FaultPlan(0, [faults.FaultRule("exec.stage",
                                                 kind="transient", nth=1)])
    try:
        with faults.active(plan):
            ctx.optimize(op, tables)
        got["injected"] = None
    except Exception as exc:  # the error under test
        got["injected"] = type(exc).__name__
    got["after"] = table_rows(ctx.optimize(op, tables))
    ctx.barrier()
    if proc == 1:
        real = faults.check

        def local_failure(point):
            if point == "exec.stage":
                raise RuntimeError("a failure only process 1 sees")
            return real(point)
        faults.check = local_failure
    t0 = time.monotonic()
    try:
        from cylon_tpu_torch import plan as pplan
        pplan.clear_plan_cache()
        ctx.optimize(op, tables)
        got["local"] = None
    except Exception as exc:  # the error under test
        got["local"] = type(exc).__name__
        got["local_class"] = resilience.classify(exc)
    got["seconds"] = time.monotonic() - t0
    with open(os.path.join(out_dir, f"proc{proc}.pkl"), "wb") as f:
        pickle.dump(got, f)
    os._exit(0)


# ---------------------------------------------------------------------------
# the process
# ---------------------------------------------------------------------------

def _controller(ctx):
    from cylon_tpu_torch import topology
    t0 = time.monotonic()
    ctx.barrier()
    return {"rank": ctx.get_rank(), "world": ctx.get_world_size(),
            "local_ranks": ctx.local_ranks(),
            "neighbours": ctx.get_neighbours(),
            "neighbours_all": ctx.get_neighbours(include_self=True),
            "distributed": ctx.is_distributed(),
            "processes": ctx.get_process_count(),
            "sequence": [ctx.get_next_sequence() for _ in range(3)],
            "axis_split": topology.axis_split(ctx),
            "slots": [s for _, s in topology.slots(ctx)],
            "barrier_s": time.monotonic() - t0}


def global_block(P: int, width: int = 3, seed: int = 9):
    """The seeded ``[P, P, width]`` int64 tensor whose row ``r`` is what
    rank ``r`` holds in the collectives check."""
    import torch
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(-1000, 1000, (P, P, width)))


def collectives(comm, x, split):
    """Every collective of ``comm`` on ``x`` (the local ranks' rows of
    :func:`global_block`): the flat forms, and the group-local forms
    under ``split`` (the process split; ``None`` skips them).  Values as
    numpy, one per collective."""
    out = {"all_to_all": comm.all_to_all(x),
           "all_gather": comm.all_gather(x[:, 0]),
           "all_reduce": comm.all_reduce(x[:, 0]),
           "all_gather_bool": comm.all_gather(x[:, 0] > 0)}
    for shift in (1, 3, -2):
        out[f"ppermute_{shift}"] = comm.ppermute(x[:, 0], shift)
    if split is not None:
        S, F = split
        for axis, G in (("slow", S), ("fast", F)):
            sp = {"split": split, "axis": axis}
            out[f"all_to_all_{axis}"] = comm.all_to_all(x[:, :G], **sp)
            out[f"all_gather_{axis}"] = comm.all_gather(x[:, 0], **sp)
            for shift in (1, G - 1):
                out[f"ppermute_{axis}_{shift}"] = comm.ppermute(
                    x[:, 0], shift, **sp)
    return {k: v.cpu().numpy() for k, v in out.items()}


def _collectives(ctx):
    from cylon_tpu_torch import CylonError
    P, r0, L = ctx.get_world_size(), ctx.get_rank(), ctx.get_local_world_size()
    split = (ctx.get_process_count(), L) if L > 1 else None
    x = global_block(P)[r0:r0 + L]
    got = collectives(ctx.comm, x, split)
    # a split other than the process split is refused, typed
    refused = None
    if L % 2 == 0:
        try:
            ctx.comm.all_to_all(x[:, :2], split=(P // 2, 2), axis="fast")
        except CylonError as exc:
            refused = exc.status.code.name
    return {"values": got, "other_split": refused}


def _refusals(ctx, dt):
    """Calls not ported across processes (the host tier, the morsel
    scans, the elastic re-mesh, slot placement, serving): each must raise
    a typed NotImplemented at once (no collective is entered, so nothing
    can hang)."""
    from cylon_tpu_torch import CylonError
    from cylon_tpu_torch.parallel import remesh
    from cylon_tpu_torch.serve import FleetRouter, ServeSession
    from cylon_tpu_torch.spill import morsel
    calls = {
        "spill": lambda: dt.spill(),
        "morsel_groupby": lambda: morsel.morsel_groupby(
            dt, ["k"], [("v", "sum")]),
        "remesh_table": lambda: remesh.remesh_table(dt, ctx),
        "with_world": lambda: ctx.with_world(2),
        "first_slot": lambda: ctx.first_slot,
        "ServeSession": lambda: ServeSession(ctx),
        "FleetRouter": lambda: FleetRouter([]),
    }
    out = {}
    for name, call in calls.items():
        t0 = time.monotonic()
        try:
            call()
            out[name] = ("no error", 0.0)
        except CylonError as exc:
            out[name] = (exc.status.code.name, time.monotonic() - t0)
    return out


def exchange_counters(counters) -> dict:
    """The exchange's strategy choices and this process's volume."""
    return {k: v for k, v in counters.items()
            if k.startswith("shuffle.strategy.")
            or k in ("shuffle.rows_sent", "shuffle.bytes_sent",
                     "shuffle.chunked_rounds", "groupby.bytes_moved")}


def clear_hints(pk) -> None:
    """Forget ``pk``'s optimistic size hints and degraded shuffle
    signatures (the port's names)."""
    import importlib
    importlib.import_module(pk.__name__ + ".parallel.dist_ops") \
        .clear_size_hints()
    importlib.import_module(pk.__name__ + ".parallel.shuffle") \
        .clear_chunk_state()


def run_scenarios(proc, nproc, local, init, out_dir) -> None:
    import torch
    torch.set_num_threads(2)
    import cylon_tpu_torch as pt
    ctx = pt.CylonContext.InitMultiHost(init, nproc, proc, world=local,
                                        device="cpu", timeout=60)
    data = inputs(ctx.get_world_size())
    env = Env(pt, ctx, ctx, data)
    results = {"controller": _controller(ctx),
               "collectives": _collectives(ctx)}
    seconds = {}
    from cylon_tpu_torch import trace
    trace.enable_counters()
    for name, fn in SCENARIOS.items():
        # each scenario sizes from its own counts, as the single-process
        # runs it is compared with do
        clear_hints(pt)
        trace.reset()
        t0 = time.monotonic()
        results[name] = local_result(fn(env))
        seconds[name] = time.monotonic() - t0
        results[name]["counters"] = exchange_counters(trace.counters())
    results["refusals"] = _refusals(ctx, env.dtable("left"))
    results["seconds"] = seconds
    ctx.barrier()
    ctx.finalize()
    with open(os.path.join(out_dir, f"proc{proc}.pkl"), "wb") as f:
        pickle.dump(results, f)


def run_peerloss(proc, nproc, local, init, out_dir) -> None:
    """Process 1 exits after the first collective; process 0 then enters
    an all_to_all that can never complete."""
    import torch
    import cylon_tpu_torch as pt
    from cylon_tpu_torch import resilience
    ctx = pt.CylonContext.InitMultiHost(init, nproc, proc, world=local,
                                        device="cpu", timeout=8)
    ctx.barrier()
    if proc == 1:
        os._exit(0)
    time.sleep(0.5)
    t0 = time.monotonic()
    got = {}
    try:
        x = torch.arange(ctx.get_world_size() * local, dtype=torch.int32)
        ctx.comm.all_to_all(x.view(local, ctx.get_world_size()))
        got = {"error": None}
    except Exception as exc:  # the error under test
        got = {"error": type(exc).__name__, "message": str(exc)[:400],
               "class": resilience.classify(exc)}
    got["seconds"] = time.monotonic() - t0
    with open(os.path.join(out_dir, f"proc{proc}.pkl"), "wb") as f:
        pickle.dump(got, f)
    os._exit(0)


def main(argv) -> int:
    mode, proc, nproc, local, init, out_dir = argv[1:7]
    sys.path.insert(0, REPO)
    try:
        if mode == "scenarios":
            run_scenarios(int(proc), int(nproc), int(local), init, out_dir)
        elif mode == "peerloss":
            run_peerloss(int(proc), int(nproc), int(local), init, out_dir)
        elif mode in ("tpch", "tpch-single"):
            run_tpch_mode(int(proc), int(nproc), int(local), init, out_dir,
                          single=mode == "tpch-single")
        elif mode == "planfault":
            run_planfault(int(proc), int(nproc), int(local), init, out_dir)
        else:
            raise SystemExit(f"unknown mode {mode!r}")
    except BaseException:
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
