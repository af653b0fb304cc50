"""The abstract plan checker: the port's ``plan_check.explain`` /
``validate`` over meta tensors against the JAX package's over tracers.

Both packages check the same plans on the same inputs (made from a seed
with numpy) at world 1 and on the 8 virtual CPU devices, and their
reports must agree: the same operator sequence, the same verdict, the
same export boundary and the same result schema.  Covered: every
distributed-operator family (joins shuffled and broadcast, semi / anti,
set ops, groupby and aggregate, shuffle, a deferred select into sort and
head, the replica gather) for int, dictionary-string and null keys; the
dense-key paths; all 22 TPC-H queries at SF 0.002 with nation and region
kept concrete.  Port-only: readable errors on broken inputs, the
boundary-before-any-op refusal, re-entrancy (inside an EXPLAIN ANALYZE
too), and that a plan run reads no count, launches nothing, and leaves
the size hints and the replica cache as they were.
"""
import dataclasses

import numpy as np
import pandas as pd
import pytest
import torch

import cylon_tpu as ct
from cylon_tpu.analysis import plan_check as jpc
from cylon_tpu.config import JoinConfig as JJoinConfig
from cylon_tpu.config import JoinType as JJoinType
from cylon_tpu.parallel import DTable as JDTable
from cylon_tpu import parallel as jpar
from cylon_tpu.parallel import broadcast as jbroadcast

import cylon_tpu_torch as pt
from cylon_tpu_torch import trace as ttrace
from cylon_tpu_torch.analysis import PlanExportReached, is_abstract
from cylon_tpu_torch.analysis import plan_check as tpc
from cylon_tpu_torch.analysis.plan_check import PlanValidationError
from cylon_tpu_torch.config import JoinConfig as TJoinConfig
from cylon_tpu_torch.config import JoinType as TJoinType
from cylon_tpu_torch.ops import hash_cuda
from cylon_tpu_torch.parallel import DTable as TDTable
from cylon_tpu_torch import parallel as tpar
from cylon_tpu_torch.parallel import broadcast as tbroadcast
from cylon_tpu_torch.parallel import dist_ops as tdist_ops
from cylon_tpu_torch.parallel import shuffle as tshuffle
from cylon_tpu_torch.tpch import queries as tqueries

from test_broadcast_join import _key_frames
from test_torch_common import jax_trace_shim  # noqa: F401
from test_torch_dist_join import _jctx
import tpch_torch_parity as tp

WORLDS = (1, 8)


def _both(dctx, world, *frames):
    """Each frame as a JAX DTable and a port DTable at ``world``."""
    jctx = _jctx(dctx, world)
    tctx = pt.CylonContext(device="cpu", world=world)
    jts = [JDTable.from_table(jctx, ct.Table.from_pandas(jctx, df))
           for df in frames]
    tts = [TDTable.from_table(tctx, pt.Table.from_pandas(tctx, df))
           for df in frames]
    return jts, tts


def _facts(rep):
    return ([n.op for n in rep.nodes], rep.ok, rep.boundary, rep.result)


def _same_report(jrep, trep):
    assert _facts(trep) == _facts(jrep), (str(trep), str(jrep))


class _Pkg:
    """One package's names, so a plan is written once for both."""

    def __init__(self, jax_side: bool):
        self.par = jpar if jax_side else tpar
        self.pc = jpc if jax_side else tpc
        self.JoinConfig = JJoinConfig if jax_side else TJoinConfig
        self.JoinType = JJoinType if jax_side else TJoinType
        self.replicate_table = (jbroadcast.replicate_table if jax_side
                                else tbroadcast.replicate_table)


JAX, PORT = _Pkg(True), _Pkg(False)


def _families(P):
    """name → (plan over (left, right, left head), kwargs)."""
    par = P.par

    def join(how, thr):
        return lambda lt, rt, l2: par.dist_join(lt, rt, P.JoinConfig(
            getattr(P.JoinType, how), left_column_idx="k",
            right_column_idx="k", broadcast_threshold=thr))

    return {
        "join-inner-bcast": join("INNER", None),
        "join-inner-shuffle": join("INNER", 0),
        "join-left-bcast": join("LEFT", None),
        "join-left-shuffle": join("LEFT", 0),
        "semi": lambda lt, rt, l2: par.dist_semi_join(lt, rt, "k", "k"),
        "anti": lambda lt, rt, l2: par.dist_anti_join(lt, rt, "k", "k"),
        "union": lambda lt, rt, l2: par.dist_union(lt, l2),
        "intersect": lambda lt, rt, l2: par.dist_intersect(lt, l2),
        "groupby": lambda lt, rt, l2: par.dist_groupby(
            lt, ["k"], [("a", "sum"), ("a", "mean")]),
        "aggregate": lambda lt, rt, l2: par.dist_aggregate(
            lt, [("a", "sum")]),
        "shuffle": lambda lt, rt, l2: par.shuffle_table(lt, ["k"]),
        "select-sort-head": lambda lt, rt, l2: par.dist_head(
            par.dist_sort(par.dist_select(lt, lambda env: env["a"] > 0.0,
                                          compact=False), "k"), 5),
        "replicate": lambda lt, rt, l2: P.replicate_table(rt),
    }


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("kind", ["int", "str", "nullint"])
def test_operator_families_match_jax(dctx, jax_trace_shim, kind, world):
    ldf, rdf = _key_frames(np.random.default_rng(11), kind)
    (jl, jr, j2), (tl, tr, t2) = _both(dctx, world, ldf, rdf, ldf.iloc[:40])
    jb, tb = _families(JAX), _families(PORT)
    for name in jb:
        jrep = jpc.validate(jb[name], jl, jr, j2)
        trep = tpc.validate(tb[name], tl, tr, t2)
        assert trep.ok, (name, str(trep))
        _same_report(jrep, trep)


@pytest.mark.parametrize("world", WORLDS)
def test_dense_key_paths_match_jax(dctx, jax_trace_shim, world):
    rng = np.random.default_rng(12)
    fact = pd.DataFrame({"k": rng.integers(1, 41, 200),
                         "a": rng.normal(size=200)})
    dim = pd.DataFrame({"k": np.arange(1, 41), "b": rng.normal(size=40)})
    (jf, jd), (tf, td) = _both(dctx, world, fact, dim)
    for P, f, d, side in ((JAX, jf, jd, "j"), (PORT, tf, td, "t")):
        reps = []
        for how in ("INNER", "LEFT"):
            reps.append(P.pc.validate(
                P.par.dist_join, f, d, P.JoinConfig(
                    getattr(P.JoinType, how), left_column_idx="k",
                    right_column_idx="k"), dense_key_range=(1, 40)))
        reps.append(P.pc.validate(P.par.dist_semi_join, f, d, "k", "k",
                                  dense_key_range=(1, 40)))
        reps.append(P.pc.validate(P.par.dist_groupby, f, ["k"],
                                  [("a", "sum")], dense_key_range=(1, 40),
                                  emit_empty=True))
        if side == "j":
            want = [_facts(r) for r in reps]
        else:
            assert all(r.ok for r in reps)
            assert [_facts(r) for r in reps] == want


@pytest.mark.parametrize("world", WORLDS)
def test_tpch_plans_match_jax(jax_trace_shim, world):
    """Every TPC-H query at SF 0.002, checked through ``DTable.explain``
    with nation and region concrete, in its eager form and, at world 1,
    through the planner (``optimize=True``, the form the bench validates;
    an abstract run of the port costs about 0.5 s a query at world 8, its
    meta kernels being Python decompositions): the port's
    report has the JAX package's operator sequence, verdict, boundary and
    result schema; Q7 and Q8 end in host tails, so both stop at the
    export boundary."""
    from cylon_tpu.tpch import queries as jqueries

    def check(base, kw, jctx, jt, tctx, tt):
        reps = []
        for optimize in (False, True) if world == 1 else (False,):
            reps.append(jt["lineitem"].explain(
                lambda t: jqueries.QUERIES[base](jctx, t, **kw), tables=jt,
                validate=True, concrete=("nation", "region"),
                optimize=optimize))
            reps.append(tt["lineitem"].explain(
                lambda t: tqueries.QUERIES[base](tctx, t, **kw), tables=tt,
                validate=True, concrete=("nation", "region"),
                optimize=optimize))
        return reps

    out = tp._sweep(list(tqueries.QUERIES), check, worlds=(world,))
    for (q, _), reps in out.items():
        for j, t in zip(reps[::2], reps[1::2]):
            assert t.ok and t.nodes, (q, str(t))
            _same_report(j, t)
            if q in ("q7", "q8"):
                assert t.boundary == "Table.to_arrow"
        assert "VALID" in str(reps[1]) and "dist_" in str(reps[1])


# ---------------------------------------------------------------------------
# port only: broken plans fail with readable errors, before any data moves
# ---------------------------------------------------------------------------

def _port_table(world=8, n=64, seed=13, **extra):
    rng = np.random.default_rng(seed)
    df = pd.DataFrame({"k": rng.integers(0, 9, n), "a": rng.normal(size=n),
                       **extra})
    ctx = pt.CylonContext(device="cpu", world=world)
    return TDTable.from_table(ctx, pt.Table.from_pandas(ctx, df))


def test_misshaped_leaf_readable_error():
    dt = _port_table()
    bad_col = dataclasses.replace(dt.columns[1],
                                  data=dt.columns[1].data[:-3])
    bad = TDTable(dt.ctx, [dt.columns[0], bad_col], dt.cap, dt.counts)
    with pytest.raises(PlanValidationError, match=r"leaf length .* P\*cap"):
        tpc.validate(tpar.dist_sort, bad, "k")


def test_key_type_mismatch_readable_error():
    rng = np.random.default_rng(14)
    ctx = pt.CylonContext(device="cpu", world=8)
    lt = TDTable.from_table(ctx, pt.Table.from_pandas(ctx, pd.DataFrame(
        {"k": rng.integers(0, 9, 64).astype(np.int32)})))
    rt = TDTable.from_table(ctx, pt.Table.from_pandas(ctx, pd.DataFrame(
        {"k": rng.normal(size=16)})))
    with pytest.raises(PlanValidationError, match="type mismatch"):
        tpc.validate(tpar.dist_join, lt, rt, TJoinConfig.InnerJoin("k", "k"))
    # without validate the report carries the error instead of raising
    rep = tpc.explain(tpar.dist_join, lt, rt, TJoinConfig.InnerJoin("k", "k"))
    assert not rep.ok and rep.error is not None
    assert "INVALID" in str(rep)


@pytest.fixture(scope="module")
def tpch_tables():
    data = tp.tpch_data(tp.SCALE, tp.SEED)
    ctx = pt.CylonContext(device="cpu", world=8)
    return ctx, {n: TDTable.from_table(ctx, pt.Table.from_pandas(ctx, df))
                 for n, df in data.items()}


def test_validate_rejects_boundary_before_any_op(tpch_tables):
    """Q7 folds nation keys at build time: without concrete= the probe
    reaches the export boundary before the first operator, and the check
    names the remedy instead of a vacuous VALID."""
    ctx, tables = tpch_tables
    with pytest.raises(PlanValidationError, match="concrete"):
        tpc.validate(lambda t: tqueries.q7(ctx, t), tables)
    # the boundary itself is control flow, raised by Table.to_arrow
    meta = tpc._flatten_dtable(tables["nation"])
    with pytest.raises(PlanExportReached):
        meta.to_table().to_pandas()


def test_explain_is_reentrant_and_suspends_analyze():
    """A plan may pre-flight a sub-plan with its own explain (the outer
    capture keeps recording), and an EXPLAIN ANALYZE whose plan does so
    keeps measuring after the abstract run."""
    dt = _port_table()

    def plan(t):
        inner = tpc.explain(tpar.dist_sort, dt, "k")  # nested
        assert inner.ok and [n.op for n in inner.nodes] == ["dist_sort"]
        return tpar.dist_select(t, lambda env: env["a"] > 0.0)

    rep = tpc.validate(plan, dt)
    assert rep.ok and [n.op for n in rep.nodes] == ["dist_select"]
    analyzed = dt.explain(plan, analyze=True)
    assert analyzed.analyzed and analyzed.ok
    assert [n.op for n in analyzed.nodes] == ["dist_select"]
    assert analyzed.nodes[0].runtime is not None


def test_abstract_tables_read_nothing_on_the_host():
    dt = _port_table()

    def plan(t):
        out = tpar.dist_select(t, lambda env: env["a"] > 0.0)
        assert is_abstract(out.counts) and out.ctx.device.type == "meta"
        assert "abstract rows" in repr(out)   # a repr never reads counts
        with pytest.raises(pt.CylonError, match="data-dependent"):
            out.counts_host()
        return out

    assert tpc.validate(plan, dt).ok


def test_dtable_explain_static_form(tpch_tables):
    """``DTable.explain(plan)`` without analyze returns the PlanReport (the
    static form); ``explain()`` alone still describes the table."""
    ctx, tables = tpch_tables
    rep = tables["lineitem"].explain(
        lambda t: tqueries.q3(ctx, t), tables=tables, validate=True)
    assert isinstance(rep, tpc.PlanReport) and rep.ok and not rep.analyzed
    assert rep.result.startswith("Table(l_orderkey:INT32")
    opt = tables["lineitem"].explain(
        lambda t: tqueries.q3(ctx, t), tables=tables, optimize=True)
    assert opt.ok and opt.nodes
    s = tables["nation"].explain(validate=True)
    assert "DTable[" in s and "n_nationkey" in s


def test_kernel_wrapper_meta_arm():
    """Meta key columns get the kernel's contract checks and a meta int32
    result, and launch nothing; the plain version stays the CPU path."""
    n = 1000
    cols = [torch.empty(n, dtype=torch.int64, device="meta"),
            torch.empty(n, dtype=torch.float32, device="meta")]
    valid = [None, torch.empty(n, dtype=torch.bool, device="meta")]
    before = hash_cuda.launches
    out = hash_cuda.partition_ids_fused(cols, valid, 8)
    assert out.device.type == "meta" and out.dtype == torch.int32
    assert tuple(out.shape) == (n,) and hash_cuda.launches == before
    with pytest.raises(pt.CylonError, match="unsupported key dtype"):
        hash_cuda.partition_ids_fused(
            [torch.empty(n, dtype=torch.complex64, device="meta")], [None], 8)
    with pytest.raises(pt.CylonError, match="contiguous"):
        hash_cuda.partition_ids_fused(
            [torch.empty((n, 2), dtype=torch.int64, device="meta")[:, 0]],
            [None], 8)


def test_plan_run_moves_no_rows_and_poisons_no_caches(tpch_tables):
    """A warm plan check reads no count, moves no byte, launches nothing
    and leaves every size hint and the replica cache as they were; the
    real query afterwards still answers as before."""
    ctx, tables = tpch_tables
    q = lambda t: tqueries.q5(ctx, t)  # noqa: E731
    tdist_ops.clear_size_hints()
    tbroadcast.clear_replica_cache()
    want = q(tables).to_pandas()      # seeds the hints and the replicas
    before = (dict(tdist_ops._capacity_hints),
              dict(tdist_ops._group_cap_hints),
              dict(tdist_ops._select_cap_hints),
              dict(tshuffle._block_hints),
              dict(tbroadcast._replica_cache))
    launches = hash_cuda.launches
    ttrace.reset()
    ttrace.enable_counters()
    try:
        rep = tpc.validate(q, tables, concrete=("nation", "region"))
        c = ttrace.counters()
    finally:
        ttrace.disable_counters()
        ttrace.reset()
    assert rep.ok and rep.nodes
    assert c.get("host.read", 0) == 0, c
    assert c.get("shuffle.bytes_sent", 0) == 0
    assert c.get("broadcast.bytes_sent", 0) == 0
    assert hash_cuda.launches == launches
    assert (dict(tdist_ops._capacity_hints),
            dict(tdist_ops._group_cap_hints),
            dict(tdist_ops._select_cap_hints),
            dict(tshuffle._block_hints),
            dict(tbroadcast._replica_cache)) == before
    pd.testing.assert_frame_equal(q(tables).to_pandas(), want)
    tdist_ops.clear_size_hints()
