"""Deferred-validation pipelines: the port's ``run_pipeline`` against its
eager runs and against the JAX package's ``run_pipeline``.

Inside ``run_pipeline`` every optimistic dispatch that has a size hint
queues its validation, and the queue resolves in ONE batched host read at
the next host boundary; an undersized hint replays the region.  Both
packages run the same plans on the same inputs (made from a seed with
numpy) at world 1 and on the 8 virtual CPU devices: results identical to
the eager path and to each other, a correct replay on a forced
undersized hint (sabotaged hints, or the ``compact.hint`` fault point),
the poisoned-prefix cases (a no-hint op after an undersized dispatch, a
contract-validating post on poisoned counts), deferred selects inside a
pipeline, the replay and fallback counters, and all 22 TPC-H queries
under ``run_pipeline`` equal to their eager results in order, with fewer
host reads once the hints are warm.
"""
import io
import sys

import numpy as np
import pandas as pd
import pytest

import cylon_tpu as ct
from cylon_tpu import config as jconfig
from cylon_tpu import faults as jfaults
from cylon_tpu.parallel import DTable as JDTable
from cylon_tpu.parallel import dist_ops as jdops
from cylon_tpu.parallel import shuffle as jshuffle
from cylon_tpu import parallel as jpar

import cylon_tpu_torch as pt
from cylon_tpu_torch import config as tconfig
from cylon_tpu_torch import faults as tfaults
from cylon_tpu_torch import logging as tglog
from cylon_tpu_torch import trace as ttrace
from cylon_tpu_torch.ops import compact as ops_compact
from cylon_tpu_torch.parallel import DTable as TDTable
from cylon_tpu_torch.parallel import dist_ops as tdops
from cylon_tpu_torch.parallel import shuffle as tshuffle
from cylon_tpu_torch import parallel as tpar
from cylon_tpu_torch.tpch import queries as tqueries

from test_torch_common import clear_port_hints, jax_trace_shim  # noqa: F401
from test_torch_dist_join import _jctx
import tpch_torch_parity as tp

WORLDS = (1, 8)


class _Pkg:
    """One package's names, so a plan is written once for both."""

    def __init__(self, jax_side: bool):
        self.jax = jax_side
        self.par = jpar if jax_side else tpar
        self.dops = jdops if jax_side else tdops
        self.shuffle = jshuffle if jax_side else tshuffle
        self.faults = jfaults if jax_side else tfaults
        self.config = jconfig if jax_side else tconfig
        self.cfg = (ct if jax_side else pt).JoinConfig
        self.JT = (ct if jax_side else pt).JoinType
        self.JA = (ct if jax_side else pt).JoinAlgorithm

    def tables(self, dctx, world, *frames):
        if self.jax:
            c = _jctx(dctx, world)
            return [JDTable.from_table(c, ct.Table.from_pandas(c, df))
                    for df in frames]
        c = pt.CylonContext(device="cpu", world=world)
        return [TDTable.from_table(c, pt.Table.from_pandas(c, df))
                for df in frames]

    def sort_join(self, left, right):
        return self.par.dist_join(left, right, self.cfg(
            self.JT.INNER, self.JA.SORT, 0, 0))

    def sabotage_join_hints(self):
        sab = False
        for key in list(self.dops._capacity_hints):
            if key[3] == "inner" and key[4] == "sort":
                self.dops._capacity_hints[key] = ((8,), 0)
                sab = True
        return sab


JAX, PORT = _Pkg(True), _Pkg(False)


def _mk(rng, n, kmax):
    return pd.DataFrame({"k": rng.integers(0, kmax, n).astype(np.int32),
                         "v": rng.random(n).astype(np.float32)})


def _query(P, left, right):
    j = P.sort_join(left, right)
    g = P.par.dist_groupby(j.rename(["k", "vl", "k2", "vr"]), ["k"],
                           [("vl", "sum")])
    out = g.to_table().to_pandas()
    return out.sort_values("k").reset_index(drop=True)


def _oracle(ldf, rdf):
    m = ldf.merge(rdf, on="k", how="inner", suffixes=("_l", "_r"))
    g = m.groupby("k", as_index=False)["v_l"].sum()
    return g.sort_values("k").reset_index(drop=True)


def _check(out, expect):
    np.testing.assert_array_equal(out["k"], expect["k"])
    np.testing.assert_allclose(out["sum_vl"], expect["v_l"], rtol=1e-5)


@pytest.fixture
def no_broadcast():
    """Broadcast joins off in both packages, so every join shuffles."""
    prev = [m.set_broadcast_join_threshold(None) for m in (jconfig, tconfig)]
    yield
    for m, p in zip((jconfig, tconfig), prev):
        m.set_broadcast_join_threshold(p)


@pytest.fixture
def counters():
    ttrace.reset()
    ttrace.enable_counters()
    yield ttrace.counters
    ttrace.disable_counters()
    ttrace.reset()


@pytest.mark.parametrize("world", WORLDS)
def test_pipeline_matches_sync_and_jax(dctx, jax_trace_shim, counters,
                                       world):
    rng = np.random.default_rng(21)
    ldf, rdf = _mk(rng, 400, 60), _mk(rng, 300, 60)
    expect = _oracle(ldf, rdf)
    got = {}
    for P in (JAX, PORT):
        left, right = P.tables(dctx, world, ldf, rdf)
        ttrace.reset()
        sync = _query(P, left, right)             # also seeds the hints
        eager_reads = counters().get("host.read", 0)
        ttrace.reset()
        pipe = P.par.run_pipeline(lambda: _query(P, left, right))
        pipe_reads = counters().get("host.read", 0)
        for out in (sync, pipe):
            _check(out, expect)
        got[P.jax] = pipe
        if not P.jax:
            # the hints are warm: the join, the shuffles and the groupby
            # ride the export's one batched read
            assert pipe_reads < eager_reads, (pipe_reads, eager_reads)
            assert counters().get("pipeline.replays", 0) == 0
    pd.testing.assert_frame_equal(got[False], got[True])


@pytest.mark.parametrize("world", WORLDS)
def test_pipeline_replays_on_undersized_hint(dctx, jax_trace_shim,
                                             counters, world):
    rng = np.random.default_rng(22)
    ldf, rdf = _mk(rng, 500, 10), _mk(rng, 400, 10)  # heavy duplication
    expect = _oracle(ldf, rdf)
    for P in (JAX, PORT):
        left, right = P.tables(dctx, world, ldf, rdf)
        _query(P, left, right)  # seed real hints
        assert P.sabotage_join_hints()
        ttrace.reset()
        out = P.par.run_pipeline(lambda: _query(P, left, right))
        _check(out, expect)
        # the replay GREW the sabotaged hints
        assert any(h[0][0] > 8 for h in P.dops._capacity_hints.values())
        if not P.jax:
            assert counters().get("pipeline.replays", 0) >= 1
    assert ops_compact._deferred.pending == []
    assert not ops_compact.deferred_mode()


def test_flush_pending_idempotent_outside_region():
    assert ops_compact.flush_pending() is True
    assert ops_compact.flush_pending() is True


@pytest.mark.parametrize("world", WORLDS)
def test_pipeline_hint_miss_after_poisoned_dispatch(dctx, jax_trace_shim,
                                                    world):
    """An op with NO size hint inside a deferred region must not size
    itself from counts computed downstream of an undersized dispatch: the
    region flushes, finds the poison, raises ReplayNeeded internally, and
    run_pipeline replays to the correct result."""
    rng = np.random.default_rng(23)
    ldf, rdf = _mk(rng, 600, 8), _mk(rng, 500, 8)
    got = {}
    for P in (JAX, PORT):
        left, right = P.tables(dctx, world, ldf, rdf)

        def query():
            j = P.sort_join(left, right)
            j2 = P.par.dist_join(j.rename(["k", "v1", "k2", "v2"]),
                                 right.rename(["k", "w"]),
                                 P.cfg(P.JT.INNER, P.JA.HASH, 0, 0))
            return j2.to_table().num_rows

        expect = query()  # sync seeding of all hints
        sab = {key: ((8,), 0) for key in P.dops._capacity_hints
               if key[3] == "inner" and key[4] == "sort"}
        assert sab
        P.dops._capacity_hints.clear()
        P.dops._capacity_hints.update(sab)
        got[P.jax] = P.par.run_pipeline(query)
        assert got[P.jax] == expect
    assert got[False] == got[True]


def test_contract_post_not_called_on_poisoned_counts(dctx, jax_trace_shim,
                                                     no_broadcast):
    """An undersized upstream exchange poisons every downstream queued
    count; the FK join's contract-validating post must NOT run on that
    garbage (it would raise a hard CylonError instead of letting
    run_pipeline replay)."""
    rng = np.random.default_rng(24)
    ldf, rdf = _mk(rng, 3000, 4000), _mk(rng, 2000, 4000)
    pk = pd.DataFrame({"k": np.arange(0, 4000, dtype=np.int32),
                       "c": rng.random(4000).astype(np.float32)})
    got = {}
    for P in (JAX, PORT):
        left, right, pkt = P.tables(dctx, 8, ldf, rdf, pk)

        def query():
            j = P.sort_join(left, right)
            fk = P.par.dist_join(j.rename(["k", "v1", "k2", "v2"]), pkt,
                                 P.cfg.LeftJoin(0, 0),
                                 dense_key_range=(0, 3999))
            return fk.to_table().num_rows

        expect = query()  # sync seeding of all hints
        assert any(k[0] == "fkleft" for k in P.dops._capacity_hints)
        assert P.shuffle._block_hints
        for key in list(P.shuffle._block_hints):
            P.shuffle._block_hints[key] = ((8, 256), 0)
        got[P.jax] = P.par.run_pipeline(query)
        assert got[P.jax] == expect
    assert got[False] == got[True]


@pytest.mark.parametrize("world", WORLDS)
def test_deferred_select_inside_run_pipeline(dctx, jax_trace_shim, world):
    """Deferred select masks and the replay protocol together: a deferred
    select into a dense LEFT join into a groupby."""
    rng = np.random.default_rng(25)
    n = 600
    df = pd.DataFrame({"k": rng.integers(1, 60, n).astype(np.int64),
                       "v": rng.normal(size=n)})
    pk = pd.DataFrame({"k": np.arange(1, 60, dtype=np.int64),
                       "c": rng.normal(size=59)})
    w = df[df["v"] > 0].merge(pk, on="k", how="left")
    want = w.groupby("c")["v"].sum().reset_index()
    want.columns = ["rt-c", "sum_lt-v"]
    want = want.sort_values("rt-c").reset_index(drop=True)
    for P in (JAX, PORT):
        dt, pkt = P.tables(dctx, world, df, pk)

        def plan():
            d = P.par.dist_select(dt, lambda env: env["v"] > 0.0,
                                  compact=False)
            j = P.par.dist_join(d, pkt, P.cfg(P.JT.LEFT, P.JA.SORT, 0, 0),
                                dense_key_range=(1, 59))
            return P.par.dist_groupby(j, ["rt-c"], [("lt-v", "sum")]) \
                .to_table()

        for _ in range(2):  # cold, then with every hint warm
            got = P.par.run_pipeline(plan).to_pandas()
            got = got.sort_values("rt-c").reset_index(drop=True)
            np.testing.assert_allclose(got["rt-c"], want["rt-c"])
            np.testing.assert_allclose(got["sum_lt-v"], want["sum_lt-v"],
                                       rtol=1e-9)


@pytest.mark.parametrize("world", WORLDS)
def test_forced_undersized_hint_redoes_correctly(dctx, jax_trace_shim,
                                                 world):
    """The ``compact.hint`` fault point quarters every hint it sees
    (``faults.undersize_hint``): plain mode redoes each undersized
    dispatch, run_pipeline replays, and both equal the fault-free
    result — in both packages."""
    rng = np.random.default_rng(26)
    ldf, rdf = _mk(rng, 500, 10), _mk(rng, 400, 10)
    frames = {}
    for P in (JAX, PORT):
        left, right = P.tables(dctx, world, ldf, rdf)

        def frame():
            df = P.sort_join(left, right).to_table().to_pandas()
            return df.sort_values(list(df.columns)).reset_index(drop=True)

        want = frame()  # seeds the hints
        for deferred in (False, True):
            plan = P.faults.FaultPlan(2, [P.faults.FaultRule(
                "compact.hint", kind="value", probability=1.0,
                mutate=P.faults.undersize_hint, limit=6)])
            with P.faults.active(plan):
                got = P.par.run_pipeline(frame) if deferred else frame()
            assert plan.injected >= 1
            pd.testing.assert_frame_equal(got, want)
        frames[P.jax] = want
    pd.testing.assert_frame_equal(frames[False], frames[True])


def _pipe_tables(world):
    rng = np.random.default_rng(27)
    return PORT.tables(None, world, _mk(rng, 500, 10), _mk(rng, 400, 10))


def test_pipeline_replays_counted(counters):
    left, right = _pipe_tables(8)

    def query():
        return PORT.sort_join(left, right).to_table().num_rows

    want = query()  # seed hints
    assert PORT.sabotage_join_hints()
    ttrace.reset()
    assert tpar.run_pipeline(query) == want
    assert counters().get("pipeline.replays", 0) >= 1
    assert counters().get("pipeline.fallback_plain", 0) == 0


def test_pipeline_fallback_plain_counted_and_warned(counters):
    left, right = _pipe_tables(8)

    def query():
        # re-sabotage on EVERY attempt: the deferred validation never
        # comes back clean, so run_pipeline falls back to plain mode
        PORT.sabotage_join_hints()
        return PORT.sort_join(left, right).to_table().num_rows

    want = PORT.sort_join(left, right).to_table().num_rows  # seed hints
    ttrace.reset()
    sink = io.StringIO()
    tglog.set_sink(sink)
    try:
        got = tpar.run_pipeline(query, max_attempts=2)
    finally:
        tglog.set_sink(sys.stderr)
    assert got == want
    c = counters()
    assert c.get("pipeline.replays", 0) >= 2
    assert c.get("pipeline.fallback_plain", 0) == 1
    assert "plain per-op validation" in sink.getvalue()


@pytest.mark.parametrize("world", WORLDS)
def test_tpch_under_run_pipeline_equals_eager(counters, world):
    """All 22 TPC-H queries at SF 0.002 (the parity harness's tables and
    parameters): warm-up, then under run_pipeline — each result equals
    the eager one in order (the eager results equal the JAX package's,
    ``test_torch_tpch_queries_*``), no replay once the hints are warm,
    and fewer host reads than eager over the whole set."""
    data = tp.tpch_data(tp.SCALE, tp.SEED)
    kwargs = dict(tp.KWARGS, q17=tp._q17_kwargs(data))
    ctx = pt.CylonContext(device="cpu", world=world)
    tables = {n: TDTable.from_table(ctx, pt.Table.from_pandas(ctx, df))
              for n, df in data.items()}
    prev = tconfig.set_broadcast_join_threshold(tp.THRESHOLD)
    clear_port_hints()
    eager_reads = pipe_reads = 0
    try:
        for q, fn in tqueries.QUERIES.items():
            run = lambda: fn(ctx, tables, **kwargs.get(q, {}))  # noqa
            ttrace.reset()
            want = run()
            q_eager = counters().get("host.read", 0)
            tpar.run_pipeline(run)  # warm: any replay happens here
            ttrace.reset()
            got = tpar.run_pipeline(run)
            c = counters()
            assert c.get("pipeline.replays", 0) == 0, q
            assert c.get("host.read", 0) <= q_eager, q
            eager_reads += q_eager
            pipe_reads += c.get("host.read", 0)
            assert tp.schema(got) == tp.schema(want)
            tp.assert_rows_close(tp.port_rows(got, ordered=True),
                                 tp.port_rows(want, ordered=True),
                                 tp.float_rtols(got))
    finally:
        tconfig.set_broadcast_join_threshold(prev)
        clear_port_hints()
    assert pipe_reads < eager_reads, (pipe_reads, eager_reads)
