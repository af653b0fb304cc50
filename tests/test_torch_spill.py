"""The out-of-core tier: the port's spill pool, morsel scans, staged-spill
exchange and morsel-scan planning against the JAX package's
(``tests/test_spill.py``), at world 1 and on the 8 virtual CPU devices,
on the same numpy-seeded inputs.

Mirrors 12 of that file's 15 tests: the spill and transparent fault-in,
the re-spill hit, LRU eviction and budget exhaustion (typed OOM), the
two-thread fault-in hammer, the switch, the morsel groupby over every key
family, the morsel join (INNER and LEFT), the forced staged-spill
exchange (rows, order, placement, counts, ``outcap``), the chooser's
spill tier, the planner's morsel scan (rule fires and rows), the degrade
to resident at an ample budget, and staging faults classified RESOURCE.
Left out: the two tests that need the executor's recovery driver and
the admission test, which needs ``serve/``."""
import threading

import numpy as np
import pandas as pd
import pytest

import cylon_tpu as ct
from cylon_tpu import config as jconfig
from cylon_tpu import faults as jfaults
from cylon_tpu import plan as jplan
from cylon_tpu import resilience as jresilience
from cylon_tpu import trace as jtrace
from cylon_tpu.parallel import DTable as JDTable
from cylon_tpu.parallel import cost as jcost
from cylon_tpu.parallel import dist_ops as jdist_ops
from cylon_tpu.spill import morsel as jmorsel
from cylon_tpu.spill import pool as jpool

import cylon_tpu_torch as pt
from cylon_tpu_torch import config as tconfig
from cylon_tpu_torch import faults as tfaults
from cylon_tpu_torch import plan as tplan
from cylon_tpu_torch import resilience as tresilience
from cylon_tpu_torch import trace as ttrace
from cylon_tpu_torch.parallel import DTable as TDTable
from cylon_tpu_torch.parallel import cost as tcost
from cylon_tpu_torch.parallel import dist_ops as tdist_ops
from cylon_tpu_torch.parallel import shuffle as tshuffle
from cylon_tpu_torch.spill import morsel as tmorsel
from cylon_tpu_torch.spill import pool as tpool
from cylon_tpu_torch.status import Code as TCode
from cylon_tpu_torch.status import CylonError as TCylonError

from test_torch_common import (assert_rows_close, float_rtols, jax_rows,
                               jax_trace_shim, port_rows, schema)  # noqa: F401
from test_torch_redistribution import assert_same_run, run_both

WORLDS = [1, 8]
SPILL_COUNTERS = ("spill.spills", "spill.respill_hits", "spill.faultins",
                  "spill.evictions", "spill.stage_outs", "spill.stage_ins",
                  "spill.morsels", "spill.morsel_groupbys",
                  "spill.morsel_joins", "spill.exchanges")


@pytest.fixture(autouse=True)
def _fresh_pools():
    for mod in (tpool, jpool):
        mod.clear_pool()
    tshuffle.clear_chunk_state()
    yield
    for mod in (tpool, jpool):
        mod.clear_pool()
    tshuffle.clear_chunk_state()
    for cfg in (tconfig, jconfig):
        cfg.set_host_memory_budget(None)
        cfg.set_spill_enabled(None)
        cfg.set_device_memory_budget(None)
        cfg.set_exchange_strategy(None)
    for tr in (ttrace, jtrace):   # counters_both() turns them on
        tr.disable_counters()


def _jctx(dctx, world):
    return dctx if world == 8 else ct.CylonContext(
        {"backend": "tpu", "devices": dctx.devices[:world]})


_TCTX = {}


def both(dctx, world, df):
    """(JAX DTable, port DTable) of one frame at ``world`` (one port
    context per world, as the JAX side has one per device set: the plan
    cache keys on the context)."""
    tctx = _TCTX.setdefault(world, pt.CylonContext(device="cpu",
                                                    world=world))
    return (JDTable.from_pandas(_jctx(dctx, world), df),
            TDTable.from_table(tctx, pt.Table.from_pandas(tctx, df)))


def same_rows(got, want, ordered=True):
    """The same schema, counts and rows per shard (floats within
    ``float_rtols``)."""
    assert schema(got) == schema(want)
    np.testing.assert_array_equal(got.counts_host(), want.counts_host())
    assert_rows_close(port_rows(got, ordered=ordered),
                      jax_rows(want, ordered=ordered), float_rtols(got))


def counters_both():
    """Reset and enable both packages' counters."""
    for tr in (ttrace, jtrace):
        tr.enable_counters()
        tr.reset()


def spill_counts():
    """(port, JAX) spill counters since the last reset."""
    t, j = ttrace.counters(), jtrace.counters()
    return ({k: t.get(k, 0) for k in SPILL_COUNTERS},
            {k: j.get(k, 0) for k in SPILL_COUNTERS})


# ---------------------------------------------------------------------------
# pool semantics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", WORLDS)
def test_spill_and_transparent_fault_in(dctx, jax_trace_shim, world):
    df = pd.DataFrame({"k": np.arange(500) % 7, "v": np.arange(500.0)})
    jt, tt = both(dctx, world, df)
    counters_both()
    for dt in (jt, tt):
        dt.spill()
        assert dt.is_spilled
        # metadata stays host-side: none of these fault the leaves in
        assert dt.num_rows == 500
        assert dt.column_names == ["k", "v"]
        assert dt.num_columns == 2
        assert "spilled to host" in repr(dt)
        assert dt.is_spilled
    assert spill_counts()[0]["spill.faultins"] == 0
    # the first DEVICE use faults in transparently
    got = tdist_ops.dist_groupby(tt, ["k"], [("v", "sum")])
    want = jdist_ops.dist_groupby(jt, ["k"], [("v", "sum")])
    assert not tt.is_spilled and not jt.is_spilled
    t, j = spill_counts()
    assert t == j
    assert t["spill.spills"] == 1 and t["spill.faultins"] == 1
    same_rows(got, want)


@pytest.mark.parametrize("world", WORLDS)
def test_respill_hits_need_no_device_read(dctx, jax_trace_shim, world):
    jt, tt = both(dctx, world, pd.DataFrame({"v": np.arange(100.0)}))
    counters_both()
    for dt in (jt, tt):
        dt.spill()
        dt.ensure_device()
        dt.spill()      # content unchanged: the pooled host copy serves
        assert dt.is_spilled
    t, j = spill_counts()
    assert t == j
    assert t["spill.respill_hits"] == 1
    assert t["spill.stage_outs"] == 1   # only the first spill read
    same_rows(tt, jt)                    # faults both in: the same rows


@pytest.mark.parametrize("world", WORLDS)
def test_pool_lru_eviction_and_budget_exhaustion(dctx, jax_trace_shim, world):
    frames = [pd.DataFrame({"v": np.arange(4096.0) + i}) for i in range(3)]
    pairs = [both(dctx, world, df) for df in frames]
    nbytes = 4096 * 8 + 64   # one spilled table (plus slack)
    counters_both()
    for cfg in (tconfig, jconfig):
        cfg.set_host_memory_budget(2 * nbytes)
    for side in (0, 1):
        blocks = [p[side] for p in pairs]
        blocks[0].spill()
        blocks[0].ensure_device()      # entry 0 becomes resident cache
        blocks[1].spill()              # fits next to the cached entry
        blocks[2].spill()              # must EVICT the resident entry
    t, j = spill_counts()
    assert t == j and t["spill.evictions"] >= 1
    # two PINNED entries fill the budget: a third pinned stage-out raises
    # the typed OutOfMemory, the resource arm
    jt, tt = both(dctx, world, pd.DataFrame({"v": np.arange(4096.0)}))
    with pytest.raises(TCylonError) as ti:
        tt.spill()
    with pytest.raises(ct.CylonError) as ji:
        jt.spill()
    assert ti.value.status.code == TCode.OutOfMemory
    assert int(ji.value.status.code) == int(ti.value.status.code)
    assert tresilience.classify(ti.value) == tresilience.RESOURCE == \
        jresilience.classify(ji.value)
    assert not tt.is_spilled
    for cfg in (tconfig, jconfig):
        cfg.set_host_memory_budget(None)
    # the evicted entry's table still answers (its own entry survives)
    same_rows(pairs[0][1], pairs[0][0])
    assert float(pairs[0][1].to_table().column("v").data.sum()) == \
        np.arange(4096.0).sum()


@pytest.mark.parametrize("world", WORLDS)
def test_pool_two_thread_fault_in_hammer(dctx, jax_trace_shim, world):
    """Two threads racing the device use of one spilled table resolve to
    exactly one stage-in and the JAX package's rows."""
    df = pd.DataFrame({"k": np.arange(2000) % 5, "v": np.arange(2000.0)})
    jt, _ = both(dctx, world, df)
    want = jdist_ops.dist_groupby(jt, ["k"], [("v", "sum")])
    for _ in range(4):
        _, tt = both(dctx, world, df)
        tt.spill()
        counters_both()
        results, errors = [], []

        def use():
            try:
                results.append(tdist_ops.dist_groupby(tt, ["k"],
                                                      [("v", "sum")]))
            except BaseException as e:  # noqa: BLE001 — surfaced below
                errors.append(e)

        ts = [threading.Thread(target=use) for _ in range(2)]
        for th in ts:
            th.start()
        for th in ts:
            th.join()
        assert not errors, errors
        assert ttrace.counters().get("spill.faultins", 0) == 1
        assert len(results) == 2
        for r in results:
            same_rows(r, want)


@pytest.mark.parametrize("world", WORLDS)
def test_spill_disabled_switch(dctx, jax_trace_shim, world, monkeypatch):
    jt, tt = both(dctx, world, pd.DataFrame({"v": [1.0, 2.0]}))
    for cfg in (tconfig, jconfig):
        cfg.set_spill_enabled(False)
    with pytest.raises(TCylonError):
        tt.spill()
    with pytest.raises(ct.CylonError):
        jt.spill()
    assert not tt.is_spilled and not jt.is_spilled
    for cfg in (tconfig, jconfig):
        cfg.set_spill_enabled(None)
    for env, on in (("0", False), ("", False), ("1", True), ("yes", True)):
        monkeypatch.setenv("CYLON_SPILL", env)
        assert tconfig.spill_enabled() == jconfig.spill_enabled() == on
    for bad in (1, "on"):
        with pytest.raises(TCylonError):
            tconfig.set_spill_enabled(bad)
        with pytest.raises(ct.CylonError):
            jconfig.set_spill_enabled(bad)


# ---------------------------------------------------------------------------
# morsel scans against the JAX package's
# ---------------------------------------------------------------------------

def _family_frame(rng, n, family):
    if family == "int":
        return pd.DataFrame({"k": rng.integers(0, 37, n),
                             "v": rng.standard_normal(n)})
    if family == "dict-string":
        words = np.array(["lima", "oslo", "kiev", "baku", "apia"])
        return pd.DataFrame({"k": pd.Categorical(
            words[rng.integers(0, len(words), n)]),
            "v": rng.standard_normal(n)})
    if family == "null":
        k = rng.integers(0, 11, n).astype("float64")
        k[rng.random(n) < 0.1] = np.nan
        return pd.DataFrame({"k": pd.array(
            np.where(np.isnan(k), None, k), dtype="Int64"),
            "v": rng.standard_normal(n)})
    return pd.DataFrame({"k": rng.integers(0, 7, n),
                         "k2": rng.integers(0, 5, n),
                         "v": rng.standard_normal(n)})


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("family", ["int", "dict-string", "null",
                                    "composite"])
def test_morsel_groupby_parity(dctx, jax_trace_shim, family, world):
    df = _family_frame(np.random.default_rng(5), 4000, family)
    keys = ["k", "k2"] if family == "composite" else ["k"]
    aggs = [("v", "sum"), ("v", "mean"), ("v", "min"), ("v", "count")]
    jt, tt = both(dctx, world, df)
    resident = tdist_ops.dist_groupby(tt, keys, aggs)
    for dt in (jt, tt):
        dt.spill()
    counters_both()
    got = tmorsel.morsel_groupby(tt, keys, aggs, morsels=4)
    want = jmorsel.morsel_groupby(jt, keys, aggs, morsels=4)
    t, j = spill_counts()
    assert t["spill.morsels"] == j["spill.morsels"] == 4
    assert t["spill.faultins"] == 0 and tt.is_spilled
    same_rows(got, want)
    # and the resident groupby's groups (sums in another order)
    assert_rows_close(sorted(port_rows(got.to_table()), key=repr),
                      sorted(port_rows(resident.to_table()), key=repr),
                      float_rtols(got, f64=1e-9))


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("how", ["inner", "left"])
def test_morsel_join_parity(dctx, jax_trace_shim, how, world):
    rng = np.random.default_rng(9)
    ldf = pd.DataFrame({"k": rng.integers(0, 60, 3000),
                        "v": rng.standard_normal(3000)})
    rdf = pd.DataFrame({"k": np.arange(55), "w": np.arange(55.0)})
    jl, tl = both(dctx, world, ldf)
    jr, tr = both(dctx, world, rdf)
    jcfg = ct.JoinConfig(ct.JoinType(how), ct.JoinAlgorithm("hash"), 0, 0,
                         broadcast_threshold=0)
    tcfg = pt.JoinConfig(pt.JoinType(how), pt.JoinAlgorithm("hash"), 0, 0,
                         broadcast_threshold=0)
    resident = tdist_ops.dist_join(tl, tr, tcfg).to_table()
    for dt in (jl, tl):
        dt.spill()
    counters_both()
    # dist_join routes a spilled probe side through the morsel scan
    got = tdist_ops.dist_join(tl, tr, tcfg) if world == 8 else \
        tmorsel.morsel_join(tl, tr, tcfg, morsels=3)
    want = jdist_ops.dist_join(jl, jr, jcfg) if world == 8 else \
        jmorsel.morsel_join(jl, jr, jcfg, morsels=3)
    t, j = spill_counts()
    assert t == j and t["spill.morsel_joins"] == 1
    assert t["spill.morsels"] >= (3 if world == 1 else 1)
    assert tl.is_spilled
    same_rows(got, want, ordered=False)
    assert sorted(port_rows(got.to_table()), key=repr) == \
        sorted(port_rows(resident), key=repr)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("flavour", ["int", "composite"])
def test_forced_staged_spill_exchange_parity(ctx, dctx, jax_trace_shim,
                                             flavour, world):
    """``set_exchange_strategy("staged-spill")``: the host-tier lowering in
    both packages gives the same rows in the same order on the same
    shards, the same counts and ``outcap``, counters and annotations; and
    the chunked plan's rows.  World 1 has no exchange to stage."""
    from test_torch_dist_join import _both_dtables
    from test_torch_redistribution import KEYS, _shuffle_ops, mixed_key_table
    jt, tt = _both_dtables(ctx, dctx, world, mixed_key_table())
    op_j, op_t = _shuffle_ops(KEYS[flavour])
    got, want = run_both(jt, tt, op_j, op_t, strategy="staged-spill")
    assert_same_run(got, want)
    chunked, _ = run_both(jt, tt, op_j, op_t, strategy="chunked")
    assert port_rows(got[0], ordered=True) == \
        port_rows(chunked[0], ordered=True)
    assert got[0].cap == chunked[0].cap
    c = got[1]
    if world > 1:
        assert c.get("shuffle.strategy.staged_spill", 0) == 1, c
        assert got[2][0][1].startswith(
            "staged-spill: forced by CYLON_EXCHANGE_STRATEGY")
        assert got[2][0][2].startswith("staged-spill shuffle: ")
    else:
        assert "shuffle.strategy.staged_spill" not in c


@pytest.mark.parametrize("world", WORLDS)
def test_forced_staged_spill_fold_combine_parity(dctx, jax_trace_shim,
                                                 world):
    """The fused groupby's partial exchange under a forced staged-spill
    folds its rounds by key, as the JAX package's does: the same groups
    on the same shards and the same counters."""
    df = _family_frame(np.random.default_rng(3), 6000, "composite")
    jt, tt = both(dctx, world, df)
    aggs = [("v", "sum"), ("v", "mean"), ("v", "max"), ("v", "count")]
    outs = []
    for cfg, ops, dt, tr in ((tconfig, tdist_ops, tt, ttrace),
                             (jconfig, jdist_ops, jt, jtrace)):
        cfg.set_exchange_strategy("staged-spill")
        cfg.set_device_memory_budget(4096)
        tr.enable_counters()
        tr.reset()
        try:
            outs.append(ops.dist_groupby_fused(dt, ["k", "k2"], aggs,
                                               mode="pre-aggregate"))
        finally:
            cfg.set_exchange_strategy(None)
            cfg.set_device_memory_budget(None)
        outs.append(dict(tr.counters()))
    got, tc, want, jc = outs
    same_rows(got, want)
    keys = ("spill.exchanges", "spill.morsels", "shuffle.fold_combined",
            "shuffle.strategy.staged_spill", "shuffle.exchange_bytes_peak")
    assert {k: tc.get(k, 0) for k in keys} == {k: jc.get(k, 0) for k in keys}
    if world > 1:
        assert tc["spill.exchanges"] == 1 and tc["spill.morsels"] > 1, tc


def test_chooser_reaches_spill_only_past_the_resident_floor():
    """``cost.choose``: staged-spill is the tier between "a resident
    strategy fits" and the best-effort floor, in both packages, on a
    4-shard and an 8-shard count matrix."""
    for P in (4, 8):
        counts = np.full((P, P), 100, np.int64)
        out = []
        for cost in (tcost, jcost):
            cands = cost.enumerate_strategies(P, 100 * P, counts, 8,
                                              1 << 20, spill_ok=True)
            choice, reason, ok = cost.choose(cands, 1 << 20)
            assert ok and choice.strategy == cost.SINGLE_SHOT
            spill = cost.price_staged_spill(P, counts, 8, 1 << 20)
            floor = min(c.peak_bytes for c in cands
                        if c.strategy != cost.STAGED_SPILL)
            tight = [c for c in cands if c.strategy != cost.STAGED_SPILL]
            tight.append(cost.StrategyPrice(cost.STAGED_SPILL, floor - 1,
                                            spill.wire_bytes, spill.rounds,
                                            spill.sizes, spill.host_bytes))
            choice2, reason2, ok2 = cost.choose(tight, floor - 1)
            assert ok2 and choice2.strategy == cost.STAGED_SPILL
            assert "no resident strategy fits" in reason2
            # below the spill morsel's price too: the best-effort floor
            choice3, reason3, ok3 = cost.choose(tight, 1)
            assert not ok3 and choice3.strategy == cost.CHUNKED
            out.append((choice.describe(), reason2, choice2.describe(),
                        reason3, spill.host_bytes))
        assert out[0] == out[1]


# ---------------------------------------------------------------------------
# the planner's morsel scan under a pinned budget
# ---------------------------------------------------------------------------

def _planned_both(dctx, world, df, budget, q_t, q_j):
    """Both planners on the same frame under ``budget`` (None: default),
    from cleared plan caches and pools: ((port result, stats, counters),
    (JAX result, stats, counters))."""
    from tpch_torch_parity import planned
    jt, tt = both(dctx, world, df)
    out = []
    for cfg, plan, dt, tr, pool in ((tconfig, tplan, tt, ttrace, tpool),
                                    (jconfig, jplan, jt, jtrace, jpool)):
        plan.clear_plan_cache()
        pool.clear_pool()
        tr.enable_counters()
        tr.reset()
        cfg.set_device_memory_budget(budget)
        try:
            res, stats = planned(plan, dt.ctx, q_t if plan is tplan else q_j,
                                 dt)
        finally:
            cfg.set_device_memory_budget(None)
            plan.clear_plan_cache()
        out.append((res, stats, dict(tr.counters())))
    return out


@pytest.mark.parametrize("world", WORLDS)
def test_planner_inserts_morsel_scan_and_stays_row_identical(
        dctx, jax_trace_shim, world):
    rng = np.random.default_rng(17)
    df = pd.DataFrame({"k": rng.integers(0, 23, 30000),
                       "v": rng.standard_normal(30000)})
    aggs = [("v", "sum"), ("v", "mean")]
    (got, ts, tc), (want, js, jc) = _planned_both(
        dctx, world, df, 100_000,
        lambda t: tdist_ops.dist_groupby(t, ["k"], aggs),
        lambda t: jdist_ops.dist_groupby(t, ["k"], aggs))
    assert ts["fires"] == js["fires"]
    same_rows(got, want)
    keys = ("spill.spills", "spill.morsels", "spill.morsel_groupbys")
    assert {k: tc.get(k, 0) for k in keys} == {k: jc.get(k, 0) for k in keys}
    if world > 1:
        assert any("morsel-scan" in f for f in ts["fires"]), ts["fires"]
        assert tc["spill.spills"] >= 1 and tc["spill.morsels"] >= 2, tc
        assert tc["spill.morsel_groupbys"] >= 1, tc
        assert 0 < tc["shuffle.exchange_bytes_peak"] <= 100_000, tc
    else:
        # world 1: no exchange to bound, no morsel scan planned
        assert tc.get("spill.spills", 0) == 0


@pytest.mark.parametrize("world", WORLDS)
def test_morsel_scan_degrades_to_resident_at_ample_budget(
        dctx, jax_trace_shim, world):
    """The morsel_scan lowering prices at EXECUTION, against the live
    budget: the plan cached under a 100 KB budget (the morsel scan
    planned) replays as a cache hit, and under an ample live budget (the
    ``resilience.budget`` value point raised, the configured budget, which
    the port's plan cache keys on, unchanged) runs resident, with no
    spill; in both packages."""
    rng = np.random.default_rng(23)
    df = pd.DataFrame({"k": rng.integers(0, 23, 30000),
                       "v": rng.standard_normal(30000)})
    jt, tt = both(dctx, world, df)
    outs = []
    for cfg, plan, ops, dt, tr, faults in (
            (tconfig, tplan, tdist_ops, tt, ttrace, tfaults),
            (jconfig, jplan, jdist_ops, jt, jtrace, jfaults)):
        def q(t, ops=ops):
            return ops.dist_groupby(t, ["k"], [("v", "sum")])
        plan.clear_plan_cache()
        cfg.set_device_memory_budget(100_000)
        try:
            first = plan.run(dt.ctx, q, dt)
            tr.enable_counters()
            tr.reset()
            ample = faults.FaultPlan(seed=0, rules=[faults.FaultRule(
                "resilience.budget", kind="value", mutate=lambda b: 1 << 40)])
            dt2 = (both(dctx, world, df)[1] if plan is tplan
                   else both(dctx, world, df)[0])
            with faults.active(ample):
                second = plan.run(dt2.ctx, q, dt2)
            c = dict(tr.counters())
        finally:
            cfg.set_device_memory_budget(None)
            plan.clear_plan_cache()
        assert c.get("plan.cache_hit", 0) == 1, c
        assert c.get("spill.spills", 0) == 0, c
        assert not dt2.is_spilled
        outs += [first, second]
    tfirst, tsecond, jfirst, jsecond = outs
    same_rows(tsecond, jsecond)
    same_rows(tfirst, jfirst)


# ---------------------------------------------------------------------------
# host-tier faults on the resource arm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", WORLDS)
def test_staging_faults_classify_resource(dctx, jax_trace_shim, world):
    """Both packages classify the staging points' faults alike, and an
    injected ``spill.stage_in`` fault in a morsel scan propagates typed
    (RESOURCE) and leaves the table consistently spilled."""
    for kind, want in (("transient", "resource"), ("resource", "resource"),
                       ("permanent", "permanent")):
        for point in ("spill.stage_in", "spill.stage_out"):
            te = {"transient": tfaults.TransientFault,
                  "resource": tfaults.ResourceFault,
                  "permanent": tfaults.PermanentFault}[kind](point)
            je = {"transient": jfaults.TransientFault,
                  "resource": jfaults.ResourceFault,
                  "permanent": jfaults.PermanentFault}[kind](point)
            assert tresilience.classify(te) == jresilience.classify(je) \
                == want
    df = pd.DataFrame({"k": np.arange(3000) % 13, "v": np.arange(3000.0)})
    jt, tt = both(dctx, world, df)
    errs = []
    for faults, dt, mod in ((tfaults, tt, tmorsel), (jfaults, jt, jmorsel)):
        dt.spill()
        plan = faults.FaultPlan(seed=0, rules=[
            faults.FaultRule("spill.stage_in", kind="resource", nth=2)])
        with faults.active(plan):
            with pytest.raises(faults.ResourceFault) as ei:
                mod.morsel_groupby(dt, ["k"], [("v", "sum")], morsels=4)
        assert plan.injected == 1 and dt.is_spilled
        errs.append(ei.value)
    assert tresilience.classify(errs[0]) == jresilience.classify(errs[1]) \
        == tresilience.RESOURCE
    # the table still answers, by the JAX package's rows
    same_rows(tdist_ops.dist_groupby(tt, ["k"], [("v", "sum")]),
              jdist_ops.dist_groupby(jt, ["k"], [("v", "sum")]))


@pytest.mark.parametrize("world", WORLDS)
def test_failed_pin_raises_typed_oom(dctx, jax_trace_shim, world,
                                     monkeypatch):
    """A host block for a card's data is page-locked; when pinning fails
    the pool raises the typed ``Code.OutOfMemory`` (the RESOURCE class, as
    the JAX package's pool exhaustion) and never falls back to pageable
    memory.  The JAX package has no pinned blocks: its counterpart is the
    exhausted pool, whose error class the port's failed pin matches."""
    real = tpool.torch.empty

    def no_pin(*args, **kwargs):
        if kwargs.get("pin_memory"):
            raise RuntimeError("cudaHostAlloc failed")
        return real(*args, **kwargs)

    monkeypatch.setattr(tpool.torch, "empty", no_pin)
    with pytest.raises(TCylonError) as ti:
        tpool.pinned_empty((world * 1024,), tpool.torch.float32,
                           tpool.torch.device("cuda"))
    assert ti.value.status.code == TCode.OutOfMemory
    # the CPU's host tier never pins
    assert tpool.pinned_empty((4,), tpool.torch.int32,
                              tpool.torch.device("cpu")).shape == (4,)
    monkeypatch.undo()
    jconfig.set_host_memory_budget(1024)
    jt, _ = both(dctx, world, pd.DataFrame({"v": np.arange(4096.0)}))
    with pytest.raises(ct.CylonError) as ji:
        jt.spill()
    assert tresilience.classify(ti.value) == jresilience.classify(ji.value) \
        == tresilience.RESOURCE


@pytest.mark.parametrize("world", WORLDS)
def test_spilled_sketch_groupby_parity(dctx, jax_trace_shim, world):
    """``dist_groupby_sketch`` of a spilled table streams it in morsels
    (the sample priorities seeded from each morsel's row offset) and
    merges the partials morsel by morsel: the JAX package's groups and
    lanes, and the port's resident result, exactly."""
    rng = np.random.default_rng(41)
    n = 6000
    df = pd.DataFrame({"k": rng.integers(0, 9, n),
                       "p": rng.integers(0, 500, n),
                       "x": rng.standard_normal(n).astype(np.float32)})
    aggs = [("p", "approx_distinct"), ("x", "approx_quantile:0.5")]
    jt, tt = both(dctx, world, df)
    resident = tdist_ops.dist_groupby_sketch(tt, ["k"], aggs)
    budget = tmorsel.table_priced_bytes(world, -(-tt.cap // 4),
                                        tmorsel._spilled_rbytes(tt))
    assert budget == jmorsel.table_priced_bytes(
        world, -(-jt.cap // 4), jmorsel._spilled_rbytes(jt))
    for dt in (jt, tt):
        dt.spill()
    counters_both()
    outs = []
    for cfg, ops, dt in ((tconfig, tdist_ops, tt), (jconfig, jdist_ops, jt)):
        cfg.set_device_memory_budget(budget)
        try:
            outs.append(ops.dist_groupby_sketch(dt, ["k"], aggs))
        finally:
            cfg.set_device_memory_budget(None)
    t, j = spill_counts()
    assert t == j and t["spill.morsels"] == 4 and t["spill.faultins"] == 0
    assert tt.is_spilled
    got, want = outs
    same_rows(got, want, ordered=False)
    assert port_rows(got) == port_rows(resident)
