"""Self-healing execution: the port's recovery driver against the JAX
package's (``tests/test_recovery.py``), at world 1 and on the 8 virtual
CPU devices, on the same numpy-seeded tables under the same
``FaultPlan``.

Mirrors that file's ladder tests: the decision table and its caps,
``demoted_exchanges`` and the strategy collector, ``choose(exclude=)``,
the transient resume, the resource replan, the permanent, organic and
exhausted failures, the restore-fault replay, the replan-setup fault,
checkpoint pricing, recovery switched off, the knob's env and the stage
count, and the two recovery cases of ``tests/test_spill.py`` (a staging
fault mid-morsel-scan, the seeded default chaos plan over a spilled
plan).  Each end-to-end case runs the two-stage plan (a HASH join, then
a groupby by the key, the broadcast threshold at 1) through both
planners and holds the port to the JAX package's rows (as multisets,
float sums to 1e-6 relative), its ``recover.*`` and strategy counters,
its flight-recorder ``recover`` events (the ladder's attempt log
included) and, on a failure, the error's type and ``e.ladder``.  One
port-only case drives the resource rung with a real
``torch.OutOfMemoryError``.  The serving-layer tests wait for
``serve/``."""
import numpy as np
import pandas as pd
import pytest
import torch

import cylon_tpu as ct
from cylon_tpu import config as jconfig
from cylon_tpu import faults as jfaults
from cylon_tpu import plan as jplan
from cylon_tpu import resilience as jres
from cylon_tpu import topology as jtopology
from cylon_tpu import trace as jtrace
from cylon_tpu.observe import flightrec as jflightrec
from cylon_tpu.parallel import DTable as JDTable
from cylon_tpu.parallel import cost as jcost
from cylon_tpu.parallel import dist_ops as jdops
from cylon_tpu.plan import ir as jir

import cylon_tpu_torch as pt
from cylon_tpu_torch import config as tconfig
from cylon_tpu_torch import faults as tfaults
from cylon_tpu_torch import plan as tplan
from cylon_tpu_torch import resilience as tres
from cylon_tpu_torch import topology as ttopology
from cylon_tpu_torch import trace as ttrace
from cylon_tpu_torch.observe import flightrec as tflightrec
from cylon_tpu_torch.parallel import DTable as TDTable
from cylon_tpu_torch.parallel import cost as tcost
from cylon_tpu_torch.parallel import dist_ops as tdops
from cylon_tpu_torch.parallel import shuffle as tshuffle
from cylon_tpu_torch.plan import executor as texecutor
from cylon_tpu_torch.plan import ir as tir
from cylon_tpu_torch.spill import pool as tpool

from test_torch_common import jax_trace_shim  # noqa: F401

WORLDS = [1, 8]
F32_RTOL = 1e-6
# the event fields both packages' recover / recover_failed notes carry
EVENT_KEYS = ("kind", "action", "attempts", "level", "retries", "lost",
              "survivor_world", "new_world", "stages")

_TCTX = {}


def tctx_of(world):
    """One port context per world (the plan cache keys on the context)."""
    return _TCTX.setdefault(world, pt.CylonContext(device="cpu",
                                                    world=world))


def jctx_of(dctx, world):
    return dctx if world == 8 else ct.CylonContext(
        {"backend": "tpu", "devices": dctx.devices[:world]})


def _close_leaked_sessions(timeout_s: float = 30.0) -> None:
    """Close serving sessions (either package's) that an earlier test
    module left open, say one that failed before its ``close()``: their
    dispatchers poll the topology registry, and a loss injected here
    would make them migrate their own tables into this test's
    ``recover.*`` counters.  Each close is bounded."""
    import threading
    for th in threading.enumerate():
        owner = getattr(getattr(th, "_target", None), "__self__", None)
        close = getattr(owner, "close", None)
        if not (th.name.endswith("-dispatch") and callable(close)):
            continue
        closer = threading.Thread(target=close, daemon=True)
        closer.start()
        closer.join(timeout_s)


@pytest.fixture(autouse=True)
def _clean_state():
    """Counters on in both packages and every module-level lever the
    ladder pulls (fault plans, recovery policy and switch, topology
    registry, budgets, plan caches) reset after each test; serving
    sessions leaked by an earlier module closed first."""
    _close_leaked_sessions()
    for tr in (ttrace, jtrace):
        tr.enable_counters()
        tr.reset()
    for fr in (tflightrec, jflightrec):
        fr.clear()
    for pl in (tplan, jplan):    # a plan cached by an earlier test module
        pl.clear_plan_cache()
    thresholds = [(cfg, cfg.broadcast_join_threshold())
                  for cfg in (tconfig, jconfig)]
    yield
    for cfg, thr in thresholds:   # None would switch broadcasts off
        cfg.set_broadcast_join_threshold(thr or None)
    for tr in (ttrace, jtrace):
        tr.disable_counters()
        tr.reset()
    for fm in (tfaults, jfaults):
        fm.uninstall()
    for rm in (tres, jres):
        rm.set_recovery_policy(rm.RecoveryPolicy())
    for cfg in (tconfig, jconfig):
        cfg.set_recovery_enabled(None)
        cfg.set_remesh_cooldown_ms(None)
        cfg.set_device_memory_budget(None)
    for topo in (ttopology, jtopology):
        topo.reset()
    for pl in (tplan, jplan):
        pl.clear_plan_cache()
    tshuffle.clear_chunk_state()
    tpool.clear_pool()


# ---------------------------------------------------------------------------
# the two-stage workload every ladder test drives
# ---------------------------------------------------------------------------

def two_stage_frames(seed=5, rows=4000, keys=300):
    """The fact and dim frames of ``tests/test_elastic.py``'s
    ``_two_stage``: int32 keys, float32 payloads."""
    rng = np.random.default_rng(seed)
    fact = pd.DataFrame({
        "k": rng.integers(0, keys, rows).astype(np.int32),
        "v": rng.random(rows).astype(np.float32)})
    dim = pd.DataFrame({
        "k": np.arange(keys, dtype=np.int32),
        "w": rng.random(keys).astype(np.float32)})
    return {"fact": fact, "dim": dim}


def tables_both(dctx, world, frames):
    """FRESH (JAX, port) DTable dicts of ``frames`` at ``world`` (a re-mesh
    mutates tables in place, so no test shares them)."""
    jctx, tctx = jctx_of(dctx, world), tctx_of(world)
    return ({k: JDTable.from_table(jctx, ct.Table.from_pandas(jctx, df))
             for k, df in frames.items()},
            {k: TDTable.from_table(tctx, pt.Table.from_pandas(tctx, df))
             for k, df in frames.items()})


def two_stage_ops():
    def op_j(t):
        j = jdops.dist_join(t["fact"], t["dim"],
                            jconfig.JoinConfig.InnerJoin(0, 0))
        return jdops.dist_groupby(j, ["lt-k"], [("rt-w", "sum")])

    def op_t(t):
        j = tdops.dist_join(t["fact"], t["dim"], pt.JoinConfig.InnerJoin(0, 0))
        return tdops.dist_groupby(j, ["lt-k"], [("rt-w", "sum")])
    return op_j, op_t


def frame_of(out):
    """A planned result as a frame sorted by its first column."""
    df = out.to_table().to_pandas()
    return df.sort_values(list(df.columns)).reset_index(drop=True)


def assert_frames_close(got, want):
    """The same rows as multisets: keys and counts exactly, float
    columns to ``F32_RTOL`` relative (a different shard count sums in
    another order)."""
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want)
    for c in got.columns:
        g, w = got[c].to_numpy(), want[c].to_numpy()
        if np.issubdtype(g.dtype, np.floating):
            np.testing.assert_allclose(g, w, rtol=F32_RTOL, atol=0)
        else:
            np.testing.assert_array_equal(g, w)


def recover_events(fr):
    return [{k: e[k] for k in EVENT_KEYS if k in e} for e in fr.events()
            if e.get("kind") in ("recover", "recover_failed")]


def ladder_counters(tr, skip=("recover.remesh_us",)):
    """The ``recover.*``, fault and strategy counters of one run."""
    return {k: v for k, v in tr.counters().items()
            if (k.startswith("recover.") or k.startswith("fault.")
                or k.startswith("shuffle.strategy.")) and k not in skip}


class Run:
    """One package's planned run: its result frame (or its error), the
    ladder counters, the recover events and the plan's tables."""

    def __init__(self, out, error, counters, events, tables):
        self.out = out
        self.error = error
        self.counters = counters
        self.events = events
        self.tables = tables


def _run_one(plan_mod, fm, tr, fr, ctx, op, tables, rules, seed):
    tr.reset()
    fr.clear()
    fp = fm.FaultPlan(seed, rules(fm)) if rules is not None else None
    out = error = None
    try:
        if fp is None:
            out = frame_of(plan_mod.run(ctx, op, tables))
        else:
            with fm.active(fp):
                out = frame_of(plan_mod.run(ctx, op, tables))
    except Exception as e:   # the error is part of what is compared
        error = e
    return Run(out, error, ladder_counters(tr), recover_events(fr), tables)


def run_both(dctx, world, rules=None, frames=None, ops=None, seed=0,
             threshold=1, tables=None):
    """Run one plan through the JAX planner and the port's under
    ``FaultPlan(seed, rules(faults_module))`` (None: no plan), with the
    broadcast threshold at ``threshold`` in both.  Returns ``(port run,
    JAX run)``."""
    frames = frames if frames is not None else two_stage_frames()
    op_j, op_t = ops if ops is not None else two_stage_ops()
    jt, tt = tables if tables is not None else tables_both(dctx, world,
                                                           frames)
    prev = [(cfg, cfg.set_broadcast_join_threshold(threshold))
            for cfg in (tconfig, jconfig)]
    try:
        got = _run_one(tplan, tfaults, ttrace, tflightrec, tctx_of(world),
                       op_t, tt, rules, seed)
        want = _run_one(jplan, jfaults, jtrace, jflightrec,
                        jctx_of(dctx, world), op_j, jt, rules, seed)
    finally:
        for cfg, thr in prev:
            cfg.set_broadcast_join_threshold(thr)
    return got, want


def assert_same_recovery(got, want):
    """The port's run = the JAX package's: rows, error type and attempt
    log, ladder counters, recover events."""
    if want.error is not None:
        assert got.error is not None, "the port recovered where JAX failed"
        assert type(got.error).__name__ == type(want.error).__name__
        assert getattr(got.error, "ladder", None) == \
            getattr(want.error, "ladder", None)
    else:
        assert got.error is None, got.error
        assert_frames_close(got.out, want.out)
    assert got.counters == want.counters
    assert got.events == want.events


# ---------------------------------------------------------------------------
# the ladder decision table (unit)
# ---------------------------------------------------------------------------

def _decisions(res, fm, policy_kw, errors):
    ladder = res.Ladder(res.RecoveryPolicy(**policy_kw))
    acts = []
    for kind in errors:
        exc = {"transient": fm.TransientFault("x"),
               "resource": fm.ResourceFault("x"),
               "permanent": fm.PermanentFault("x"),
               "topology": fm.TopologyFault("mesh.device_lost")}[kind]
        acts.append((ladder.decide(exc), ladder.demote_level,
                     ladder.remeshes))
    return acts, ladder.as_dicts()


@pytest.mark.parametrize("policy_kw,errors", [
    ({"max_stage_retries": 2, "max_replans": 1},
     ["transient", "transient", "transient"]),
    ({"max_stage_retries": 0, "max_replans": 2},
     ["resource", "resource", "resource", "permanent"]),
    ({"max_remeshes": 1}, ["topology", "topology", "transient"]),
])
def test_ladder_decisions_and_caps_equal_jax(policy_kw, errors):
    assert _decisions(tres, tfaults, policy_kw, errors) == \
        _decisions(jres, jfaults, policy_kw, errors)


def test_recovery_policy_validation():
    for kw in ({"max_stage_retries": -1}, {"max_remeshes": -1},
               {"checkpoint_fraction": 1.5}):
        with pytest.raises(pt.CylonError):
            tres.RecoveryPolicy(**kw)
        with pytest.raises(ct.CylonError):
            jres.RecoveryPolicy(**kw)
    with pytest.raises(pt.CylonError):
        tres.set_recovery_policy("nope")
    assert tres.RecoveryPolicy() == tres.RecoveryPolicy(
        max_stage_retries=2, max_replans=2, max_remeshes=1, max_scaleups=1,
        checkpoint_fraction=0.25)
    assert tres.RecoveryPolicy().__dict__ == jres.RecoveryPolicy().__dict__


def _demotion_walk(res, cost):
    out = [res.exchange_demotions()]
    with res.demoted_exchanges(1):
        out.append(res.exchange_demotions())
        with res.demoted_exchanges(3):
            out.append(res.exchange_demotions())
        out.append(res.exchange_demotions())
    out.append(res.exchange_demotions())
    with res.demoted_exchanges(1, failed=(cost.ALLGATHER, cost.CHUNKED)):
        out.append(res.exchange_demotions())
    with res.collect_strategy_choices() as chosen:
        res.note_strategy_choice(cost.ALLGATHER)
    res.note_strategy_choice(cost.RING)  # no window: a no-op
    out.append(chosen)
    return out


def test_demoted_exchanges_equal_jax():
    got = _demotion_walk(tres, tcost)
    assert got == _demotion_walk(jres, jcost)
    assert got[0] == () and got[1] == (tcost.SINGLE_SHOT,)
    assert tcost.CHUNKED not in got[2] and tcost.CHUNKED not in got[5]
    assert tcost.ALLGATHER in got[5] and got[6] == {tcost.ALLGATHER}


@pytest.mark.parametrize("world", [3, 4, 7, 8])
def test_cost_choose_exclude_equal_jax(world):
    counts = np.full((world, world), 64, dtype=np.int64)
    cands_t = tcost.enumerate_strategies(world, 256, counts, 8, 1 << 30)
    cands_j = jcost.enumerate_strategies(world, 256, counts, 8, 1 << 30)
    for exclude in ((), (tcost.SINGLE_SHOT,),
                    (tcost.SINGLE_SHOT, tcost.ALLGATHER),
                    tuple(tcost.STRATEGIES)):
        bt, rt, ft = tcost.choose(cands_t, 1 << 30, exclude=exclude)
        bj, rj, fj = jcost.choose(cands_j, 1 << 30, exclude=exclude)
        assert (bt.strategy, bt.peak_bytes, bt.wire_bytes, bt.rounds, rt,
                ft) == (bj.strategy, bj.peak_bytes, bj.wire_bytes,
                        bj.rounds, rj, fj)
        if exclude == (tcost.SINGLE_SHOT,):
            assert bt.strategy != tcost.SINGLE_SHOT
            assert "replan demotion excluded" in rt
    assert tcost.price_retained(128, 16) == jcost.price_retained(128, 16) \
        == 128 * 16


# ---------------------------------------------------------------------------
# the escalation ladder end to end
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", WORLDS)
def test_transient_stage_fault_resumes_exactly(dctx, jax_trace_shim, world):
    """A transient at the SECOND stage boundary resumes from the intact
    execution memo: one stage retry, zero completed stages replayed."""
    got, want = run_both(dctx, world, lambda fm: [
        fm.FaultRule("exec.stage", kind="transient", nth=2)], seed=1)
    assert_same_recovery(got, want)
    c = got.counters
    assert c.get("recover.stage_retries") == 1
    assert c.get("recover.recovered") == 1
    assert c.get("recover.checkpoints", 0) >= 1
    assert c.get("recover.stages_replayed", 0) == 0


@pytest.mark.parametrize("world", WORLDS)
def test_resource_fault_replans_to_degraded_strategy(dctx, jax_trace_shim,
                                                     world):
    """A resource fault replans: the retry runs demoted off the
    single-shot fast path and resumes from the checkpoint store."""
    got, want = run_both(dctx, world, lambda fm: [
        fm.FaultRule("exec.stage", kind="resource", nth=2)], seed=2)
    assert_same_recovery(got, want)
    c = got.counters
    assert c.get("recover.replans") == 1
    assert c.get("recover.recovered") == 1
    assert c.get("recover.checkpoint_hits", 0) >= 1
    assert c.get("recover.stages_replayed", 0) < 2
    if world > 1:
        assert c.get("shuffle.strategy.downgrades", 0) >= 1


@pytest.mark.parametrize("world", WORLDS)
def test_permanent_fault_fails_annotated(dctx, jax_trace_shim, world):
    got, want = run_both(dctx, world, lambda fm: [
        fm.FaultRule("exec.stage", kind="permanent", nth=1)], seed=3)
    assert_same_recovery(got, want)
    assert isinstance(got.error, tfaults.PermanentFault)
    assert got.error.ladder[-1] == {
        "class": "permanent", "action": "fail",
        "error": got.error.ladder[-1]["error"]}
    assert got.counters.get("recover.failures") == 1
    assert [e["kind"] for e in got.events] == ["recover_failed"]


@pytest.mark.parametrize("world", WORLDS)
def test_organic_first_failure_not_booked(dctx, jax_trace_shim, world):
    """A plain user error the ladder never engaged with is annotated but
    not booked as ``recover.failures``."""
    def bad_j(env):
        raise ct.CylonError(ct.Status(ct.Code.Invalid, "user bug"))

    def bad_t(env):
        raise pt.CylonError(pt.Status(pt.Code.Invalid, "user bug"))

    got, want = run_both(
        dctx, world, ops=(lambda t: jdops.dist_select(t["fact"], bad_j),
                          lambda t: tdops.dist_select(t["fact"], bad_t)))
    assert_same_recovery(got, want)
    assert got.counters.get("recover.failures", 0) == 0
    assert got.error.ladder[-1]["class"] == "permanent"


@pytest.mark.parametrize("world", WORLDS)
def test_exhausted_transient_ladder_fails_annotated(dctx, jax_trace_shim,
                                                    world):
    for rm in (tres, jres):
        rm.set_recovery_policy(rm.RecoveryPolicy(max_stage_retries=1))
    got, want = run_both(dctx, world, lambda fm: [
        fm.FaultRule("exec.stage", kind="transient", probability=1.0)],
        seed=4)
    assert_same_recovery(got, want)
    assert isinstance(got.error, tfaults.TransientFault)
    assert [a["action"] for a in got.error.ladder] == ["retry", "fail"]
    assert got.counters.get("recover.failures") == 1


@pytest.mark.parametrize("world", WORLDS)
def test_checkpoint_restore_fault_degrades_to_replay(dctx, jax_trace_shim,
                                                     world):
    """A failed checkpoint restore drops the checkpoint and recomputes
    the stage — still correct, the dropped restore visible."""
    got, want = run_both(dctx, world, lambda fm: [
        fm.FaultRule("exec.stage", kind="resource", nth=2),
        fm.FaultRule("recover.checkpoint_restore", kind="transient",
                     probability=1.0)], seed=5)
    assert_same_recovery(got, want)
    c = got.counters
    assert c.get("recover.restore_failed", 0) >= 1
    assert c.get("recover.stages_replayed", 0) >= 1
    assert c.get("recover.recovered") == 1


@pytest.mark.parametrize("world", WORLDS)
def test_replan_trigger_fault_escalates_to_failure(dctx, jax_trace_shim,
                                                   world):
    got, want = run_both(dctx, world, lambda fm: [
        fm.FaultRule("exec.stage", kind="resource", nth=2),
        fm.FaultRule("recover.replan", kind="transient", probability=1.0)],
        seed=6)
    assert_same_recovery(got, want)
    assert isinstance(got.error, tfaults.TransientFault)
    assert got.error.ladder[-1]["action"] == "fail"
    assert "replan setup failed" in got.error.ladder[-1]["error"]
    assert got.counters.get("recover.failures") == 1


@pytest.mark.parametrize("world", WORLDS)
def test_checkpoint_budget_prices_retention(dctx, jax_trace_shim, world):
    """A checkpoint budget too small for any stage result skips
    retention: the replanning recovery still works, it replays the
    completed stage."""
    for cfg in (tconfig, jconfig):
        cfg.set_device_memory_budget(64 << 20)
    for rm in (tres, jres):
        rm.set_recovery_policy(rm.RecoveryPolicy(checkpoint_fraction=1e-7))
    got, want = run_both(dctx, world, lambda fm: [
        fm.FaultRule("exec.stage", kind="resource", nth=2)], seed=7)
    assert_same_recovery(got, want)
    c = got.counters
    assert c.get("recover.checkpoint_skipped", 0) >= 1
    assert c.get("recover.checkpoints", 0) == 0
    assert c.get("recover.stages_replayed", 0) >= 1
    assert c.get("recover.recovered") == 1


@pytest.mark.parametrize("world", WORLDS)
def test_recovery_disabled_propagates_first_failure(dctx, jax_trace_shim,
                                                    world):
    for cfg in (tconfig, jconfig):
        cfg.set_recovery_enabled(False)
    got, want = run_both(dctx, world, lambda fm: [
        fm.FaultRule("exec.stage", kind="transient", nth=1)], seed=8)
    assert_same_recovery(got, want)
    assert isinstance(got.error, tfaults.TransientFault)
    assert not hasattr(got.error, "ladder")
    assert got.counters.get("recover.stage_retries", 0) == 0
    assert got.counters.get("recover.failures", 0) == 0
    with pytest.raises(pt.CylonError):
        tconfig.set_recovery_enabled("yes")


def test_recovery_knob_env(monkeypatch):
    for cfg in (tconfig, jconfig):
        prev = cfg.set_recovery_enabled(None)
        try:
            assert cfg.recovery_enabled()     # default on
            monkeypatch.setenv("CYLON_RECOVERY", "0")
            assert not cfg.recovery_enabled()
            monkeypatch.setenv("CYLON_RECOVERY", "1")
            assert cfg.recovery_enabled()
            monkeypatch.delenv("CYLON_RECOVERY")
        finally:
            cfg.set_recovery_enabled(prev)


def test_stage_count_and_boundaries(dctx, jax_trace_shim):
    op_j, op_t = two_stage_ops()
    jt, tt = tables_both(dctx, 8, two_stage_frames())
    roots = []
    for ir_mod, ctx, op, tables in ((tir, tctx_of(8), op_t, tt),
                                    (jir, dctx, op_j, jt)):
        b = ir_mod.Builder(ctx)
        wrapped = b.wrap_tables(tables)
        with ir_mod.capture(b):
            roots.append(op(wrapped)._node)
    rt, rj = roots
    assert tir.stage_count(rt) == jir.stage_count(rj) == 2
    assert [tir.is_stage_boundary(n) for n in tir.topo(rt)] == \
        [jir.is_stage_boundary(n) for n in jir.topo(rj)]
    assert tir.EXCHANGE_OPS == jir.EXCHANGE_OPS


def test_cuda_oom_takes_the_resource_rung(monkeypatch):
    """A real allocation failure (``torch.OutOfMemoryError``, what the
    caching allocator raises on the card) is the RESOURCE class: the
    ladder drops the memo and re-lowers with the exchanges demoted,
    exactly as for an injected resource fault."""
    world = 8
    tt = {k: TDTable.from_table(tctx_of(world),
                                pt.Table.from_pandas(tctx_of(world), df))
          for k, df in two_stage_frames().items()}
    _, op_t = two_stage_ops()
    tconfig.set_broadcast_join_threshold(1)
    want = frame_of(tplan.run(tctx_of(world), op_t, tt))
    real = texecutor.LOWERING["dist_groupby_fused"]
    calls = []

    def oom_once(ctx, ins, static, rt):
        calls.append(tres.exchange_demotions())
        if len(calls) == 1:
            raise torch.OutOfMemoryError("CUDA out of memory (simulated)")
        return real(ctx, ins, static, rt)

    monkeypatch.setitem(texecutor.LOWERING, "dist_groupby_fused", oom_once)
    ttrace.reset()
    tplan.clear_plan_cache()
    got = frame_of(tplan.run(tctx_of(world), op_t, tt))
    assert_frames_close(got, want)
    c = ttrace.counters()
    assert c.get("recover.replans") == 1 and c.get("recover.recovered") == 1
    assert c.get("recover.checkpoint_hits", 0) >= 1   # the join restored
    assert calls[0] == () and tcost.SINGLE_SHOT in calls[1]


# ---------------------------------------------------------------------------
# recovery over the host tier (``tests/test_spill.py:365``, ``:395``)
# ---------------------------------------------------------------------------

def _spill_frame(seed):
    rng = np.random.default_rng(seed)
    return pd.DataFrame({"k": rng.integers(0, 23, 30000),
                         "v": rng.standard_normal(30000)})


def _spilled_runs(dctx, world, df, ops, fault_plan):
    """Each package's planned ``op`` on a fresh table of ``df``,
    fault-free and then under ``fault_plan(faults_module)`` with a 100 KB
    device budget (the morsel scan planned at world 8), from cleared
    pools and plan caches.  Returns ((fault-free frame, faulted frame,
    counters, plan) for the port, (...) for JAX)."""
    from cylon_tpu.spill import pool as jpool
    out = []
    for cfg, pl, tr, fm, pool, op, side in (
            (tconfig, tplan, ttrace, tfaults, tpool, ops[1], 1),
            (jconfig, jplan, jtrace, jfaults, jpool, ops[0], 0)):
        def run(plan=None):
            dt = tables_both(dctx, world, {"t": df})[side]["t"]
            if plan is None:
                return frame_of(pl.run(dt.ctx, op, dt))
            with fm.active(plan):
                return frame_of(pl.run(dt.ctx, op, dt))
        pool.clear_pool()
        pl.clear_plan_cache()
        clean = run()
        fp = fault_plan(fm)
        tr.reset()
        pl.clear_plan_cache()
        cfg.set_device_memory_budget(100_000)
        try:
            got = run(fp)
            c = dict(tr.counters())
        finally:
            cfg.set_device_memory_budget(None)
            pl.clear_plan_cache()
            pool.clear_pool()
        out.append((clean, got, c, fp))
    return out


def _frames_equal(got, want):
    assert list(got.columns) == list(want.columns) and len(got) == len(want)
    for c in got.columns:
        np.testing.assert_allclose(got[c].to_numpy(), want[c].to_numpy(),
                                   rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("world", WORLDS)
def test_spilled_plan_recovers_from_staging_fault(dctx, jax_trace_shim,
                                                  world):
    """An injected staging fault mid-morsel-scan replans through the
    recovery driver and still answers row-identically, with the JAX
    package's injections, replans and rows (at world 1 no morsel scan is
    planned, so nothing stages and nothing fires, in either package)."""
    (tclean, tgot, tc, tfp), (jclean, jgot, jc, jfp) = _spilled_runs(
        dctx, world, _spill_frame(29),
        (lambda t: jdops.dist_groupby(t, ["k"], [("v", "sum")]),
         lambda t: tdops.dist_groupby(t, ["k"], [("v", "sum")])),
        lambda fm: fm.FaultPlan(seed=0, rules=[
            fm.FaultRule("spill.stage_in", kind="resource", nth=3)]))
    assert tfp.injected == jfp.injected
    keys = ("recover.replans", "recover.recovered", "recover.failures",
            "spill.morsels", "fault.injected")
    assert {k: tc.get(k, 0) for k in keys} == {k: jc.get(k, 0) for k in keys}
    if world > 1:
        assert tfp.injected == 1
        assert tc.get("recover.replans", 0) >= 1, tc
    _frames_equal(tgot, tclean)
    _frames_equal(tgot, jgot)


@pytest.mark.parametrize("world", WORLDS)
def test_chaos_leg_over_spilled_plan(dctx, jax_trace_shim, world):
    """A seeded default FaultPlan over a plan forced through the spill
    path: each package answers its fault-free rows, the port's equal to
    the JAX package's, with no exhausted retry."""
    aggs = [("v", "sum"), ("v", "count")]
    policies = [(m, m.set_retry_policy(m.RetryPolicy(
        max_attempts=6, base_delay_s=0.0))) for m in (tres, jres)]
    try:
        (tclean, tgot, tc, _), (jclean, jgot, _, _) = _spilled_runs(
            dctx, world, _spill_frame(31),
            (lambda t: jdops.dist_groupby(t, ["k"], aggs),
             lambda t: tdops.dist_groupby(t, ["k"], aggs)),
            lambda fm: fm.FaultPlan.default(23))
    finally:
        for m, prev in policies:
            m.set_retry_policy(prev)
    assert tc.get("retry.exhausted", 0) == 0, tc
    if world > 1:
        assert tc.get("spill.morsels", 0) >= 2, tc
    _frames_equal(tgot, tclean)
    _frames_equal(jgot, jclean)
    _frames_equal(tgot, jgot)
