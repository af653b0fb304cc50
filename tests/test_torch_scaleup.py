"""Elastic degraded-world execution, the scale-up half: device rejoin,
hysteresis and deferral in the port against the JAX package's
(``tests/test_elastic.py:624-860``), on the same numpy-seeded tables under
the same ``FaultPlan``: the cooldown knob, the amortized win, after /
window gating, ``poll``, rejoin, epoch identity, a no-op join,
hysteresis, scale-up parity (4 → 8 and 7 → 8, shard by shard), deferred
and flap-damped scale-up."""
import pytest

from cylon_tpu import config as jconfig
from cylon_tpu import faults as jfaults
from cylon_tpu import observe as jobserve
from cylon_tpu import topology as jtopology
from cylon_tpu import trace as jtrace
from cylon_tpu.observe import stats as jobstats
from cylon_tpu.parallel import cost as jcost

import cylon_tpu_torch as pt
from cylon_tpu_torch import config as tconfig
from cylon_tpu_torch import faults as tfaults
from cylon_tpu_torch import observe as tobserve
from cylon_tpu_torch import topology as ttopology
from cylon_tpu_torch import trace as ttrace
from cylon_tpu_torch.observe import stats as tobstats
from cylon_tpu_torch.parallel import cost as tcost

from test_torch_common import jax_trace_shim  # noqa: F401
from test_torch_elastic import assert_same_shards, assert_tables_follow
from test_torch_recovery import (_clean_state, assert_same_recovery,  # noqa: F401
                                 run_both, tables_both, tctx_of,
                                 two_stage_frames)


def test_remesh_cooldown_knob_validation(monkeypatch):
    assert tconfig.remesh_cooldown_ms() == 0
    prev = tconfig.set_remesh_cooldown_ms(250)
    try:
        assert tconfig.remesh_cooldown_ms() == 250
    finally:
        tconfig.set_remesh_cooldown_ms(prev)
    for bad in (-1, 1.5, True, "100"):
        with pytest.raises(pt.CylonError):
            tconfig.set_remesh_cooldown_ms(bad)
    monkeypatch.setenv("CYLON_REMESH_COOLDOWN_MS", "40")
    assert tconfig.remesh_cooldown_ms() == jconfig.remesh_cooldown_ms() == 40


@pytest.mark.parametrize("args", [(1000, 4, 4, 8), (1000, 0, 4, 8),
                                  (-5.0, 3, 4, 8), (1000, 3, 8, 8),
                                  (777, 5, 3, 4), (123, 2, 7, 8)])
def test_amortized_remesh_win_equal_jax(args):
    assert tcost.amortized_remesh_win(*args) == \
        jcost.amortized_remesh_win(*args)
    assert tcost.amortized_remesh_win(1000, 4, 4, 8) == pytest.approx(2000.0)


def test_fault_rule_after_window_gating():
    with pytest.raises(pt.CylonError):
        tfaults.FaultRule("exec.stage", window=3)
    with pytest.raises(pt.CylonError):
        tfaults.FaultRule("exec.stage", after="exec.stage", window=0)

    def walk(fm, window, burn):
        plan = fm.FaultPlan(seed=0, rules=[
            fm.FaultRule("mesh.device_lost", kind="topology", nth=1,
                         lost=1, limit=1),
            fm.FaultRule("mesh.device_joined", kind="topology",
                         probability=1.0, limit=1, lost=1,
                         after="mesh.device_lost", window=window)])
        out = []
        with fm.active(plan):
            out.append(fm.poll("mesh.device_joined"))   # gated
            with pytest.raises(fm.TopologyFault):
                fm.check("mesh.device_lost")
            for _ in range(burn):
                fm.check("exec.stage")
            out.append(fm.poll("mesh.device_joined"))
            out.append(fm.poll("mesh.device_joined"))   # limit spent
        return [None if r is None else r.lost for r in out]

    for window, burn, expect in ((10, 0, [None, 1, None]),
                                 (2, 3, [None, None, None])):
        assert walk(tfaults, window, burn) == walk(jfaults, window, burn) \
            == expect


def test_poll_without_plan_is_none():
    assert tfaults.poll("mesh.device_joined") is None


def _rejoin_walk(topo, ctx):
    c4 = topo.mark_lost(ctx, 4)
    restored = topo.mark_joined(ctx, 4)
    return [c4.get_world_size(), restored is ctx, topo.effective(c4) is ctx,
            topo.degraded(ctx)]


def test_topology_rejoin_restores_original(dctx):
    got = _rejoin_walk(ttopology, tctx_of(8))
    assert got == _rejoin_walk(jtopology, dctx) == [4, True, True, False]
    assert ttrace.counters().get("recover.scaleups") == \
        jtrace.counters().get("recover.scaleups") == 1


def _epoch_walk(topo, ctx):
    c6 = topo.mark_lost(ctx, 2)
    c7 = topo.mark_joined(ctx, 1)
    c6b = topo.mark_lost(ctx, 1)
    out = [c6.get_world_size(), c7.get_world_size(), c6b.get_world_size(),
           topo.effective(c6) is c6b, topo.effective(c7) is c6b]
    out.append(topo.mark_joined(ctx, 2) is ctx)
    return out, (c6, c7, c6b)


def test_topology_epoch_append_only_identity(dctx):
    tctx = tctx_of(8)
    got, (c6, c7, c6b) = _epoch_walk(ttopology, tctx)
    assert got == _epoch_walk(jtopology, dctx)[0] == \
        [6, 7, 6, True, True, True]
    roster = ttopology.slots(tctx)
    assert ttopology.slots(c6) == roster[:6]
    assert ttopology.slots(c7) == roster[:7]   # rejoin EXTENDS the prefix
    assert ttopology.slots(c6b) == roster[:6]


def test_topology_join_on_healthy_world_noop(dctx):
    for topo, ctx in ((ttopology, tctx_of(8)), (jtopology, dctx)):
        ep0 = topo.epoch()
        assert topo.mark_joined(ctx, 1) is ctx
        assert topo.epoch() == ep0 and topo.pending_joins(ctx) == 0


def _hysteresis_walk(topo, cfg, ctx):
    prev = cfg.set_remesh_cooldown_ms(600_000)
    try:
        c6 = topo.mark_lost(ctx, 2)
        out = [topo.mark_joined(ctx, 2) is c6, topo.pending_joins(ctx),
               topo.effective(ctx) is c6, topo.mark_joined(ctx, 0) is c6]
    finally:
        cfg.set_remesh_cooldown_ms(prev)
    out += [topo.mark_joined(ctx, 0) is ctx, topo.pending_joins(ctx)]
    return out


def test_topology_join_hysteresis_damps_flap(dctx):
    got = _hysteresis_walk(ttopology, tconfig, tctx_of(8))
    assert got == _hysteresis_walk(jtopology, jconfig, dctx) == \
        [True, 2, True, True, True, 0]
    for tr in (ttrace, jtrace):
        c = tr.counters()
        assert c.get("recover.join_damped") == 1
        assert c.get("recover.scaleups") == 1


@pytest.mark.parametrize("lost", [4, 1])
def test_scaleup_mid_plan_equal_jax(dctx, jax_trace_shim, lost):
    """A plan running degraded on 8 − lost slots re-expands mid-plan on
    ``mesh.device_joined`` (4 → 8, 7 → 8) and completes with the JAX
    package's rows, counters and events; its scan tables are back on the
    full world with the JAX package's shards, and the follow-up plan
    runs there."""
    jt, tt = tables_both(dctx, 8, two_stage_frames())
    ttopology.mark_lost(tctx_of(8), lost)
    jtopology.mark_lost(dctx, lost)
    got, want = run_both(dctx, 8, lambda fm: [
        fm.FaultRule("mesh.device_joined", kind="topology", nth=2,
                     lost=lost)], tables=(jt, tt))
    assert_same_recovery(got, want)
    assert_tables_follow(got, want)
    c = got.counters
    assert c.get("recover.scaleups") == 1
    assert c.get("recover.scaleup_deferred", 0) == 0
    assert c.get("recover.evacuated_bytes", 0) > 0
    assert ttopology.effective(tctx_of(8)) is tctx_of(8)
    assert tt["fact"].ctx is tctx_of(8) and tt["dim"].ctx is tctx_of(8)
    again, again_j = run_both(dctx, 8, tables=(jt, tt))
    assert_same_recovery(again, again_j)


def test_scaleup_deferred_honors_amortization(dctx, jax_trace_shim):
    """With tiny observed bytes on record for the plan's fingerprint the
    expansion is DEFERRED (counted and annotated), the plan finishes on
    the shrunken world; the next plan migrates to the full world."""
    frames = two_stage_frames(seed=17)
    jt, tt = tables_both(dctx, 8, frames)
    ttopology.mark_lost(tctx_of(8), 4)
    jtopology.mark_lost(dctx, 4)
    tobserve.STATS_STORE.clear()
    jobserve.STATS_STORE.clear()
    try:
        # the degraded run learns the plan's digests; then tiny observed
        # exchange bytes are seeded for them: win << migration cost
        with tobstats.collect_digests() as tds, \
                jobstats.collect_digests() as jds:
            run_both(dctx, 8, tables=(jt, tt))
        assert list(tds) and list(jds)
        for ds, store in ((tds, tobserve.STATS_STORE),
                          (jds, jobserve.STATS_STORE)):
            for d in list(ds):
                store.record_run(d, counters={"shuffle.bytes_sent": 64})
        got, want = run_both(dctx, 8, lambda fm: [
            fm.FaultRule("mesh.device_joined", kind="topology", nth=2,
                         lost=4)], tables=(jt, tt))
        assert_same_recovery(got, want)
        c = got.counters
        assert c.get("recover.scaleup_deferred", 0) >= 1
        assert c.get("recover.scaleups") == 1
        assert ttopology.effective(tctx_of(8)) is tctx_of(8)
        assert tt["fact"].ctx.get_world_size() == 4
        again, again_j = run_both(dctx, 8, tables=(jt, tt))
        assert_same_recovery(again, again_j)
        assert tt["fact"].ctx is tctx_of(8)
        assert_same_shards(tt["fact"], jt["fact"])
    finally:
        tobserve.STATS_STORE.clear()
        jobserve.STATS_STORE.clear()


def test_scaleup_flap_damping_bounds_thrash(dctx, jax_trace_shim):
    """Lose, then an immediate rejoin under an active hysteresis window:
    the rejoin is HELD, the plan completes on the survivor world with
    exactly one re-mesh, as in the JAX package."""
    for cfg in (tconfig, jconfig):
        cfg.set_remesh_cooldown_ms(600_000)
    got, want = run_both(dctx, 8, lambda fm: [
        fm.FaultRule("mesh.device_lost", kind="topology", nth=2, lost=2),
        fm.FaultRule("mesh.device_joined", kind="topology",
                     probability=1.0, limit=1, lost=2,
                     after="mesh.device_lost", window=400)],
        frames=two_stage_frames(seed=23))
    assert_same_recovery(got, want)
    assert_tables_follow(got, want)
    c = got.counters
    assert c.get("recover.remesh") == 1
    assert c.get("recover.scaleups", 0) == 0
    assert c.get("recover.join_damped", 0) >= 1
    assert ttopology.pending_joins(tctx_of(8)) == 2
    assert ttopology.effective(tctx_of(8)).get_world_size() == 6
