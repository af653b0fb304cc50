"""Elastic degraded-world execution, the loss half: the port's topology
registry, in-place re-mesh and the recovery driver's topology rung
against the JAX package's (``tests/test_elastic.py:94-420``), on the same
numpy-seeded tables under the same ``FaultPlan``.

Mirrors the topology fault and rule, the default chaos plan,
``classify``, the ladder's remesh rung, the registry, a single device,
the ``lost`` clamp, ``price_remesh``, the in-place and the spilled-table
re-mesh, loss → survivors, the untouched table, a single device
degrading to retry, exhaustion, recovery switched off, and the doctor's
elasticity timeline (``:1050``).  The port's roster is the shard slots
of the simulated world where the JAX package's is the device list, so
the registry is compared by world sizes.  After a re-mesh each shard's
rows equal the JAX package's exactly (the re-block is deterministic).
The non-power-of-two worlds (3 and 7) get their own checks:
``next_bucket`` capacities, ``axis_split``, the hierarchical lowering's
refusal, the partition's ``% P`` and the chooser's prices.  The scale-up
half is ``test_torch_scaleup.py``; the serving and benchdiff tests wait
for ``serve/`` and the tooling."""
import numpy as np
import pandas as pd
import pytest
import torch

import cylon_tpu as ct
from cylon_tpu import config as jconfig
from cylon_tpu import faults as jfaults
from cylon_tpu import resilience as jres
from cylon_tpu import topology as jtopology
from cylon_tpu.ops import hash as jhash
from cylon_tpu.ops.compact import next_bucket as jnext_bucket
from cylon_tpu.parallel import DTable as JDTable
from cylon_tpu.parallel import cost as jcost
from cylon_tpu.parallel import dist_ops as jdops
from cylon_tpu.parallel import remesh as jremesh

import cylon_tpu_torch as pt
from cylon_tpu_torch import config as tconfig
from cylon_tpu_torch import faults as tfaults
from cylon_tpu_torch import resilience as tres
from cylon_tpu_torch import topology as ttopology
from cylon_tpu_torch import trace as ttrace
from cylon_tpu_torch.observe import doctor as tdoctor
from cylon_tpu_torch.ops import hash as thash
from cylon_tpu_torch.ops.compact import next_bucket as tnext_bucket
from cylon_tpu_torch.parallel import DTable as TDTable
from cylon_tpu_torch.parallel import cost as tcost
from cylon_tpu_torch.parallel import dist_ops as tdops
from cylon_tpu_torch.parallel import remesh as tremesh
from cylon_tpu_torch.spill import pool as tpool

from test_torch_common import jax_rows, jax_trace_shim, port_rows  # noqa: F401
from test_torch_recovery import (_clean_state, assert_same_recovery,  # noqa: F401
                                 jctx_of, run_both, tables_both, tctx_of,
                                 two_stage_frames)


def assert_same_shards(tt, jt):
    """The same world, counts and rows per shard, in order."""
    assert tt.nparts == jt.nparts
    assert tt.cap == jt.cap
    np.testing.assert_array_equal(tt.counts_host(), jt.counts_host())
    assert port_rows(tt, ordered=True) == jax_rows(jt, ordered=True)


def assert_tables_follow(got, want):
    """After a run: every scan table sits on the same world as the JAX
    package's, with the same rows per shard."""
    for name in want.tables:
        assert_same_shards(got.tables[name], want.tables[name])


# ---------------------------------------------------------------------------
# the fault class + classification
# ---------------------------------------------------------------------------

def test_topology_fault_type_and_rule():
    exc = tfaults.TopologyFault("mesh.device_lost", lost=3)
    assert exc.point == "mesh.device_lost" and exc.lost == 3
    assert isinstance(exc, tfaults.FaultError)
    assert not isinstance(exc, tfaults.TransientFault)
    assert tfaults.FaultRule("mesh.device_lost", kind="topology",
                             lost=2).lost == 2
    for bad in (0, True):
        with pytest.raises(pt.CylonError):
            tfaults.FaultRule("mesh.device_lost", kind="topology", lost=bad)
    plan = tfaults.FaultPlan(seed=0, rules=[
        tfaults.FaultRule("mesh.device_lost", kind="topology", nth=1,
                          lost=4)])
    with tfaults.active(plan):
        with pytest.raises(tfaults.TopologyFault) as ei:
            tfaults.check("mesh.device_lost")
    assert ei.value.lost == 4
    for point in ("exec.stage", "recover.checkpoint_restore",
                  "recover.replan", "mesh.device_lost", "mesh.device_joined",
                  "spill.stage_in", "spill.stage_out"):
        assert tfaults.POINTS[point] == jfaults.POINTS[point]


def _rule_facts(plan, points):
    return [(r.point, r.kind, r.probability, r.nth, r.once, r.limit,
             r.lost, r.after, r.window)
            for r in plan.rules if r.point in points]


def test_default_chaos_plan_equal_jax_at_the_port_points():
    """``FaultPlan.default`` keeps the JAX plan's rules at every point the
    port hosts — one capped device loss, the capped flap pattern on
    top — and fires the same consultations."""
    tp, jp = tfaults.FaultPlan.default(7), jfaults.FaultPlan.default(7)
    points = set(tfaults.POINTS)
    assert {r.point for r in tp.rules} <= points
    assert _rule_facts(tp, points) == _rule_facts(jp, points)
    losses = [r for r in tp.rules if r.point == "mesh.device_lost"]
    assert [(r.after, r.limit) for r in losses] == \
        [(None, 1), ("mesh.device_joined", 1)]
    joins = [r for r in tp.rules if r.point == "mesh.device_joined"]
    assert [(r.after, r.limit) for r in joins] == [("mesh.device_lost", 1)]


def test_chaos_env_installs_default_plan(monkeypatch):
    monkeypatch.setenv("CYLON_CHAOS", "0")
    assert tfaults.install_chaos_from_env() is None
    assert tfaults.plan() is None
    monkeypatch.setenv("CYLON_CHAOS", "13")
    fp = tfaults.install_chaos_from_env()
    assert tfaults.plan() is fp and fp.seed == 13
    assert _rule_facts(fp, set(tfaults.POINTS)) == _rule_facts(
        tfaults.FaultPlan.default(13), set(tfaults.POINTS))


def test_classify_topology():
    for res, fm in ((tres, tfaults), (jres, jfaults)):
        assert res.classify(fm.TopologyFault("mesh.device_lost")) == \
            res.TOPOLOGY
        # micro retries must NOT absorb a topology fault
        assert not res.RetryPolicy().is_transient(
            fm.TopologyFault("mesh.device_lost"))
    assert tres.classify(torch.OutOfMemoryError("x")) == tres.RESOURCE


def test_ladder_remesh_rung_bounded():
    for res, fm in ((tres, tfaults), (jres, jfaults)):
        ladder = res.Ladder(res.RecoveryPolicy(max_remeshes=1))
        assert ladder.decide(fm.TopologyFault("mesh.device_lost")) == \
            "remesh"
        assert ladder.remeshes == 1
        assert ladder.decide(fm.TopologyFault("mesh.device_lost")) == "fail"


# ---------------------------------------------------------------------------
# the survivor-context registry
# ---------------------------------------------------------------------------

def _registry_walk(topo, ctx):
    ep0 = topo.epoch()
    out = [topo.effective(ctx) is ctx, topo.degraded(ctx)]
    a = topo.mark_lost(ctx, 2)
    out += [a.get_world_size(), topo.effective(ctx) is a,
            topo.effective(a) is a, topo.degraded(ctx), topo.epoch() > ep0]
    b = topo.mark_lost(ctx, 1)          # chained: shrinks the CURRENT world
    out += [b.get_world_size(), topo.effective(ctx) is b,
            topo.effective(a) is b]
    topo.reset()
    out.append(topo.effective(ctx) is ctx)
    return out, a


def test_topology_registry_equal_jax(dctx):
    tctx = tctx_of(8)
    got, survivor = _registry_walk(ttopology, tctx)
    assert got == _registry_walk(jtopology, dctx)[0]
    assert got[2] == 6 and got[7] == 5
    # the survivor context: the same card, the parent's config map
    assert survivor.device == tctx.device
    assert ttopology.slots(survivor) == ttopology.slots(tctx)[:6]


def test_survivor_context_carries_the_config_map():
    ctx = pt.CylonContext({"k": "v"}, device="cpu", world=4)
    s = ttopology.mark_lost(ctx, 1)
    assert s.get_world_size() == 3 and s.get_config("k") == "v"
    s.add_config("k", "w")
    assert ctx.get_config("k") == "v"


def test_topology_single_device_no_survivors(dctx):
    for topo, ctx in ((ttopology, tctx_of(1)), (jtopology, jctx_of(dctx, 1))):
        assert topo.mark_lost(ctx, 1) is ctx
        assert not topo.degraded(ctx)


def test_topology_lost_clamped(dctx):
    assert ttopology.mark_lost(tctx_of(8), 99).get_world_size() == \
        jtopology.mark_lost(dctx, 99).get_world_size() == 1


# ---------------------------------------------------------------------------
# the re-mesh lowering
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("p_old,p_new", [(8, 4), (8, 7), (4, 3), (3, 4),
                                         (7, 8)])
def test_price_remesh_equal_jax(p_old, p_new):
    counts = np.arange(100, 100 + p_old)
    t = tcost.price_remesh(p_old, p_new, counts, 16)
    j = jcost.price_remesh(p_old, p_new, counts, 16)
    assert (t.strategy, t.peak_bytes, t.wire_bytes, t.rounds, t.sizes,
            t.host_bytes) == (j.strategy, j.peak_bytes, j.wire_bytes,
                              j.rounds, j.sizes, j.host_bytes)
    assert t.wire_bytes == int(counts.sum()) * 16
    assert t.host_bytes == 2 * t.wire_bytes
    assert tcost.REMESH not in tcost.STRATEGIES


def _remesh_frame(rows=997, seed=11):
    rng = np.random.default_rng(seed)
    return pd.DataFrame({
        "k": rng.integers(0, 50, rows).astype(np.int32),
        "v": rng.random(rows).astype(np.float32),
        "s": pd.array([None if i % 7 == 0 else f"s{i % 13}"
                       for i in range(rows)], dtype="string")})


@pytest.mark.parametrize("lost", [4, 1, 5])
def test_remesh_table_in_place_equal_jax(dctx, lost):
    """8 → 8 − lost in place: the same DTable object on the survivor
    world, each shard's rows, the counts, the capacity and the evacuated
    bytes equal to the JAX package's; a second call is a no-op."""
    df = _remesh_frame()
    jctx, tctx = jctx_of(dctx, 8), tctx_of(8)
    jt = JDTable.from_table(jctx, ct.Table.from_pandas(jctx, df))
    tt = TDTable.from_table(tctx, pt.Table.from_pandas(tctx, df))
    before = sorted(port_rows(tt.to_table()), key=repr)
    got = tremesh.remesh_table(tt, ttopology.mark_lost(tctx, lost))
    want = jremesh.remesh_table(jt, jtopology.mark_lost(dctx, lost))
    assert got == want > 0
    assert tt.ctx is ttopology.effective(tctx)
    assert tt.nparts == 8 - lost
    assert_same_shards(tt, jt)
    assert sorted(port_rows(tt.to_table()), key=repr) == before
    c = ttrace.counters()
    assert c.get("recover.evacuated_bytes") == got
    assert c.get("spill.stage_outs", 0) == 1 and c.get("spill.stage_ins") == 1
    assert tremesh.remesh_table(tt, tt.ctx) == 0


def test_remesh_spilled_table_equal_jax(dctx):
    """An already-spilled table re-blocks from its pooled copy: no device
    read, the pinned entry released, the rows the JAX package's."""
    from cylon_tpu.spill import pool as jpool
    rng = np.random.default_rng(3)
    df = pd.DataFrame({"k": rng.integers(0, 9, 500).astype(np.int32),
                       "v": rng.random(500).astype(np.float32)})
    jctx, tctx = jctx_of(dctx, 8), tctx_of(8)
    jpool.clear_pool()
    jt = JDTable.from_table(jctx, ct.Table.from_pandas(jctx, df))
    tt = TDTable.from_table(tctx, pt.Table.from_pandas(tctx, df))
    out = []
    for dt, pool, topo, rm, ctx in ((tt, tpool, ttopology, tremesh, tctx),
                                    (jt, jpool, jtopology, jremesh, dctx)):
        dt.spill()
        held = pool.get_pool().host_bytes()
        evac = rm.remesh_table(dt, topo.mark_lost(ctx, 6))
        out.append((evac, dt.is_spilled, dt.nparts,
                    pool.get_pool().host_bytes() < held))
    assert out[0] == out[1] == (0, False, 2, True)
    assert_same_shards(tt, jt)
    jpool.clear_pool()


# ---------------------------------------------------------------------------
# the executor's topology rung, end to end
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lost", [4, 1])
def test_device_loss_recovers_on_survivor_world(dctx, jax_trace_shim, lost):
    """A loss at the SECOND stage boundary: the scan tables and the
    retained checkpoint move onto the 8 − lost survivors, the plan
    resumes without replaying the join, and everything — rows, ladder
    counters, events, each scan table's shards — equals the JAX
    package's; a follow-up plan anchors on the survivor world."""
    got, want = run_both(dctx, 8, lambda fm: [
        fm.FaultRule("mesh.device_lost", kind="topology", nth=2,
                     lost=lost)])
    assert_same_recovery(got, want)
    assert_tables_follow(got, want)
    c = got.counters
    assert c.get("recover.remesh") == 1 and c.get("recover.recovered") == 1
    assert c.get("recover.stages_replayed", 0) < 2
    assert c.get("recover.evacuated_bytes", 0) > 0
    eff = ttopology.effective(tctx_of(8))
    assert eff.get_world_size() == 8 - lost
    assert got.tables["fact"].ctx is eff
    again, again_j = run_both(dctx, 8, tables=(want.tables, got.tables))
    assert_same_recovery(again, again_j)


def test_untouched_table_migrates_without_second_loss(dctx, jax_trace_shim):
    """A table the victim's plan never scanned moves onto the survivor
    world on its next ``plan.run`` (``remesh.ensure_current``), without a
    second ``mark_lost``."""
    rng = np.random.default_rng(9)
    other = pd.DataFrame({"g": rng.integers(0, 20, 2000).astype(np.int32),
                          "x": rng.random(2000).astype(np.float32)})
    jo, to = tables_both(dctx, 8, {"o": other})
    got, want = run_both(dctx, 8, lambda fm: [
        fm.FaultRule("mesh.device_lost", kind="topology", nth=2, lost=4)])
    assert_same_recovery(got, want)
    assert to["o"].ctx is tctx_of(8)          # untouched: the old world
    ep = ttopology.epoch()
    got2, want2 = run_both(
        dctx, 8, tables=(jo, to),
        ops=(lambda t: jdops.dist_groupby(t["o"], ["g"], [("x", "sum")]),
             lambda t: tdops.dist_groupby(t["o"], ["g"], [("x", "sum")])))
    assert_same_recovery(got2, want2)
    assert to["o"].ctx is ttopology.effective(tctx_of(8))
    assert ttopology.epoch() == ep            # no second slot sacrificed
    assert_same_shards(to["o"], jo["o"])


def test_device_loss_single_device_degrades_to_retry(dctx, jax_trace_shim):
    got, want = run_both(dctx, 1, lambda fm: [
        fm.FaultRule("mesh.device_lost", kind="topology", nth=1,
                     once=True)])
    assert_same_recovery(got, want)
    assert got.counters.get("recover.remesh", 0) == 0
    assert got.counters.get("recover.stage_retries") == 1
    assert not ttopology.degraded(tctx_of(1))


def test_device_loss_exhausts_to_annotated_failure(dctx, jax_trace_shim):
    got, want = run_both(dctx, 8, lambda fm: [
        fm.FaultRule("mesh.device_lost", kind="topology", probability=1.0,
                     lost=1)], frames=two_stage_frames(seed=9, rows=600))
    assert_same_recovery(got, want)
    assert isinstance(got.error, tfaults.TopologyFault)
    assert any(a["class"] == "topology" for a in got.error.ladder)
    assert got.counters.get("recover.failures") == 1


def test_recovery_disabled_propagates(dctx, jax_trace_shim):
    for cfg in (tconfig, jconfig):
        cfg.set_recovery_enabled(False)
    got, want = run_both(dctx, 8, lambda fm: [
        fm.FaultRule("mesh.device_lost", kind="topology", nth=1)],
        frames=two_stage_frames(seed=13, rows=600))
    assert_same_recovery(got, want)
    assert isinstance(got.error, tfaults.TopologyFault)
    assert got.counters.get("recover.remesh", 0) == 0
    assert not ttopology.degraded(tctx_of(8))


# ---------------------------------------------------------------------------
# non-power-of-two worlds (the survivor worlds 3 and 7)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", [3, 7])
def test_odd_world_sizes_equal_jax(dctx, world):
    # next_bucket capacities of the re-blocked shards
    for rows in (1, 7, 997, 4000, 16_777_216):
        per = -(-rows // world)
        assert tnext_bucket(per, minimum=8) == jnext_bucket(per, minimum=8)
    # axis_split: a (2, 2) or (2, 4) shape no longer tiles -> flat
    tctx, jctx = tctx_of(world), jctx_of(dctx, world)
    for shape in ((2, 2), (2, 4), (1, world)):
        for cfg in (tconfig, jconfig):
            cfg.set_mesh_shape(shape)
        try:
            assert ttopology.axis_split(tctx) == \
                jtopology.axis_split(jctx)
            assert ttopology.axis_split(tctx)[0] == 1
        finally:
            for cfg in (tconfig, jconfig):
                cfg.set_mesh_shape(None)
    # the hierarchical lowering refuses a flat split; the prices agree
    counts = np.random.default_rng(world).integers(
        0, 500, (world, world)).astype(np.int64)
    for budget in (1 << 30, 20_000, 2_000):
        ct_ = tcost.enumerate_strategies(world, 4096, counts, 12, budget,
                                         split=(1, world))
        cj = jcost.enumerate_strategies(world, 4096, counts, 12, budget,
                                        split=(1, world))
        assert [(c.strategy, c.peak_bytes, c.wire_bytes, c.rounds)
                for c in ct_] == [(c.strategy, c.peak_bytes, c.wire_bytes,
                                   c.rounds) for c in cj]
        assert tcost.HIERARCHICAL not in [c.strategy for c in ct_]
        bt, rt, _ = tcost.choose(ct_, budget)
        bj, rj, _ = jcost.choose(cj, budget)
        assert (bt.strategy, rt) == (bj.strategy, rj)
    # the partition's % P on the same hashes
    keys = np.random.default_rng(1).integers(-2**31, 2**31, 5000,
                                             dtype=np.int64).astype(np.int32)
    got = thash.partition_ids(thash.row_hash((torch.from_numpy(keys),),
                                             (None,)), world)
    want = jhash.partition_ids(jhash.row_hash((keys,), (None,)), world)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got.max()) == world - 1


def test_doctor_renders_elasticity_timeline():
    doc = {"schema": 1, "reason": "test", "events": [
        {"kind": "mesh_degraded", "t": 1.0, "lost": 2,
         "survivor_world": 6, "session": "s"},
        {"kind": "mesh_join_damped", "t": 2.0, "pending": 1,
         "cooldown_ms": 500, "world": 6},
        {"kind": "capacity_request", "t": 3.0, "rule": "p99-drift",
         "session": "s", "detail": "p99 drifted"},
        {"kind": "mesh_expanded", "t": 4.0, "joined": 2, "world": 6,
         "new_world": 8},
        {"kind": "recover", "action": "scaleup", "t": 5.0,
         "new_world": 8, "evacuated_bytes": 123, "note": "win"},
    ], "queries": [], "counters": {}}
    text = tdoctor.render(doc)
    assert "elasticity timeline" in text
    assert "MESH DEGRADED: lost 2 device(s) -> 6 survivors" in text
    assert "JOIN DAMPED: 1 rejoin(s) held (flap window 500 ms)" in text
    assert "CAPACITY REQUEST [p99-drift] (session s): p99 drifted" in text
    assert "MESH EXPANDED: +2 device(s) -> 8 world" in text
    assert "SCALE-UP: evacuated 123 B, resumed on 8 devices (win)" in text
    from cylon_tpu.observe import doctor as jdoctor
    assert text == jdoctor.render(doc)
