"""The serving layer under topology changes and the fleet router, against
the JAX package's, from ``tests/test_elastic.py``: a served device loss
(degraded mode on the survivors), the re-priced admission budget and its
relaxation on a scale-up, the served scale-up, the deadline estimate
that sees the retry cap, the capacity-request lifecycle, and the
:class:`FleetRouter` (validation, affinity, failover, per-replica
drain).  Also the port's slot-range context (``first_slot``), the
counterpart of the JAX package's ``CylonContext({"devices": subset})``:
the JAX package's replicas are two halves of its 8 devices, the port's
two slot ranges of one device.

Scenarios run through both packages; results, session tallies, counters,
placements and budgets must be the JAX package's.
"""
import time

import numpy as np
import pandas as pd
import pytest

from test_torch_serve_common import (TIMEOUT, WORLDS, assert_same, counters,
                                     dtables, frame, handle_obs, held, pkgs,
                                     run_both, tallies)
from test_torch_serve_common import serve_state  # noqa: F401
from test_torch_common import jax_trace_shim  # noqa: F401

pytestmark = pytest.mark.usefixtures("serve_state", "jax_trace_shim")


def _wait_until(pred, timeout=30.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return pred()


def _elastic_frames(seed):
    """``tests/test_elastic.py``'s two-stage tables: int32 keys, float32
    values."""
    rng = np.random.default_rng(seed)
    fact = pd.DataFrame({"k": rng.integers(0, 300, 4000).astype(np.int32),
                         "v": rng.random(4000).astype(np.float32)})
    dim = pd.DataFrame({"k": np.arange(300, dtype=np.int32),
                        "w": rng.random(300).astype(np.float32)})
    return {"fact": fact, "dim": dim}


_OPS = {}


def _op(P):
    """The two-stage plan (a join, then a groupby), one per package."""
    if P.name not in _OPS:
        d, JC = P.dops, P.JoinConfig

        def op(t):
            j = d.dist_join(t["fact"], t["dim"], JC.InnerJoin(0, 0))
            return d.dist_groupby(j, ["lt-k"], [("rt-w", "sum")])

        def fleet_op(t):
            return d.dist_groupby(t["t"], ["g"], [("x", "sum")])
        _OPS[P.name] = (op, fleet_op)
    return _OPS[P.name]


def _halves(dctx):
    """``{package: (context a, context b)}``: disjoint halves."""
    import cylon_tpu as ct
    import cylon_tpu_torch as pt
    devs = dctx.devices
    return {"cylon_tpu": (
        ct.CylonContext({"backend": "tpu", "devices": devs[:4]}),
        ct.CylonContext({"backend": "tpu", "devices": devs[4:]})),
        "cylon_tpu_torch": (
        pt.CylonContext(device="cpu", world=4),
        pt.CylonContext(device="cpu", world=4, first_slot=4))}


# ---------------------------------------------------------------------------
# the slot-range context
# ---------------------------------------------------------------------------

def test_slot_range_context_and_survivors():
    import cylon_tpu_torch as pt
    _, T = pkgs()
    a = pt.CylonContext(device="cpu", world=4)
    b = pt.CylonContext(device="cpu", world=4, first_slot=4)
    assert T.topology.slots(a) == tuple(("cpu", i) for i in range(4))
    assert T.topology.slots(b) == tuple(("cpu", i) for i in range(4, 8))
    assert "first_slot=4" in repr(b) and "first_slot" not in repr(a)
    assert b.with_world(2).first_slot == 4
    with pytest.raises(T.CylonError):
        pt.CylonContext(device="cpu", first_slot=-1)
    # a loss keeps the survivors inside the replica's own range
    surv = T.topology.mark_lost(b, 1)
    assert T.topology.slots(surv) == (("cpu", 4), ("cpu", 5), ("cpu", 6))
    assert not T.topology.degraded(a)
    T.topology.mark_joined(b, 1)
    assert T.topology.effective(b) is b


# ---------------------------------------------------------------------------
# degraded mode and scale-up
# ---------------------------------------------------------------------------

def test_served_device_loss_degraded_mode(dctx):
    frames_ = _elastic_frames(21)

    def scenario(P, ctx):
        op = _op(P)[0]
        P.config.set_broadcast_join_threshold(1)
        want = frame(P.plan.run(ctx, op, dtables(P, ctx, frames_)))
        P.topology.reset()
        P.trace.reset()
        tabs = dtables(P, ctx, frames_)
        plan = P.faults.FaultPlan(seed=0, rules=[P.faults.FaultRule(
            "mesh.device_lost", kind="topology", nth=2, lost=2)])
        with P.faults.active(plan), \
                P.serve.ServeSession(ctx, tables=tabs,
                                     batch_window_ms=10.0) as s:
            with held(s):
                victim = s.submit(op, label="victim")
                peer = s.submit(op, label="peer")
            got = [victim.result(TIMEOUT), peer.result(TIMEOUT)]
            tail = s.submit(op, label="tail")
            got.append(tail.result(TIMEOUT))
            st = s.stats()
        world = P.topology.effective(ctx).get_world_size()
        keys = ("recover.remesh", "fault.injected")
        return {"frames": got + [want], "stats": tallies(st),
                "world": world,
                "h": [handle_obs(h, keys) for h in (victim, peer, tail)]}

    j, t = run_both(dctx, 8, scenario)
    assert_same(t, j)
    victim, peer, _ = t["h"]
    assert victim["counters"]["recover.remesh"] == 1 and victim["recovered"]
    assert peer["counters"] == {"recover.remesh": 0, "fault.injected": 0}
    assert t["stats"]["degraded_world"] == 6 and t["world"] == 6
    assert t["stats"]["mesh_degraded"] >= 1 and t["stats"]["failed"] == 0


def test_degraded_admission_budget_repriced_and_relaxed(dctx):
    """4 of 8 survivors halve the window budget; partial and full
    rejoins re-price it back up along the same line."""
    def scenario(P, ctx):
        s = P.serve.ServeSession(ctx, tables=None,
                                 admission_budget=8_000_000)
        try:
            out = [s._budget()]
            P.topology.mark_lost(ctx, 4)
            out.append(s._budget())
            P.topology.mark_joined(ctx, 2)
            out.append(s._budget())
            P.topology.mark_joined(ctx, 2)
            out.append(s._budget())
        finally:
            s.close()
        return {"budgets": out,
                "scaled": [P.admission.scaled_budget(1000, w, 8)
                           for w in range(0, 10)]}

    j, t = run_both(dctx, 8, scenario)
    assert t == j
    assert t["budgets"] == [8_000_000, 4_000_000, 6_000_000, 8_000_000]


def test_served_scaleup_undegrades_and_serves_full_mesh(dctx):
    frames_ = _elastic_frames(31)

    def scenario(P, ctx):
        op = _op(P)[0]
        P.config.set_broadcast_join_threshold(1)
        want = frame(P.plan.run(ctx, op, dtables(P, ctx, frames_)))
        tabs = dtables(P, ctx, frames_)
        P.trace.reset()
        with P.serve.ServeSession(ctx, tables=tabs, batch_window_ms=0.0,
                                  admission_budget=8_000_000,
                                  name="scaleup-test") as s:
            P.topology.mark_lost(ctx, 4)
            assert _wait_until(
                lambda: s.stats().get("mesh_degraded", 0) >= 1)
            degraded_budget = s._budget()
            r1 = s.submit(op, label="degraded").result(TIMEOUT)
            P.topology.mark_joined(ctx, 4)
            assert _wait_until(
                lambda: s.stats().get("mesh_expanded", 0) >= 1)
            st = tallies(s.stats())
            budget = s._budget()
            r2 = s.submit(op, label="restored").result(TIMEOUT)
            full = (P.topology.effective(ctx) is ctx
                    and tabs["fact"].ctx is ctx)
        return {"frames": [r1, r2, want], "stats": st,
                "budgets": (degraded_budget, budget), "full": full,
                "scaleups": P.trace.counters().get("recover.scaleups", 0)}

    j, t = run_both(dctx, 8, scenario)
    assert_same(t, j)
    assert t["budgets"] == (4_000_000, 8_000_000) and t["full"]
    assert t["stats"]["mesh_expanded"] == 1
    assert "degraded_world" not in t["stats"] and t["scaleups"] == 1


@pytest.mark.parametrize("world", WORLDS)
def test_serve_deadline_estimate_sees_retry_cap(dctx, world):
    def scenario(P, ctx):
        s = P.serve.ServeSession(ctx, tables=None, batch_window_ms=0.0)
        try:
            s._ewma_ms = 10.0
            prev = P.resilience.set_retry_policy(
                P.resilience.RetryPolicy(max_elapsed_s=5.0))
            try:
                with pytest.raises(P.serve.Overloaded, match="deadline"):
                    s.submit(lambda: None, tables=None, deadline_ms=50.0)
            finally:
                P.resilience.set_retry_policy(prev)
            h = s.submit(lambda: None, tables=None, deadline_ms=50.0)
            h.result(timeout=60)
        finally:
            s.close()
        return {"stats": tallies(s.stats()), "counters": counters(P)}

    j, t = run_both(dctx, world, scenario)
    assert_same(t, j)
    assert t["stats"]["shed"] == 1 and t["stats"]["completed"] == 1


def test_capacity_request_lifecycle(dctx):
    def scenario(P, ctx):
        s = P.serve.ServeSession(ctx, tables=None, batch_window_ms=0.0)
        try:
            sampler = P.timeseries.TimeSeriesSampler(session=s)
            sampler._alert("p99-drift", {"t": 1.0}, "p99 drifted 4x")
            sampler._alert("cache-hit-collapse", {"t": 2.0}, "churn")
            reqs = [(r.rule, r.status) for r in s.capacity_requests()]
            tally = s.stats()["capacity_requests"]
            P.topology.mark_lost(ctx, 4)
            assert _wait_until(
                lambda: s.stats().get("mesh_degraded", 0) >= 1)
            P.topology.mark_joined(ctx, 4)
            assert _wait_until(
                lambda: s.stats().get("mesh_expanded", 0) >= 1)
            after = [(r.rule, r.status) for r in s.capacity_requests()]
        finally:
            s.close()
        return {"reqs": reqs, "after": after, "tally": tally,
                "alerts": [a["rule"] for a in sampler.alerts],
                "counters": counters(P)}

    j, t = run_both(dctx, 8, scenario)
    assert_same(t, j)
    assert t["reqs"] == [("p99-drift", "open")] and t["tally"] == 1
    assert t["after"] == [("p99-drift", "fulfilled")]


# ---------------------------------------------------------------------------
# the fleet router
# ---------------------------------------------------------------------------

def test_fleet_router_validation(dctx):
    import cylon_tpu_torch as pt
    halves = _halves(dctx)
    for P in pkgs():
        ctx = halves[P.name][0]
        FR = P.router.FleetRouter
        with pytest.raises(P.CylonError, match="at least one"):
            FR([])
        s1 = P.serve.ServeSession(ctx, tables=None, name="dup")
        s2 = P.serve.ServeSession(ctx, tables=None, name="dup")
        try:
            with pytest.raises(P.CylonError, match="unique"):
                FR([s1, s2])
        finally:
            s1.close()
            s2.close()
        s3 = P.serve.ServeSession(ctx, tables=None, name="left")
        s4 = P.serve.ServeSession(ctx, tables=None, name="right")
        try:
            with pytest.raises(P.CylonError, match="disjoint"):
                FR([s3, s4])
        finally:
            s3.close()
            s4.close()
    _, T = pkgs()
    # overlapping slot ranges of one device are not disjoint either
    sa = T.serve.ServeSession(pt.CylonContext(device="cpu", world=4),
                              tables=None, name="a")
    sb = T.serve.ServeSession(pt.CylonContext(device="cpu", world=4,
                                              first_slot=3),
                              tables=None, name="b")
    try:
        with pytest.raises(T.CylonError, match="disjoint"):
            T.router.FleetRouter([sa, sb])
    finally:
        sa.close()
        sb.close()


def _fleet(P, ca, cb, df):
    sa = P.serve.ServeSession(ca, tables={"t": P.DTable.from_pandas(ca, df)},
                              name="rep-a", batch_window_ms=0.0)
    sb = P.serve.ServeSession(cb, tables={"t": P.DTable.from_pandas(cb, df)},
                              name="rep-b", batch_window_ms=0.0)
    return sa, sb


def test_fleet_router_affinity_and_failover_parity(dctx):
    rng = np.random.default_rng(41)
    df = pd.DataFrame({"g": rng.integers(0, 20, 2000).astype(np.int32),
                       "x": rng.random(2000).astype(np.float32)})
    exp = (df.groupby("g", as_index=False)["x"].sum()
           .sort_values("g").reset_index(drop=True))
    halves = _halves(dctx)
    out = []
    for P in pkgs():
        op = _op(P)[1]
        ca, cb = halves[P.name]
        sa, sb = _fleet(P, ca, cb, df)
        try:
            r = P.router.FleetRouter([sa, sb])
            res = [r.submit(op, label="first").result(TIMEOUT)]
            first = r.replica_of(op)
            res.append(r.submit(op, label="second").result(TIMEOUT))
            again = r.replica_of(op)
            victim = {"rep-a": sa, "rep-b": sb}[first]
            P.topology.mark_lost(victim.ctx, 2)
            res.append(r.submit(op, label="failover").result(TIMEOUT))
            moved = r.replica_of(op)
            P.topology.mark_joined(victim.ctx, 2)
            healed = not P.topology.degraded(victim.ctx)
            out.append({"frames": res, "placements": (first, again, moved),
                        "healed": healed,
                        "counters": counters(P, ("serve.router",))})
        finally:
            sa.close()
            sb.close()
            P.topology.reset()
    assert_same(out[1], out[0])
    for got in out[1]["frames"]:
        g = frame(got)
        assert np.allclose(g["sum_x"].to_numpy(), exp["x"].to_numpy(),
                           atol=1e-4)
    first, again, moved = out[1]["placements"]
    assert first in ("rep-a", "rep-b") and again == first and moved != first
    c = out[1]["counters"]
    assert c["serve.router_affinity_hits"] >= 1
    assert c["serve.router_failovers"] == 1 and c["serve.router_routed"] == 3
    assert out[1]["healed"]


def test_fleet_router_drain_keeps_serving(dctx):
    df = pd.DataFrame({"g": np.arange(8, dtype=np.int32),
                       "x": np.ones(8, np.float32)})
    halves = _halves(dctx)
    out = []
    for P in pkgs():
        op = _op(P)[1]
        sa, sb = _fleet(P, *halves[P.name], df)
        try:
            r = P.router.FleetRouter([sa, sb])
            final = tallies(r.drain("rep-a"))
            res = r.submit(op, label="after-drain").result(TIMEOUT)
            with pytest.raises(P.CylonError, match="no replica"):
                r.drain("rep-z")
            out.append({"frames": [res], "final": final,
                        "replica": r.replica_of(op),
                        "draining": r.stats()["draining"]})
        finally:
            sa.close()
            sb.close()
    assert_same(out[1], out[0])
    assert out[1]["final"]["failed"] == 0
    assert out[1]["replica"] == "rep-b" and out[1]["draining"] == ["rep-a"]
    assert len(frame(out[1]["frames"][0])) == 8
