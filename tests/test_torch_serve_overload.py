"""Overload protection of the serving layer against the JAX package's,
from ``tests/test_recovery.py``'s serving tests: a query healed by the
recovery ladder inside a session (and the ``recovered`` tally with the
counters off), the per-plan circuit breaker (its state machine, the
fingerprint, eviction, stale outcomes, the served quarantine, the probe
fault point and a probe slot released by a failed submit, export
failures that must not count), load shedding by depth and priority, by
the deferred backlog and by a hopeless deadline, and ``drain``.

Each served scenario runs through both packages on the two-stage tables
(a HASH join then a groupby, broadcast threshold 1) and compares results,
errors, session tallies, ``serve.*`` counters and handle fields.  The
breaker's unit tests drive each package's :class:`CircuitBreaker` with
the same calls.  ``tests/test_recovery.py``'s abstract-explain case goes
through ``plan_check.validate``, which the port does not have.
"""
import time

import pytest

from test_torch_serve_common import (TIMEOUT, WORLDS, assert_same, counters,
                                     dtables, frame, handle_obs, held, ops,
                                     pkgs, run_both, tallies, two_stage_frames)
from test_torch_serve_common import serve_state  # noqa: F401
from test_torch_common import jax_trace_shim  # noqa: F401

pytestmark = pytest.mark.usefixtures("serve_state", "jax_trace_shim")


def _poison_type(P):
    class Poison(P.CylonError):
        def __init__(self):
            super().__init__(P.status.Status(P.status.Code.ExecutionError,
                                             "poison plan"))
    return Poison


_POISON = {}


def poison_of(P):
    """One poison error type per package (the breaker tests catch it)."""
    return _POISON.setdefault(P.name, _poison_type(P))


# ---------------------------------------------------------------------------
# recovery inside a session
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", WORLDS)
def test_recovery_through_serving_layer(dctx, world):
    """A transient at the victim's second stage heals in place: the
    victim's own slice shows the ladder, the peer's stays clean, and
    the session tallies the recovery."""
    frames_ = two_stage_frames()

    def scenario(P, ctx):
        o = ops(P)
        P.config.set_broadcast_join_threshold(1)
        tabs = dtables(P, ctx, frames_)
        want = frame(P.plan.run(ctx, o.two_stage, tabs))
        P.trace.reset()
        fp = P.faults.FaultPlan(seed=9, rules=[P.faults.FaultRule(
            "exec.stage", kind="transient", nth=2)])
        with P.faults.active(fp), \
                P.serve.ServeSession(ctx, tables=tabs,
                                     batch_window_ms=10.0) as s:
            with held(s):
                victim = s.submit(o.two_stage, label="victim")
                peer = s.submit(o.agg_v, label="peer")
            got = victim.result(TIMEOUT)
            peer.result(TIMEOUT)
            st = s.stats()
        return {"frames": [got, want], "stats": tallies(st),
                "counters": counters(P),
                "h": [handle_obs(victim), handle_obs(peer)]}

    j, t = run_both(dctx, world, scenario)
    assert_same(t, j)
    victim, peer = t["h"]
    assert victim["counters"]["recover.stage_retries"] == 1
    assert victim["counters"]["recover.recovered"] == 1
    assert peer["counters"]["fault.injected"] == 0
    assert t["stats"]["recovered"] == 1


@pytest.mark.parametrize("world", WORLDS)
def test_recovery_stat_self_accounts_with_counters_off(dctx, world):
    frames_ = two_stage_frames()

    def scenario(P, ctx):
        o = ops(P)
        P.config.set_broadcast_join_threshold(1)
        tabs = dtables(P, ctx, frames_)
        want = frame(P.plan.run(ctx, o.two_stage, tabs))
        P.trace.disable_counters()
        fp = P.faults.FaultPlan(seed=9, rules=[P.faults.FaultRule(
            "exec.stage", kind="transient", nth=2)])
        try:
            with P.faults.active(fp), \
                    P.serve.ServeSession(ctx, tables=tabs,
                                         batch_window_ms=0.0) as s:
                h = s.submit(o.two_stage, label="victim")
                got = h.result(TIMEOUT)
        finally:
            P.trace.enable_counters()
        return {"frames": [got, want], "recovered": h.recovered,
                "stats": tallies(s.stats())}

    j, t = run_both(dctx, world, scenario)
    assert_same(t, j)
    assert t["recovered"] and t["stats"]["recovered"] == 1


# ---------------------------------------------------------------------------
# the circuit breaker: units, driven identically in both packages
# ---------------------------------------------------------------------------

def _both_breakers(drive):
    """``drive(P)`` for both packages; returns both transcripts."""
    J, T = pkgs()
    return drive(J), drive(T)


def test_breaker_state_machine_unit():
    def drive(P):
        CB = P.serve.CircuitBreaker
        br = CB(threshold=2, cooldown_s=0.05)

        def op():
            pass
        key = CB.key_of(op)
        log = [br.check(key, op), br.on_failure(key, op),
               br.on_failure(key, op), br.state_of(key), br.check(key, op)]
        time.sleep(0.06)
        log += [br.check(key, op), br.check(key, op)]
        br.on_success(key)
        log.append(br.state_of(key))
        br.on_success(key, probe=True)
        log += [br.state_of(key), br.check(key, op)]
        br.on_failure(key, op)
        br.on_success(key)
        log.append(br.on_failure(key, op))
        with pytest.raises(P.CylonError):
            CB(threshold=0)
        with pytest.raises(P.CylonError):
            CB(cooldown_s=0)
        return log

    j, t = _both_breakers(drive)
    assert t == j == ["admit", False, True, "open", "reject", "probe",
                      "reject", "half-open", "closed", "admit", False]


def test_breaker_key_collides_across_fresh_lambdas():
    import functools

    def drive(P):
        key_of = P.serve.CircuitBreaker.key_of

        def make(qfn):
            return lambda t, q=qfn: q

        a, b = make(min), make(min)

        class NotAFunction:
            def __call__(self, t):
                return t

        class Runner:
            def q(self, t):
                return t
        x, y = NotAFunction(), NotAFunction()
        ra, rb = Runner(), Runner()
        pa, pb, pc = (functools.partial(min, 1), functools.partial(min, 1),
                      functools.partial(min, 2))
        return [a is not b, key_of(a) == key_of(b),
                key_of(a) != key_of(make(max)), key_of(x) != key_of(y),
                key_of(pa) == key_of(pb), key_of(pa) != key_of(pc),
                key_of(ra.q) != key_of(rb.q), key_of(ra.q) == key_of(ra.q)]

    j, t = _both_breakers(drive)
    assert t == j == [True] * 8


def test_breaker_eviction_never_lifts_a_quarantine():
    def drive(P):
        CB = P.serve.CircuitBreaker
        br = CB(threshold=1, cooldown_s=60.0, max_entries=4)

        def poison():
            pass
        pkey = CB.key_of(poison)
        log = [br.on_failure(pkey, poison)]
        fillers = []
        for i in range(8):
            fn = eval(f"lambda: {i}")
            fillers.append(fn)
            br.check(CB.key_of(fn), fn)
        log += [br.state_of(pkey), br.check(pkey, poison)]
        sat = CB(threshold=1, cooldown_s=60.0, max_entries=2)
        opens = [eval(f"lambda: {i} + 100") for i in range(2)]
        log += [sat.on_failure(CB.key_of(fn), fn) for fn in opens]
        extra = eval("lambda: 999")
        ekey = CB.key_of(extra)
        log += [sat.check(ekey, extra), sat.on_failure(ekey, extra),
                sat.check(ekey, extra)]
        log += [sat.state_of(CB.key_of(fn)) for fn in opens]
        return log

    j, t = _both_breakers(drive)
    assert t == j == [True, "open", "reject", True, True, "admit", False,
                      "admit", "open", "open"]


def test_breaker_stale_success_cannot_lift_quarantine_unit():
    def drive(P):
        CB = P.serve.CircuitBreaker
        br = CB(threshold=1, cooldown_s=60.0)

        def op():
            pass
        key = CB.key_of(op)
        log = [br.on_failure(key, op)]
        br.on_success(key)
        return log + [br.state_of(key), br.check(key, op)]

    j, t = _both_breakers(drive)
    assert t == j == [True, "open", "reject"]


def test_breaker_stale_failure_cannot_preempt_probe_unit():
    def drive(P):
        CB = P.serve.CircuitBreaker
        br = CB(threshold=1, cooldown_s=0.05)

        def op():
            pass
        key = CB.key_of(op)
        log = [br.on_failure(key, op)]
        time.sleep(0.06)
        log += [br.check(key, op), br.on_failure(key, op, probe=False),
                br.state_of(key)]
        br.on_success(key, probe=True)
        return log + [br.state_of(key)]

    j, t = _both_breakers(drive)
    assert t == j == [True, "probe", False, "half-open", "closed"]


def test_breaker_probe_failure_reopens_unit():
    def drive(P):
        CB = P.serve.CircuitBreaker
        br = CB(threshold=1, cooldown_s=0.05)

        def op():
            pass
        key = CB.key_of(op)
        log = [br.on_failure(key, op)]
        time.sleep(0.06)
        return log + [br.check(key, op),
                      br.on_failure(key, op, probe=True),
                      br.check(key, op)]

    j, t = _both_breakers(drive)
    assert t == j == [True, "probe", True, "reject"]


# ---------------------------------------------------------------------------
# the circuit breaker, served
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", WORLDS)
def test_breaker_ignores_export_failures(dctx, world):
    frames_ = two_stage_frames()

    def bad_export(r):
        raise ValueError("flaky sink")

    def scenario(P, ctx):
        o = ops(P)
        tabs = dtables(P, ctx, frames_)
        with P.serve.ServeSession(ctx, tables=tabs, batch_window_ms=0.0,
                                  breaker_threshold=2,
                                  breaker_cooldown_s=60.0) as s:
            for i in range(3):
                h = s.submit(o.agg_v, label=f"e{i}", export=bad_export)
                with pytest.raises(ValueError):
                    h.result(TIMEOUT)
            ok = s.submit(o.agg_v, label="fine").result(TIMEOUT)
            st = s.stats()
        return {"frames": [ok], "stats": tallies(st),
                "counters": counters(P)}

    j, t = run_both(dctx, world, scenario)
    assert_same(t, j)
    assert t["counters"].get("serve.breaker_open", 0) == 0
    assert t["stats"]["failed"] == 3


def test_breaker_probe_slot_released_on_submit_error(dctx, monkeypatch):
    frames_ = two_stage_frames()

    def boom(tabs):
        raise RuntimeError("pricing exploded")

    def scenario(P, ctx):
        Poison = poison_of(P)

        def poison(t):
            raise Poison()
        tabs = dtables(P, ctx, frames_)
        with P.serve.ServeSession(ctx, tables=tabs, batch_window_ms=0.0,
                                  breaker_threshold=1,
                                  breaker_cooldown_s=0.05) as s:
            h = s.submit(poison, label="p0")
            with pytest.raises(Poison):
                h.result(TIMEOUT)
            time.sleep(0.06)
            monkeypatch.setattr(P.session.admission, "price_query", boom)
            with pytest.raises(RuntimeError):
                s.submit(poison, label="probe-dies")
            monkeypatch.undo()
            hp = s.submit(poison, label="probe-2")
            probe = hp.probe
            hp._event.wait(TIMEOUT)
            st = s.stats()
        return {"probe": probe, "stats": tallies(st),
                "counters": counters(P), "h": handle_obs(hp)}

    j, t = run_both(dctx, 8, scenario)
    assert_same(t, j)
    assert t["probe"]


@pytest.mark.parametrize("world", WORLDS)
def test_breaker_quarantines_poison_served_plan(dctx, world):
    """Two failures trip the breaker; a typed rejection costs no window;
    a peer completes; after the cooldown one probe restores service."""
    frames_ = two_stage_frames()

    def scenario(P, ctx):
        Poison = poison_of(P)
        o = ops(P)
        state = {"broken": True}

        def poison(t):
            if state["broken"]:
                raise Poison()
            return P.dops.dist_aggregate(t["fact"], [("v", "sum")])
        tabs = dtables(P, ctx, frames_)
        with P.serve.ServeSession(ctx, tables=tabs, batch_window_ms=0.0,
                                  breaker_threshold=2,
                                  breaker_cooldown_s=0.2) as s:
            for i in range(2):
                h = s.submit(poison, label=f"p{i}")
                with pytest.raises(Poison):
                    h.result(TIMEOUT)
            batches = s.stats()["batches"]
            t0 = time.perf_counter()
            with pytest.raises(P.serve.Quarantined):
                s.submit(poison, label="rejected")
            assert time.perf_counter() - t0 < 0.05
            assert s.stats()["batches"] == batches
            peer = s.submit(o.agg_v, label="peer").result(TIMEOUT)
            state["broken"] = False
            time.sleep(0.25)
            hp = s.submit(poison, label="probe")
            probe = hp.probe
            healed = [hp.result(TIMEOUT),
                      s.submit(poison, label="healed").result(TIMEOUT)]
            st = s.stats()
        return {"frames": [peer] + healed, "probe": probe,
                "stats": tallies(st), "counters": counters(P)}

    j, t = run_both(dctx, world, scenario)
    assert_same(t, j)
    assert t["probe"]
    assert t["stats"]["breaker_rejected"] == 1
    assert t["stats"]["breaker_probes"] == 1
    assert t["counters"]["serve.breaker_open"] >= 1
    assert t["counters"]["serve.breaker_closed"] >= 1


def test_breaker_probe_fault_point(dctx):
    frames_ = two_stage_frames()

    def scenario(P, ctx):
        Poison = poison_of(P)

        def poison(t):
            raise Poison()
        fp = P.faults.FaultPlan(seed=0, rules=[P.faults.FaultRule(
            "serve.breaker_probe", kind="transient", probability=1.0)])
        tabs = dtables(P, ctx, frames_)
        with P.serve.ServeSession(ctx, tables=tabs, batch_window_ms=0.0,
                                  breaker_threshold=1,
                                  breaker_cooldown_s=0.05) as s:
            h = s.submit(poison, label="p0")
            with pytest.raises(Poison):
                h.result(TIMEOUT)
            time.sleep(0.06)
            with P.faults.active(fp):
                with pytest.raises(P.faults.TransientFault):
                    s.submit(poison, label="probe")
            with pytest.raises(P.serve.Quarantined):
                s.submit(poison, label="still-quarantined")
            st = s.stats()
        return {"stats": tallies(st), "counters": counters(P)}

    j, t = run_both(dctx, 8, scenario)
    assert_same(t, j)
    assert t["stats"]["breaker_probes"] == 1


# ---------------------------------------------------------------------------
# load shedding and drain
# ---------------------------------------------------------------------------

def test_load_shedding_by_depth_and_priority(dctx):
    frames_ = two_stage_frames()

    def scenario(P, ctx):
        o = ops(P)
        tabs = dtables(P, ctx, frames_)
        with P.serve.ServeSession(ctx, tables=tabs, batch_window_ms=10.0,
                                  shed_depth=2) as s:
            with held(s):
                hs = [s.submit(o.agg_v, label=f"q{i}") for i in range(2)]
                with pytest.raises(P.serve.Overloaded):
                    s.submit(o.agg_v, label="shed-me")
                hs.append(s.submit(o.agg_v, label="vip", priority=1))
            res = [h.result(TIMEOUT) for h in hs]
            st = s.stats()
        return {"frames": res, "stats": tallies(st),
                "counters": counters(P)}

    j, t = run_both(dctx, 8, scenario)
    assert_same(t, j)
    assert t["stats"]["shed"] == 1 and t["stats"]["completed"] == 3


def test_shed_sees_deferred_backlog(dctx):
    """Budget deferrals leave the queue for the dispatcher's pending
    list; the shed depth counts them."""
    frames_ = two_stage_frames()

    def scenario(P, ctx):
        o = ops(P)
        tabs = dtables(P, ctx, frames_)
        with P.serve.ServeSession(ctx, tables=tabs, batch_window_ms=150.0,
                                  admission_budget=1, shed_depth=2) as s:
            with held(s):
                held_hs = [s.submit(o.agg_v, label=f"q{i}", priority=1)
                           for i in range(4)]
            deadline = time.time() + 10
            while (s._pending_count < 2 or len(s._queue) > 0) \
                    and time.time() < deadline:
                time.sleep(0.01)
            backlog = s._pending_count >= 2 and len(s._queue) == 0
            with pytest.raises(P.serve.Overloaded):
                s.submit(o.agg_v, label="shed-me")
            res = [h.result(TIMEOUT) for h in held_hs]
            st = s.stats()
        return {"frames": res, "backlog": backlog, "shed": st["shed"],
                "completed": st["completed"]}

    j, t = run_both(dctx, 8, scenario)
    assert_same(t, j)
    assert t["backlog"] and t["shed"] == 1 and t["completed"] == 4


def test_slo_pressure_shed_on_hopeless_deadline(dctx):
    frames_ = two_stage_frames()

    def scenario(P, ctx):
        o = ops(P)
        tabs = dtables(P, ctx, frames_)
        with P.serve.ServeSession(ctx, tables=tabs, batch_window_ms=10.0,
                                  shed_depth=0) as s:
            s._ewma_ms = 200.0
            with held(s):
                h1 = s.submit(o.agg_v, label="held")
                with pytest.raises(P.serve.Overloaded):
                    s.submit(o.agg_v, label="hopeless", deadline_ms=50.0)
                h2 = s.submit(o.agg_v, label="roomy", deadline_ms=60_000.0)
            res = [h1.result(TIMEOUT), h2.result(TIMEOUT)]
            st = s.stats()
        return {"frames": res, "stats": tallies(st),
                "counters": counters(P)}

    j, t = run_both(dctx, 8, scenario)
    assert_same(t, j)
    assert t["stats"]["shed"] == 1


@pytest.mark.parametrize("world", WORLDS)
def test_drain_finishes_in_flight_and_flushes(dctx, world):
    frames_ = two_stage_frames()

    def scenario(P, ctx):
        o = ops(P)
        tabs = dtables(P, ctx, frames_)
        s = P.serve.ServeSession(ctx, tables=tabs, batch_window_ms=5.0)
        with held(s):
            hs = [s.submit(o.agg_v, label=f"q{i}",
                           export=lambda r: r.to_pandas())
                  for i in range(3)]
        stats = s.drain()
        assert all(h.done() for h in hs)
        res = [h.result(timeout=1) for h in hs]
        with pytest.raises(P.CylonError):
            s.submit(o.agg_v, label="late")
        stats2 = s.drain()
        drained = any(e["kind"] == "drain" for e in P.flightrec.events())
        s2 = P.serve.ServeSession(ctx, tables=tabs, batch_window_ms=0.0)
        s2.close()
        s2.drain()
        return {"frames": res, "stats": tallies(stats),
                "stats2": tallies(stats2), "drained": drained,
                "drains": P.trace.counters().get("serve.drains", 0)}

    j, t = run_both(dctx, world, scenario)
    assert_same(t, j)
    assert t["stats"]["completed"] == 3 and t["drained"]
    assert t["drains"] == 2


def test_shed_knob_validation(dctx):
    frames_ = two_stage_frames()

    def scenario(P, ctx):
        with pytest.raises(P.CylonError):
            P.serve.ServeSession(ctx, tables=dtables(P, ctx, frames_),
                                 shed_depth=-1)
        for bad in (dict(tail_keep_k=0), dict(tail_window=0),
                    dict(batch_window_ms=-1.0)):
            with pytest.raises(P.CylonError):
                P.serve.ServeSession(ctx, tables=None, **bad)
        return {}

    j, t = run_both(dctx, 8, scenario)
    assert t == j
