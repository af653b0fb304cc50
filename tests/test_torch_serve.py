"""The serving layer (``cylon_tpu_torch/serve/``) against the JAX
package's, scenario by scenario from ``tests/test_serve.py``: concurrent
TPC-H parity, the shared subplan that executes once, prefix sharing, no
window no sharing, admission deferrals, the tightened device budget, an
injected fault that fails only its own query, a transient retried inside
its query, the bounded queue, queue-full rejection, submit after close,
the async export lane, an export error on its handle, the nearest-rank
percentile, the latency percentiles, and the three thread-hammer
satellites (``warn_once``, its reset, the replica cache).

Each scenario runs through both packages at world 1 and 8 on the same
numpy-seeded tables (``test_torch_serve_common``): served rows, the session's
tallies, the ``serve.*`` counters and the handles' fields must be the
JAX package's.  Windows are deterministic (``held``).
"""
import io
import sys
import threading
import time

import numpy as np
import pytest

from test_torch_serve_common import (TIMEOUT, WORLDS, assert_frames_equal,
                                     assert_same, counters, dtables,
                                     fact_dim_frames, frame, handle_obs, held,
                                     ops, pkgs, run_both, tallies, wait_all)
from test_torch_serve_common import serve_state  # noqa: F401
from test_torch_common import jax_trace_shim  # noqa: F401

pytestmark = pytest.mark.usefixtures("serve_state", "jax_trace_shim")

# the TPC-H mix of tests/test_serve.py (8 distinct shapes)
_MIX = ("q1", "q3", "q4", "q5", "q6", "q10", "q12", "q14")
_SCALE, _SEED, _THRESHOLD = 0.002, 7, 256
# the fault point of the isolation tests, by world: at world 8 the host
# count read of the fact shuffle (tests/test_serve.py's point); at world
# 1 the port's plan reads no counts (its groupby needs no optimistic
# count read, the JAX package's does), so both packages are faulted at
# the executor's stage dispatch instead
_FAULT_POINT = {1: "exec.stage", 8: "compact.read_counts"}


def _tpch_frames():
    from tpch_torch_parity import tpch_data
    return tpch_data(_SCALE, _SEED)


@pytest.mark.parametrize("world", WORLDS)
def test_serve_concurrent_tpch_parity(dctx, world):
    """Eight client threads, one TPC-H query each, one window: every
    served result equals serial planned execution in its own package
    and the JAX package's served result; tallies and counters equal."""
    data = _tpch_frames()

    def scenario(P, ctx):
        P.config.set_broadcast_join_threshold(_THRESHOLD)
        tabs = dtables(P, ctx, data)
        serial = {}
        for name in _MIX:
            qfn = P.queries.QUERIES[name]
            serial[name] = frame(P.plan.run(
                ctx, lambda t, q=qfn: q(ctx, t), tabs))
        P.trace.reset()
        with P.serve.ServeSession(ctx, tables=tabs,
                                  batch_window_ms=20.0) as s:
            handles = {}
            with held(s):
                for name in _MIX:     # one client thread each, in order
                    qfn = P.queries.QUERIES[name]
                    th = threading.Thread(target=lambda n=name, q=qfn:
                                          handles.__setitem__(n, s.submit(
                                              lambda t, q=q: q(ctx, t),
                                              label=n)))
                    th.start()
                    th.join()
            got = {n: frame(h.result(timeout=TIMEOUT))
                   for n, h in handles.items()}
            st = s.stats()
        for n in _MIX:
            assert_frames_equal(got[n], serial[n])
            assert handles[n].latency_ms > 0
        return {"frames": [got[n] for n in _MIX],
                "stats": tallies(st), "counters": counters(P),
                "handles": {n: handle_obs(h) for n, h in handles.items()}}

    j, t = run_both(dctx, world, scenario)
    assert_same(t, j)
    assert t["stats"]["completed"] == len(_MIX)
    assert t["stats"]["subplan_shared"] >= 1


@pytest.mark.parametrize("world", WORLDS)
def test_serve_shared_subplan_executes_once(dctx, world):
    """The same plan twice in one window adds no exchange over one
    serial run; the share lands on the consuming handle."""
    frames_ = fact_dim_frames()

    def scenario(P, ctx):
        o = ops(P)
        tabs = dtables(P, ctx, frames_)
        want = frame(P.plan.run(ctx, o.shuffle_groupby, tabs))
        P.broadcast.clear_replica_cache()
        P.trace.reset()
        P.plan.run(ctx, o.shuffle_groupby, tabs)
        serial_ex = P.metrics.exchange_count(P.trace.counters())
        P.broadcast.clear_replica_cache()
        P.trace.reset()
        with P.serve.ServeSession(ctx, tables=tabs,
                                  batch_window_ms=10.0) as s:
            with held(s):
                h1 = s.submit(o.shuffle_groupby, label="first")
                h2 = s.submit(o.shuffle_groupby, label="second")
            r1, r2 = h1.result(TIMEOUT), h2.result(TIMEOUT)
            st = s.stats()
        ex = P.metrics.exchange_count(P.trace.counters())
        assert ex == serial_ex
        assert st["batches"] == 1 and st["subplan_shared"] >= 1
        assert h1.shared_subplans + h2.shared_subplans
        return {"frames": [r1, r2, want], "exchanges": (serial_ex, ex),
                "stats": tallies(st), "counters": counters(P),
                "h": [handle_obs(h1), handle_obs(h2)]}

    j, t = run_both(dctx, world, scenario)
    assert_same(t, j)


@pytest.mark.parametrize("world", WORLDS)
def test_serve_prefix_shared_across_distinct_queries(dctx, world):
    frames_ = fact_dim_frames()

    def scenario(P, ctx):
        o = ops(P)
        tabs = dtables(P, ctx, frames_)
        want_a = frame(P.plan.run(ctx, o.join_groupby, tabs))
        want_b = frame(P.plan.run(ctx, o.shuffle_groupby, tabs))
        P.trace.reset()
        with P.serve.ServeSession(ctx, tables=tabs,
                                  batch_window_ms=10.0) as s:
            with held(s):
                ha = s.submit(o.join_groupby, label="a")
                hb = s.submit(o.shuffle_groupby, label="b")
            ra, rb = ha.result(TIMEOUT), hb.result(TIMEOUT)
            st = s.stats()
        assert_frames_equal(ra, want_a)
        assert_frames_equal(rb, want_b)
        assert "scan" in ha.shared_subplans + hb.shared_subplans
        return {"frames": [ra, rb], "stats": tallies(st),
                "counters": counters(P),
                "h": [handle_obs(ha), handle_obs(hb)]}

    j, t = run_both(dctx, world, scenario)
    assert_same(t, j)
    assert t["stats"]["subplan_shared"] >= 1


@pytest.mark.parametrize("world", WORLDS)
def test_serve_no_window_no_sharing(dctx, world):
    frames_ = fact_dim_frames()

    def scenario(P, ctx):
        o = ops(P)
        tabs = dtables(P, ctx, frames_)
        with P.serve.ServeSession(ctx, tables=tabs,
                                  batch_window_ms=0.0) as s:
            r1 = s.run(o.shuffle_groupby, timeout=TIMEOUT)
            r2 = s.run(o.shuffle_groupby, timeout=TIMEOUT)
            st = s.stats()
        return {"frames": [r1, r2], "stats": tallies(st),
                "counters": counters(P)}

    j, t = run_both(dctx, world, scenario)
    assert_same(t, j)
    assert t["stats"]["batches"] >= 2 and t["stats"]["subplan_shared"] == 0


@pytest.mark.parametrize("world", WORLDS)
def test_serve_admission_defers_past_budget(dctx, world):
    """The budget pinned to one query's price: the head admits, the
    rest defer to later windows; the same prices and the same
    deferrals in both packages."""
    frames_ = fact_dim_frames()

    def scenario(P, ctx):
        o = ops(P)
        tabs = dtables(P, ctx, frames_)
        want = frame(P.plan.run(ctx, o.shuffle_groupby, tabs))
        price = P.serve.price_query(tabs)
        P.trace.reset()
        with P.serve.ServeSession(ctx, tables=tabs, batch_window_ms=10.0,
                                  admission_budget=price) as s:
            with held(s):
                hs = [s.submit(o.shuffle_groupby, label=f"n{i}")
                      for i in range(4)]
            res = [h.result(TIMEOUT) for h in hs]
            st = s.stats()
        for r in res:
            assert_frames_equal(r, want)
        return {"frames": res, "price": price,
                "priced": [h.priced_bytes for h in hs],
                "stats": tallies(st), "counters": counters(P),
                "h": [handle_obs(h) for h in hs]}

    j, t = run_both(dctx, world, scenario)
    assert_same(t, j)
    assert t["price"] > 0
    assert t["stats"]["deferred"] >= 1 and t["stats"]["batches"] >= 2


@pytest.mark.parametrize("world", WORLDS)
def test_serve_tight_device_budget_stays_within_peak(dctx, world):
    """A 32 KiB device budget steers admission (the live budget is the
    default ceiling) and degrades the fact shuffle to chunked rounds:
    the exchange peak stays within it, nothing fails or exhausts."""
    frames_ = fact_dim_frames()
    budget = 32 << 10

    def scenario(P, ctx):
        o = ops(P)
        tabs = dtables(P, ctx, frames_)
        want = frame(P.plan.run(ctx, o.wide_exchange, tabs))
        assert P.serve.price_query(tabs) > budget
        P.config.set_device_memory_budget(budget)
        P.plan.clear_plan_cache()
        P.trace.reset()
        with P.serve.ServeSession(ctx, tables=tabs,
                                  batch_window_ms=10.0) as s:
            with held(s):
                hs = [s.submit(o.wide_exchange, label=f"t{i}")
                      for i in range(8)]
            res = [h.result(TIMEOUT) for h in hs]
            st = s.stats()
        c = P.trace.counters()
        P.config.set_device_memory_budget(None)
        for r in res:
            assert_frames_equal(r, want)
        assert c.get("shuffle.exchange_bytes_peak", 0) <= budget
        assert c.get("retry.exhausted", 0) == 0
        return {"frames": res, "stats": tallies(st), "counters": counters(P),
                "peak": c.get("shuffle.exchange_bytes_peak", 0),
                "chunked": c.get("shuffle.chunked", 0)}

    j, t = run_both(dctx, world, scenario)
    assert_same(t, j)
    assert t["stats"]["completed"] == 8 and t["stats"]["deferred"] >= 1
    if world > 1:
        assert t["chunked"] >= 1 and t["peak"] > 0


@pytest.mark.parametrize("world", WORLDS)
def test_serve_injected_fault_fails_only_its_query(dctx, world):
    """One permanent fault at the count read: one query fails with it on
    its handle and in its counter slice; peers complete clean."""
    frames_ = fact_dim_frames()

    def scenario(P, ctx):
        o = ops(P)
        tabs = dtables(P, ctx, frames_)
        want = frame(P.plan.run(ctx, o.shuffle_groupby, tabs))
        P.trace.reset()
        fp = P.faults.FaultPlan(seed=3, rules=[P.faults.FaultRule(
            _FAULT_POINT[world], kind="permanent", once=True)])
        with P.faults.active(fp), \
                P.serve.ServeSession(ctx, tables=tabs,
                                     batch_window_ms=10.0) as s:
            with held(s):
                hs = [s.submit(o.shuffle_groupby, label=f"c{i}")
                      for i in range(4)]
            wait_all(hs)
            st = s.stats()
        ok = [h for h in hs if h.error is None]
        for h in ok:
            assert_frames_equal(h.result(1), want)
        return {"frames": [h.result(1) for h in ok], "stats": tallies(st),
                "counters": counters(P),
                "h": [handle_obs(h) for h in hs]}

    j, t = run_both(dctx, world, scenario)
    assert_same(t, j)
    assert t["stats"]["failed"] == 1 and t["stats"]["completed"] == 3
    bad = [h for h in t["h"] if h["error"]]
    assert bad[0]["error"] == "PermanentFault"
    assert bad[0]["counters"]["fault.injected"] == 1


@pytest.mark.parametrize("world", WORLDS)
def test_serve_transient_fault_retried_inside_query(dctx, world):
    frames_ = fact_dim_frames()

    def scenario(P, ctx):
        o = ops(P)
        tabs = dtables(P, ctx, frames_)
        want = frame(P.plan.run(ctx, o.shuffle_groupby, tabs))
        P.trace.reset()
        fp = P.faults.FaultPlan(seed=5, rules=[P.faults.FaultRule(
            _FAULT_POINT[world], kind="transient", once=True)])
        with P.faults.active(fp), \
                P.serve.ServeSession(ctx, tables=tabs,
                                     batch_window_ms=10.0) as s:
            with held(s):
                hs = [s.submit(o.shuffle_groupby, label=f"r{i}")
                      for i in range(2)]
            res = [h.result(TIMEOUT) for h in hs]
            st = s.stats()
        for r in res:
            assert_frames_equal(r, want)
        c = P.trace.counters()
        return {"frames": res, "stats": tallies(st), "counters": counters(P),
                "retries": (c.get("retry.attempts", 0),
                            c.get("retry.exhausted", 0)),
                "h": [handle_obs(h) for h in hs]}

    j, t = run_both(dctx, world, scenario)
    assert_same(t, j)
    assert t["stats"]["failed"] == 0 and t["retries"][1] == 0
    healed = ("retry.attempts" if world > 1 else "recover.stage_retries")
    assert sum(h["counters"][healed] for h in t["h"]) >= 1


def test_query_queue_bounded_backpressure():
    for P in pkgs():
        q = P.serve.QueryQueue(2)
        assert q.put("a") and q.put("b")
        assert len(q) == 2
        assert not q.put("c", block=False)
        assert not q.put("c", timeout=0.05)
        assert q.drain() == ["a", "b"]
        assert len(q) == 0 and q.put("c")
        with pytest.raises(P.CylonError):
            P.serve.QueryQueue(0)


def test_serve_rejects_when_queue_full(dctx):
    frames_ = fact_dim_frames()

    def scenario(P, ctx):
        o = ops(P)
        tabs = dtables(P, ctx, frames_)
        with P.serve.ServeSession(ctx, tables=tabs, batch_window_ms=10.0,
                                  max_queue=1) as s:
            with held(s):
                h1 = s.submit(o.shuffle_groupby, label="kept")
                with pytest.raises(P.CylonError, match="queue full"):
                    s.submit(o.shuffle_groupby, label="shed", block=False)
                mid = tallies(s.stats())
            h1.result(TIMEOUT)
        return {"mid": mid, "counters": counters(P), "status": h1.status}

    j, t = run_both(dctx, 8, scenario)
    assert_same(t, j)
    assert t["mid"]["rejected"] == 1 and t["status"] == "done"


def test_serve_submit_after_close_raises(dctx):
    frames_ = fact_dim_frames()

    def scenario(P, ctx):
        s = P.serve.ServeSession(ctx, tables=dtables(P, ctx, frames_))
        s.close()
        with pytest.raises(P.CylonError, match="closed"):
            s.submit(ops(P).shuffle_groupby)
        s.close()
        return {"stats": tallies(s.stats())}

    j, t = run_both(dctx, 8, scenario)
    assert_same(t, j)


@pytest.mark.parametrize("world", WORLDS)
def test_serve_async_export_overlaps(dctx, world):
    frames_ = fact_dim_frames()

    def scenario(P, ctx):
        o = ops(P)
        tabs = dtables(P, ctx, frames_)
        want = frame(P.plan.run(ctx, o.shuffle_groupby, tabs))
        P.trace.reset()
        with P.serve.ServeSession(ctx, tables=tabs,
                                  batch_window_ms=10.0) as s:
            with held(s):
                hs = [s.submit(o.shuffle_groupby,
                               export=lambda r: r.to_table().to_pandas(),
                               label=f"e{i}") for i in range(3)]
            res = [h.result(TIMEOUT) for h in hs]
            st = s.stats()
        for r in res:
            assert type(r).__name__ == "DataFrame"
            assert_frames_equal(r, want)
        return {"frames": res, "stats": tallies(st),
                "counters": counters(P)}

    j, t = run_both(dctx, world, scenario)
    assert_same(t, j)
    assert t["stats"]["exports_async"] == 3


def test_serve_export_error_lands_on_handle(dctx):
    frames_ = fact_dim_frames()

    def bad_export(r):
        raise ValueError("export boom")

    def scenario(P, ctx):
        tabs = dtables(P, ctx, frames_)
        with P.serve.ServeSession(ctx, tables=tabs,
                                  batch_window_ms=0.0) as s:
            h = s.submit(ops(P).shuffle_groupby, export=bad_export)
            with pytest.raises(ValueError, match="export boom"):
                h.result(timeout=TIMEOUT)
            st = s.stats()
        return {"stats": tallies(st), "counters": counters(P),
                "h": handle_obs(h)}

    j, t = run_both(dctx, 8, scenario)
    assert_same(t, j)
    assert t["stats"]["failed"] == 1


def test_percentile_nearest_rank():
    J, T = pkgs()
    rng = np.random.default_rng(3)
    cases = [sorted(float(i) for i in range(1, 101)), [], [7.0],
             sorted(rng.normal(size=37).tolist())]
    for xs in cases:
        for q in (0, 1, 50, 90, 99, 99.9, 100):
            assert T.serve.percentile(xs, q) == J.serve.percentile(xs, q)
    assert T.serve.percentile(cases[0], 50) == 50.0
    assert T.serve.percentile([], 50) is None


def test_serve_stats_latency_percentiles(dctx):
    frames_ = fact_dim_frames()

    def scenario(P, ctx):
        tabs = dtables(P, ctx, frames_)
        with P.serve.ServeSession(ctx, tables=tabs,
                                  batch_window_ms=10.0) as s:
            for _ in range(4):
                s.run(ops(P).shuffle_groupby, timeout=TIMEOUT)
            st = s.stats()
        assert st["p50_ms"] > 0 and st["p99_ms"] >= st["p50_ms"]
        assert st["p999_ms"] >= st["p99_ms"]
        assert st["batch_window_ms"] == 10.0
        return {"stats": tallies(st)}

    j, t = run_both(dctx, 8, scenario)
    assert_same(t, j)


def test_warn_once_concurrent_exactly_once():
    """N racing threads, one key: exactly one emits."""
    _, T = pkgs()
    glog = T.glog
    for round_ in range(25):
        key = ("race-key", round_)
        sink = io.StringIO()
        glog.set_sink(sink)
        barrier = threading.Barrier(8)
        fired = []

        def hammer():
            barrier.wait()
            fired.append(glog.warn_once(key, "raced warning %d", round_))

        threads = [threading.Thread(target=hammer) for _ in range(8)]
        try:
            for th in threads:
                th.start()
            for th in threads:
                th.join()
        finally:
            glog.set_sink(sys.stderr)
        assert sum(fired) == 1
        assert sink.getvalue().count("raced warning") == 1


def test_warn_once_reset_race_does_not_crash():
    _, T = pkgs()
    glog = T.glog
    stop = threading.Event()
    errors = []

    def warner(tid):
        i = 0
        try:
            while not stop.is_set():
                glog.warn_once(("reset-race", tid, i % 7), "x")
                i += 1
        except Exception as e:  # pragma: no cover - the failure signal
            errors.append(e)

    def resetter():
        try:
            while not stop.is_set():
                glog.reset_warn_once()
        except Exception as e:  # pragma: no cover
            errors.append(e)

    glog.set_sink(io.StringIO())
    threads = [threading.Thread(target=warner, args=(t,))
               for t in range(3)] + [threading.Thread(target=resetter)]
    try:
        for th in threads:
            th.start()
        time.sleep(0.3)
        stop.set()
        for th in threads:
            th.join()
    finally:
        glog.set_sink(sys.stderr)
    assert not errors, errors


def test_replica_cache_concurrent_hammer():
    """Concurrent replicate_table + clear_replica_cache: no exception,
    every replica the full table."""
    import pandas as pd

    import cylon_tpu_torch as pt
    _, T = pkgs()
    ctx = pt.CylonContext(device="cpu", world=8)
    dim = T.DTable.from_pandas(ctx, pd.DataFrame({
        "k": np.arange(60, dtype=np.int32),
        "w": np.arange(60, dtype=np.float32)}))
    T.broadcast.clear_replica_cache()
    want = T.broadcast.replicate_table(dim).num_rows
    stop = threading.Event()
    errors = []

    def replicator():
        try:
            while not stop.is_set():
                assert T.broadcast.replicate_table(dim).num_rows == want
        except Exception as e:  # pragma: no cover - the failure signal
            errors.append(e)

    def clearer():
        try:
            while not stop.is_set():
                T.broadcast.clear_replica_cache()
        except Exception as e:  # pragma: no cover
            errors.append(e)

    threads = [threading.Thread(target=replicator) for _ in range(3)] \
        + [threading.Thread(target=clearer)]
    for th in threads:
        th.start()
    time.sleep(0.4)
    stop.set()
    for th in threads:
        th.join()
    T.broadcast.clear_replica_cache()
    assert not errors, errors


def test_session_loads_pyarrow_before_its_threads():
    """A fresh process: constructing a session imports pyarrow on the
    caller's thread, so no export worker is the first to load it (a
    process whose first Arrow export ran on the worker while the
    dispatcher ran torch ops crashed in later exports)."""
    import subprocess
    code = (
        "import sys\n"
        "import cylon_tpu_torch as pt\n"
        "from cylon_tpu_torch.serve import ServeSession\n"
        "before = 'pyarrow' in sys.modules\n"
        "s = ServeSession(pt.CylonContext(device='cpu', world=2))\n"
        "after = 'pyarrow' in sys.modules\n"
        "s.close()\n"
        "print(before, after)\n")
    from pathlib import Path
    root = Path(__file__).resolve().parent.parent
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["False", "True"]
