"""Materialized views (``cylon_tpu_torch/serve/matview.py``) against the
JAX package's, from ``tests/test_matview.py``: the cross-window hit with
fewer exchanges, the store switched off, O(delta) folds of sum / count /
mean / min / max over int, dictionary-string, nullable and composite keys
and of the HLL / quantile sketches, invalidation of a non-foldable view,
the non-foldable tail, LRU eviction under a host budget, a zero budget,
the ``matview.fold`` fault, pipelined dispatch, the cross-window subplan
carry and the router's live-view affinity; plus ``tests/test_spill.py``'s
admission price of a spilled table.

Each scenario runs through both packages at world 1 and 8 on the same
numpy-seeded frames: the served and folded rows (a folded view's
aggregation state, finalized), the view outcome of every handle (hit /
fold / recompute), the session's view tallies and the ``serve.*`` /
``matview.*`` counters must be the JAX package's, and the folded rows
must equal a cold run of the same plan over base + deltas in the same
package.  At world 1 both packages' groupby takes its local path, which
captures no mergeable state, so there the second window recomputes in
both instead of folding.
"""
import threading

import numpy as np
import pandas as pd
import pytest

from test_torch_serve_common import (TIMEOUT, WORLDS, assert_frames_equal,
                                     assert_same, base_df, counters, frame,
                                     held, ops, pkgs, run_both, tallies)
from test_torch_serve_common import serve_state  # noqa: F401
from test_torch_common import jax_trace_shim  # noqa: F401

pytestmark = pytest.mark.usefixtures("serve_state", "jax_trace_shim")


def _cold(P, ctx, df, qfn):
    """The package's own cold answer over a fresh table."""
    return frame(qfn({"fact": P.DTable.from_pandas(ctx, df)}))


def _view_obs(P, st, handles):
    return {"views": [h.view for h in handles],
            "tallies": {k: v for k, v in tallies(st).items()
                        if k.startswith("view")},
            "counters": counters(P)}


def _fold_roundtrip(P, ctx, base, delta, qfn, label):
    """Window 1 executes, ingest appends, window 2 must fold."""
    dt = P.DTable.from_pandas(ctx, base)
    with P.serve.ServeSession(ctx, tables={"fact": dt},
                              batch_window_ms=0.0) as s:
        h1 = s.submit(qfn, label=f"{label}-w1")
        h1.result(TIMEOUT)
        s.ingest("fact", P.DTable.from_pandas(ctx, delta)).result(TIMEOUT)
        h2 = s.submit(qfn, label=f"{label}-w2")
        out = frame(h2.result(TIMEOUT))
        st = s.stats()
    both = pd.concat([base, delta], ignore_index=True)
    cold = _cold(P, ctx, both, qfn)
    return out, cold, _view_obs(P, st, [h1, h2])


def _folded(world):
    """The view outcome of window 2 after an append (see the module
    docstring for world 1)."""
    return "fold" if world > 1 else None


def _fold_case(dctx, world, base, delta, qname, rtol=None):
    def scenario(P, ctx):
        q = getattr(ops(P), qname)
        out, cold, obs = _fold_roundtrip(P, ctx, base, delta, q, qname)
        assert_frames_equal(out, cold, rtol=rtol)
        return dict(obs, frames=[out])
    j, t = run_both(dctx, world, scenario)
    assert_same(t, j)
    return t


# ---------------------------------------------------------------------------
# cross-window hits
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", WORLDS)
def test_cross_window_hit_parity_and_fewer_exchanges(dctx, world):
    base = base_df()

    def scenario(P, ctx):
        q = ops(P).q_agg
        dt = P.DTable.from_pandas(ctx, base)
        with P.serve.ServeSession(ctx, tables={"fact": dt},
                                  batch_window_ms=0.0) as s:
            h1 = s.submit(q, label="w1")
            r1 = h1.result(TIMEOUT)
            h2 = s.submit(q, label="w2")
            r2 = h2.result(TIMEOUT)
            st = s.stats()
        ex = [P.metrics.exchange_count(h.counters) for h in (h1, h2)]
        return dict(_view_obs(P, st, [h1, h2]), frames=[r1, r2],
                    exchanges=ex)

    j, t = run_both(dctx, world, scenario)
    assert_same(t, j)
    assert t["views"] == [None, "hit"]
    assert t["exchanges"][1] < t["exchanges"][0] or world == 1
    assert t["tallies"]["view_hits"] == 1
    assert t["counters"]["matview.retained"] >= 1


@pytest.mark.parametrize("world", WORLDS)
def test_view_disabled_never_serves_from_cache(dctx, world):
    base = base_df()

    def scenario(P, ctx):
        q = ops(P).q_sum
        dt = P.DTable.from_pandas(ctx, base)
        with P.serve.ServeSession(ctx, tables={"fact": dt},
                                  batch_window_ms=0.0, views=False) as s:
            h1 = s.submit(q, label="w1")
            r1 = h1.result(TIMEOUT)
            h2 = s.submit(q, label="w2")
            r2 = h2.result(TIMEOUT)
            st = s.stats()
        return dict(_view_obs(P, st, [h1, h2]), frames=[r1, r2])

    j, t = run_both(dctx, world, scenario)
    assert_same(t, j)
    assert t["views"] == [None, None] and t["tallies"]["view_hits"] == 0


# ---------------------------------------------------------------------------
# incremental maintenance: delta folds
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", WORLDS)
def test_fold_parity_sum_count_mean_min_max_int_keys(dctx, world):
    base, delta = base_df(seed=1), base_df(n=150, seed=2)
    t = _fold_case(dctx, world, base, delta, "q_agg")
    assert t["views"] == [None, _folded(world)]
    if world > 1:
        assert t["counters"]["matview.folds"] == 1
        assert t["counters"]["matview.fold_rows"] >= len(delta)


@pytest.mark.parametrize("world", WORLDS)
def test_fold_parity_dict_string_keys(dctx, world):
    cities = np.array(["auckland", "bern", "cairo", "dakar", "erbil"])

    def mk(n, seed):
        r = np.random.default_rng(seed)
        return pd.DataFrame({"k": cities[r.integers(0, 5, n)],
                             "v": r.normal(size=n),
                             "w": r.integers(0, 100, n).astype(np.int64)})
    t = _fold_case(dctx, world, mk(800, 4), mk(120, 5), "q_agg")
    assert t["views"] == [None, _folded(world)]


@pytest.mark.parametrize("world", WORLDS)
def test_fold_parity_null_values(dctx, world):
    def mk(n, seed):
        r = np.random.default_rng(seed)
        v = r.normal(size=n)
        return pd.DataFrame({
            "k": r.integers(0, 8, n).astype(np.int64),
            "v": pd.array(np.where(r.random(n) < 0.25, None, v),
                          dtype="Float64"),
            "w": r.integers(0, 100, n).astype(np.int64)})
    t = _fold_case(dctx, world, mk(600, 6), mk(90, 7), "q_agg")
    assert t["views"] == [None, _folded(world)]


@pytest.mark.parametrize("world", WORLDS)
def test_fold_parity_composite_keys(dctx, world):
    def mk(n, seed):
        r = np.random.default_rng(seed)
        return pd.DataFrame({
            "k": r.integers(0, 6, n).astype(np.int64),
            "k2": r.integers(0, 3, n).astype(np.int64),
            "v": r.normal(size=n),
            "w": r.integers(0, 100, n).astype(np.int64)})
    t = _fold_case(dctx, world, mk(900, 8), mk(140, 9), "q_composite")
    assert t["views"] == [None, _folded(world)]


@pytest.mark.parametrize("world", WORLDS)
def test_fold_sketch_within_advertised_bounds(dctx, world):
    """The folded HLL / quantile lanes equal the JAX package's fold, and
    land inside the sketches' advertised bounds of base + delta."""
    def mk(n, seed):
        r = np.random.default_rng(seed)
        return pd.DataFrame({"g": r.integers(0, 4, n).astype(np.int64),
                             "ids": r.integers(0, 2500, n).astype(np.int64),
                             "x": (r.standard_normal(n) * 40.0)})
    base, delta = mk(6000, 10), mk(1200, 11)

    def scenario(P, ctx):
        out, _cold_, obs = _fold_roundtrip(P, ctx, base, delta,
                                           ops(P).q_sketch, "sketch")
        return dict(obs, frames=[out])

    j, t = run_both(dctx, world, scenario)
    assert_same(t, j)
    assert t["views"] == [None, "fold"]   # the sketch captures at world 1
    _, T = pkgs()
    both = pd.concat([base, delta], ignore_index=True)
    exact = both.groupby("g")["ids"].nunique()
    for _, r in t["frames"][0].iterrows():
        e = exact[int(r["g"])]
        assert abs(int(r["approx_distinct_ids"]) - e) / e \
            <= T.sketch.HLL_ERROR_BOUND
        vals = np.sort(both[both["g"] == int(r["g"])]["x"].to_numpy())
        rank = np.searchsorted(vals, float(r["p50_x"])) / len(vals)
        assert abs(rank - 0.5) <= T.sketch.QUANTILE_RANK_ERROR_BOUND


# ---------------------------------------------------------------------------
# invalidation and fallback: never stale
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", WORLDS)
def test_invalidation_on_base_change_no_stale_rows(dctx, world):
    base, delta = base_df(n=400, seed=12), base_df(n=60, seed=13)

    def scenario(P, ctx):
        q = ops(P).q_sort
        dt = P.DTable.from_pandas(ctx, base)
        with P.serve.ServeSession(ctx, tables={"fact": dt},
                                  batch_window_ms=0.0) as s:
            h1 = s.submit(q, label="w1")
            h1.result(TIMEOUT)
            h2 = s.submit(q, label="w2")
            h2.result(TIMEOUT)
            s.ingest("fact", P.DTable.from_pandas(ctx, delta)) \
                .result(TIMEOUT)
            h3 = s.submit(q, label="w3")
            r3 = frame(h3.result(TIMEOUT))
            st = s.stats()
        return dict(_view_obs(P, st, [h1, h2, h3]), frames=[r3])

    j, t = run_both(dctx, world, scenario)
    assert_same(t, j)
    assert t["views"] == [None, "hit", None]
    assert len(t["frames"][0]) == len(base) + len(delta)
    assert t["tallies"]["view_invalidations"] >= 1


@pytest.mark.parametrize("world", WORLDS)
def test_non_foldable_join_tail_falls_back(dctx, world):
    base, delta = base_df(n=500, seed=14), base_df(n=80, seed=15)
    t = _fold_case(dctx, world, base, delta, "q_nonfold")
    assert t["views"] == [None, None]
    assert t["counters"].get("matview.folds", 0) == 0


# ---------------------------------------------------------------------------
# retention economics: budget + LRU
# ---------------------------------------------------------------------------

def test_lru_eviction_under_pinned_host_budget(dctx):
    """Two views that cannot coexist under the host budget: retaining
    the second evicts the first, whose next query recomputes."""
    base = base_df(n=2000, groups=512, seed=16)

    def scenario(P, ctx):
        o = ops(P)
        cold_a = _cold(P, ctx, base, o.q_agg)
        cold_b = _cold(P, ctx, base, o.q_mean)
        pool = P.pool.get_pool()
        dt = P.DTable.from_pandas(ctx, base)
        with P.serve.ServeSession(ctx, tables={"fact": dt},
                                  batch_window_ms=0.0) as s:
            s.submit(o.q_agg, label="probe-a").result(TIMEOUT)
            s.submit(o.q_mean, label="probe-b").result(TIMEOUT)
            both_bytes = pool.host_bytes()
        P.trace.reset()
        P.config.set_host_memory_budget(both_bytes - 1)
        dt = P.DTable.from_pandas(ctx, base)
        with P.serve.ServeSession(ctx, tables={"fact": dt},
                                  batch_window_ms=0.0) as s:
            hs = [s.submit(o.q_agg, label="a1"),
                  s.submit(o.q_mean, label="b1")]
            for h in hs:
                h.result(TIMEOUT)
            hs.append(s.submit(o.q_agg, label="a2"))
            r_a2 = hs[-1].result(TIMEOUT)
            hs.append(s.submit(o.q_mean, label="b2"))
            r_b2 = hs[-1].result(TIMEOUT)
            st = s.stats()
        P.config.set_host_memory_budget(None)
        assert_frames_equal(r_a2, cold_a)
        assert_frames_equal(r_b2, cold_b)
        return dict(_view_obs(P, st, hs), frames=[r_a2, r_b2],
                    both_bytes=both_bytes)

    j, t = run_both(dctx, 8, scenario)
    assert_same(t, j)
    assert t["both_bytes"] > 0
    assert t["views"][2] is None
    assert t["counters"]["matview.lost"] >= 1


def test_zero_budget_declines_retention(dctx):
    base = base_df(n=300, seed=17)

    def scenario(P, ctx):
        q = ops(P).q_sum
        P.config.set_host_memory_budget(1)
        dt = P.DTable.from_pandas(ctx, base)
        with P.serve.ServeSession(ctx, tables={"fact": dt},
                                  batch_window_ms=0.0) as s:
            h1 = s.submit(q, label="w1")
            r1 = h1.result(TIMEOUT)
            h2 = s.submit(q, label="w2")
            r2 = h2.result(TIMEOUT)
            st = s.stats()
        P.config.set_host_memory_budget(None)
        return dict(_view_obs(P, st, [h1, h2]), frames=[r1, r2])

    j, t = run_both(dctx, 8, scenario)
    assert_same(t, j)
    assert t["views"] == [None, None]


# ---------------------------------------------------------------------------
# chaos: the fold fault degrades, never lies
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", WORLDS)
def test_chaos_fold_fault_degrades_to_recompute(dctx, world):
    base, delta = base_df(n=600, seed=18), base_df(n=90, seed=19)
    delta2 = base_df(n=70, seed=20)

    def scenario(P, ctx):
        q = ops(P).q_agg
        dt = P.DTable.from_pandas(ctx, base)
        plan = P.faults.FaultPlan(seed=0, rules=[P.faults.FaultRule(
            "matview.fold", kind="transient", once=True)])
        with P.serve.ServeSession(ctx, tables={"fact": dt},
                                  batch_window_ms=0.0) as s:
            h1 = s.submit(q, label="w1")
            h1.result(TIMEOUT)
            s.ingest("fact", P.DTable.from_pandas(ctx, delta)) \
                .result(TIMEOUT)
            with P.faults.active(plan):
                h2 = s.submit(q, label="w2-chaos")
                r2 = frame(h2.result(TIMEOUT))
            s.ingest("fact", P.DTable.from_pandas(ctx, delta2)) \
                .result(TIMEOUT)
            h3 = s.submit(q, label="w3")
            r3 = frame(h3.result(TIMEOUT))
            st = s.stats()
        assert_frames_equal(r2, _cold(P, ctx, pd.concat(
            [base, delta], ignore_index=True), q))
        assert_frames_equal(r3, _cold(P, ctx, pd.concat(
            [base, delta, delta2], ignore_index=True), q))
        return dict(_view_obs(P, st, [h1, h2, h3]), frames=[r2, r3])

    j, t = run_both(dctx, world, scenario)
    assert_same(t, j)
    assert t["views"] == [None, None, _folded(world)]
    assert t["counters"].get("matview.fold_failures", 0) == (world > 1)


# ---------------------------------------------------------------------------
# pipelined dispatch
# ---------------------------------------------------------------------------

def test_pipelined_dispatch_parity_with_serial(dctx):
    """View hits pinned on the dispatcher and served on the export
    pipeline answer as the serial dispatch path does."""
    base = base_df(n=900, seed=21)

    def scenario(P, ctx):
        q = ops(P).q_agg
        want = _cold(P, ctx, base, q)
        out = {}
        for pipelined in (False, True):
            dt = P.DTable.from_pandas(ctx, base)
            with P.serve.ServeSession(ctx, tables={"fact": dt},
                                      batch_window_ms=10.0,
                                      pipelined=pipelined) as s:
                s.submit(q, label="warm").result(TIMEOUT)
                hs = []
                with held(s):
                    for i in range(6):
                        th = threading.Thread(target=lambda i=i: hs.append(
                            s.submit(q, label=f"p{i}")))
                        th.start()
                        th.join()
                res = [frame(h.result(TIMEOUT)) for h in hs]
                st = s.stats()
            for r in res:
                assert_frames_equal(r, want)
            out[pipelined] = dict(_view_obs(P, st, hs), frames=res)
        return {"frames": out[False]["frames"] + out[True]["frames"],
                "serial": {k: v for k, v in out[False].items()
                           if k != "frames"},
                "pipelined": {k: v for k, v in out[True].items()
                              if k != "frames"}}

    j, t = run_both(dctx, 8, scenario)
    assert_same(t, j)
    assert t["serial"]["tallies"]["view_hits"] >= 1
    assert t["pipelined"]["tallies"]["view_hits"] >= 1


# ---------------------------------------------------------------------------
# cross-window subplan carry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", WORLDS)
def test_cross_window_subplan_carry(dctx, world):
    """A subplan shared inside window 1 is carried through the pool: a
    different query with the same prefix in window 2 rebuilds it."""
    base = base_df(n=1000, seed=22)

    def scenario(P, ctx):
        o = ops(P)
        dt = P.DTable.from_pandas(ctx, base)
        with P.serve.ServeSession(ctx, tables={"fact": dt},
                                  batch_window_ms=10.0) as s:
            with held(s):
                first = [s.submit(o.qa, label="qa"),
                         s.submit(o.qb, label="qb")]
            for h in first:
                h.result(TIMEOUT)
            h3 = s.submit(o.qc, label="carry")
            r3 = h3.result(TIMEOUT)
            st = s.stats()
        assert_frames_equal(r3, _cold(P, ctx, base, o.qc))
        return dict(_view_obs(P, st, first + [h3]), frames=[r3],
                    shared=st["subplan_shared"])

    j, t = run_both(dctx, world, scenario)
    assert_same(t, j)
    assert t["shared"] >= 1
    assert t["tallies"]["view_subplan_hits"] >= 1


# ---------------------------------------------------------------------------
# fleet routing: live-view affinity
# ---------------------------------------------------------------------------

def test_router_prefers_replica_holding_live_view(dctx):
    """The replica whose store holds a live view wins placement.  The
    JAX package's replicas are two halves of the 8 devices; the port's
    two slot ranges of one device (``CylonContext(first_slot=4)``)."""
    import cylon_tpu as ct
    import cylon_tpu_torch as pt
    base = base_df(n=400, seed=23)
    devs = dctx.devices
    ctxs = {"cylon_tpu": (
        ct.CylonContext({"backend": "dist", "devices": devs[:4]}),
        ct.CylonContext({"backend": "dist", "devices": devs[4:]})),
        "cylon_tpu_torch": (
        pt.CylonContext(device="cpu", world=4),
        pt.CylonContext(device="cpu", world=4, first_slot=4))}
    out = []
    for P in pkgs():
        ca, cb = ctxs[P.name]
        q = ops(P).q_sum
        sa = P.serve.ServeSession(
            ca, tables={"fact": P.DTable.from_pandas(ca, base)},
            batch_window_ms=0.0, name="replica-a")
        sb = P.serve.ServeSession(
            cb, tables={"fact": P.DTable.from_pandas(cb, base)},
            batch_window_ms=0.0, name="replica-b")
        try:
            with P.router.FleetRouter([sa, sb]) as router:
                seeded = sb.submit(q, label="seed").result(TIMEOUT)
                holds = (sb.holds_view(q), sa.holds_view(q))
                h = router.submit(q, label="routed")
                routed = h.result(TIMEOUT)
                out.append({"frames": [seeded, routed], "holds": holds,
                            "view": h.view,
                            "counters": counters(P, ("serve.router",))})
        finally:
            sa.close()
            sb.close()
    assert_same(out[1], out[0])
    assert out[1]["holds"] == (True, False) and out[1]["view"] == "hit"
    assert out[1]["counters"]["serve.router_view_affinity_hits"] >= 1


def test_admission_prices_spilled_table_by_morsel(dctx):
    """``tests/test_spill.py``'s case: a spilled table prices as one
    admission-sized morsel, without faulting in."""
    def scenario(P, ctx):
        df = pd.DataFrame({"v": np.arange(30000.0)})
        dt = P.DTable.from_pandas(ctx, df)
        resident = P.admission.price_table(dt)
        dt.spill()
        P.trace.reset()
        P.config.set_device_memory_budget(100_000)
        spilled = P.admission.price_table(dt)
        P.config.set_device_memory_budget(None)
        return {"prices": (resident, spilled), "spilled": dt.is_spilled,
                "faultins": P.trace.counters().get("spill.faultins", 0)}

    j, t = run_both(dctx, 8, scenario)
    assert t == j
    resident, spilled = t["prices"]
    assert t["spilled"] and t["faultins"] == 0
    assert 0 < spilled <= 100_000 and spilled < resident
