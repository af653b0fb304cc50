"""The port's logical planner (``cylon_tpu_torch/plan/``) against the JAX
package's, at world 1 and on 8 shards, on the same numpy inputs: lazy
capture, ``LogicalTable`` metadata, each rewrite rule, the compiled-plan
cache and the optimizer switch (the shapes of ``tests/test_query_planner.py``).

Every planned result equals the JAX planner's (the same rows on the same
shards, keys, counts and integers exact, float64 within 1e-12 and float32
within 1e-6 relative) and the port's eager result, and both planners
record the same rule fires and planned exchange row bytes.  Wire bytes
(``shuffle.bytes_sent + broadcast.bytes_sent``) and the plan counters are
read from the port's ``trace`` counters."""
import inspect

import numpy as np
import pyarrow as pa
import pytest

from cylon_tpu import plan as jplan
from cylon_tpu.parallel import broadcast as jbroadcast
from cylon_tpu.parallel import dist_ops as jdist_ops
from cylon_tpu.parallel import streaming as jstreaming

import cylon_tpu_torch as pt
from cylon_tpu_torch import config as tconfig
from cylon_tpu_torch import plan as tplan
from cylon_tpu_torch import trace
from cylon_tpu_torch.analysis import plan_check
from cylon_tpu_torch.parallel import broadcast as tbroadcast
from cylon_tpu_torch.parallel import dist_ops as tdist_ops
from cylon_tpu_torch.parallel import streaming as tstreaming

from test_torch_common import (assert_rows_close, float_rtols,  # noqa: F401
                               jax_trace_shim, port_rows)
from test_torch_dist_groupby import _same_close
from test_torch_dist_join import _both_dtables
from tpch_torch_parity import planned

WORLDS = (1, 8)


@pytest.fixture(autouse=True)
def _planner_isolation():
    """Fresh plan caches and counters around every test."""
    tplan.clear_plan_cache()
    jplan.clear_plan_cache()
    trace.enable_counters()
    trace.reset()
    yield
    trace.disable_counters()
    trace.reset()
    tplan.clear_plan_cache()
    jplan.clear_plan_cache()


def _wide_dim():
    """A wide fact table (``k`` int32 in [0, 700), six float32 payloads)
    and a 700-row dimension keyed 0..699."""
    rng = np.random.default_rng(11)
    n = 6000
    wide = {"k": rng.integers(0, 700, n).astype(np.int32)}
    for j in range(6):
        wide[f"v{j}"] = rng.random(n).astype(np.float32)
    dim = {"k": np.arange(700, dtype=np.int32),
           "w": np.arange(700, dtype=np.float32),
           "x": np.ones(700, dtype=np.float32),
           "y": np.zeros(700, dtype=np.float32)}
    return pa.table(wide), pa.table(dim)


@pytest.fixture(scope="module")
def tables(ctx, dctx):
    """{world: ({name: JAX DTable}, {name: port DTable})}."""
    wide, dim = _wide_dim()
    out = {}
    for world in WORLDS:
        jw, tw = _both_dtables(ctx, dctx, world, wide)
        jd, td = _both_dtables(ctx, dctx, world, dim)
        out[world] = ({"wide": jw, "dim": jd}, {"wide": tw, "dim": td})
    return out


def _both(tabs, world, op, names=("wide",), single=False):
    """``op(dist_ops, tables)`` through both planners: (port result, JAX
    result, port stats, JAX stats).  ``single`` hands the first table
    itself instead of a dict."""
    jt, tt = tabs[world]
    jin = jt[names[0]] if single else {n: jt[n] for n in names}
    tin = tt[names[0]] if single else {n: tt[n] for n in names}
    jctx, tctx = _ctx_of(jin), _ctx_of(tin)
    want, jstats = planned(jplan, jctx, lambda t: op(jdist_ops, t), jin)
    got, tstats = planned(tplan, tctx, lambda t: op(tdist_ops, t), tin)
    return got, want, tstats, jstats


def _ctx_of(tables):
    t = next(iter(tables.values())) if isinstance(tables, dict) else tables
    return t.ctx


def _check_parity(got, want, tstats, jstats):
    _same_close(got, want)
    assert tstats["fires"] == jstats["fires"]
    assert tstats["pre_exchange_row_bytes"] == jstats["pre_exchange_row_bytes"]
    assert tstats["post_exchange_row_bytes"] == \
        jstats["post_exchange_row_bytes"]


def _run_pair(ctx, op, tables):
    """The port's (eager result, planned result, eager bytes, planned
    bytes, eager counters, planned counters); both legs start from a
    cleared replica cache (a hit skips the gather and its bytes)."""
    out = {}
    for leg in ("eager", "opt"):
        tbroadcast.clear_replica_cache()
        trace.reset()
        res = op(tables) if leg == "eager" else ctx.optimize(op, tables)
        c = trace.counters()
        out[leg] = (res, c.get("shuffle.bytes_sent", 0)
                    + c.get("broadcast.bytes_sent", 0), c)
    return (out["eager"][0], out["opt"][0], out["eager"][1], out["opt"][1],
            out["eager"][2], out["opt"][2])


def _canon(t):
    """All rows of a Table / DTable, sorted with floats rounded for the
    sort key only (an order-of-summation wobble cannot permute them)."""
    rows = port_rows(t)
    if rows and isinstance(rows[0], list):
        rows = [r for shard in rows for r in shard]
    return sorted(rows, key=lambda r: repr(tuple(
        round(x, 4) if isinstance(x, float) else x for x in r)))


def _same_rows(a, b):
    """The same rows (the planner may place them on other shards), floats
    within 1e-9 (float64) and 1e-6 (float32) relative."""
    assert [c.name for c in a.columns] == [c.name for c in b.columns]
    assert_rows_close(_canon(a), _canon(b), float_rtols(a, f64=1e-9))


def _fires(stats, rule):
    return [f for f in stats["fires"] if rule in f]


# stable module-level predicates: plan-cache keys include callable
# identities (either package's tensors compare the same way)
def _pred_v0(env):
    return env["v0"] > 0.5


def _pred_rt_w(env):
    return env["rt-w"] < 100.0


def _pred_k_half(env):
    return env["k"] < 350


# ---------------------------------------------------------------------------
# capture
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", WORLDS)
def test_capture_is_lazy(tables, jax_trace_shim, world):
    seen = {}

    def op(d, t):
        out = d.shuffle_table(t["wide"], ["k"])
        seen.setdefault("types", []).append(type(out).__name__)
        seen.setdefault("sent", []).append(
            trace.counters().get("shuffle.exchanges", 0))
        return out

    got, want, ts, js = _both(tables, world, op)
    assert seen["types"] == ["LogicalTable", "LogicalTable"]
    assert seen["sent"][1] == 0, "capture must not run the exchange"
    assert trace.counters().get("shuffle.exchanges", 0) == (world > 1)
    _check_parity(got, want, ts, js)
    assert got.num_rows == tables[world][1]["wide"].num_rows


@pytest.mark.parametrize("world", WORLDS)
def test_logical_table_metadata(tables, jax_trace_shim, world):
    def op(d, lt):
        src = tables[world][0 if d is jdist_ops else 1]["wide"]
        assert lt.column_names == src.column_names
        assert lt.num_columns == src.num_columns
        assert lt.column("k").dtype.type == src.column("k").dtype.type
        assert lt.column_index("v1") == src.column_index("v1")
        # num_rows on an ingest scan reads cached counts: no execution
        assert lt.num_rows == src.num_rows
        rn = lt.rename(["kk"] + lt.column_names[1:])
        assert rn.column_names[0] == "kk"
        return d.dist_project(rn, ["kk", "v0"])

    got, want, ts, js = _both(tables, world, op, single=True)
    assert got.column_names == ["kk", "v0"]
    assert ts["cache_misses"] == 1 and ts["cache_hits"] == 0
    _check_parity(got, want, ts, js)


def test_logical_table_proxies_the_host_cache(tables):
    """A scan's ``_host_cols_cache`` lives on the source DTable, so a
    second capture of the same table reads what the first stored."""
    tt = tables[8][1]["dim"]
    b = tplan.Builder(tt.ctx)
    lt = b.wrap_tables({"dim": tt})["dim"]
    assert lt._host_cols_cache is None
    lt._host_cols_cache = {"k": np.arange(3)}
    again = tplan.Builder(tt.ctx).wrap_tables({"dim": tt})["dim"]
    assert again._host_cols_cache["k"].tolist() == [0, 1, 2]
    del tt._host_cols_cache


# ---------------------------------------------------------------------------
# rewrite rules: parity with the JAX planner, wire bytes, recorded fires
# ---------------------------------------------------------------------------

def _sort_select(d, t):
    return d.dist_select(d.dist_sort(t["wide"], "k"), _pred_v0)


@pytest.mark.parametrize("world", WORLDS)
def test_filter_pushdown_below_sort(tables, jax_trace_shim, world):
    got, want, ts, js = _both(tables, world, _sort_select)
    _check_parity(got, want, ts, js)
    assert _fires(ts, "filter-pushdown: select sunk below dist_sort")
    tt = tables[world][1]
    eager, opt, eb, ob, _, _ = _run_pair(
        tt["wide"].ctx, lambda t: _sort_select(tdist_ops, t), tt)
    _same_rows(opt, eager)
    if world > 1:
        assert ob < eb, "the pushed select must shrink the sort exchange"


def _pred_env_surface(env):
    # reads through the whole env protocol (in, len, iteration, keys /
    # items / values), not just env[k]
    assert "kk" in env and "nope" not in env
    assert len(env) == 7
    assert sorted(env.keys()) == sorted(iter(env))
    vals = dict(env.items())
    assert len(env.values()) == len(vals)
    return vals["v0"] > 0.5


def _renamed_sort_select(d, t):
    rn = t["wide"].rename(["kk"] + t["wide"].column_names[1:])
    return d.dist_select(d.dist_sort(rn, "kk"), _pred_env_surface)


@pytest.mark.parametrize("world", WORLDS)
def test_pushdown_env_adapter_full_read_surface(tables, jax_trace_shim,
                                                world):
    """Pushed below a rename, the predicate reads through the mapped env
    adapter, which serves every spelling the recording env does."""
    got, want, ts, js = _both(tables, world, _renamed_sort_select)
    _check_parity(got, want, ts, js)
    assert _fires(ts, "select sunk below rename")
    tt = tables[world][1]
    eager, opt, eb, ob, _, _ = _run_pair(
        tt["wide"].ctx, lambda t: _renamed_sort_select(tdist_ops, t), tt)
    _same_rows(opt, eager)
    if world > 1:
        assert ob < eb


@pytest.mark.parametrize("world", WORLDS)
def test_filter_not_pushed_into_nullable_join_side(tables, jax_trace_shim,
                                                   world):
    """After a LEFT join the select sees null-filled right columns and
    must veto those rows: pushing it below the join would change the
    answer, so the rule refuses."""
    from cylon_tpu import JoinConfig as JJoinConfig

    jt, tt = tables[world]
    jin = {"wide": jt["wide"],
           "half": jdist_ops.dist_select(jt["dim"], _pred_k_half)}
    tin = {"wide": tt["wide"],
           "half": tdist_ops.dist_select(tt["dim"], _pred_k_half)}

    def op(d, t, cfg):
        j = d.dist_join(t["wide"], t["half"], cfg.LeftJoin("k", "k"))
        return d.dist_select(j, _pred_rt_w)

    want, js = planned(jplan, jt["wide"].ctx,
                       lambda t: op(jdist_ops, t, JJoinConfig), jin)
    got, ts = planned(tplan, tt["wide"].ctx,
                      lambda t: op(tdist_ops, t, pt.JoinConfig), tin)
    _check_parity(got, want, ts, js)
    assert not _fires(ts, "left join")
    eager = op(tdist_ops, tin, pt.JoinConfig)
    assert got.num_rows < tt["wide"].num_rows  # unmatched rows vetoed
    _same_rows(got, eager)


def _join_project(d, t):
    cfg = (pt.JoinConfig if d is tdist_ops else _jcfg()).InnerJoin("k", "k")
    j = d.dist_join(t["wide"], t["dim"], cfg)
    return d.dist_project(j, ["lt-v0", "rt-w"])


def _jcfg():
    from cylon_tpu import JoinConfig
    return JoinConfig


@pytest.mark.parametrize("world", WORLDS)
def test_projection_pruning_reduces_exchange_bytes(tables, jax_trace_shim,
                                                   world):
    got, want, ts, js = _both(tables, world, _join_project,
                              names=("wide", "dim"))
    _check_parity(got, want, ts, js)
    assert _fires(ts, "projection-pruning")
    assert ts["post_exchange_row_bytes"] < ts["pre_exchange_row_bytes"]
    tt = tables[world][1]
    eager, opt, eb, ob, _, _ = _run_pair(
        tt["wide"].ctx, lambda t: _join_project(tdist_ops, t), tt)
    _same_rows(opt, eager)
    if world > 1:
        assert 0 < ob < eb, "narrowed inputs must shrink the exchange"


def _join_only(d, t):
    cfg = (pt.JoinConfig if d is tdist_ops else _jcfg()).InnerJoin("k", "k")
    return d.dist_join(t["wide"], t["dim"], cfg)


@pytest.mark.parametrize("world", WORLDS)
def test_join_strategy_planned_from_ingest_counts(tables, jax_trace_shim,
                                                  world):
    got, want, ts, js = _both(tables, world, _join_only,
                              names=("wide", "dim"))
    _check_parity(got, want, ts, js)
    assert got.num_rows == tables[world][1]["wide"].num_rows  # FK join
    if world > 1:
        assert trace.counters().get("join.broadcast", 0) >= 1
        assert [f for f in _fires(ts, "join-strategy") if "broadcast" in f]
    else:
        assert not _fires(ts, "join-strategy")


def _twice_shuffled_union(d, t):
    a = d.shuffle_table(t["wide"], ["k"])
    b = d.shuffle_table(t["wide"], ["k"])
    return d.dist_union(a, b)


@pytest.mark.parametrize("world", WORLDS)
def test_common_subplan_executes_once(tables, jax_trace_shim, world):
    got, want, ts, js = _both(tables, world, _twice_shuffled_union)
    _check_parity(got, want, ts, js)
    assert _fires(ts, "common-subplan")
    tt = tables[world][1]
    eager, opt, eb, ob, ec, oc = _run_pair(
        tt["wide"].ctx, lambda t: _twice_shuffled_union(tdist_ops, t), tt)
    _same_rows(opt, eager)
    if world > 1:
        assert ob < eb, "the duplicate shuffle must be exchanged once"
        assert oc["shuffle.exchanges"] == ec["shuffle.exchanges"] - 1


# ---------------------------------------------------------------------------
# compiled-plan cache
# ---------------------------------------------------------------------------

def _q_repeat(t):
    sel = tdist_ops.dist_select(t, _pred_v0)
    return tdist_ops.dist_groupby(sel, ["k"], [("v1", "sum")])


@pytest.mark.parametrize("world", WORLDS)
def test_plan_cache_hit_skips_retrace(tables, world):
    wide = tables[world][1]["wide"]
    tplan.ir._reads_cache.clear()
    first = wide.ctx.optimize(_q_repeat, wide)
    c1 = trace.counters()
    assert c1.get("plan.cache_miss", 0) == 1
    assert c1.get("plan.cache_hit", 0) == 0
    assert c1.get("plan.reads_trace", 0) == 1
    assert tplan.plan_cache_len() == 1
    trace.reset()
    second = wide.ctx.optimize(_q_repeat, wide)
    c2 = trace.counters()
    # a repeated query hits the compiled plan and re-runs no predicate
    # discovery and no rewrite
    assert c2.get("plan.cache_hit", 0) == 1
    assert c2.get("plan.cache_miss", 0) == 0
    assert c2.get("plan.reads_trace", 0) == 0
    assert c2.get("compile.plan_build_us", 0) == 0
    assert c2.get("optimizer.rule_fires", 0) \
        == c1.get("optimizer.rule_fires", 0), "fires replay on hits"
    _same_rows(second, first)


@pytest.mark.parametrize("knob", ["threshold", "budget"])
def test_plan_cache_keyed_on_config_fingerprint(tables, knob):
    tt = tables[8][1]
    op = lambda t: _join_only(tdist_ops, t)  # noqa: E731
    tt["wide"].ctx.optimize(op, tt)
    if knob == "threshold":
        prev = tconfig.set_broadcast_join_threshold(3)
        restore = tconfig.set_broadcast_join_threshold
    else:
        prev = tconfig.set_device_memory_budget(1 << 30)
        restore = tconfig.set_device_memory_budget
    try:
        trace.reset()
        tt["wide"].ctx.optimize(op, tt)
        # a changed planning knob re-plans, never replays a stale plan
        assert trace.counters().get("plan.cache_miss", 0) == 1
    finally:
        restore(prev)
    trace.reset()
    tt["wide"].ctx.optimize(op, tt)
    assert trace.counters().get("plan.cache_hit", 0) == 1


def _q_cap_a(t):
    return tdist_ops.dist_groupby(t, ["k"], [("v0", "sum")])


def _q_cap_b(t):
    return tdist_ops.dist_groupby(t, ["k"], [("v1", "max")])


def _q_cap_c(t):
    return tdist_ops.dist_groupby(t, ["k"], [("v2", "min")])


def test_plan_cache_lru_cap_and_evictions(tables):
    """Distinct plans past the capacity evict the least recently used
    entry (a hit refreshes recency), counted as ``plan.cache_evictions``."""
    wide = tables[8][1]["wide"]
    ctx = wide.ctx
    prev = tconfig.set_plan_cache_capacity(2)
    try:
        ctx.optimize(_q_cap_a, wide)
        ctx.optimize(_q_cap_b, wide)
        assert tplan.plan_cache_len() == 2
        trace.reset()
        ctx.optimize(_q_cap_a, wide)    # refresh A's recency
        assert trace.counters().get("plan.cache_hit", 0) == 1
        trace.reset()
        ctx.optimize(_q_cap_c, wide)    # evicts B (LRU), not A
        c = trace.counters()
        assert c.get("plan.cache_evictions", 0) == 1
        assert tplan.plan_cache_len() == 2
        trace.reset()
        ctx.optimize(_q_cap_a, wide)    # A survived the eviction
        assert trace.counters().get("plan.cache_hit", 0) == 1
        trace.reset()
        ctx.optimize(_q_cap_b, wide)    # B was the victim: re-plans
        c = trace.counters()
        assert c.get("plan.cache_miss", 0) == 1
        assert c.get("plan.cache_evictions", 0) == 1  # evicts C now
    finally:
        tconfig.set_plan_cache_capacity(prev)


# ---------------------------------------------------------------------------
# the escape hatch
# ---------------------------------------------------------------------------

def test_optimizer_disabled_runs_eager(tables):
    wide = tables[8][1]["wide"]
    prev = tconfig.set_optimizer_enabled(False)
    try:
        out = wide.ctx.optimize(_q_repeat, wide)
        c = trace.counters()
        assert c.get("plan.cache_miss", 0) == 0
        assert c.get("plan.cache_hit", 0) == 0
        assert tplan.plan_cache_len() == 0
        assert c.get("groupby.pushdown", 0) == 0
    finally:
        tconfig.set_optimizer_enabled(prev)
    on = wide.ctx.optimize(_q_repeat, wide)
    assert trace.counters().get("groupby.pushdown", 0) == 1
    assert_rows_close(sorted(sum(port_rows(on), [])),
                      sorted(sum(port_rows(out), [])), [0.0, 1e-6])


def test_optimizer_env_escape_hatch(tables, monkeypatch):
    wide = tables[8][1]["wide"]
    prev = tconfig.set_optimizer_enabled(None)  # env-resolved
    try:
        monkeypatch.setenv("CYLON_OPTIMIZER", "0")
        assert not tconfig.optimizer_enabled()
        wide.ctx.optimize(_q_repeat, wide)
        assert tplan.plan_cache_len() == 0
        monkeypatch.setenv("CYLON_OPTIMIZER", "1")
        assert tconfig.optimizer_enabled()
        wide.ctx.optimize(_q_repeat, wide)
        assert tplan.plan_cache_len() == 1
    finally:
        tconfig.set_optimizer_enabled(prev)


# ---------------------------------------------------------------------------
# the capture surface: names, signatures, lowering, the recorder
# ---------------------------------------------------------------------------

# instrumented entry points outside CAPTURED_OPS: run eagerly under a
# capture
_EAGER_UNDER_CAPTURE = {"dist_groupby_fused": (tdist_ops, jdist_ops),
                        "dist_multiway_join": (tdist_ops, jdist_ops),
                        "replicate_table": (tbroadcast, jbroadcast)}


def _entry(name):
    if name in _EAGER_UNDER_CAPTURE:
        return _EAGER_UNDER_CAPTURE[name]
    if name == "dist_join_streaming":
        return tstreaming, jstreaming
    return tdist_ops, jdist_ops


def test_captured_surface_matches_reference():
    assert set(tplan.ir.CAPTURED_OPS) == set(jplan.ir.CAPTURED_OPS)
    for name, spec in tplan.ir.CAPTURED_OPS.items():
        jspec = jplan.ir.CAPTURED_OPS[name]
        assert spec.arg_names == jspec.arg_names, name
        assert spec.defaults == jspec.defaults, name
        assert spec.materializes == jspec.materializes, name
    assert set(tplan.executor.LOWERING) == set(jplan.executor.LOWERING)
    assert set(tplan.ir.CAPTURED_OPS) <= set(tplan.executor.LOWERING)
    # the groupby-strategy rule reads the psum slot cap: equal caps give
    # the same planned mode in both packages
    assert tdist_ops._PSUM_SLOT_CAP == jdist_ops._PSUM_SLOT_CAP == 4096


@pytest.mark.parametrize("name", sorted(set(tplan.ir.CAPTURED_OPS)
                                        | set(_EAGER_UNDER_CAPTURE)))
def test_entry_point_signature_matches_reference(name):
    """``_bind`` binds arguments by position to the reference's parameter
    names, so every instrumented port entry point takes the reference's
    parameters in the reference's order, and is instrumented."""
    tmod, jmod = _entry(name)
    tfn, jfn = getattr(tmod, name), getattr(jmod, name)
    assert list(inspect.signature(tfn).parameters) == \
        list(inspect.signature(jfn).parameters)
    assert tfn.__wrapped__ is not None  # functools.wraps of instrument
    if name in tplan.ir.CAPTURED_OPS:
        params = list(inspect.signature(tfn).parameters)
        spec = tplan.ir.CAPTURED_OPS[name]
        assert params[:len(spec.arg_names)] == list(spec.arg_names)


def test_eager_op_under_capture_runs_on_concrete_inputs(tables):
    """An instrumented op outside the captured surface (here
    ``replicate_table``) runs eagerly on materialized inputs."""
    wide = tables[8][1]["wide"]
    seen = {}

    def op(t):
        p = tdist_ops.dist_project(t, ["k", "v0"])
        rep = tbroadcast.replicate_table(p, cache=False)
        seen["type"] = type(rep).__name__
        return rep

    out = wide.ctx.optimize(op, wide)
    assert seen["type"] == "DTable"
    assert out.num_rows == wide.num_rows * 8  # ALL: every shard counts all
    assert trace.counters().get("join.broadcast_gather", 0) == 1


def test_recorder_attaches_rule_fires_to_lowered_ops(tables):
    tt = tables[8][1]
    with plan_check.recording() as nodes:
        tt["wide"].ctx.optimize(lambda t: _join_project(tdist_ops, t), tt)
    ops = [n.op for n in nodes]
    assert "dist_join" in ops and "dist_project" in ops
    notes = [n.info["optimizer"] for n in nodes if "optimizer" in n.info]
    assert any("projection-pruning" in x for x in notes)
    assert any("join-strategy" in x for x in notes)
    assert plan_check.capture_index() is None  # the recording closed


# ---------------------------------------------------------------------------
# reads discovery and fold analysis
# ---------------------------------------------------------------------------

def _pred_two(env):
    return (env["v0"] > 0.5) & (env["k"] < 10)


def _pred_data_dependent(env):
    # which column it reads depends on a value: discovery cannot tell
    return env["v0"] > float(env["v1"][0])


def _pred_params(env, v):
    return env["v2"] > v


def test_referenced_columns_on_meta_tensors(tables):
    import torch
    schema = tplan.ir.schema_of_dtable(tables[1][1]["wide"])
    tplan.ir._reads_cache.clear()
    assert tplan.ir.referenced_columns(_pred_two, schema) == ("k", "v0")
    assert tplan.ir.referenced_columns(_pred_data_dependent, schema) is None
    assert tplan.ir.referenced_columns(
        _pred_params, schema, (torch.tensor(0.5),)) == ("v2",)
    trace.reset()
    assert tplan.ir.referenced_columns(_pred_two, schema) == ("k", "v0")
    assert trace.counters().get("plan.reads_trace", 0) == 0  # memoized


def _agg_over_join(d, t):
    j = d.dist_join(t["wide"], t["dim"],
                    (pt.JoinConfig if d is tdist_ops else _jcfg())
                    .InnerJoin("k", "k"))
    return d.dist_groupby(j, ["lt-k"], [("lt-v0", "sum")])


def _agg_over_union(d, t):
    return d.dist_groupby(d.dist_union(t["wide"], t["wide"]), ["k"],
                          [("v0", "sum")])


@pytest.mark.parametrize("op,foldable", [(_agg_over_join, True),
                                         (_agg_over_union, False)])
def test_fold_analysis_matches_reference(tables, jax_trace_shim, op,
                                         foldable):
    results = []
    for pkg, d, tabs in ((tplan, tdist_ops, tables[8][1]),
                         (jplan, jdist_ops, tables[8][0])):
        ctx = tabs["wide"].ctx
        with pkg.executor.collect_roots() as roots:
            planned(pkg, ctx, lambda t: op(d, t), tabs)
        bases, fold, scans = pkg.ir.fold_analysis(roots[0])
        results.append((fold, sorted(scans.values()), len(bases)))
    assert results[0] == results[1]
    assert results[0][0] is foldable
