"""The JAX bench's out-of-core stage on the CPU, for both packages: TPC-H
Q1, Q18 and Q11 at SF 0.002, world 8, through each package's planner under
the bench's budget rule, ``max(192 KiB, priced // 48)`` with ``priced`` the
morsel price of ``lineitem`` (``morsel.table_priced_bytes``), each query
from a cleared plan cache and spill pool.  Each result equals the JAX
package's under the same budget and the port's own ample-budget run, the
planner fires the same rules, and the port streams morsels
(``spill.morsels`` > 0) wherever the JAX package does."""
import pytest

from cylon_tpu_torch import config as tconfig
from cylon_tpu_torch import plan as tplan
from cylon_tpu_torch import trace as ttrace
from cylon_tpu_torch.spill import morsel as tmorsel
from cylon_tpu_torch.spill import pool as tpool
from cylon_tpu_torch.tpch import queries as tqueries

from test_torch_common import assert_rows_close, float_rtols, port_rows
from tpch_torch_parity import PLANNED_F32, _sweep, check_tables, planned

NAMES = ("q1", "q18", "q11")
COUNTERS = ("spill.spills", "spill.morsels", "spill.faultins",
            "spill.morsel_groupbys", "spill.morsel_joins",
            "spill.stage_out_bytes", "spill.stage_in_bytes")


def _ooc_budget(morsel, li) -> int:
    priced = morsel.table_priced_bytes(li.nparts, li.cap,
                                       morsel._spilled_rbytes(li))
    return max(192 << 10, priced // 48)


def _run(base, kw, jctx, jt, tctx, tt):
    from cylon_tpu import config as jconfig
    from cylon_tpu import plan as jplan
    from cylon_tpu import trace as jtrace
    from cylon_tpu.spill import morsel as jmorsel
    from cylon_tpu.spill import pool as jpool
    from cylon_tpu.tpch import queries as jqueries
    top = lambda t: tqueries.QUERIES[base](tctx, t, **kw)  # noqa: E731
    jop = lambda t: jqueries.QUERIES[base](jctx, t, **kw)  # noqa: E731
    tplan.clear_plan_cache()
    ample, _ = planned(tplan, tctx, top, tt)
    out = {"ample": ample}
    for name, cfg, plan, tr, pool, morsel, op, ctx, tables in (
            ("got", tconfig, tplan, ttrace, tpool, tmorsel, top, tctx, tt),
            ("want", jconfig, jplan, jtrace, jpool, jmorsel, jop, jctx, jt)):
        budget = _ooc_budget(morsel, tables["lineitem"])
        plan.clear_plan_cache()
        pool.clear_pool()
        tr.enable_counters()
        tr.reset()
        prev = cfg.set_device_memory_budget(budget)
        try:
            res, stats = planned(plan, ctx, op, tables)
            c = dict(tr.counters())
        finally:
            cfg.set_device_memory_budget(prev)
            plan.clear_plan_cache()
            pool.clear_pool()
            tr.disable_counters()   # a later test module starts with them off
        out[name] = res
        out[name + "_stats"] = stats
        out[name + "_counters"] = {k: c.get(k, 0) for k in COUNTERS}
        out[name + "_budget"] = budget
    # the query's scans may have been spilled: fault them back in for the
    # next query, as a reader of the tables would
    for dt in list(tt.values()) + list(jt.values()):
        dt.ensure_device()
    return out


@pytest.fixture(scope="module")
def results():
    return _sweep(NAMES, _run, worlds=(8,))


@pytest.mark.parametrize("q", NAMES)
def test_out_of_core_query_matches_jax(results, q):
    r = results[(q, 8)]
    assert r["got_budget"] == r["want_budget"]
    check_tables(q, r["got"], r["want"])
    assert r["got_stats"]["fires"] == r["want_stats"]["fires"]


@pytest.mark.parametrize("q", NAMES)
def test_out_of_core_query_equals_ample_run(results, q):
    """Keys, counts and integers exactly, float64 within 1e-9; a float32
    column's mean within 1e-6 where the ample plan's psum combine sums in
    float64 lanes and the morsel fold in float32 partials (the planned
    against eager rule of ``tpch_torch_parity.PLANNED_F32``)."""
    r = results[(q, 8)]
    got = r["got"]
    rtols = float_rtols(got, f64=1e-9)
    for j, c in enumerate(got.columns):
        if c.name in PLANNED_F32.get(q, ()):
            rtols[j] = 1e-6
    assert_rows_close(port_rows(got, ordered=True),
                      port_rows(r["ample"], ordered=True), rtols)


@pytest.mark.parametrize("q", NAMES)
def test_out_of_core_query_streams_where_jax_does(results, q):
    r = results[(q, 8)]
    got, want = r["got_counters"], r["want_counters"]
    if want["spill.morsels"]:
        assert got["spill.morsels"] > 0, (got, want)
    for k in ("spill.spills", "spill.morsels", "spill.morsel_groupbys",
              "spill.morsel_joins"):
        assert got[k] == want[k], (k, got, want)


def test_some_query_spills(results):
    assert any(results[(q, 8)]["got_counters"]["spill.morsels"] > 0
               for q in NAMES)
