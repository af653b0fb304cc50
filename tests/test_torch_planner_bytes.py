"""What the port's planner saves on the wire: all 22 TPC-H queries eager and
through ``ctx.optimize`` on ``generate_device(0.002, seed=7)`` at world 8
under the default broadcast threshold (the port alone, no JAX, so the
sweep runs in one worker), mirroring the floors of
``tests/test_query_planner.py``:

  * every planned query returns the eager rows in order (keys, counts and
    integers exact, float64 within 1e-9 and float32 within 1e-6 relative)
    and moves no more bytes (``shuffle.bytes_sent +
    broadcast.bytes_sent``) and runs no more exchanges than eager;
  * at least 6 queries move strictly fewer bytes;
  * each groupby target (q1, q3, q4, q13, q16) moves fewer bytes;
  * at least 3 of the star-join targets (q2, q5, q7, q8, q9, q10) lower
    through ``dist_multiway_join``."""
import pytest

import cylon_tpu_torch as pt
from cylon_tpu_torch import plan as tplan
from cylon_tpu_torch import trace
from cylon_tpu_torch.parallel import broadcast
from cylon_tpu_torch.tpch import QUERIES, generate_device

from test_torch_common import assert_rows_close, float_rtols, port_rows
from tpch_torch_parity import KWARGS, PLANNED_F32


def _exchanges(c: dict) -> int:
    return (c.get("shuffle.exchanges", 0) + c.get("join.broadcast_gather", 0)
            + c.get("groupby.broadcast_gather", 0)
            + c.get("groupby.psum_combine", 0))


@pytest.fixture(scope="module")
def sweep():
    """{query: (eager result, planned result, eager counters, planned
    counters)}, each leg from a cleared replica cache."""
    ctx = pt.CylonContext(device="cpu", world=8)
    tables = generate_device(ctx, 0.002, seed=7)
    tplan.clear_plan_cache()
    trace.enable_counters()
    out = {}
    try:
        for q, fn in QUERIES.items():
            kw = KWARGS.get(q, {})
            op = (lambda t, fn=fn, kw=kw: fn(ctx, t, **kw))
            legs = []
            for planned in (False, True):
                broadcast.clear_replica_cache()
                trace.reset()
                res = ctx.optimize(op, tables) if planned else op(tables)
                legs.append((res, trace.counters()))
            out[q] = (legs[0][0], legs[1][0], legs[0][1], legs[1][1])
    finally:
        trace.disable_counters()
        trace.reset()
        tplan.clear_plan_cache()
        broadcast.clear_replica_cache()
    return out


def _bytes(c: dict) -> int:
    return c.get("shuffle.bytes_sent", 0) + c.get("broadcast.bytes_sent", 0)


@pytest.mark.parametrize("q", sorted(QUERIES))
def test_planned_query_moves_no_more(sweep, q):
    eager, opt, ce, co = sweep[q]
    rtols = float_rtols(opt, f64=1e-9)
    for j, c in enumerate(opt.columns):
        if c.name in PLANNED_F32.get(q, ()):
            rtols[j] = 1e-6
    assert_rows_close(port_rows(opt, ordered=True),
                      port_rows(eager, ordered=True), rtols)
    assert co.get("plan.cache_miss", 0) >= 1
    assert _bytes(co) <= _bytes(ce), \
        f"{q}: the planner added {_bytes(co) - _bytes(ce)} wire bytes"
    assert _exchanges(co) <= _exchanges(ce), \
        f"{q}: the planner added whole exchanges"


def test_byte_savings_floor(sweep):
    reduced = sorted(q for q, (_, _, ce, co) in sweep.items()
                     if _bytes(co) < _bytes(ce))
    assert len(reduced) >= 6, \
        f"only {reduced} moved fewer bytes under the planner"


def test_groupby_byte_savings_floor(sweep):
    targets = ("q1", "q3", "q4", "q13", "q16")
    not_reduced = [q for q in targets
                   if not _bytes(sweep[q][3]) < _bytes(sweep[q][2])]
    assert not not_reduced, not_reduced


def test_multiway_fusion_floor(sweep):
    targets = ("q2", "q5", "q7", "q8", "q9", "q10")
    fused = [q for q in targets if sweep[q][3].get("join.multiway", 0) >= 1]
    assert len(fused) >= 3, f"only {fused} lowered through " \
        "dist_multiway_join"
