"""Shared harness of the TPC-H query parity tests (a plain module, not a
test file): the JAX package's queries and the port's run on the same
``generate(0.002, seed=7)`` tables at world 1 and 8, both packages with
the broadcast threshold at 256 rows.  131,072 × 0.002 ≈ 262, so at this
scale nation, region and supplier broadcast while customer, part and
orders shuffle, as at SF 10 under the default threshold.

Every query result is compared with the JAX package's at the same world:
the same columns and types, the same rows in the same order (every query
ends in a sort), keys, counts and integers exactly, floats within
``float_rtols``.  One column is compared at float32 precision although
it is stored as float64: Q9's ``sum_profit`` sums per-row amounts
``l_extendedprice·(1 − l_discount) − ps_supplycost·l_quantity`` computed
in float32, and XLA on the CPU contracts that expression into a fused
multiply-add (one rounding fewer than the separate IEEE operations the
port, numpy and pandas perform), so a third of the rows differ from the
port's by one float32 ulp before the float64 sum
(``test_q9_amount_is_separately_rounded`` pins the port's side).
"""
from __future__ import annotations

import pytest

import cylon_tpu_torch as pt
from cylon_tpu_torch import config as tconfig
from cylon_tpu_torch.parallel import DTable as TDTable
from cylon_tpu_torch.parallel import broadcast as tbroadcast
from cylon_tpu_torch.parallel import dist_ops as tdist_ops
from cylon_tpu_torch.tpch import queries as tqueries

from test_torch_common import (assert_rows_close, float_rtols, jax_rows,
                               port_rows, schema)

SCALE = 0.002
SEED = 7
THRESHOLD = 256
WORLDS = (1, 8)
# the parameters test_tpch.py runs the JAX queries with at this scale
KWARGS = {"q18": {"quantity": 120.0}, "q11": {"fraction_per_sf": 0.000002}}
# variants: a test name → (query, extra keyword arguments); Q9's
# streaming branch stages lineitem through dist_join_streaming in 3 slices
VARIANTS = {"q9_streaming": ("q9", {"streaming_chunks": 3})}
# columns whose values are float32 arithmetic stored as float64 (see the
# module docstring): compared at float32 precision
F32_COMPUTED = {"q9": {"sum_profit"}, "q9_streaming": {"sum_profit"}}
NONEMPTY = ("q11", "q22")  # test_tpch.py asserts these cohorts exist


def _q17_kwargs(data):
    """The spec's (Brand#23, MED BOX) selects no part at this scale:
    test_tpch.py's rule, the most frequent (brand, container) pair."""
    p = data["part"]
    counts = p.groupby(["p_brand", "p_container"], observed=True).size()
    brand, container = counts.idxmax()
    return {"brand": str(brand), "container": str(container)}


def _clear_jax_state():
    from cylon_tpu.parallel import broadcast, dist_ops, shuffle
    shuffle._block_hints.clear()
    dist_ops._capacity_hints.clear()
    dist_ops._group_cap_hints.clear()
    dist_ops._select_cap_hints.clear()
    dist_ops._select_cache.clear()
    broadcast.clear_replica_cache()


def run_both(names):
    """``{(query, world): (port Table, JAX Table, port decisions)}`` for
    the queries ``names`` (a query or a ``VARIANTS`` name); JAX runs under the trace shim of
    ``test_torch_common.jax_trace_shim`` for the length of the call."""
    import jax
    from jax._src import core as jcore

    import cylon_tpu as ct
    from cylon_tpu import config as jconfig
    from cylon_tpu.parallel import DTable as JDTable
    from cylon_tpu.tpch import generate
    from cylon_tpu.tpch import queries as jqueries

    data = generate(SCALE, seed=SEED)
    kwargs = dict(KWARGS, q17=_q17_kwargs(data))
    cpus = jax.devices("cpu")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        if not hasattr(jax.core, "trace_state_clean"):
            mp.setattr(jax.core, "trace_state_clean",
                       jcore.trace_state_clean, raising=False)
        jprev = jconfig.set_broadcast_join_threshold(THRESHOLD)
        tprev = tconfig.set_broadcast_join_threshold(THRESHOLD)
        try:
            _clear_jax_state()
            tbroadcast.clear_replica_cache()
            for world in WORLDS:
                jctx = ct.CylonContext({"backend": "tpu",
                                        "devices": cpus[:world]})
                jt = {n: JDTable.from_pandas(jctx, df)
                      for n, df in data.items()}
                tctx = pt.CylonContext(device="cpu", world=world)
                tt = {n: TDTable.from_table(tctx,
                                            pt.Table.from_pandas(tctx, df))
                      for n, df in data.items()}
                for q in names:
                    base, extra = VARIANTS.get(q, (q, {}))
                    kw = dict(kwargs.get(base, {}), **extra)
                    want = jqueries.QUERIES[base](jctx, jt, **kw)
                    tdist_ops.decisions.clear()
                    got = tqueries.QUERIES[base](tctx, tt, **kw)
                    out[(q, world)] = (got, want,
                                       dict(tdist_ops.decisions))
        finally:
            jconfig.set_broadcast_join_threshold(jprev)
            tconfig.set_broadcast_join_threshold(tprev)
            _clear_jax_state()
            tbroadcast.clear_replica_cache()
    return out


def check_query(results, q: str, world: int) -> None:
    got, want, _ = results[(q, world)]
    assert schema(got) == schema(want)
    rtols = float_rtols(got)
    for j, c in enumerate(got.columns):
        if c.name in F32_COMPUTED.get(q, ()):
            rtols[j] = 1e-6
    rows = port_rows(got, ordered=True)
    assert_rows_close(rows, jax_rows(want, ordered=True), rtols)
    if q in NONEMPTY:
        assert len(rows) > 0, f"{q}: empty result at the test scale"


def decisions(results, q: str, world: int) -> dict:
    return results[(q, world)][2]


def queries_param(names):
    return pytest.mark.parametrize(
        "q,world", [(q, w) for q in names for w in WORLDS])

