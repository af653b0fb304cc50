"""The two-level exchange under ``CYLON_MESH_SHAPE=2x4`` at world 8: the
port's ``hierarchical`` and ``hierarchical-combine`` lowerings against the
JAX package's (the cases of ``tests/test_hierarchy.py``), on the same
numpy inputs.  Per shard the same rows in the same order, counts and
``outcap``; the same strategy, slow-axis and pre-combine counters and
annotations; the pre-combine moves exactly one partial per group per
non-resident slow block; and a world the configured shape cannot span
falls back to the flat lowerings."""
import numpy as np
import pyarrow as pa
import pytest
import torch

import jax
import jax.numpy as jnp

from cylon_tpu import trace as jtrace
from cylon_tpu.parallel import dist_ops as jdist_ops
from cylon_tpu.parallel import shuffle as jshuffle

from cylon_tpu_torch import config as tconfig
from cylon_tpu_torch import topology as ttopo
from cylon_tpu_torch import trace as ttrace
from cylon_tpu_torch import CylonContext
from cylon_tpu_torch.parallel import cost as tcost
from cylon_tpu_torch.parallel import dist_ops as tdist_ops
from cylon_tpu_torch.parallel import shuffle as tshuffle

from test_torch_common import jax_trace_shim  # noqa: F401
from test_torch_dist_groupby import _same_close
from test_torch_dist_join import _both_dtables
from test_torch_redistribution import (KEYS, assert_same_run,
                                       mixed_key_table, run_both,
                                       _shuffle_ops)


@pytest.fixture(autouse=True)
def _mesh_2x4(monkeypatch):
    monkeypatch.setenv("CYLON_MESH_SHAPE", "2x4")
    tshuffle.clear_chunk_state()
    yield
    tconfig.set_exchange_strategy(None)
    tconfig.set_device_memory_budget(None)
    tshuffle.clear_chunk_state()


@pytest.mark.parametrize("flavour", list(KEYS))
def test_hierarchical_shuffle_matches_jax(ctx, dctx, jax_trace_shim,
                                          flavour):
    jt, tt = _both_dtables(ctx, dctx, 8, mixed_key_table())
    op_j, op_t = _shuffle_ops(KEYS[flavour])
    got, want = run_both(jt, tt, op_j, op_t, strategy="hierarchical")
    assert_same_run(got, want)
    c = got[1]
    assert c["shuffle.strategy.hierarchical"] == 1
    assert 0 < c["shuffle.bytes_sent_slow"]
    assert 0 < c["shuffle.rows_sent_slow"] <= c["shuffle.rows_sent"]


AGGS = [("v", "sum"), ("v", "count"), ("v", "max"), ("w", "min"),
        ("w", "sum")]


@pytest.mark.parametrize("flavour", list(KEYS))
def test_hier_combine_fused_groupby_matches_jax(ctx, dctx, jax_trace_shim,
                                                flavour):
    jt, tt = _both_dtables(ctx, dctx, 8, mixed_key_table(seed=13))
    keys = KEYS[flavour]

    def op(dops):
        return lambda t: dops.dist_groupby_fused(t, keys, AGGS,
                                                 mode="pre-aggregate")

    got, want = run_both(jt, tt, op(jdist_ops), op(tdist_ops),
                         strategy="hierarchical-combine")
    assert_same_run(got, want, same=_same_close)
    c = got[1]
    assert c["shuffle.strategy.hierarchical_combine"] == 1
    assert c["groupby.axis_precombine"] == 1
    assert c["shuffle.fold_combined"] == 3      # stage 1 + S = 2 rounds


def _skewed(Pn=8, cap=2048):
    """Every row on shard d targets (d+4)%8: all traffic crosses the
    slow axis of the (2, 4) split, one peer per sender."""
    pid = np.repeat((np.arange(Pn) + 4) % Pn, cap).astype(np.int32)
    vals = np.arange(Pn * cap, dtype=np.int32)
    return pid, vals


def _port_leaves(strategy, pid, vals):
    tconfig.set_exchange_strategy(strategy)
    ttrace.enable_counters()
    ttrace.reset()
    try:
        ctx = CylonContext(device="cpu", world=8)
        outs, cnts, oc = tshuffle.shuffle_leaves(
            ctx, torch.from_numpy(pid), [torch.from_numpy(vals)])
        c = ttrace.counters()
    finally:
        tconfig.set_exchange_strategy(None)
        ttrace.disable_counters()
        ttrace.reset()
    cn = cnts.numpy()
    buf = outs[0].numpy()
    return [buf[d * oc:d * oc + int(cn[d])].tolist() for d in range(8)], \
        oc, c


def _jax_leaves(dctx, strategy, pid, vals):
    from cylon_tpu import config as jconfig
    jconfig.set_exchange_strategy(strategy)
    jtrace.enable_counters()
    jtrace.reset()
    try:
        sh = dctx.sharding()
        outs, cnts, oc = jshuffle.shuffle_leaves(
            dctx, jax.device_put(jnp.asarray(pid), sh),
            (jax.device_put(jnp.asarray(vals), sh),))
        c = jtrace.counters()
    finally:
        jconfig.set_exchange_strategy(None)
        jtrace.disable_counters()
        jtrace.reset()
        jshuffle.clear_chunk_state()
    cn = np.asarray(jax.device_get(cnts))
    buf = np.asarray(jax.device_get(outs[0]))
    return [buf[d * oc:d * oc + int(cn[d])].tolist() for d in range(8)], \
        oc, c


SLOW = ("shuffle.bytes_sent_slow", "shuffle.rows_sent_slow",
        "shuffle.rows_sent", "shuffle.bytes_sent")


def test_skewed_raw_exchange_matches_jax(dctx, jax_trace_shim):
    """The one-peer cross-slow pattern through ``shuffle_leaves``: the
    hierarchy's rows equal JAX's in order and single-shot's as sets,
    and it sends fewer bytes across the slow axis than the flat
    exchange's slow share."""
    pid, vals = _skewed()
    runs = {}
    for strategy in ("single-shot", "hierarchical"):
        got = _port_leaves(strategy, pid, vals)
        want = _jax_leaves(dctx, strategy, pid, vals)
        assert got[0] == want[0] and got[1] == want[1]
        for k in SLOW + (tcost.strategy_counter(strategy),):
            assert got[2].get(k, 0) == want[2].get(k, 0), k
        runs[strategy] = got
    flat, hier = runs["single-shot"], runs["hierarchical"]
    assert [sorted(s) for s in hier[0]] == [sorted(s) for s in flat[0]]
    assert 0 < hier[2]["shuffle.bytes_sent_slow"] \
        < flat[2]["shuffle.bytes_sent_slow"]
    assert hier[2]["shuffle.rows_sent_slow"] == \
        flat[2]["shuffle.rows_sent_slow"] == pid.size


def test_precombine_moves_only_per_group_partials(ctx, dctx,
                                                  jax_trace_shim):
    """Striped keys put every group on every shard: the pre-combine
    moves exactly K·(S−1) partials across the slow axis whatever the
    row count, as in the JAX package."""
    nkeys = 37
    for n in (2960, 5920):
        at = pa.table({"k": pa.array((np.arange(n) % nkeys)
                                     .astype(np.int32)),
                       "v": pa.array(np.arange(n, dtype=np.float32))})
        jt, tt = _both_dtables(ctx, dctx, 8, at)

        def op(dops):
            return lambda t: dops.dist_groupby_fused(
                t, ["k"], [("v", "sum")], mode="pre-aggregate")

        got, want = run_both(jt, tt, op(jdist_ops), op(tdist_ops),
                             strategy="hierarchical-combine")
        assert_same_run(got, want, same=_same_close)
        assert got[1]["groupby.axis_precombine_rows"] == nkeys * (2 - 1)


def test_degraded_choice_under_split_matches_jax(ctx, dctx,
                                                 jax_trace_shim):
    """With the (2, 4) split priced, the chooser's natural pick under a
    tightening budget (the hierarchy among the candidates; flat prices
    decorated with their slow share) equals the JAX package's: the same
    lowering, reason, rows and slow-axis bytes.  Without a measured
    profile the (rounds, wire) proxy keeps preferring the flat lowerings
    here, as in the JAX package."""
    jt, tt = _both_dtables(ctx, dctx, 8, mixed_key_table())
    keys = KEYS["composite"]
    op_j, op_t = _shuffle_ops(keys)
    got, _ = run_both(jt, tt, op_j, op_t)
    ss = int(got[2][0][1].split("peak ")[1].split(" B")[0])
    for budget in (ss - 1, ss // 3, ss // 10):
        got, want = run_both(jt, tt, op_j, op_t, budget=budget)
        assert_same_run(got, want)
        assert got[1]["shuffle.strategy.downgrades"] == 1
        assert got[1]["shuffle.bytes_sent_slow"] > 0


def test_survivor_world_falls_back_to_flat():
    """A world of 4 under the (2, 4) shape (the survivors of losing 4 of
    8 shards) is one the slow axis cannot span: the split re-resolves
    flat, and the chooser serves the exchange with a flat lowering, rows
    unchanged."""
    from cylon_tpu_torch import Table
    from cylon_tpu_torch.parallel import DTable, shuffle_table
    full = CylonContext(device="cpu", world=8)
    assert ttopo.axis_split(full) == (2, 4)
    survivor = CylonContext(device="cpu", world=4)
    assert ttopo.axis_split(survivor) == (1, 4)
    at = mixed_key_table(2000)
    ttrace.enable_counters()
    ttrace.reset()
    try:
        base = shuffle_table(DTable.from_table(
            full, Table.from_arrow(full, at)), ["ki"])
        tconfig.set_device_memory_budget(8192)
        out = shuffle_table(DTable.from_table(
            survivor, Table.from_arrow(survivor, at)), ["ki"])
        c = ttrace.counters()
    finally:
        ttrace.disable_counters()
        ttrace.reset()
    assert c["shuffle.strategy.downgrades"] == 1
    assert not any(k.startswith("shuffle.strategy.hier") for k in c)

    def rows(dt):
        cnt = dt.counts_host()
        return sorted(r for s in range(len(cnt)) for r in zip(
            *[col.data[s * dt.cap:s * dt.cap + cnt[s]].tolist()
              for col in dt.columns[:2]]))

    assert rows(out) == rows(base)
