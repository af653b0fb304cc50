"""Costed redistribution parity: the port's exchange lowerings and chooser
against the JAX package's (mirroring ``tests/test_redistribution.py``) at
world 1 and on the 8 virtual CPU devices, on the same numpy inputs.

Each strategy — forced through ``config.set_exchange_strategy`` and
chosen naturally under a budget inside its band — across int,
dictionary-string, nullable and composite keys: per shard the same rows
in the same order (each lowering's own order: chunked round-major, ring
own rows then rounds, allgather sender order), the same counts and
``outcap``; the same strategy counters, exchange byte counters and
priced peak; the same ``exchange=`` / ``degraded=`` annotations under
EXPLAIN ANALYZE.  The fused groupby's fold-combine (chunked) is held the
same way."""
import numpy as np
import pyarrow as pa
import pytest

from cylon_tpu import config as jconfig
from cylon_tpu import observe as jobserve
from cylon_tpu.parallel import dist_ops as jdist_ops
from cylon_tpu.parallel import shuffle_table as jshuffle_table

from cylon_tpu_torch import config as tconfig
from cylon_tpu_torch import observe as tobserve
from cylon_tpu_torch import trace as ttrace
from cylon_tpu_torch.parallel import cost as tcost
from cylon_tpu_torch.parallel import dist_ops as tdist_ops
from cylon_tpu_torch.parallel import shuffle as tshuffle
from cylon_tpu_torch.parallel import shuffle_table as tshuffle_table

from test_torch_common import jax_trace_shim  # noqa: F401
from test_torch_dist_groupby import _same_close
from test_torch_dist_join import _both_dtables, _same

KEYS = {"int": ["ki"], "dict": ["ks"], "nullable": ["kn"],
        "composite": ["ki", "ks", "kn"]}
COUNTERS = ("shuffle.exchanges", "shuffle.rows_sent", "shuffle.bytes_sent",
            "shuffle.strategy.downgrades", "shuffle.chunked",
            "shuffle.chunked_rounds", "shuffle.fold_combined",
            "shuffle.bytes_sent_slow", "shuffle.rows_sent_slow",
            "groupby.partials_rows", "groupby.bytes_moved",
            "groupby.axis_precombine", "groupby.axis_precombine_rows",
            "shuffle.exchange_bytes_peak")


@pytest.fixture(autouse=True)
def _port_state():
    tshuffle.clear_chunk_state()
    yield
    tconfig.set_exchange_strategy(None)
    tconfig.set_mesh_shape(None)
    tconfig.set_device_memory_budget(None)
    jconfig.set_device_memory_budget(None)
    tshuffle.clear_chunk_state()


def mixed_key_table(n=3000, seed=11):
    """int / dict-string / nullable keys and a float, int64 and bool
    payload (``test_redistribution._mixed_key_frame``'s flavours)."""
    rng = np.random.default_rng(seed)
    return pa.table({
        "ki": pa.array(rng.integers(0, 50, n).astype(np.int32)),
        "ks": pa.array([f"s{c}" for c in rng.integers(0, 7, n)]),
        "kn": pa.array(rng.integers(0, 9, n), mask=np.arange(n) % 17 == 0),
        "v": pa.array(rng.random(n).astype(np.float32)),
        "w": pa.array(rng.integers(-2**40, 2**40, n)),
        "b": pa.array(rng.integers(0, 2, n) == 1),
    })


def one_hot_table(n=8192):
    """Every row keyed identically: one hot target (the JAX suite's
    budget-band fixture)."""
    return pa.table({"k": pa.array(np.full(n, 7, dtype=np.int32)),
                     "v": pa.array(np.arange(n, dtype=np.float32))})


def _set(pkg_config, strategy, budget, shape):
    pkg_config.set_exchange_strategy(strategy)
    pkg_config.set_device_memory_budget(budget)
    pkg_config.set_mesh_shape(shape)


def _facts(report):
    """(output, selected counters, (exchange, degraded) per node) of an
    analyzed run."""
    c = dict(report.totals["counters"])
    picked = {k: v for k, v in c.items()
              if k.startswith("shuffle.strategy.") or k in COUNTERS}
    notes = [(n.op, n.info.get("exchange"), n.info.get("degraded"))
             for n in report.nodes]
    return report.output, picked, notes


def run_both(jt, tt, op_j, op_t, strategy=None, budget=None, shape=None):
    """Analyze ``op`` in both packages under the same forced strategy,
    budget and mesh shape; returns ((port output, counters, notes),
    (jax ...))."""
    _set(tconfig, strategy, budget, shape)
    _set(jconfig, strategy, budget, shape)
    try:
        got = _facts(tobserve.analyze(op_t, tt))
        want = _facts(jobserve.analyze(op_j, jt))
    finally:
        _set(tconfig, None, None, None)
        _set(jconfig, None, None, None)
    return got, want


def assert_same_run(got, want, same=_same):
    (gout, gc, gnotes), (wout, wc, wnotes) = got, want
    same(gout, wout)
    assert gc == wc
    assert gnotes == wnotes


def _shuffle_ops(keys):
    return (lambda t: jshuffle_table(t, keys),
            lambda t: tshuffle_table(t, keys))


@pytest.mark.parametrize("world", [1, 8])
@pytest.mark.parametrize("flavour", list(KEYS))
@pytest.mark.parametrize("strategy", ["single-shot", "chunked", "ring",
                                      "allgather"])
def test_forced_strategy_matches_jax(ctx, dctx, jax_trace_shim, world,
                                     flavour, strategy):
    jt, tt = _both_dtables(ctx, dctx, world, mixed_key_table())
    op_j, op_t = _shuffle_ops(KEYS[flavour])
    got, want = run_both(jt, tt, op_j, op_t, strategy=strategy)
    assert_same_run(got, want)
    if world > 1:
        c = got[1]
        assert c.get(tcost.strategy_counter(strategy), 0) == 1, c
        assert got[2][0][1].startswith(
            f"{strategy}: forced by CYLON_EXCHANGE_STRATEGY")


def _band_budgets(tt, keys):
    """For the port's count matrix of ``shuffle_table(tt, keys)``: the
    least budget, among every candidate's price (and 64 B above it) and
    one byte under the single-shot price, at which each strategy is the
    chooser's feasible pick."""
    pid = tdist_ops._hash_pids(tt, tdist_ops._resolve_ids(tt, keys))
    counts = tshuffle._counts(tt.ctx.comm, pid).numpy().astype(np.int64)
    P, cap = tt.nparts, tt.cap
    leaves = [lf for c in tt.columns for lf in (c.data, c.validity)
              if lf is not None]
    rbytes = max(tobserve.row_bytes(leaves), 1)
    prices = {c.peak_bytes for c in tcost.enumerate_strategies(
        P, cap, counts, rbytes, 1 << 40)}
    ss = tcost.price_single_shot(P, *tcost.exchange_sizes(counts)[:2],
                                 rbytes).peak_bytes
    picks = {}
    for b in sorted(prices | {ss - 1} | {p + 64 for p in prices}):
        choice, _, feasible = tcost.choose(
            tcost.enumerate_strategies(P, cap, counts, rbytes, b), b)
        if feasible:
            picks.setdefault(choice.strategy, b)
    return picks


@pytest.mark.parametrize("flavour", ["int", "composite"])
@pytest.mark.parametrize("table", ["mixed", "one_hot"])
def test_natural_choice_matches_jax(ctx, dctx, jax_trace_shim, flavour,
                                    table):
    """Every strategy that is the cheapest feasible one at some budget
    for this count matrix, run at that budget in both packages: the same
    choice, reason, rows and counters (one-hot keys: allgather and ring
    each own a band, as in the JAX suite)."""
    at = mixed_key_table() if table == "mixed" else one_hot_table()
    keys = KEYS[flavour] if table == "mixed" else ["k"]
    jt, tt = _both_dtables(ctx, dctx, 8, at)
    picks = _band_budgets(tt, keys)
    assert "single-shot" in picks and "chunked" in picks
    if table == "one_hot":
        assert {"allgather", "ring"} <= set(picks)
    op_j, op_t = _shuffle_ops(keys)
    for strategy, budget in picks.items():
        got, want = run_both(jt, tt, op_j, op_t, budget=budget)
        assert_same_run(got, want)
        assert got[1].get(tcost.strategy_counter(strategy), 0) == 1
        assert got[1].get("shuffle.strategy.downgrades", 0) == \
            (strategy != "single-shot")
        assert got[2][0][1].startswith(f"{strategy}: ")


def test_ring_and_allgather_bands_of_the_jax_suite(ctx, dctx,
                                                   jax_trace_shim):
    """The JAX suite's fixed budgets on the one-hot fixture: 30,000 B
    picks the ring, 180,000 B the allgather, in both packages."""
    jt, tt = _both_dtables(ctx, dctx, 8, one_hot_table())
    op_j, op_t = _shuffle_ops(["k"])
    for budget, strategy in ((30_000, "ring"), (180_000, "allgather")):
        got, want = run_both(jt, tt, op_j, op_t, budget=budget)
        assert_same_run(got, want)
        assert got[1][tcost.strategy_counter(strategy)] == 1


def test_best_effort_floor_matches_jax(ctx, dctx, jax_trace_shim):
    """A budget below every strategy's floor: chunked at C = 1 runs
    anyway, annotated best-effort, in both packages."""
    jt, tt = _both_dtables(ctx, dctx, 8, one_hot_table(1024))
    op_j, op_t = _shuffle_ops(["k"])
    got, want = run_both(jt, tt, op_j, op_t, budget=10)
    assert_same_run(got, want)
    assert "best-effort" in got[2][0][1]
    assert got[1]["shuffle.chunked_rounds"] == 128


@pytest.mark.parametrize("world", [1, 8])
@pytest.mark.parametrize("flavour", list(KEYS))
def test_fold_combine_matches_jax(ctx, dctx, jax_trace_shim, world,
                                  flavour):
    """The fused groupby's partial exchange forced onto the chunked
    lowering: the rounds fold by key (``shuffle.fold_combined``), and
    the groups, their order, ``cap`` and counts equal the JAX
    package's."""
    aggs = [("v", "sum"), ("v", "count"), ("w", "min"), ("w", "max"),
            ("v", "mean")]
    jt, tt = _both_dtables(ctx, dctx, world, mixed_key_table(seed=12))
    keys = KEYS[flavour]

    def op(dops):
        return lambda t: dops.dist_groupby_fused(t, keys, aggs,
                                                 mode="pre-aggregate")

    got, want = run_both(jt, tt, op(jdist_ops), op(tdist_ops),
                         strategy="chunked")
    assert_same_run(got, want, same=_same_close)
    if world > 1:
        assert got[1]["shuffle.fold_combined"] >= 2
        assert got[1]["shuffle.strategy.chunked"] == 1


def test_fast_path_unchanged_under_big_budget(ctx, dctx, jax_trace_shim):
    """Under an ample budget the chooser keeps single-shot: no
    downgrade, the annotation names the budget it fit."""
    jt, tt = _both_dtables(ctx, dctx, 8, one_hot_table())
    op_j, op_t = _shuffle_ops(["k"])
    got, want = run_both(jt, tt, op_j, op_t)
    assert_same_run(got, want)
    assert got[1]["shuffle.strategy.single_shot"] == 1
    assert "shuffle.strategy.downgrades" not in got[1]
    assert "<= budget" in got[2][0][1]


def test_skew_warning_once_per_signature():
    """The hot-key warning fires once per shuffle signature until
    ``clear_chunk_state``."""
    from cylon_tpu_torch import logging as glog
    import io
    buf = io.StringIO()
    glog.set_sink(buf)
    try:
        per_recv = np.array([70_000, 10, 10, 10])
        for _ in range(3):
            tshuffle._warn_skew(4, ("sig",), per_recv, 81920)
        assert buf.getvalue().count("skewed exchange") == 1
        tshuffle.clear_chunk_state()
        tshuffle._warn_skew(4, ("sig",), per_recv, 81920)
        assert buf.getvalue().count("skewed exchange") == 2
        tshuffle._warn_skew(4, ("small",), np.array([9, 1, 1, 1]), 16)
        assert buf.getvalue().count("skewed exchange") == 2
    finally:
        glog.set_sink(None)
        tshuffle.clear_chunk_state()


def test_watchdog_runs_the_dispatch_and_times_out():
    """With ``CYLON_EXCHANGE_TIMEOUT_MS`` set the dispatch runs on a
    helper thread; one that completes returns its value, one that wedges
    raises a TransientFault naming the point."""
    import threading
    import torch
    from cylon_tpu_torch import faults
    ttrace.enable_counters()
    ttrace.reset()
    prev = tconfig.set_exchange_timeout_ms(2000)
    cpu = torch.device("cpu")
    try:
        seen = []
        out = tshuffle._watchdog_dispatch(
            "shuffle.exchange",
            lambda: seen.append(threading.current_thread().name) or 7, cpu)
        assert out == 7 and seen == ["cylon-exchange-watchdog"]
        with pytest.raises(ValueError):
            tshuffle._watchdog_dispatch(
                "shuffle.exchange", lambda: int("x"), cpu)
        tconfig.set_exchange_timeout_ms(50)
        gate = threading.Event()
        try:
            with pytest.raises(faults.TransientFault) as ei:
                tshuffle._watchdog_dispatch(
                    "shuffle.exchange", lambda: gate.wait(5), cpu)
        finally:
            gate.set()
        assert ei.value.point == "shuffle.exchange"
        assert ttrace.counters()["shuffle.watchdog_timeouts"] == 1
    finally:
        tconfig.set_exchange_timeout_ms(prev)
        ttrace.disable_counters()
        ttrace.reset()


def test_shuffle_under_watchdog_equals_without(ctx, dctx):
    """A whole shuffle under the watchdog (every lowering's dispatch on
    the helper thread) gives the rows it gives without."""
    from cylon_tpu_torch import CylonContext, Table
    from cylon_tpu_torch.parallel import DTable
    tctx = CylonContext(device="cpu", world=8)
    at = mixed_key_table(1000)
    tt = DTable.from_table(tctx, Table.from_arrow(tctx, at))
    want = tshuffle_table(tt, ["ki"])
    prev = tconfig.set_exchange_timeout_ms(60_000)
    try:
        for strategy in ("single-shot", "chunked", "ring", "allgather"):
            tconfig.set_exchange_strategy(strategy)
            got = tshuffle_table(tt, ["ki"])
            for a, b in zip(got.columns, want.columns):
                assert sorted(a.data[:got.cap].tolist()) == \
                    sorted(b.data[:want.cap].tolist())
    finally:
        tconfig.set_exchange_timeout_ms(prev)
        tconfig.set_exchange_strategy(None)
