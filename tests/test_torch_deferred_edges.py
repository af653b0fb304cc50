"""The port's deferred count protocol (``ops/compact.py``), edge by edge:
nested regions, an exception mid-region clearing the queue,
``flush_pending_with`` on an empty batch, the poisoned-prefix skip, the
no-hint arm flushing first, thread-local regions (and threads sharing the
hints under load) and the one batched read per flush — each pinned with synthetic dispatch / post closures, as the
JAX package's ``tests/test_deferred_edges.py`` pins them, plus the
optimistic shuffle's degraded-signature state against the JAX package's
at world 8: the chunked steady state and its self-promotion, a chunked
exchange inside ``run_pipeline``, an adequate hint that prices over
budget inside a flush (invalidate, then replay through the degraded
lowering), and a plan check that never degrades.
"""
import threading

import numpy as np
import pandas as pd
import pytest
import torch

import cylon_tpu as ct
from cylon_tpu import config as jconfig
from cylon_tpu.parallel import DTable as JDTable
from cylon_tpu.parallel import run_pipeline as jrun_pipeline
from cylon_tpu.parallel import shuffle as jshuffle
from cylon_tpu.parallel import shuffle_table as jshuffle_table

import cylon_tpu_torch as pt
from cylon_tpu_torch import config as tconfig
from cylon_tpu_torch import trace as ttrace
from cylon_tpu_torch.ops import compact as ops_compact
from cylon_tpu_torch.ops.compact import (ReplayNeeded, deferred_mode,
                                         deferred_region, flush_pending,
                                         flush_pending_with,
                                         optimistic_dispatch)
from cylon_tpu_torch.parallel import DTable as TDTable
from cylon_tpu_torch.parallel import run_pipeline as trun_pipeline
from cylon_tpu_torch.parallel import shuffle as tshuffle
from cylon_tpu_torch.parallel import shuffle_table as tshuffle_table

from test_torch_common import jax_trace_shim  # noqa: F401


def _queue(hints, key, hint, counts_value, post):
    """Queue one synthetic optimistic dispatch (hint present + deferred
    mode ⇒ validation is deferred).  dispatch() echoes its sizes;
    ``counts_value`` is the tensor the flush will read."""
    hints[key] = (tuple(hint), 0)
    return optimistic_dispatch(hints, key, lambda sizes: sizes,
                               torch.tensor(np.asarray(counts_value)), post)


def _post_need(need, calls=None):
    def post(counts):
        if calls is not None:
            calls.append(np.asarray(counts).copy())
        return tuple(need)
    return post


@pytest.fixture
def counters():
    ttrace.reset()
    ttrace.enable_counters()
    yield ttrace.counters
    ttrace.disable_counters()
    ttrace.reset()


def test_nested_regions_flush_at_outer_exit():
    hints = {}
    with deferred_region():
        with deferred_region():
            res, used, counts = _queue(hints, "k", (8,), [4],
                                       _post_need((4,)))
            assert counts is None and used == (8,)  # queued, not waited
        # the inner exit neither flushes nor clears
        assert deferred_mode()
        assert len(ops_compact._deferred.pending) == 1
        assert flush_pending() is True
        assert ops_compact._deferred.pending == []
    assert not deferred_mode()


def test_nested_region_exception_clears_pending_at_outer_exit():
    hints = {}
    with pytest.raises(ValueError):
        with deferred_region():
            with pytest.raises(ValueError):
                with deferred_region():
                    _queue(hints, "k", (8,), [4], _post_need((4,)))
                    raise ValueError("inner")
            assert len(ops_compact._deferred.pending) == 1
            raise ValueError("outer")
    assert ops_compact._deferred.pending == []
    assert flush_pending() is True  # and no stale not-ok leaks either


def test_exception_mid_region_clears_pending():
    hints = {}
    with pytest.raises(RuntimeError):
        with deferred_region():
            _queue(hints, "k", (8,), [4], _post_need((4,)))
            raise RuntimeError("boom")
    assert ops_compact._deferred.pending == []
    assert not deferred_mode()
    assert flush_pending_with(()) == (True, [])


def test_failed_region_does_not_leak_not_ok_to_depth_zero():
    hints = {}
    with deferred_region():
        _queue(hints, "k", (8,), [4], _post_need((16,)))  # undersized
        assert flush_pending() is False
    assert flush_pending() is True


def test_flush_pending_with_empty_batch_fetches_extra(counters):
    ok, vals = flush_pending_with((torch.arange(3), torch.tensor(7)))
    assert ok is True
    np.testing.assert_array_equal(vals[0], [0, 1, 2])
    assert int(vals[1]) == 7
    assert counters().get("host.read", 0) == 1


def test_one_batched_read_per_flush(counters):
    """Three queued validations and a payload: ONE host read, and one
    ``compact.flush`` consultation behind it."""
    from cylon_tpu_torch import faults
    hints = {}
    plan = faults.FaultPlan(0, [faults.FaultRule(
        "compact.flush", kind="transient", nth=1)])
    with faults.active(plan), deferred_region():
        for key in "abc":
            _queue(hints, key, (8,), [4], _post_need((4,)))
        assert counters().get("host.read", 0) == 0  # nothing waited yet
        ok, extra = flush_pending_with((torch.tensor([5]),))
    assert ok is True and int(extra[0][0]) == 5
    assert counters().get("host.read", 0) == 1
    assert plan.injected == 1  # the retry absorbed the injected fault


def test_poisoned_prefix_skips_downstream_posts():
    hints = {}
    calls_a = []

    def poisoned_post(counts):
        raise AssertionError("post ran on poisoned counts")

    with deferred_region():
        _queue(hints, "a", (8,), [32], _post_need((32,), calls_a))
        _queue(hints, "b", (8,), [4], poisoned_post)
        ok, extra = flush_pending_with((torch.tensor(5),))
        assert ok is False
        assert len(calls_a) == 1
        assert hints["a"][0] == (32,)
        assert hints["b"][0] == (8,)  # skipped: untouched
        assert int(extra[0]) == 5
        assert ops_compact._deferred.pending == []
        with pytest.raises(ReplayNeeded):
            ops_compact._abort_if_poisoned()


def test_poison_skip_resumes_validation_on_next_region():
    hints = {}
    calls_b = []
    with deferred_region():
        _queue(hints, "a", (8,), [32], _post_need((32,)))  # undersized
        _queue(hints, "b", (8,), [4], _post_need((4,), calls_b))
        assert flush_pending() is False
        assert calls_b == []
    with deferred_region():  # the replay
        _queue(hints, "a", (32,), [32], _post_need((32,)))
        _queue(hints, "b", (8,), [4], _post_need((4,), calls_b))
        assert flush_pending() is True
        assert len(calls_b) == 1


def test_no_hint_mid_region_resolves_queued_upstream_first():
    hints = {}
    with deferred_region():
        _queue(hints, "a", (8,), [32], _post_need((32,)))  # undersized
        with pytest.raises(ReplayNeeded):
            optimistic_dispatch({}, "nohint", lambda sizes: sizes,
                                torch.tensor([1]), _post_need((1,)))
        # a blocking read inside the failed attempt aborts the same way
        with pytest.raises(ReplayNeeded):
            ops_compact.read_host(torch.tensor([1]))


def test_regions_are_thread_local():
    """A region on one thread never sees another thread's queue (the
    serving dispatcher runs exchanges on its own thread)."""
    hints = {}
    seen = {}
    with deferred_region():
        _queue(hints, "main", (8,), [4], _post_need((4,)))

        def other():
            seen["mode"] = deferred_mode()
            seen["pending"] = list(ops_compact._deferred.pending)
            seen["flush"] = flush_pending()

        th = threading.Thread(target=other)
        th.start()
        th.join()
        assert len(ops_compact._deferred.pending) == 1
        assert flush_pending() is True
    assert seen == {"mode": False, "pending": [], "flush": True}


def test_meta_counts_size_from_zeros_and_leave_hints():
    hints = {"k": ((64,), 0)}
    calls = []
    res, used, counts = optimistic_dispatch(
        hints, "k", lambda sizes: sizes,
        torch.empty((3,), dtype=torch.int32, device="meta"),
        _post_need((8,), calls))
    assert res == (8,) and used == (8,)
    np.testing.assert_array_equal(counts, [0, 0, 0])
    assert hints == {"k": ((64,), 0)}
    assert ops_compact.read_host(
        torch.empty((2, 2), dtype=torch.int64, device="meta")).sum() == 0


# ---------------------------------------------------------------------------
# the optimistic shuffle's degraded-signature state, against the JAX
# package's at world 8
# ---------------------------------------------------------------------------

BUDGET = 230_000  # between one 4-round chunked transient and single-shot's


def _skewed_frame(n=40_000, seed=3):
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 1 << 16, n).astype(np.int32)
    k[: n // 2] = 7  # hot key: half of all rows land on ONE shard
    return pd.DataFrame({"k": k, "v": rng.random(n, dtype=np.float32)})


class _Side:
    """One package's shuffle of the skewed frame at world 8."""

    def __init__(self, dctx, jax_side: bool):
        df = _skewed_frame()
        if jax_side:
            self.make = lambda: JDTable.from_table(
                dctx, ct.Table.from_pandas(dctx, df))
            self.shuffle, self.mod = jshuffle_table, jshuffle
            self.config, self.run = jconfig, jrun_pipeline
        else:
            ctx = pt.CylonContext(device="cpu", world=8)
            self.make = lambda: TDTable.from_table(
                ctx, pt.Table.from_pandas(ctx, df))
            self.shuffle, self.mod = tshuffle_table, tshuffle
            self.config, self.run = tconfig, trun_pipeline

    def frame(self):
        out = self.shuffle(self.make(), ["k"]).to_table().to_pandas()
        return out.sort_values(["k", "v"]).reset_index(drop=True)


def _both(dctx):
    return _Side(dctx, True), _Side(dctx, False)


def _with_budget(side, budget, fn):
    prev = side.config.set_device_memory_budget(budget)
    try:
        return fn()
    finally:
        side.config.set_device_memory_budget(prev)


def test_chunked_steady_state_and_promotion(dctx, jax_trace_shim,
                                            counters):
    base = None
    for side in _both(dctx):
        want = side.frame()
        base = want if base is None else base
        pd.testing.assert_frame_equal(want, base)

        def degraded():
            side.mod.clear_chunk_state()
            side.frame()                   # degrades the signature
            assert side.mod._chunked_keys
            ttrace.reset()
            return side.frame()            # steady state

        out = _with_budget(side, BUDGET, degraded)
        pd.testing.assert_frame_equal(out, base)
        if side.mod is tshuffle:
            assert counters().get("shuffle.chunked", 0) == 1
            assert counters().get("host.read", 0) >= 1
        # budget restored: the signature self-promotes to single-shot
        ttrace.reset()
        pd.testing.assert_frame_equal(side.frame(), base)
        assert not side.mod._chunked_keys
        if side.mod is tshuffle:
            assert counters().get("shuffle.chunked", 0) == 0
            assert tshuffle._block_hints  # the optimism was reseeded


def test_chunked_shuffle_inside_deferred_pipeline(dctx, jax_trace_shim):
    outs = []
    for side in _both(dctx):
        base = side.frame()

        def run():
            side.mod.clear_chunk_state()
            side.frame()  # degrade first
            return side.run(side.frame)

        out = _with_budget(side, BUDGET, run)
        pd.testing.assert_frame_equal(out, base)
        outs.append(out)
    assert ops_compact._deferred.pending == []
    pd.testing.assert_frame_equal(outs[0], outs[1])


def test_deferred_adequate_hint_over_budget_replays_chunked(
        dctx, jax_trace_shim, counters):
    """The hint was seeded under an ample budget, then the budget drops:
    inside a flush the hinted dispatch is correctly SIZED (nothing
    undersized to trip on), so post() invalidates the flush and the
    replay re-enters through the chunked lowering."""
    outs = []
    for side in _both(dctx):
        base = side.frame()  # seeds the single-shot hint

        def run():
            side.mod.clear_chunk_state()
            ttrace.reset()
            return side.run(side.frame)

        out = _with_budget(side, BUDGET, run)
        pd.testing.assert_frame_equal(out, base)
        outs.append(out)
        if side.mod is tshuffle:
            c = counters()
            assert c.get("pipeline.replays", 0) >= 1
            assert c.get("shuffle.chunked", 0) >= 1
            assert c.get("shuffle.chunked_rounds", 0) > 1
    pd.testing.assert_frame_equal(outs[0], outs[1])


def test_plan_check_unaffected_by_tiny_budget():
    """An abstract plan run prices from zeroed counts and never degrades,
    whatever the budget knob says."""
    from cylon_tpu_torch.analysis import plan_check
    rng = np.random.default_rng(4)
    ctx = pt.CylonContext(device="cpu", world=8)
    df = pd.DataFrame({"k": rng.integers(0, 50, 300).astype(np.int32),
                       "v": rng.random(300).astype(np.float32)})
    dt = TDTable.from_table(ctx, pt.Table.from_pandas(ctx, df))
    prev = tconfig.set_device_memory_budget(1 << 20)
    try:
        tshuffle.clear_chunk_state()
        rep = dt.explain(lambda t: tshuffle_table(t, ["k"]), validate=True)
        assert rep.ok and isinstance(rep, plan_check.PlanReport)
        assert "single-shot (static" in rep.nodes[0].info["exchange"]
        assert not tshuffle._chunked_keys
    finally:
        tconfig.set_device_memory_budget(prev)


def test_threads_share_hints_but_not_regions():
    """More threads than cores run the same join under run_pipeline and
    eagerly at a short switch interval: the size hints are shared and
    updated without a lock (a lost update costs one redone dispatch),
    the deferred regions are per thread, and every result is right."""
    import os
    import sys

    from cylon_tpu_torch.parallel import dist_join
    rng = np.random.default_rng(5)
    ctx = pt.CylonContext(device="cpu", world=4)
    frames = [pd.DataFrame({"k": rng.integers(0, 40, n).astype(np.int32),
                            "v": rng.random(n).astype(np.float32)})
              for n in (300, 200)]
    left, right = (TDTable.from_table(ctx, pt.Table.from_pandas(ctx, df))
                   for df in frames)
    cfg = pt.JoinConfig(pt.JoinType.INNER, pt.JoinAlgorithm.SORT, 0, 0)
    want = len(frames[0].merge(frames[1], on="k"))
    results, errors = [], []

    def worker(i):
        try:
            for j in range(3):
                run = lambda: dist_join(left, right, cfg).to_table().num_rows
                results.append(trun_pipeline(run) if (i + j) % 2 else run())
                assert ops_compact._deferred.pending == []
        except BaseException as e:  # re-raised on the main thread below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(2 * (os.cpu_count() or 2) + 2)]
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(prev)
    assert not any(th.is_alive() for th in threads)
    assert not errors, errors[0]
    assert results == [want] * (3 * len(threads))
