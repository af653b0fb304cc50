"""Sanitizer mode of the port (``cylon_tpu_torch.config.sanitize``) against
the JAX package's (``cylon_tpu.config.sanitize``).

The sync guard (``torch.cuda.set_sync_debug_mode("error")`` over every
span body) bites only on the card, as the JAX transfer guard bites only on
real device backends: this torch has no CUDA, so here the guard is held as
wiring — scope and restore through a stand-in debug mode, and no
``torch.cuda`` debug-mode call on a CPU process.  What runs for real here
is the NaN trap, the host-cache content check at export, lock-order
enforcement, and the engine answering under sanitize exactly as the JAX
package does under its own, at world 1 and on 8 virtual CPU devices.
``tests/test_torch_gpu.py`` holds the guard on the card."""
import dataclasses
import threading

import numpy as np
import pandas as pd
import pyarrow as pa
import pytest
import torch

import cylon_tpu as ct
from cylon_tpu import config as jconfig
from cylon_tpu.parallel import DTable as JDTable
from cylon_tpu.parallel import dist_groupby as jdist_groupby
from cylon_tpu.parallel import dist_join as jdist_join
from cylon_tpu.parallel import dist_sort as jdist_sort

import cylon_tpu_torch as pt
from cylon_tpu_torch import config as tconfig
from cylon_tpu_torch import trace
from cylon_tpu_torch.analysis import plan_check as tpc
from cylon_tpu_torch.ops.compact import bincount, read_host
from cylon_tpu_torch.parallel import DTable as TDTable
from cylon_tpu_torch.parallel import dist_groupby as tdist_groupby
from cylon_tpu_torch.parallel import dist_join as tdist_join
from cylon_tpu_torch.parallel import dist_sort as tdist_sort
from cylon_tpu_torch.tpch import queries as tqueries

import tpch_torch_parity as tp
from test_torch_common import (assert_rows_close, float_rtols, jax_rows,
                               jax_trace_shim, port_rows, schema)  # noqa: F401
from test_torch_dist_join import _both_dtables

WORLDS = (1, 8)


@pytest.fixture(autouse=True)
def _restore_knobs():
    """Each test leaves both packages' sanitize and lock-order switches
    as it found them."""
    prev = (tconfig.sanitizing(), tconfig.lockcheck_enabled(),
            jconfig.sanitizing())
    yield
    assert (tconfig.sanitizing(), tconfig.lockcheck_enabled(),
            jconfig.sanitizing()) == prev


class _FakeDebugMode:
    """A stand-in for the card's process-wide sync debug mode: records
    every mode the guard sets."""

    def __init__(self, monkeypatch, start=0):
        self.mode = start
        self.history = []
        monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
        monkeypatch.setattr(torch.cuda, "get_sync_debug_mode",
                            lambda: self.mode)
        monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", self.set)

    def set(self, mode):
        self.mode = {"default": 0, "warn": 1, "error": 2}.get(mode, mode)
        self.history.append(self.mode)


# ---------------------------------------------------------------------------
# sanitize(): scope, restore, the guard's wiring
# ---------------------------------------------------------------------------

def test_sanitize_scope_and_restore():
    assert not tconfig.sanitizing()
    prev_lockcheck = tconfig.set_lockcheck(None)
    try:
        with tconfig.sanitize() as h:
            assert tconfig.sanitizing() and tconfig.lockcheck_enabled()
            assert tconfig.sanitize_guard() is not None
            with tconfig.sanitize(False):
                assert not tconfig.sanitizing()
                assert tconfig.sanitize_guard() is None
            assert tconfig.sanitizing()
        assert isinstance(h, tconfig._SanitizeHandle)
        assert not tconfig.sanitizing() and not tconfig.lockcheck_enabled()
        assert tconfig.sanitize_guard() is None
        h = tconfig.sanitize()            # kept, then closed by hand
        assert tconfig.sanitizing()
        h.close()
        assert not tconfig.sanitizing()
    finally:
        tconfig.set_lockcheck(prev_lockcheck)
    assert pt.sanitize is tconfig.sanitize


def test_cpu_process_makes_no_debug_mode_call(monkeypatch):
    """On a process without CUDA the guard never touches torch.cuda's
    debug mode (this torch raises on it): span bodies, nested spans and
    the sanctioned reads all run."""
    def refuse(*a, **k):
        raise AssertionError("torch.cuda debug-mode call on a CPU process")

    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", refuse)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", refuse)
    assert not torch.cuda.is_initialized()
    with tconfig.sanitize():
        with trace.span_sync("sanitize.outer") as sp:
            with trace.span("sanitize.inner"):
                x = torch.arange(6) * 3
            sp.sync(x)
            got = read_host(x)
    assert got[2] == 6 and tconfig._guard_depth == 0


@pytest.mark.parametrize("prior", [0, 1])
def test_guard_scopes_and_restores_across_spans_and_threads(monkeypatch,
                                                            prior):
    """With CUDA up the guard sets "error" for a span body, lifts it for
    the sanctioned reads, keeps it through nested spans and a second
    thread's span, and the last body out restores the prior mode."""
    fake = _FakeDebugMode(monkeypatch, start=prior)
    inside, release = threading.Event(), threading.Event()
    seen = {}

    def other():
        with trace.span("sanitize.thread"):
            seen["thread"] = fake.mode
            inside.set()
            release.wait(30)

    with tconfig.sanitize():
        with trace.span_sync("sanitize.outer"):
            assert fake.mode == 2
            with trace.span("sanitize.inner"):
                assert fake.mode == 2
                with tconfig.sync_allowed():
                    assert fake.mode == prior
                assert fake.mode == 2
            th = threading.Thread(target=other)
            th.start()
            assert inside.wait(30)
        # the other thread's body is still guarded
        assert fake.mode == 2 and seen["thread"] == 2
        release.set()
        th.join(30)
        assert fake.mode == prior
        read_host(torch.arange(3))   # outside every span: no change
        assert fake.mode == prior
    assert fake.mode == prior and tconfig._guard_depth == 0
    assert tconfig._lift_depth == 0 and fake.history[-1] == prior


def test_guard_restores_when_the_body_raises(monkeypatch):
    fake = _FakeDebugMode(monkeypatch, start=1)
    with tconfig.sanitize():
        with pytest.raises(KeyError):
            with trace.span("sanitize.raises"):
                assert fake.mode == 2
                raise KeyError("x")
    assert fake.mode == 1 and tconfig._guard_depth == 0


# ---------------------------------------------------------------------------
# the NaN trap
# ---------------------------------------------------------------------------

def test_nan_trap_names_the_producing_op():
    with tconfig.sanitize():
        with pytest.raises(FloatingPointError, match=r"aten\.log\.default"):
            with trace.span("sanitize.nan"):
                y = torch.log(torch.tensor([-1.0, 2.0]))
        # an in-place write through a view names the op that wrote the
        # surviving base
        with pytest.raises(FloatingPointError, match=r"aten\.copy_"):
            with trace.span("sanitize.nan_inplace"):
                z = torch.zeros(4)
                z[1:3] = torch.tensor([0.0, 1.0]) / torch.tensor([0.0, 1.0])
    # outside sanitize nothing is checked
    with trace.span("sanitize.off"):
        y = torch.log(torch.tensor([-1.0]))
    assert torch.isnan(y).all()


def test_nan_trap_ignores_a_masked_intermediate():
    """``torch.where(valid, a / b, 0)``: the NaN lanes of ``a / b`` die
    inside the body, as inside a JAX jit kernel, so nothing trips; a NaN
    outside any span is not checked either."""
    a = torch.tensor([1.0, 0.0, 3.0])
    b = torch.tensor([2.0, 0.0, 4.0])
    with tconfig.sanitize():
        with trace.span("sanitize.masked"):
            out = torch.where(b != 0, a / b, 0)
        free = torch.log(torch.tensor([-1.0]))
    assert out.tolist() == [0.5, 0.0, 0.75]
    assert torch.isnan(free).all()


def test_nan_trap_skips_meta_tensors():
    with tconfig.sanitize():
        with trace.span("sanitize.meta"):
            m = torch.log(torch.empty(8, device="meta"))
    assert m.device.type == "meta"


def test_plan_check_under_sanitize_reads_nothing():
    """An abstract plan run under sanitize: meta tensors only, so the trap
    checks nothing and no host read happens."""
    ctx = pt.CylonContext(device="cpu", world=4)
    rng = np.random.default_rng(3)
    dt = TDTable.from_table(ctx, pt.Table.from_columns(ctx, {
        "k": rng.integers(0, 50, 400), "a": rng.normal(size=400)}))
    trace.reset()
    trace.enable_counters()
    try:
        with tconfig.sanitize():
            rep = tpc.validate(lambda t: tdist_sort(tpar_select(t), "k"), dt)
        c = trace.counters()
    finally:
        trace.disable_counters()
        trace.reset()
    assert rep.ok and [n.op for n in rep.nodes] == ["dist_select",
                                                     "dist_sort"]
    assert c.get("host.read", 0) == 0, c


def tpar_select(t):
    from cylon_tpu_torch.parallel import dist_select
    return dist_select(t, lambda env: env["a"] > 0.0)


@pytest.mark.parametrize("traced", [False, True])
def test_span_bodies_run_under_sanitize(traced):
    """Spans stay functional under the guard: the sanctioned reads (the
    count read, the span's own sync) are what the guard lets through."""
    if traced:
        trace.enable()
    try:
        with tconfig.sanitize():
            with trace.span_sync("sanitize.test") as sp:
                x = torch.arange(8) * 2
                sp.sync(x)
                got = read_host(x)
    finally:
        trace.disable()
        trace.reset()
    assert got[3] == 6


# ---------------------------------------------------------------------------
# the engine under sanitize = the JAX package under its sanitize
# ---------------------------------------------------------------------------

def _tables(rng, n_l=240, n_r=170, nan_payload=False):
    kl, kr = rng.integers(0, 30, n_l), rng.integers(0, 30, n_r)
    v = rng.random(n_l).astype(np.float32)
    if nan_payload:
        v[::7] = np.nan
    lt = pa.table({"k": pa.array(kl, pa.int64(),
                                 mask=rng.random(n_l) < 0.1),
                   "v": pa.array(v)})
    rt = pa.table({"k": pa.array(kr, pa.int64()),
                   "w": pa.array(rng.normal(size=n_r))})
    return lt, rt


def _same(got, want, rows_only=False):
    assert schema(got) == schema(want)
    if not rows_only:
        assert got.cap == want.cap
        np.testing.assert_array_equal(got.counts_host(), want.counts_host())
    assert_rows_close(port_rows(got, ordered=True),
                      jax_rows(want, ordered=True), float_rtols(got))


def _run_both(fn_j, fn_t):
    with jconfig.sanitize():
        want = fn_j()
    with tconfig.sanitize():
        got = fn_t()
    return got, want


OPS = {
    "join_hash": (
        lambda j, jr: jdist_join(j, jr, ct.JoinConfig(
            ct.JoinType.INNER, ct.JoinAlgorithm.HASH, 0, 0,
            broadcast_threshold=0)),
        lambda t, tr: tdist_join(t, tr, pt.JoinConfig(
            pt.JoinType.INNER, pt.JoinAlgorithm.HASH, 0, 0,
            broadcast_threshold=0))),
    "join_sort": (
        lambda j, jr: jdist_join(j, jr, ct.JoinConfig(
            ct.JoinType.LEFT, ct.JoinAlgorithm.SORT, 0, 0,
            broadcast_threshold=0)),
        lambda t, tr: tdist_join(t, tr, pt.JoinConfig(
            pt.JoinType.LEFT, pt.JoinAlgorithm.SORT, 0, 0,
            broadcast_threshold=0))),
    "groupby": (
        lambda j, jr: jdist_groupby(j, ["k"], [("v", "sum"), ("v", "mean"),
                                               ("v", "count")]),
        lambda t, tr: tdist_groupby(t, ["k"], [("v", "sum"), ("v", "mean"),
                                               ("v", "count")])),
    "sort": (lambda j, jr: jdist_sort(j, "v"),
             lambda t, tr: tdist_sort(t, "v")),
}


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("op", list(OPS))
def test_engine_under_sanitize_matches_jax(ctx, dctx, jax_trace_shim, op,
                                           world):
    lt, rt = _tables(np.random.default_rng(11))
    jl, tl = _both_dtables(ctx, dctx, world, lt)
    jr, tr = _both_dtables(ctx, dctx, world, rt)
    fj, ft = OPS[op]
    got, want = _run_both(lambda: fj(jl, jr), lambda: ft(tl, tr))
    # the JAX groupby sizes its partial blocks from earlier calls' hints;
    # rows and shards are what both packages promise alike
    _same(got, want, rows_only=op == "groupby")
    plain = ft(tl, tr)
    assert port_rows(plain, ordered=True) == port_rows(got, ordered=True)


# The same NaN-producing computations in both packages, each inside a
# span: the JAX side in a freshly jitted function (a kernel compiled under
# the flag, so its outputs are checked), the port's in the span body.
# Whether each raises: a NaN in a result raises in both, a NaN that a
# later op masks away inside the kernel / body raises in neither.
NAN_CASES = {
    "log_of_negative": (True, lambda jnp: jnp.log(jnp.asarray([-1.0, 2.0])),
                        lambda: torch.log(torch.tensor([-1.0, 2.0]))),
    "zero_over_zero": (True, lambda jnp: jnp.asarray([0.0, 1.0])
                       / jnp.asarray([0.0, 2.0]),
                       lambda: torch.tensor([0.0, 1.0])
                       / torch.tensor([0.0, 2.0])),
    "masked_division": (False, lambda jnp: jnp.where(
        jnp.asarray([0.0, 2.0]) != 0,
        jnp.asarray([0.0, 1.0]) / jnp.asarray([0.0, 2.0]), 0.0),
        lambda: torch.where(torch.tensor([0.0, 2.0]) != 0,
                            torch.tensor([0.0, 1.0])
                            / torch.tensor([0.0, 2.0]), 0.0)),
    "sqrt_then_nan_to_num": (False, lambda jnp: jnp.nan_to_num(
        jnp.sqrt(jnp.asarray([-4.0, 4.0]))),
        lambda: torch.nan_to_num(torch.sqrt(torch.tensor([-4.0, 4.0])))),
}


@pytest.mark.parametrize("case", list(NAN_CASES))
def test_nan_verdict_matches_jax(case):
    """Both sanitizers raise FloatingPointError on the same NaN-producing
    computation, or both answer.  (NaN values that merely pass through
    the engine are not held here: the JAX verdict on them depends on
    whether each kernel was compiled under the flag — a warm jit cache
    skips the check.)"""
    import jax
    import jax.numpy as jnp
    from cylon_tpu import trace as jtrace

    want_raise, fj, ft = NAN_CASES[case]
    kernel = jax.jit(lambda: fj(jnp))   # compiled under the flag below
    raised = []
    for sanitize, span, fn in (
            (jconfig.sanitize, jtrace.span_sync,
             lambda: kernel().block_until_ready()),
            (tconfig.sanitize, trace.span_sync, ft)):
        try:
            with sanitize(), span("sanitize.nan_case"):
                out = fn()
            raised.append(False)
        except FloatingPointError:
            raised.append(True)
    assert raised == [want_raise, want_raise]
    if not want_raise:
        assert not torch.isnan(torch.as_tensor(np.asarray(out))).any()


TPCH_NAMES = ("q1", "q5", "q6")


def _sanitized_query(base, kw, jctx, jt, tctx, tt):
    from cylon_tpu.tpch import queries as jqueries
    with jconfig.sanitize():
        want = jqueries.QUERIES[base](jctx, jt, **kw)
    with tconfig.sanitize():
        got = tqueries.QUERIES[base](tctx, tt, **kw)
        got.to_arrow()        # the export's host-cache content check
    plain = tqueries.QUERIES[base](tctx, tt, **kw)
    return got, want, plain


@pytest.fixture(scope="module")
def tpch_results():
    return tp._sweep(TPCH_NAMES, _sanitized_query)


@pytest.mark.parametrize("q,world", [(q, w) for q in TPCH_NAMES
                                     for w in tp.WORLDS])
def test_tpch_under_sanitize_matches_jax(tpch_results, q, world):
    got, want, plain = tpch_results[(q, world)]
    tp.check_tables(q, got, want)
    assert port_rows(got, ordered=True) == port_rows(plain, ordered=True)


# ---------------------------------------------------------------------------
# stale host caches: structural (always on) + content (sanitize)
# ---------------------------------------------------------------------------

def _cached(ctx, tctx):
    df = pd.DataFrame({"v": np.arange(6.0)})
    jt, tt = ct.Table.from_pandas(ctx, df), pt.Table.from_pandas(tctx, df)
    assert jt.columns[0].host_data is not None
    assert tt.columns[0].host_data is not None
    return jt, tt


def test_stale_cache_length_check_is_always_on(ctx):
    for t in _cached(ctx, pt.CylonContext(device="cpu")):
        c = t.columns[0]
        t.columns[0] = dataclasses.replace(c, data=c.data[:-2])
        with pytest.raises(Exception, match="stale host_data"):
            t.to_arrow()


def test_stale_cache_content_check_under_sanitize(ctx):
    """Same length, other contents: invisible to the structural check,
    caught by both sanitizers' byte-compare."""
    for t, sanitize in zip(_cached(ctx, pt.CylonContext(device="cpu")),
                           (jconfig.sanitize, tconfig.sanitize)):
        c = t.columns[0]
        t.columns[0] = dataclasses.replace(c, data=c.data + 1.0)
        with sanitize(False):
            assert t.to_arrow() is not None
        with sanitize():
            with pytest.raises(Exception, match="disagrees"):
                t.to_arrow()


def test_with_data_keeps_export_honest(ctx):
    got = []
    for t, sanitize in zip(_cached(ctx, pt.CylonContext(device="cpu")),
                           (jconfig.sanitize, tconfig.sanitize)):
        t.columns[0] = t.columns[0].with_data(t.columns[0].data + 1.0)
        with sanitize():
            got.append(t.to_arrow().column("v").to_pylist())
    assert got[0] == got[1] == [1.0, 2.0, 3.0, 4.0, 5.0, 6.0]


# ---------------------------------------------------------------------------
# the guard across threads, and the sync-free count
# ---------------------------------------------------------------------------

def test_sanitize_warns_while_worker_threads_run(monkeypatch):
    """The sync guard is one setting of the process: ``sanitize()`` warns
    once while a host pipeline runs its worker threads (a serving session
    registers the same way), a pipeline started under sanitize warns too,
    and nothing warns once it closed."""
    import weakref

    from cylon_tpu_torch import logging as glog
    from cylon_tpu_torch.parallel.streaming import HostPipeline
    lines = []
    monkeypatch.setattr(glog, "_emit",
                        lambda level, msg, depth=2: lines.append(msg))
    monkeypatch.setattr(tconfig, "_workers", weakref.WeakSet())
    key = ("config.sanitize", "worker threads")
    glog.reset_warn_once(key)
    try:
        with tconfig.sanitize():
            pass
        assert lines == []
        pipe = HostPipeline(workers=2)
        try:
            for _ in range(2):
                with tconfig.sanitize():
                    pass
        finally:
            pipe.close()
        assert len(lines) == 1 and "process-wide" in lines[0]
        glog.reset_warn_once(key)
        with tconfig.sanitize():
            pass
        assert len(lines) == 1
        with tconfig.sanitize():
            HostPipeline().close()
        assert len(lines) == 2
    finally:
        glog.reset_warn_once(key)


@pytest.mark.parametrize("layout", ["flat", "shards"])
def test_bincount_counts_values_below_nbins(layout):
    """``ops/compact.bincount``, the one count of the shuffle (per-shard
    targets, a 2-D lane) and the dense groupby (slots, a flat lane): the
    values ``0 .. nbins-1`` of each row counted, the padding value
    ``nbins`` dropped, for int32 and int64 lanes; a meta lane gives a
    meta result of the same shape.  On the card each form it picks by
    the bin count is held by ``tests/test_torch_gpu.py``."""
    rng = np.random.default_rng(5)
    for dtype in (torch.int32, torch.int64):
        for nbins in (1, 2, 3, 4, 20, 5000):
            x = torch.from_numpy(rng.integers(0, nbins + 1, 4096)).to(dtype)
            if layout == "shards":
                x = x.view(8, -1)
            want = np.stack([np.bincount(r, minlength=nbins + 1)[:nbins]
                             for r in x.reshape(-1, x.shape[-1]).numpy()])
            got = bincount(x, nbins)
            assert got.dtype == torch.int64
            assert got.shape == x.shape[:-1] + (nbins,)
            assert np.array_equal(got.reshape(-1, nbins).numpy(), want)
            meta = bincount(x.to("meta"), nbins)
            assert meta.device.type == "meta" and meta.shape == got.shape


# ---------------------------------------------------------------------------
# set_broadcast_join_threshold validation (tests/test_sanitize.py:124-143)
# ---------------------------------------------------------------------------

def test_threshold_rejects_zero_negative_nonint():
    for bad in (0, -1, -(1 << 20), 0.5, 1.5, "128k", True, False):
        with pytest.raises(pt.CylonError, match="threshold"):
            tconfig.set_broadcast_join_threshold(bad)
    assert tconfig.broadcast_join_threshold() \
        == tconfig.DEFAULT_BROADCAST_JOIN_THRESHOLD


def test_threshold_none_disables_and_roundtrips():
    prev = tconfig.set_broadcast_join_threshold(None)
    try:
        assert tconfig.broadcast_join_threshold() <= 0
        back = tconfig.set_broadcast_join_threshold(4096)
        assert back is None
        assert tconfig.broadcast_join_threshold() == 4096
    finally:
        tconfig.set_broadcast_join_threshold(prev)
    assert tconfig.broadcast_join_threshold() \
        == tconfig.DEFAULT_BROADCAST_JOIN_THRESHOLD
