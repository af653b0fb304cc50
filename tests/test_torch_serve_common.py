"""Shared harness of the serving-layer parity tests (a plain module of
helpers and the ``serve_state`` fixture, like ``test_torch_common``; it
holds no test): one scenario, written once against a package namespace
(:class:`Pkg`), runs through the JAX package and through the port on the
same numpy-seeded tables at the same world, and the two observations are
compared.

An observation is a dict.  Its ``frames`` entry (a list of pandas
frames, row order ignored) is compared with ``float_rtols``' tolerances:
keys, counts and integers exactly, float64 to 1e-12 and float32 to 1e-6
relative.  Every other entry — ``serve.*`` / ``matview.*`` counters,
session tallies, handle fields, admission decisions, error types — must
be equal.

Batch windows are made deterministic with :func:`held`: the dispatcher
is parked before the queue's next wait, every submission lands, and
only then does it wake, so both packages see the same windows.
"""
from __future__ import annotations

import contextlib
import importlib
import threading
import time
import types

import numpy as np
import pandas as pd
import pytest

WORLDS = (1, 8)
TIMEOUT = 600
# session tallies that are host-clock readings, not decisions
TIMING_STATS = ("p50_ms", "p99_ms", "p999_ms", "queue_depth",
                "batch_window_ms")


class Pkg:
    """One package's modules under package-neutral names."""

    def __init__(self, root: str):
        def m(name):
            return importlib.import_module(f"{root}.{name}")
        self.name = root
        self.root = importlib.import_module(root)
        self.config = m("config")
        self.faults = m("faults")
        self.trace = m("trace")
        self.plan = m("plan")
        self.resilience = m("resilience")
        self.topology = m("topology")
        self.glog = m("logging")
        self.status = m("status")
        self.serve = m("serve")
        self.session = m("serve.session")
        self.admission = m("serve.admission")
        self.matview = m("serve.matview")
        self.router = m("serve.router")
        self.dops = m("parallel.dist_ops")
        self.broadcast = m("parallel.broadcast")
        self.shuffle = m("parallel.shuffle")
        self.DTable = m("parallel.dtable").DTable
        self.flightrec = m("observe.flightrec")
        self.obstats = m("observe.stats")
        self.metrics = m("observe.metrics")
        self.exporter = m("observe.exporter")
        self.timeseries = m("observe.timeseries")
        self.histogram = m("observe.histogram")
        self.pool = m("spill.pool")
        self.sketch = m("ops.sketch")
        self.queries = m("tpch.queries")
        self.JoinConfig = self.config.JoinConfig
        self.CylonError = self.status.CylonError

    def __repr__(self) -> str:
        return f"Pkg({self.name})"


_PKGS = {}


def pkgs():
    """``(JAX, port)`` namespaces (made once per process)."""
    if not _PKGS:
        _PKGS["jax"] = Pkg("cylon_tpu")
        _PKGS["torch"] = Pkg("cylon_tpu_torch")
    return _PKGS["jax"], _PKGS["torch"]


_TCTX = {}


def contexts(dctx, world: int):
    """``{pkg name: context}`` at ``world``: the JAX context over the
    first ``world`` virtual CPU devices, the port's on the CPU (one per
    world, as the plan cache keys on the context)."""
    import cylon_tpu as ct
    import cylon_tpu_torch as pt
    jctx = dctx if world == 8 else ct.CylonContext(
        {"backend": "tpu", "devices": dctx.devices[:world]})
    tctx = _TCTX.setdefault(world, pt.CylonContext(device="cpu",
                                                   world=world))
    return {"cylon_tpu": jctx, "cylon_tpu_torch": tctx}


def reset(P) -> None:
    """Forget every module-level lever a serving run touches."""
    P.trace.reset()
    P.flightrec.clear()
    P.plan.clear_plan_cache()
    P.broadcast.clear_replica_cache()
    P.shuffle.clear_chunk_state()
    P.pool.clear_pool()
    P.obstats.STORE.clear()
    P.topology.reset()
    P.faults.uninstall()
    P.glog.reset_warn_once()


@pytest.fixture
def serve_state():
    """Counters on in both packages and every lever reset before and
    after the test; the knobs a scenario may set are restored."""
    J, T = pkgs()
    saved = []
    for P in (J, T):
        P.trace.enable_counters()
        reset(P)
        saved.append((P, P.config.broadcast_join_threshold(),
                      P.resilience.recovery_policy(),
                      P.resilience.retry_policy()))
    yield
    for P, thr, rpol, retry in saved:
        P.config.set_broadcast_join_threshold(thr or None)
        P.resilience.set_recovery_policy(rpol)
        P.resilience.set_retry_policy(retry)
        P.config.set_device_memory_budget(None)
        P.config.set_host_memory_budget(None)
        P.config.set_recovery_enabled(None)
        P.config.set_remesh_cooldown_ms(None)
        P.config.set_metrics_port(None)
        P.config.set_event_log_path(None)
        P.matview.set_matview_enabled(None)
        P.matview.set_matview_min_runs(None)
        P.matview.set_matview_min_benefit(None)
        P.exporter.stop()
        P.exporter.stop_event_log()
        P.trace.disable_counters()
        P.trace.disable()
        reset(P)


def run_both(dctx, world, scenario, *args):
    """``(JAX observation, port observation)`` of ``scenario(P, ctx,
    *args)`` at ``world``; each package starts from reset state."""
    ctxs = contexts(dctx, world)
    out = []
    for P in pkgs():
        reset(P)
        out.append(scenario(P, ctxs[P.name], *args))
    return out[0], out[1]


# ---------------------------------------------------------------------------
# reading results
# ---------------------------------------------------------------------------

def frame(res) -> pd.DataFrame:
    """A result (DTable, Table or frame) as a frame with its rows sorted
    and categorical columns as strings."""
    if not isinstance(res, pd.DataFrame):
        if not hasattr(res, "to_pandas"):
            res = res.to_table()
        res = res.to_pandas()
    df = res.copy()
    for c in df.columns:
        if isinstance(df[c].dtype, pd.CategoricalDtype):
            df[c] = df[c].astype(str)
    if len(df.columns) and len(df):
        df = df.sort_values(list(df.columns)).reset_index(drop=True)
    return df


def _rtol(s: pd.Series) -> float:
    dt = s.dtype
    if dt == np.float32 or str(dt) == "Float32":
        return 1e-6
    if pd.api.types.is_float_dtype(dt):
        return 1e-12
    return 0.0


def assert_frames_equal(got: pd.DataFrame, want: pd.DataFrame,
                        rtol=None) -> None:
    """The same columns and rows: keys, counts and integers exactly,
    floats within ``float_rtols``' tolerance (or ``rtol``), nulls and
    NaN in the same cells."""
    got, want = frame(got), frame(want)
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want), (len(got), len(want))
    for c in got.columns:
        tol = _rtol(want[c]) if rtol is None else rtol
        if tol:
            g = got[c].to_numpy(np.float64, na_value=np.nan)
            w = want[c].to_numpy(np.float64, na_value=np.nan)
            assert np.array_equal(np.isnan(g), np.isnan(w)), c
            ok = ~np.isnan(w)
            np.testing.assert_allclose(g[ok], w[ok], rtol=tol, atol=0,
                                       err_msg=c)
        else:
            assert got[c].astype(str).tolist() \
                == want[c].astype(str).tolist(), c


def assert_same(got: dict, want: dict) -> None:
    """The port's observation equals the JAX package's: ``frames``
    within tolerance, everything else exactly."""
    assert set(got) == set(want), (sorted(got), sorted(want))
    for k in want:
        if k == "frames":
            assert len(got[k]) == len(want[k])
            for g, w in zip(got[k], want[k]):
                assert_frames_equal(g, w)
        else:
            assert got[k] == want[k], (k, got[k], want[k])


def counters(P, prefixes=("serve.", "matview.")) -> dict:
    """The package's counters under ``prefixes``."""
    return {k: v for k, v in P.trace.counters().items()
            if k.startswith(prefixes)}


def tallies(stats: dict) -> dict:
    """A session's ``stats()`` without its host-clock readings."""
    return {k: v for k, v in stats.items() if k not in TIMING_STATS}


def handle_obs(h, counter_keys=("fault.injected", "retry.attempts",
                                "retry.exhausted",
                                "recover.stage_retries",
                                "recover.recovered")) -> dict:
    """What a handle says about its query, comparable across packages."""
    return {"status": h.status, "view": h.view, "deferrals": h.deferrals,
            "probe": h.probe, "recovered": h.recovered,
            "deadline_missed": h.deadline_missed,
            "error": None if h.error is None else type(h.error).__name__,
            "shared": sorted(h.shared_subplans),
            "counters": {k: h.counters.get(k, 0) for k in counter_keys}}


def wait_all(handles) -> None:
    for h in handles:
        h._event.wait(TIMEOUT)


# ---------------------------------------------------------------------------
# deterministic windows
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def held(session):
    """Park ``session``'s dispatcher before its next queue wait for the
    length of the block: everything submitted inside lands in ONE batch
    window when the block exits."""
    gate = threading.Event()
    orig = session._queue.wait_nonempty

    def gated(timeout=None):
        gate.wait()
        return orig(timeout)

    session._queue.wait_nonempty = gated
    time.sleep(0.08)   # the wait in progress times out (0.05 s) first
    try:
        yield
    finally:
        gate.set()


# ---------------------------------------------------------------------------
# data and plans
# ---------------------------------------------------------------------------

def dtables(P, ctx, frames: dict) -> dict:
    """FRESH DTables of ``frames`` (name → frame) in ``P``."""
    return {k: P.DTable.from_pandas(ctx, df) for k, df in frames.items()}


def fact_dim_frames(seed=5, n=4000, keys=60):
    """``tests/test_serve.py``'s fact (int32 key, two float32 values)
    and dim tables."""
    rng = np.random.default_rng(seed)
    fact = pd.DataFrame({
        "k": rng.integers(0, keys, n).astype(np.int32),
        "a": rng.random(n).astype(np.float32),
        "b": rng.random(n).astype(np.float32)})
    dim = pd.DataFrame({"k": np.arange(keys, dtype=np.int32),
                        "w": np.arange(keys, dtype=np.float32)})
    return {"fact": fact, "dim": dim}


def two_stage_frames(seed=5):
    """``tests/test_recovery.py``'s two-stage tables: int64 keys, float64
    values."""
    rng = np.random.default_rng(seed)
    fact = pd.DataFrame({"k": rng.integers(0, 400, 5000).astype(np.int64),
                         "v": rng.random(5000)})
    dim = pd.DataFrame({"k": np.arange(400, dtype=np.int64),
                        "w": rng.random(400)})
    return {"fact": fact, "dim": dim}


def base_df(n=1200, groups=16, seed=0):
    """``tests/test_matview.py``'s base table."""
    rng = np.random.default_rng(seed)
    return pd.DataFrame({
        "k": rng.integers(0, groups, n).astype(np.int64),
        "v": rng.normal(size=n),
        "w": rng.integers(0, 100, n).astype(np.int64)})


_OPS = {}


def ops(P):
    """The plans of the serving tests for package ``P``, made once per
    process so repeated submissions share code and captured-value
    identities (the breaker's and the view store's fingerprint, the
    execution memo's keys)."""
    got = _OPS.get(P.name)
    if got is not None:
        return got
    d = P.dops
    JC = P.JoinConfig

    def join_groupby(t):
        j = d.dist_join(t["fact"], t["dim"], JC.InnerJoin("k", "k"))
        return d.dist_groupby(j, ["lt-k"], [("rt-w", "sum"),
                                            ("lt-a", "sum")])

    def shuffle_groupby(t):
        s = d.shuffle_table(t["fact"], ["k"])
        return d.dist_groupby(s, ["k"], [("a", "sum"), ("b", "sum")])

    def wide_exchange(t):
        s = d.shuffle_table(t["fact"], ["k"])
        g1 = d.dist_groupby(s, ["k"], [("a", "sum")])
        g2 = d.dist_groupby(s, ["k"], [("b", "max")])
        return d.dist_join(g1, g2, JC.InnerJoin("k", "k"))

    def two_stage(t):
        j = d.dist_join(t["fact"], t["dim"], JC.InnerJoin(0, 0))
        return d.dist_groupby(j, ["lt-k"], [("rt-w", "sum")])

    def agg_v(t):
        return d.dist_aggregate(t["fact"], [("v", "sum")])

    def q_agg(t):
        s = d.shuffle_table(t["fact"], ["k"])
        return d.dist_groupby(s, ["k"], [("v", "sum"), ("v", "count"),
                                         ("v", "mean"), ("w", "min"),
                                         ("w", "max")])

    def q_sum(t):
        s = d.shuffle_table(t["fact"], ["k"])
        return d.dist_groupby(s, ["k"], [("v", "sum"), ("v", "count")])

    def q_mean(t):
        s = d.shuffle_table(t["fact"], ["k"])
        return d.dist_groupby(s, ["k"], [("v", "mean"), ("w", "max")])

    def q_sort(t):
        return d.dist_sort(t["fact"], ["k", "v"])

    def q_composite(t):
        s = d.shuffle_table(t["fact"], ["k", "k2"])
        return d.dist_groupby(s, ["k", "k2"],
                              [("v", "sum"), ("v", "mean"),
                               ("w", "min"), ("w", "max")])

    def q_sketch(t):
        return d.dist_groupby_sketch(t["fact"], ["g"],
                                     [("ids", "approx_distinct"),
                                      ("x", "approx_quantile:0.5")])

    def q_nonfold(t):
        s = d.shuffle_table(t["fact"], ["k"])
        g = d.dist_groupby(s, ["k"], [("v", "sum"), ("v", "count")])
        return d.dist_select(g, lambda c: c["sum_v"] > -1e18)

    def qa(t):
        s = d.shuffle_table(t["fact"], ["k"])
        return d.dist_groupby(s, ["k"], [("v", "sum")])

    def qb(t):
        s = d.shuffle_table(t["fact"], ["k"])
        return d.dist_groupby(s, ["k"], [("w", "max")])

    def qc(t):
        s = d.shuffle_table(t["fact"], ["k"])
        return d.dist_groupby(s, ["k"], [("v", "count"), ("w", "min")])

    got = _OPS[P.name] = types.SimpleNamespace(**{
        k: v for k, v in locals().items() if callable(v) and k not in (
            "m", "JC")})
    return got
