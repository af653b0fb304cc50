"""The port's pure host observability modules against the JAX package's
on the same inputs: histogram buckets, quantiles and merge / minus, the
metric catalogue, ``OrderedLock``'s inverted-order detection, the glog
line format and level gating; and, port only: the registry's typed
snapshot, the run-stats store (digests stable across processes,
``CYLON_STATS_PATH`` round trip, a corrupt file), the flight recorder
and ``doctor``, ``devmem``'s CPU fallback, and build observability."""
import io
import json
import os
import re
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from cylon_tpu import logging as jlog
from cylon_tpu.observe import histogram as jhist
from cylon_tpu.observe import locks as jlocks
from cylon_tpu.observe import metrics as jmetrics

from cylon_tpu_torch import config as tconfig
from cylon_tpu_torch import logging as tlog
from cylon_tpu_torch import trace as ttrace
from cylon_tpu_torch.observe import compile as tcompile
from cylon_tpu_torch.observe import devmem, doctor, flightrec
from cylon_tpu_torch.observe import histogram as thist
from cylon_tpu_torch.observe import locks as tlocks
from cylon_tpu_torch.observe import metrics as tmetrics
from cylon_tpu_torch.observe import stats as tstats

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _clean():
    ttrace.reset()
    flightrec.clear()
    yield
    ttrace.disable()
    ttrace.disable_counters()
    ttrace.reset()
    flightrec.clear()


# ---------------------------------------------------------------------------
# histogram
# ---------------------------------------------------------------------------

def _draws(seed, n=2000):
    rng = np.random.default_rng(seed)
    x = np.concatenate([rng.lognormal(2.0, 3.0, n), [0.0, -1.0, 8.0,
                                                      2.0 ** -40, 2.0 ** 70,
                                                      float("nan")]])
    return [float(v) for v in x]


def _fill(mod, values):
    h = mod.Histogram()
    for v in values:
        h.observe(v)
    return h


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_histogram_matches_jax(seed):
    a, b = _draws(seed), _draws(seed + 10, 500)
    th, jh = _fill(thist, a), _fill(jhist, a)
    assert th.to_dict() == jh.to_dict()
    for q in (0, 1, 50, 90, 99, 99.9, 100):
        assert th.quantile(q) == jh.quantile(q)
    assert list(th.cumulative()) == list(jh.cumulative())
    assert th.mean() == jh.mean()
    tb, jb = _fill(thist, b), _fill(jhist, b)
    assert th.copy().merge(tb).to_dict() == jh.copy().merge(jb).to_dict()
    # a window is the bucket-wise difference of two snapshots
    tw = th.copy().merge(tb).minus(th)
    jw = jh.copy().merge(jb).minus(jh)
    assert tw.to_dict() == jw.to_dict() and tw.count == len(b)
    assert thist.Histogram.from_dict(th.to_dict()).to_dict() == th.to_dict()
    for v in a[:50]:
        assert thist.bucket_exponent(v) == jhist.bucket_exponent(v)
    assert thist.Histogram().quantile(50) is None


# ---------------------------------------------------------------------------
# metrics catalogue + registry
# ---------------------------------------------------------------------------

def test_metric_catalogue_matches_jax():
    tm = {n: (s.kind, s.unit) for n, s in tmetrics.METRICS.items()}
    jm = {n: (s.kind, s.unit) for n, s in jmetrics.METRICS.items()}
    assert tm == jm
    assert list(tmetrics.METRICS) == list(jmetrics.METRICS)


def test_counter_delta_and_exchange_count_match_jax():
    before = {"shuffle.exchanges": 2, "shuffle.exchange_bytes_peak": 10,
              "host.read": 5}
    after = {"shuffle.exchanges": 5, "shuffle.exchange_bytes_peak": 30,
             "host.read": 5, "join.broadcast_gather": 1}
    assert tmetrics.counter_delta(before, after) == \
        jmetrics.counter_delta(before, after)
    assert tmetrics.exchange_count(after) == jmetrics.exchange_count(after)
    leaves = [torch.zeros(4, dtype=torch.int64), torch.zeros(4, 3),
              torch.zeros(4, dtype=torch.bool)]
    assert tmetrics.row_bytes(leaves) == 8 + 12 + 1


def test_registry_snapshot_is_typed():
    ttrace.enable_counters()
    ttrace.count("shuffle.rows_sent", 3)
    ttrace.count_max("shuffle.exchange_bytes_peak", 7)
    ttrace.count_max("shuffle.exchange_bytes_peak", 5)
    ttrace.gauge("broadcast.replica_cache_size", 2)
    ttrace.hist("serve.latency_ms", 3.0)
    snap = ttrace.snapshot()
    assert snap["counters"] == {"shuffle.rows_sent": 3}
    assert snap["watermarks"] == {"shuffle.exchange_bytes_peak": 7}
    assert snap["gauges"] == {"broadcast.replica_cache_size": 2}
    assert snap["histograms"]["serve.latency_ms"]["count"] == 1
    rep = ttrace.report()
    assert "counter shuffle.exchange_bytes_peak = 7 (max)" in rep
    assert "counter broadcast.replica_cache_size = 2 (gauge)" in rep


# ---------------------------------------------------------------------------
# locks
# ---------------------------------------------------------------------------

def _invert(mod, a_name, b_name):
    """Take A then B, then B then A: the second order closes a cycle."""
    a, b = mod.OrderedLock(a_name), mod.OrderedLock(b_name)
    with a:
        with b:
            pass
    with b:
        with a:
            pass
    return a, b


def test_ordered_lock_detects_inversion_like_jax():
    from cylon_tpu import config as jconfig
    jprev = jconfig.set_lockcheck(True)
    tprev = tconfig.set_lockcheck(True)
    try:
        with pytest.raises(jlocks.LockOrderViolation) as je:
            _invert(jlocks, "t.obs.ja", "t.obs.jb")
        with pytest.raises(tlocks.LockOrderViolation) as te:
            _invert(tlocks, "t.obs.ta", "t.obs.tb")
    finally:
        jconfig.set_lockcheck(jprev)
        tconfig.set_lockcheck(tprev)
    assert je.value.cycle == ["t.obs.ja", "t.obs.jb", "t.obs.ja"]
    assert te.value.cycle == ["t.obs.ta", "t.obs.tb", "t.obs.ta"]
    g = tlocks.lock_graph()
    assert "t.obs.tb" in g["t.obs.ta"] and "t.obs.ta" not in g.get(
        "t.obs.tb", {})


def test_ordered_lock_without_enforcement_warns_and_records():
    tconfig.set_lockcheck(False)
    ttrace.enable_counters()
    buf = io.StringIO()
    tlog.set_sink(buf)
    try:
        a, b = _invert(tlocks, "t.obs.wa", "t.obs.wb")
    finally:
        tlog.set_sink(sys.stderr)
        tconfig.set_lockcheck(None)
    assert "lock-order violation" in buf.getvalue()
    c = ttrace.counters()
    assert c["lock.order_violations"] == 1 and c["lock.acquires"] >= 4
    kinds = [e["kind"] for e in flightrec.events()]
    assert "lock_edge" in kinds and "lock_violation" in kinds
    assert a.acquires == 2 and b.acquires == 2


def test_ordered_lock_reentrant_and_condition():
    lk = tlocks.OrderedLock("t.obs.re", reentrant=True)
    with lk:
        with lk:
            assert lk.locked()
    assert not lk.locked()
    cv = threading.Condition(tlocks.OrderedLock("t.obs.cv"))
    with cv:
        cv.notify_all()


# ---------------------------------------------------------------------------
# glog
# ---------------------------------------------------------------------------

def test_glog_format_and_levels_match_jax():
    outs = []
    for mod in (jlog, tlog):
        buf = io.StringIO()
        mod.set_sink(buf)
        prev_v = mod._verbosity
        try:
            mod.info("hello %d", 42)
            mod.error("bad thing")
            mod.vlog(5, "too verbose")
            mod.set_verbosity(5)
            mod.vlog(5, "now visible")
            mod.set_min_level(mod.ERROR)
            mod.warning("gated")
            mod.error("still shown")
            mod.reset_warn_once("k")
            # the key is spent even when the level gates the line
            assert mod.warn_once("k", "once") is True
            assert mod.warn_once("k", "once") is False
        finally:
            mod.set_min_level(mod.INFO)
            mod.set_verbosity(prev_v)
            mod.set_sink(sys.stderr)
        lines = buf.getvalue().splitlines()
        # the glog shape: severity letter, MMDD hh:mm:ss.micros file:line]
        for ln in lines:
            assert re.match(r"^[IWEF]\d{4} \d\d:\d\d:\d\d\.\d{6} "
                            r"test_torch_observe\.py:\d+\] ", ln), ln
        outs.append([(ln[0], ln.split("] ", 1)[1]) for ln in lines])
    assert outs[0] == outs[1] == [
        ("I", "hello 42"), ("E", "bad thing"), ("I", "now visible"),
        ("E", "still shown")]


def test_warn_once_emits_once_across_threads():
    buf = io.StringIO()
    tlog.set_sink(buf)
    tlog.reset_warn_once("race")
    fired = []
    try:
        ts = [threading.Thread(
            target=lambda: fired.append(tlog.warn_once("race", "x")))
            for _ in range(8)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
    finally:
        tlog.set_sink(sys.stderr)
    assert fired.count(True) == 1
    assert buf.getvalue().count("] x") == 1


# ---------------------------------------------------------------------------
# run-stats store
# ---------------------------------------------------------------------------

KEY = (("cpu", 8, 256, None),
       (("dist_join", ("inner", "hash"), (("k", 9), ("v", 12)), (1, 2),
         ()), ("scan", (), (("k", 9),), (), ((1000, 8),))))


def test_plan_digest_is_stable_across_processes():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import torch\n"
            "from cylon_tpu_torch.observe.stats import plan_digest\n"
            "print(plan_digest((%r, torch.device('cpu'), torch.int32)))\n"
            % (str(ROOT), KEY))
    got = [subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, check=True).stdout.strip()
           for _ in range(2)]
    here = tstats.plan_digest((KEY, torch.device("cpu"), torch.int32))
    assert got[0] == got[1] == here
    assert len(here) == 20 and here != tstats.plan_digest(KEY)


def test_stats_store_round_trips_through_the_env_path(tmp_path,
                                                      monkeypatch):
    path = tmp_path / "stats.json"
    monkeypatch.setenv("CYLON_STATS_PATH", str(path))
    store = tstats.StatsStore()
    store.record_run("abc", counters={"shuffle.exchanges": 2},
                     latency_ms=1.5, label="q1")
    store.save()
    data = json.loads(path.read_text())
    assert data["abc"]["runs"] == 1 and data["abc"]["label"] == "q1"
    again = tstats.StatsStore()
    rec = again.get("abc")
    assert rec["counters"] == {"shuffle.exchanges": 2}
    assert rec["latency_ms"] == 1.5
    assert again.fingerprints() == ["abc"]


def test_stats_store_tolerates_a_corrupt_file(tmp_path):
    path = tmp_path / "bad.json"
    path.write_text("{not json")
    store = tstats.StatsStore(str(path))
    assert store.fingerprints() == []
    store.record_run("d1", latency_ms=2.0)
    store.save()
    assert tstats.StatsStore(str(path)).get("d1")["latency_ms"] == 2.0


def test_note_plan_only_inside_a_collector():
    assert tstats.note_plan(KEY) is None
    with tstats.collect_digests() as ds:
        d = tstats.note_plan(KEY)
        tstats.note_plan(KEY)
    assert ds == [d]


def test_analyzed_optimized_run_is_recorded():
    import cylon_tpu_torch as pt
    from cylon_tpu_torch import plan as tplan
    from cylon_tpu_torch.parallel import DTable, dist_ops
    ctx = pt.CylonContext(device="cpu", world=4)
    t = pt.Table.from_columns(ctx, {"k": np.arange(100) % 7,
                                    "v": np.arange(100.0)})
    dt = DTable.from_table(ctx, t)
    tplan.clear_plan_cache()
    tstats.STORE.clear()
    try:
        rep = dt.explain(
            lambda x: dist_ops.dist_groupby(x, ["k"], [("v", "sum")]),
            analyze=True, optimize=True)
        assert rep.ok and rep.stats_digests
        rec = tstats.STORE.get(rep.stats_digests[0])
        assert rec["runs"] == 1
        assert [n["op"] for n in rec["nodes"]] == [n.op for n in rep.nodes]
        assert tstats.STORE.observed_rows(rep.stats_digests[0])
    finally:
        tstats.STORE.clear()
        tplan.clear_plan_cache()


# ---------------------------------------------------------------------------
# flight recorder + doctor
# ---------------------------------------------------------------------------

def test_flightrec_dump_renders_with_doctor(tmp_path, capsys):
    ttrace.enable()
    with ttrace.span("join.shuffle"):
        ttrace.count("shuffle.exchanges")
    flightrec.note("query", qid=1, label="q1", status="ok", latency_ms=3)
    flightrec.note("lock_hold", lock="x", held_ms=2000, watchdog_ms=1000,
                   thread="main")
    path = flightrec.dump(str(tmp_path / "b.json"), reason="test")
    doc = json.loads(Path(path).read_text())
    assert doc["config"]["torch"] == torch.__version__
    assert doc["config"]["platform"] in ("cpu", "gpu")
    assert doc["trace"]["traceEvents"]
    assert doctor.main([path]) == 0
    out = capsys.readouterr().out
    assert "flight-recorder bundle" in out and "join.shuffle" in out
    assert "lock hold-time watchdog" in out and "q1" in out


def test_doctor_cli_exit_codes(tmp_path):
    path = flightrec.dump(str(tmp_path / "ok.json"))
    run = lambda *a: subprocess.run(  # noqa: E731
        [sys.executable, "-m", "cylon_tpu_torch.observe.doctor", *a],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    ok = run(path)
    assert ok.returncode == 0 and "config fingerprint" in ok.stdout
    missing = run(str(tmp_path / "missing.json"))
    assert missing.returncode == 2 and "cannot read bundle" in missing.stderr
    (tmp_path / "x.json").write_text("[1, 2]")
    assert run(str(tmp_path / "x.json")).returncode == 2
    assert run().returncode == 2


def test_flightrec_auto_dump_is_capped(tmp_path, monkeypatch):
    monkeypatch.setenv("CYLON_FLIGHTREC_DIR", str(tmp_path))
    paths = [flightrec.maybe_dump_on_error("t", ValueError("x"))
             for _ in range(flightrec.MAX_AUTO_DUMPS + 2)]
    assert sum(p is not None for p in paths) == flightrec.MAX_AUTO_DUMPS
    assert ttrace.counters()["flightrec.dumps_suppressed"] == 2
    monkeypatch.delenv("CYLON_FLIGHTREC_DIR")
    assert flightrec.maybe_dump_on_error("t", ValueError("x")) is None


# ---------------------------------------------------------------------------
# devmem + builds
# ---------------------------------------------------------------------------

def test_devmem_cpu_fallback_is_not_the_allocator():
    x = torch.ones(1 << 16, dtype=torch.float64)
    s = devmem.snapshot("cpu")
    assert s.source == "live-tensors" and s.source != "memory_stats"
    assert s.peak_bytes is None and s.live_bytes >= x.numel() * 8
    before = devmem.snapshot("cpu")
    y = torch.zeros(1 << 18, dtype=torch.uint8)
    after = devmem.snapshot("cpu")
    assert devmem.observed_exchange_bytes(before, after) >= y.numel()
    assert devmem.observed_exchange_bytes(None, after) is None


def test_kernel_factory_counts_builds_and_storms():
    tcompile.clear_state()
    ttrace.enable_counters()
    buf = io.StringIO()
    tlog.set_sink(buf)
    tlog.reset_warn_once(("compile.storm", "_sized_fn"))

    @tcompile.kernel_factory
    def _sized_fn(block: int):
        return lambda x: x[:block]

    try:
        x = torch.arange(64)
        with tcompile.attribute_compiles() as events:
            _sized_fn(4)(x)
            _sized_fn(4)(x)       # factory hit, signature seen
            for b in range(1, 9):
                _sized_fn(b)(x)
    finally:
        tlog.set_sink(sys.stderr)
    c = ttrace.counters()
    assert c["compile.cache_misses"] == 8 and c["compile.cache_hits"] == 2
    assert c["compile.builds"] == 8 == len(events)
    assert c["compile.storms"] == 1
    assert "block=1/2/3/4/5/6" in buf.getvalue()
    assert _sized_fn.cache_info().currsize == 8
    _sized_fn.cache_clear()
    tcompile.clear_state()


def test_nvcc_build_is_a_build_event(monkeypatch):
    """The partition-hash library's build and load is one build event; a
    library already loaded is a cache hit (the build is stubbed here: no
    nvcc on the CPU)."""
    from cylon_tpu_torch.ops import hash_cuda

    class _Fn:
        argtypes = restype = None

    class _Lib:   # the library's two entries
        cylon_partition_hash = _Fn()
        cylon_partition_hash_chained = _Fn()

    monkeypatch.setattr(hash_cuda, "_lib", None)
    monkeypatch.setattr(hash_cuda, "build", lambda: "libstub.so")
    monkeypatch.setattr(hash_cuda.ctypes, "CDLL", lambda p: _Lib())
    ttrace.enable()
    with tcompile.attribute_compiles() as events:
        hash_cuda.load()
        hash_cuda.load()
    c = ttrace.counters()
    assert c["compile.builds"] == 1 and c["compile.cache_misses"] == 1
    assert c["compile.cache_hits"] == 1
    assert [e["factory"] for e in events] == ["hash_cuda.load"]
    assert [n for n, _, _ in ttrace.get_spans()] == ["compile.build"]


def test_trace_env_switch():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from cylon_tpu_torch import trace\n"
            "print(trace.enabled())\n" % str(ROOT))
    env = dict(os.environ, CYLON_TRACE="1")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == "True"
