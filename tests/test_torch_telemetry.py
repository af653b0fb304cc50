"""The live telemetry plane of the serving layer against the JAX
package's, from ``tests/test_telemetry.py`` and
``tests/test_live_telemetry.py``: the OpenMetrics exposition
(``observe/exporter.py``: the rendered text, the endpoint, its start from
``config.metrics_port`` when a session starts, the event log and its
rotation, the knobs), the time-series sampler (``observe/timeseries.py``:
the ring, validation, the typed empty summary, sampling without a device
sync, sampling a serving session, the SLO alerts), and the session's
telemetry surfaces (the query-lifecycle tracks of a Chrome export under
concurrent serving, the queue-wait span's admission evidence, run-stats
records of served executions, the histogram percentiles and the
``telemetry_window`` cursor, tail sampling on and off).

Where the two packages render the same registry, the text must be the
same; where a scenario serves queries, its tallies and counters must be
the JAX package's.
"""
import json
import os
import re
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pandas as pd
import pytest

from test_torch_serve_common import (TIMEOUT, WORLDS, assert_same, counters,
                                     dtables, held, pkgs, run_both, tallies)
from test_torch_serve_common import serve_state  # noqa: F401
from test_torch_common import jax_trace_shim  # noqa: F401

pytestmark = pytest.mark.usefixtures("serve_state", "jax_trace_shim")

_OPS = {}


def _plans(P):
    """``(groupby plan, join plan, sort plan)`` over ``{"l", "r"}``."""
    if P.name not in _OPS:
        d, JC = P.dops, P.JoinConfig

        def gb(t):
            return d.dist_groupby(d.shuffle_table(t["l"], ["k"]), ["k"],
                                  [("a", "sum")])

        def jn(t):
            j = d.dist_join(t["l"], t["r"], JC.InnerJoin("k", "k"))
            return d.dist_groupby(j, ["lt-k"], [("rt-b", "sum")])

        def srt(t):
            return d.dist_sort(t["l"], "k")
        _OPS[P.name] = (gb, jn, srt)
    return _OPS[P.name]


def _frames(seed=3, n_l=400, n_r=40):
    rng = np.random.default_rng(seed)
    return {"l": pd.DataFrame({"k": rng.integers(0, n_r, n_l),
                               "a": rng.normal(size=n_l)}),
            "r": pd.DataFrame({"k": np.arange(n_r),
                               "b": rng.normal(size=n_r)})}


def _strip_info(text: str) -> str:
    """OpenMetrics text without the config-fingerprint info line (its
    labels name each package's own versions)."""
    return "\n".join(ln for ln in text.splitlines()
                     if not ln.startswith("cylon_observe_config_info{"))


# ---------------------------------------------------------------------------
# the exporter
# ---------------------------------------------------------------------------

def test_openmetrics_text_equals_jax():
    """The same registry contents render the same exposition (the
    config-info line aside), catalogued families only, ``# EOF`` last."""
    texts = []
    for P in pkgs():
        P.trace.reset()
        P.trace.count("serve.completed", 3)
        P.trace.count("serve.view_hits", 2)
        P.trace.count("not.catalogued", 1)
        P.trace.gauge("serve.queue_depth", 4)
        P.trace.count_max("shuffle.exchange_bytes_peak", 4096)
        for v in (0.7, 12.5, 12.5, 900.0):
            P.trace.hist("serve.latency_ms", v)
        body = P.exporter.render_openmetrics()
        assert body.endswith("# EOF\n")
        texts.append((_strip_info(body), P.trace.counters().get(
            "observe.export_skipped", 0)))
    assert texts[1] == texts[0]
    assert "cylon_serve_completed_total 3" in texts[1][0]
    assert 'cylon_serve_latency_ms_bucket{le="+Inf"} 4' in texts[1][0]
    assert texts[1][1] >= 1     # the uncatalogued name was refused


def test_openmetrics_scrape_catalogued_and_terminated():
    _, T = pkgs()
    T.trace.reset()
    T.trace.count("serve.completed", 3)
    T.trace.hist("serve.latency_ms", 12.5)
    port = T.exporter.start(0)
    assert T.exporter.running() and T.exporter.port() == port
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                timeout=30) as resp:
        assert "text/plain" in resp.headers["Content-Type"]
        body = resp.read().decode("utf-8")
    assert body.endswith("# EOF\n")
    assert "cylon_serve_completed_total 3" in body
    assert "cylon_serve_latency_ms_count 1" in body
    assert "cylon_observe_config_info{" in body
    fams = {T.exporter.family_name(n) for n in T.metrics.METRICS}
    for m in re.finditer(r"^# TYPE (\S+) (\S+)$", body, re.M):
        assert m.group(1) in fams, m.group(1)
    assert T.trace.counters()["observe.export_scrapes"] >= 1
    assert T.exporter.start(0) == port
    with pytest.raises(urllib.error.HTTPError):
        urllib.request.urlopen(f"http://127.0.0.1:{port}/nope", timeout=30)
    T.exporter.stop()
    assert not T.exporter.running()


def test_session_starts_endpoint_from_config_and_scrape_never_syncs(dctx):
    """``config.set_metrics_port(0)``: the session's construction brings
    the endpoint up on an ephemeral loopback port; a scrape during
    serving carries the ``serve_`` families and adds no device sync."""
    frames_ = _frames()
    _, T = pkgs()
    from test_torch_serve_common import contexts
    ctx = contexts(dctx, 8)["cylon_tpu_torch"]
    T.config.set_metrics_port(0)
    tabs = dtables(T, ctx, frames_)
    gb = _plans(T)[0]
    with T.serve.ServeSession(ctx, tables=tabs, batch_window_ms=0.0) as s:
        port = T.exporter.port()
        assert port
        s.submit(gb, label="a").result(TIMEOUT)
        syncs = T.trace.counters().get("trace.sync", 0)
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                    timeout=30) as resp:
            body = resp.read().decode("utf-8")
        assert T.trace.counters().get("trace.sync", 0) == syncs
    assert "cylon_serve_completed_total 1" in body
    assert "cylon_serve_admitted_total 1" in body
    assert "cylon_serve_latency_ms_bucket" in body


def test_event_log_streams_flightrec_and_rotates(tmp_path):
    _, T = pkgs()
    path = str(tmp_path / "events.jsonl")
    w = T.exporter.start_event_log(path, max_bytes=400)
    assert T.exporter.event_log_writer() is w
    for i in range(20):
        T.flightrec.note("slo_alert", rule="p99-drift", i=i)
    T.exporter.stop_event_log()
    assert T.exporter.event_log_writer() is None
    assert os.path.exists(path + ".1")
    kinds = []
    for p in (path + ".1", path):
        with open(p, encoding="utf-8") as fh:
            for line in fh:
                ev = json.loads(line)
                kinds.append(ev["kind"])
                assert "t" in ev
    assert kinds and set(kinds) == {"slo_alert"}
    prev = T.flightrec.set_tap(lambda ev: 1 / 0)
    try:
        T.flightrec.note("still_fine")
    finally:
        T.flightrec.set_tap(prev)


def test_config_knobs_validate(monkeypatch):
    monkeypatch.delenv("CYLON_METRICS_PORT", raising=False)
    monkeypatch.delenv("CYLON_EVENT_LOG", raising=False)
    for P in pkgs():
        cfg = P.config
        for bad in (True, -1, 70000, "9184"):
            with pytest.raises(P.CylonError):
                cfg.set_metrics_port(bad)
        prev = cfg.set_metrics_port(9184)
        assert cfg.metrics_port() == 9184
        cfg.set_metrics_port(prev)
        assert cfg.metrics_port() is None
        monkeypatch.setenv("CYLON_METRICS_PORT", "not-a-port")
        with pytest.raises(P.CylonError):
            cfg.metrics_port()
        monkeypatch.setenv("CYLON_METRICS_PORT", "9185")
        assert cfg.metrics_port() == 9185
        monkeypatch.delenv("CYLON_METRICS_PORT")
        with pytest.raises(P.CylonError):
            cfg.set_event_log_path(7)
        prev = cfg.set_event_log_path("/tmp/x.jsonl")
        assert cfg.event_log_path() == "/tmp/x.jsonl"
        cfg.set_event_log_path(prev)
        monkeypatch.setenv("CYLON_EVENT_LOG", "/tmp/y.jsonl")
        assert cfg.event_log_path() == "/tmp/y.jsonl"
        monkeypatch.delenv("CYLON_EVENT_LOG")
        assert cfg.event_log_path() is None


# ---------------------------------------------------------------------------
# the time-series sampler
# ---------------------------------------------------------------------------

def test_sampler_ring_wraps_with_visible_retention():
    for P in pkgs():
        s = P.timeseries.TimeSeriesSampler(period_s=0.01, capacity=4)
        for _ in range(7):
            s.sample_once()
        samples = s.samples()
        assert len(samples) == 4 and s.dropped == 3
        ts = [x["t"] for x in samples]
        assert ts == sorted(ts)
        u = P.timeseries.TimeSeriesSampler(period_s=0.01, capacity=16)
        for _ in range(5):
            u.sample_once()
        assert len(u.samples()) == 5 and u.dropped == 0


def test_sampler_validation_and_typed_empty_summary():
    keys = []
    for P in pkgs():
        with pytest.raises(P.CylonError):
            P.timeseries.TimeSeriesSampler(period_s=0.0)
        with pytest.raises(P.CylonError):
            P.timeseries.TimeSeriesSampler(capacity=0)
        summary = P.timeseries.TimeSeriesSampler(period_s=60.0,
                                                 capacity=8).summary()
        assert summary["empty"] is True and summary["samples"] == 0
        keys.append(summary)
    assert keys[1] == keys[0]


def test_sampler_thread_samples_with_zero_device_syncs():
    _, T = pkgs()
    syncs0 = T.trace.counters().get("trace.sync", 0)
    with T.timeseries.TimeSeriesSampler(period_s=0.01, capacity=64) as s:
        time.sleep(0.08)
    assert len(s.samples()) >= 2
    assert T.trace.counters().get("trace.sync", 0) == syncs0


def test_sampler_anomaly_rules_equal_jax():
    """The same synthetic series fires the same alerts in both
    samplers (p99 drift, QPS collapse under queued demand, cache-hit
    collapse)."""
    def series(i):
        base = {"t": float(i), "completed": i, "failed": 0, "deferred": 0,
                "queue_depth": 0, "qps": 10.0, "p50_ms": 5.0,
                "p99_ms": 10.0, "cache_hit_ratio": 0.9,
                "subplan_shared": 0, "share_delta": 0,
                "exchange_bytes_peak": 0}
        if i == 9:
            base.update(p99_ms=100.0)
        if i == 10:
            base.update(qps=1.0, queue_depth=5)
        if i == 11:
            base.update(cache_hit_ratio=0.1)
        return base

    fired = []
    for P in pkgs():
        sm = P.timeseries.TimeSeriesSampler(period_s=60.0, capacity=64,
                                            min_history=8)
        for i in range(12):
            smp = series(i)
            sm._check_anomalies(smp)
            sm._append(smp)
        fired.append([(a["rule"], a["detail"]) for a in sm.alerts])
    assert fired[1] == fired[0]
    assert [r for r, _ in fired[1]] == ["p99-drift", "qps-collapse",
                                        "cache-hit-collapse"]


@pytest.mark.parametrize("world", WORLDS)
def test_sampler_over_serving_session(dctx, world):
    frames_ = _frames()

    def scenario(P, ctx):
        gb = _plans(P)[0]
        tabs = dtables(P, ctx, frames_)
        with P.serve.ServeSession(ctx, tables=tabs,
                                  batch_window_ms=10.0) as srv:
            sampler = P.timeseries.TimeSeriesSampler(
                period_s=0.02, capacity=256, session=srv)
            with sampler:
                with held(srv):
                    hs = [srv.submit(gb, label=f"s{i}") for i in range(4)]
                for h in hs:
                    h.result(TIMEOUT)
            st = srv.stats()
        samples = sampler.samples()
        summary = sampler.summary()
        assert any(s["p50_ms"] is not None for s in samples)
        assert max(s["qps"] for s in samples) > 0
        assert summary["samples"] == len(samples)
        return {"last": {k: samples[-1][k] for k in ("completed", "failed",
                                                     "deferred")},
                "final_completed": summary["final_completed"],
                "stats": tallies(st)}

    j, t = run_both(dctx, world, scenario)
    assert_same(t, j)
    assert t["last"]["completed"] == 4 and t["final_completed"] == 4


# ---------------------------------------------------------------------------
# the session's telemetry surfaces
# ---------------------------------------------------------------------------

def test_chrome_export_tracks_under_concurrent_serving(dctx):
    """Eight clients in one window: one named track per query, each with
    its queue wait, execution and async export, the same span names per
    track as the JAX package's, and monotone counter series."""
    frames_ = _frames()

    def scenario(P, ctx):
        jn = _plans(P)[1]
        tabs = dtables(P, ctx, frames_)
        P.trace.enable()
        P.trace.reset()
        handles = []
        with P.serve.ServeSession(ctx, tables=tabs,
                                  batch_window_ms=10.0) as s:
            with held(s):
                for i in range(8):
                    th = threading.Thread(target=lambda i=i: handles.append(
                        s.submit(jn, label=f"c{i}",
                                 export=lambda r: r.to_table().to_pandas())))
                    th.start()
                    th.join()
            for h in handles:
                h.result(TIMEOUT)
        doc = P.trace.export_chrome_trace(None)
        P.trace.disable()
        json.loads(json.dumps(doc))
        meta = {e["args"]["name"]: e["tid"] for e in doc["traceEvents"]
                if e.get("ph") == "M"}
        want = {f"query {h.trace_id}" for h in handles}
        assert want <= set(meta) and len({meta[w] for w in want}) == 8
        xs = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
        tracks = {}
        for h in handles:
            names = {e["name"] for e in xs
                     if e["args"].get("trace_id") == h.trace_id}
            assert {"serve.queue_wait", "serve.query",
                    "serve.export"} <= names, (h.trace_id, names)
            tracks[h.label] = sorted(n for n in names
                                     if n.startswith("serve."))
        series = {}
        for e in doc["traceEvents"]:
            if e.get("ph") == "C" and P.metrics.REGISTRY.kind_of(
                    e["name"]) == P.metrics.COUNTER:
                series.setdefault(e["name"], []).append(
                    e["args"][e["name"]])
        for name, vals in series.items():
            assert vals == sorted(vals), name
        return {"tracks": tracks}

    j, t = run_both(dctx, 8, scenario)
    assert t == j


@pytest.mark.parametrize("world", WORLDS)
def test_queue_wait_span_carries_admission_evidence(dctx, world):
    frames_ = _frames()

    def scenario(P, ctx):
        srt = _plans(P)[2]
        tabs = dtables(P, ctx, frames_)
        P.trace.enable()
        P.trace.reset()
        with P.serve.ServeSession(ctx, tables=tabs,
                                  batch_window_ms=10.0) as s:
            h = s.submit(srt, label="w")
            h.result(TIMEOUT)
        doc = P.trace.export_chrome_trace(None)
        P.trace.disable()
        qw = [e for e in doc["traceEvents"]
              if e.get("ph") == "X" and e["name"] == "serve.queue_wait"]
        assert len(qw) == 1 and h.queue_wait_ms >= 0
        assert qw[0]["args"]["trace_id"] == h.trace_id
        return {"args": {k: qw[0]["args"][k]
                         for k in ("priced_bytes", "deferrals")},
                "priced": h.priced_bytes}

    j, t = run_both(dctx, world, scenario)
    assert t == j
    assert t["args"]["priced_bytes"] == t["priced"]


@pytest.mark.parametrize("world", WORLDS)
def test_served_execution_records_run_stats(dctx, world):
    frames_ = _frames()

    def scenario(P, ctx):
        gb = _plans(P)[0]
        tabs = dtables(P, ctx, frames_)
        P.obstats.STORE.clear()
        with P.serve.ServeSession(ctx, tables=tabs,
                                  batch_window_ms=10.0) as s:
            h = s.submit(gb, label="sq")
            h.result(TIMEOUT)
        assert h.plan_digests
        rec = P.obstats.STORE.get(h.plan_digests[0])
        assert rec["latency_ms"] > 0
        n_before = len(P.obstats.STORE.fingerprints())
        ctx.optimize(gb, tabs).to_table()
        return {"n_digests": len(h.plan_digests), "label": rec["label"],
                "runs": rec["runs"],
                "eager_records": len(P.obstats.STORE.fingerprints())
                - n_before}

    j, t = run_both(dctx, world, scenario)
    assert t == j
    assert t["label"] == "sq" and t["eager_records"] == 0


def test_serve_stats_histogram_percentiles_and_window_cursor(dctx):
    frames_ = _frames()

    def scenario(P, ctx):
        gb = _plans(P)[0]
        tabs = dtables(P, ctx, frames_)
        with P.serve.ServeSession(ctx, tables=tabs,
                                  batch_window_ms=10.0) as s:
            for _ in range(3):
                s.submit(gb, export=lambda r: r.to_table().to_pandas()
                         ).result(TIMEOUT)
            st = s.stats()
            stats, win, cum = s.telemetry_window()
            _, win2, _ = s.telemetry_window(cursor=cum)
        assert st["p50_ms"] > 0
        assert st["p50_ms"] <= st["p99_ms"] <= st["p999_ms"]
        assert not hasattr(s, "_latencies")
        return {"counts": (cum.count, win.count, win2.count),
                "stats": tallies(stats)}

    j, t = run_both(dctx, 8, scenario)
    assert_same(t, j)
    assert t["counts"] == (3, 3, 0)


def test_serve_tail_sampling_keeps_slow_drops_fast(dctx):
    frames_ = _frames()
    _, T = pkgs()
    from test_torch_serve_common import contexts
    ctx = contexts(dctx, 8)["cylon_tpu_torch"]
    gb = _plans(T)[0]
    tabs = dtables(T, ctx, frames_)
    T.trace.enable()
    T.trace.reset()
    handles = []
    with T.serve.ServeSession(ctx, tables=tabs, batch_window_ms=10.0,
                              tail_keep_k=1) as s:
        for i in range(3):
            h = s.submit(gb, label=f"q{i}",
                         export=lambda r: r.to_table().to_pandas())
            h.result(TIMEOUT)
            handles.append(h)
        miss = s.submit(gb, label="slo", deadline_ms=0.001,
                        export=lambda r: r.to_table().to_pandas())
        miss.result(TIMEOUT)
    ids = {r[5] for r in T.trace.get_span_records(True) if r[5]}
    assert miss.trace_id in ids          # always kept: a deadline miss
    assert handles[0].trace_id in ids    # the first fills the k=1 heap
    assert {h.trace_id for h in handles[1:]} - ids
    assert T.trace.snapshot()["counters"]["trace.sampled_out"] > 0
    # tail sampling off: every trace retained
    T.trace.reset()
    with T.serve.ServeSession(ctx, tables=tabs, batch_window_ms=10.0,
                              tail_keep_k=None) as s:
        hs = [s.submit(gb, export=lambda r: r.to_table().to_pandas())
              for _ in range(3)]
        for h in hs:
            h.result(TIMEOUT)
    ids = {r[5] for r in T.trace.get_span_records(True) if r[5]}
    assert {h.trace_id for h in hs} <= ids


def test_session_tail_kwargs_validated(dctx):
    def scenario(P, ctx):
        for bad in ({"tail_keep_k": 0}, {"tail_keep_k": True},
                    {"tail_window": 0}):
            with pytest.raises(P.CylonError):
                P.serve.ServeSession(ctx, tables=None, **bad)
        return {}

    j, t = run_both(dctx, 8, scenario)
    assert t == j


def test_exports_equal_counters_after_serving(dctx):
    """After the same served workload, the two packages' ``serve.*``
    families in the OpenMetrics text are the same lines."""
    frames_ = _frames()

    def scenario(P, ctx):
        gb = _plans(P)[0]
        tabs = dtables(P, ctx, frames_)
        with P.serve.ServeSession(ctx, tables=tabs,
                                  batch_window_ms=10.0) as s:
            with held(s):
                hs = [s.submit(gb, label=f"x{i}") for i in range(3)]
            for h in hs:
                h.result(TIMEOUT)
        body = P.exporter.render_openmetrics()
        lines = [ln for ln in body.splitlines()
                 if re.match(r"cylon_(serve|matview)_\w+_total ", ln)]
        return {"lines": lines, "counters": counters(P)}

    j, t = run_both(dctx, 8, scenario)
    assert_same(t, j)
    assert "cylon_serve_completed_total 3" in t["lines"]
