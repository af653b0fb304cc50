"""Sustained-load time-series metrics: the bounded ring-buffer sampler.

The port of ``cylon_tpu/observe/timeseries.py``.  One-window snapshots
(``trace.snapshot()``, ``ServeSession.stats()``) answer "what
happened"; a serving tier needs "what is happening" — sliding-window
QPS, tail latency, queue depth and cache hit ratios over minutes of
sustained traffic.  :class:`TimeSeriesSampler` is that instrument:

  * a background daemon thread samples on a configurable period into a
    bounded ring buffer (oldest samples drop once ``capacity`` wraps);
  * every sample reads HOST-side state only — the metrics registry's
    merged counters / gauges and the serve session's self-accounted
    tallies and latency histogram.  No tensor is read and no stream is
    synchronized, so the sampler can run next to the serving loop;
  * per-sample derived fields: window QPS (completed-delta / dt),
    window p50/p99 (histogram quantiles of the latencies completed in
    the window — ``Histogram.minus`` of two session snapshots), queue
    depth, plan-cache and subplan-share hit ratios, and the
    ``shuffle.exchange_bytes_peak`` watermark.

**SLO anomaly rules**: every sample is checked against the retained
history — p99 drift (the window p99 past a multiple of the historical
median), QPS collapse (throughput below a fraction of the historical
median while demand is queued) and cache-hit collapse (the plan-cache
hit ratio off a healthy baseline).  Each firing raises a structured
alert: a ``warn_once`` line per rule, a ``serve.slo_violations`` bump,
a flight-recorder event, an entry in ``sampler.alerts``, and for the
first two rules a capacity request on the session.
"""
from __future__ import annotations

import atexit
import threading
import time
import weakref
from typing import Any, Dict, List, Optional

from .histogram import Histogram
from .locks import OrderedLock
from .metrics import REGISTRY

GUARDED_STATE = {"_buf": "_lock", "_n": "_lock",
                 "_live_samplers": "_registry_lock",
                 "_atexit_registered": "_registry_lock"}

__all__ = ["TimeSeriesSampler"]

# live samplers, stopped at interpreter exit so no daemon thread is
# still sampling while the runtime tears down
_registry_lock = OrderedLock("observe.sampler_registry")
_live_samplers: "weakref.WeakSet" = weakref.WeakSet()
_atexit_registered = False


def _stop_live_samplers() -> None:
    for s in list(_live_samplers):
        try:
            s.stop()
        except Exception:  # graftlint: ok[broad-except]
            # shutdown must never raise out of atexit
            pass


def _percentile(sorted_xs: List[float], q: float) -> Optional[float]:
    # THE nearest-rank definition lives in serve/session.py — one
    # algorithm behind the sampler windows and the serve stats.
    # Imported lazily: observe loads before the serve package exists
    # (trace → observe at package import time).
    from ..serve.session import percentile
    return percentile(sorted_xs, q)


class TimeSeriesSampler:
    """Bounded ring-buffer sampler over registry + serve-session state.

    Parameters:
      * ``period_s`` — sampling period (default 0.25 s; the thread
        wakes, samples, sleeps — drift-free enough for trend data).
      * ``capacity`` — ring size; once full, each new sample evicts the
        oldest (``dropped`` counts evictions, so retention is visible).
      * ``session`` — an optional
        :class:`~cylon_tpu_torch.serve.ServeSession`
        whose self-accounted stats and latencies feed the serving
        fields; without one, only registry-derived fields are sampled.

    Use as a context manager (``with TimeSeriesSampler(...) as s:``) or
    via ``start()``/``stop()``; ``sample_once()`` takes one sample
    synchronously (tests, ad-hoc probes) without the thread.

    Anomaly-rule knobs (module docstring; all relative to the retained
    history): ``alerts`` switches the rules off wholesale;
    ``min_history`` samples must exist before any rule can fire;
    ``p99_drift_factor`` / ``qps_collapse_frac`` / ``hit_collapse_frac``
    are the rule thresholds.  Fired alerts land in ``self.alerts``.

    ``min_history`` interaction (docs/observability.md "SLO rules"):
    every rule compares the CURRENT sample against the retained
    history, so until ``min_history`` samples exist no rule can fire —
    a cold start cannot alert on its own warm-up.  With the default
    ``period_s=0.25`` and ``min_history=8`` that is a ~2 s blind
    window; size them together (the blind window is ``min_history *
    period_s``) when tuning either.  ``summary()`` applies the same
    philosophy: fewer than 2 samples yield a typed EMPTY summary
    (every key present, values ``None``) rather than one-window
    numbers masquerading as steady state.
    """

    def __init__(self, period_s: float = 0.25, capacity: int = 512,
                 session=None, alerts: bool = True,
                 min_history: int = 8, p99_drift_factor: float = 3.0,
                 qps_collapse_frac: float = 0.25,
                 hit_collapse_frac: float = 0.5) -> None:
        from ..status import Code, CylonError, Status
        if period_s <= 0:
            raise CylonError(Status(Code.Invalid,
                f"sampler period must be > 0 s, got {period_s}"))
        if capacity < 1:
            raise CylonError(Status(Code.Invalid,
                f"sampler capacity must be >= 1, got {capacity}"))
        self.period_s = period_s
        self.capacity = capacity
        self.alerts_enabled = alerts
        self.min_history = min_history
        self.p99_drift_factor = p99_drift_factor
        self.qps_collapse_frac = qps_collapse_frac
        self.hit_collapse_frac = hit_collapse_frac
        self.alerts: List[Dict[str, Any]] = []
        self._session = session
        self._lock = OrderedLock("observe.sampler")
        self._buf: List[Optional[Dict[str, Any]]] = [None] * capacity
        self._n = 0                      # samples ever taken
        self._t0 = time.perf_counter()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # previous-sample state for window deltas
        self._prev_t = self._t0
        self._prev_completed = 0
        self._prev_cache = (0, 0)        # (hits, misses)
        self._prev_shared = 0
        # cumulative-latency-histogram snapshot at the previous sample
        # (None = nothing consumed yet); the next window is the
        # session's cumulative histogram minus this cursor
        self._lat_cursor: Optional[Histogram] = None

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "TimeSeriesSampler":
        if self._thread is not None:
            return self
        global _atexit_registered
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop,
                                        name="telemetry-sampler",
                                        daemon=True)
        with _registry_lock:
            _live_samplers.add(self)
            if not _atexit_registered:
                # one process-wide hook stopping still-live samplers
                # before the runtime tears down (deterministic shutdown:
                # no daemon thread samples a half-destructed registry at
                # exit).  Registration is check-then-act — atomic under
                # the registry lock so two concurrently-started samplers
                # cannot double-register it.
                atexit.register(_stop_live_samplers)
                _atexit_registered = True
        self._thread.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        """Stop the sampling thread DETERMINISTICALLY (join bounded by
        ``timeout`` — the loop wakes at most one period later, so the
        join returns promptly; a wedged thread is warned about, never
        waited on forever).  Samples stay readable; one final sample is
        taken so short runs never end empty-handed.  Idempotent."""
        t = self._thread
        self._stop.set()
        if t is not None:
            t.join(timeout)
            if t.is_alive():
                from .. import logging as glog
                glog.warning("telemetry sampler thread did not stop "
                             "within %.1f s", timeout)
            self._thread = None
        with _registry_lock:
            _live_samplers.discard(self)
        self.sample_once()

    def __enter__(self) -> "TimeSeriesSampler":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def _loop(self) -> None:
        while not self._stop.wait(self.period_s):
            self.sample_once()

    # -- sampling -----------------------------------------------------------

    def _session_window(self):
        """(stats, window latency histogram) from the attached session
        — reads the session's self-accounting, never the device."""
        s = self._session
        if s is None:
            return None, None
        stats, window, self._lat_cursor = \
            s.telemetry_window(self._lat_cursor)
        return stats, window

    def sample_once(self) -> Dict[str, Any]:
        """Take one sample now; returns it (and appends to the ring)."""
        now = time.perf_counter()
        dt = max(now - self._prev_t, 1e-9)
        snap = REGISTRY.snapshot()
        c, marks, gauges = (snap["counters"], snap["watermarks"],
                            snap["gauges"])
        stats, window_hist = self._session_window()
        if stats is not None:
            completed = stats.get("completed", 0)
            failed = stats.get("failed", 0)
            deferred = stats.get("deferred", 0)
            shared = stats.get("subplan_shared", 0)
            queue_depth = stats.get("queue_depth", 0)
        else:
            completed = c.get("serve.completed", 0)
            failed = c.get("serve.failed", 0)
            deferred = c.get("serve.deferred", 0)
            shared = c.get("serve.subplan_shared", 0)
            queue_depth = gauges.get("serve.queue_depth", 0)
        hits = c.get("plan.cache_hit", 0)
        misses = c.get("plan.cache_miss", 0)
        # a registry reset mid-session (trace.reset(), an ANALYZE run)
        # drops cumulative counters below the previous sample — clamp
        # the window deltas at zero (and re-baseline below) so the
        # series never reports negative qps or a nonsense hit ratio
        dh = max(hits - self._prev_cache[0], 0)
        dm = max(misses - self._prev_cache[1], 0)
        dc = max(completed - self._prev_completed, 0)
        sample = {
            "t": round(now - self._t0, 4),
            "completed": completed,
            "failed": failed,
            "deferred": deferred,
            "queue_depth": queue_depth,
            "qps": round(dc / dt, 3),
            "p50_ms": (window_hist.quantile(50)
                       if window_hist is not None else None),
            "p99_ms": (window_hist.quantile(99)
                       if window_hist is not None else None),
            "cache_hit_ratio": (round(dh / (dh + dm), 4)
                                if dh + dm else None),
            "subplan_shared": shared,
            "share_delta": max(shared - self._prev_shared, 0),
            "exchange_bytes_peak":
                marks.get("shuffle.exchange_bytes_peak", 0),
        }
        self._prev_t = now
        self._prev_completed = completed
        self._prev_cache = (hits, misses)
        self._prev_shared = shared
        if self.alerts_enabled:
            # check BEFORE appending: the rules compare the new sample
            # against the retained history, not against itself
            try:
                self._check_anomalies(sample)
            except Exception:  # graftlint: ok[broad-except]
                # a rule bug must never take the
                pass            # sampler down
        self._append(sample)
        return sample

    def _append(self, sample: Dict[str, Any]) -> None:
        with self._lock:
            self._buf[self._n % self.capacity] = sample
            self._n += 1

    # -- rolling-window anomaly rules (docs/observability.md) ---------------

    def _check_anomalies(self, sample: Dict[str, Any]) -> None:
        history = self.samples()
        if len(history) < self.min_history:
            return
        # p99 drift: the current window's tail latency blows past a
        # multiple of the historical median — an admission, sharing or
        # retrace regression surfacing in the tail first
        p99s = sorted(s["p99_ms"] for s in history
                      if s.get("p99_ms") is not None)
        base_p99 = _percentile(p99s, 50) if p99s else None
        cur_p99 = sample.get("p99_ms")
        if (base_p99 and cur_p99 is not None
                and cur_p99 > self.p99_drift_factor * base_p99):
            self._alert("p99-drift", sample,
                        f"window p99 {cur_p99:.1f} ms > "
                        f"{self.p99_drift_factor:.1f}x the "
                        f"{base_p99:.1f} ms historical median")
        # QPS collapse: completions dropped to a fraction of the
        # historical median WHILE demand is queued (an idle session is
        # not a collapse)
        qs = sorted(s["qps"] for s in history if s.get("qps", 0) > 0)
        base_qps = _percentile(qs, 50) if qs else None
        if (base_qps and sample.get("queue_depth", 0) > 0
                and sample.get("qps", 0.0)
                < self.qps_collapse_frac * base_qps):
            self._alert("qps-collapse", sample,
                        f"window QPS {sample.get('qps', 0.0):.2f} < "
                        f"{self.qps_collapse_frac:.2f}x the "
                        f"{base_qps:.2f} historical median with "
                        f"{sample.get('queue_depth', 0)} queued")
        # cache-hit collapse: the plan-cache hit ratio fell off a
        # healthy baseline (eviction churn / fingerprint instability)
        ratios = [s["cache_hit_ratio"] for s in history
                  if s.get("cache_hit_ratio") is not None]
        cur_ratio = sample.get("cache_hit_ratio")
        if ratios and cur_ratio is not None:
            base_ratio = sum(ratios) / len(ratios)
            if (base_ratio >= 0.5
                    and cur_ratio < self.hit_collapse_frac * base_ratio):
                self._alert("cache-hit-collapse", sample,
                            f"window hit ratio {cur_ratio:.2f} < "
                            f"{self.hit_collapse_frac:.2f}x the "
                            f"{base_ratio:.2f} baseline")

    def _alert(self, rule: str, sample: Dict[str, Any],
               detail: str) -> None:
        """One structured SLO alert: a warn_once line (one key per
        rule), a counter bump, the session tally, a flight-recorder
        event and a local log entry."""
        from .. import logging as glog
        from .. import trace
        from . import flightrec
        trace.count("serve.slo_violations")
        if self._session is not None:
            try:
                self._session._tally("slo_violations")
            except Exception:  # graftlint: ok[broad-except]
                # a session mid-close must not kill
                pass            # alerts
        flightrec.note("alert", rule=rule, detail=detail,
                       sample_t=sample.get("t"))
        self.alerts.append({"t": sample.get("t"), "rule": rule,
                            "detail": detail})
        del self.alerts[:-64]   # bounded like everything else here
        if (self._session is not None
                and rule in ("p99-drift", "qps-collapse")):
            # the SLO loop's demand half (docs/robustness.md
            # "Elasticity"): sustained tail-latency drift or throughput
            # collapse under queued demand are the pressure signatures
            # a bigger mesh actually fixes — open a typed capacity
            # request on the session (cache-hit collapse is a plan
            # cache problem; more devices do not help it)
            try:
                self._session.request_capacity(rule, detail)
            except Exception:  # graftlint: ok[broad-except]
                # a session mid-close must not kill
                pass            # alerts
        msg = f"SLO alert [{rule}]: {detail} (logged once per rule " \
              f"per process — sampler.alerts and the serve tally " \
              f"record every firing; docs/observability.md 'SLO rules')"
        if rule == "p99-drift":
            glog.warn_once("slo.p99-drift", "%s", msg)
        elif rule == "qps-collapse":
            glog.warn_once("slo.qps-collapse", "%s", msg)
        else:
            glog.warn_once("slo.cache-hit-collapse", "%s", msg)

    # -- reads --------------------------------------------------------------

    @property
    def dropped(self) -> int:
        """Samples evicted by ring wrap (retention made visible)."""
        with self._lock:
            return max(0, self._n - self.capacity)

    def samples(self) -> List[Dict[str, Any]]:
        """Retained samples, oldest → newest (≤ ``capacity``)."""
        with self._lock:
            n = self._n
            if n <= self.capacity:
                return [s for s in self._buf[:n] if s is not None]
            start = n % self.capacity
            out = self._buf[start:] + self._buf[:start]
            return [s for s in out if s is not None]

    def summary(self) -> Dict[str, Any]:
        """Steady-state roll-up of the retained series: median window
        QPS over the SECOND half (warm-up excluded), the worst window
        p99, and totals.

        Fewer than 2 retained samples yield the TYPED EMPTY summary:
        the full key set with ``None`` values (plus ``empty: True``),
        never an exception and never one-window numbers pretending to
        be steady state — consumers index the same keys either way."""
        samples = self.samples()
        out: Dict[str, Any] = {"samples": len(samples),
                               "dropped": self.dropped}
        if len(samples) < 2:
            out.update({"empty": True, "steady_qps": None,
                        "worst_p99_ms": None, "steady_p50_ms": None,
                        "final_completed": None,
                        "max_queue_depth": None,
                        "cache_hit_ratio": None,
                        "exchange_bytes_peak": None})
            return out
        half = samples[len(samples) // 2:]
        qps = sorted(s["qps"] for s in half)
        out["steady_qps"] = _percentile(qps, 50)
        p99s = [s["p99_ms"] for s in samples if s["p99_ms"] is not None]
        out["worst_p99_ms"] = max(p99s) if p99s else None
        p50s = [s["p50_ms"] for s in half if s["p50_ms"] is not None]
        out["steady_p50_ms"] = (_percentile(sorted(p50s), 50)
                                if p50s else None)
        out["final_completed"] = samples[-1]["completed"]
        out["max_queue_depth"] = max(s["queue_depth"] for s in samples)
        ratios = [s["cache_hit_ratio"] for s in samples
                  if s["cache_hit_ratio"] is not None]
        out["cache_hit_ratio"] = (round(sum(ratios) / len(ratios), 4)
                                  if ratios else None)
        out["exchange_bytes_peak"] = max(s["exchange_bytes_peak"]
                                         for s in samples)
        return out
