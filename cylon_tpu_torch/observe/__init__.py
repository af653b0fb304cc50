"""Observability: metrics, EXPLAIN ANALYZE, trace export, the flight
recorder.

The port of ``cylon_tpu/observe/``.  ``trace.py`` reproduces the
reference's glog phase lines as spans and counters (reference:
cpp/src/cylon/join/join.cpp:61-102, table_api.cpp:636-662); this
package is the subsystem underneath and above it:

  * **metrics**: the typed catalogue (``METRICS``, the JAX package's
    rows) and the process-level :class:`MetricsRegistry` behind
    ``trace.count`` / ``count_max`` / ``gauge`` / ``hist``.
  * **histogram**: mergeable log2-bucket histograms.
  * **locks**: :class:`OrderedLock`, the lock-order DAG and
    :class:`LockOrderViolation`.
  * **export**: ``export_chrome_trace(path)``, spans and counter series
    as Chrome trace-event JSON with per-thread and per-query tracks.
  * **analyze**: EXPLAIN ANALYZE, the real query run once with runtime
    statistics stitched onto the ``PlanNode`` list.
  * **stats**: the run-stats store keyed by plan-cache fingerprint
    (``CYLON_STATS_PATH`` persists it).
  * **compile**: build observability (the ``nvcc`` build and load of a
    CUDA source, ``kernel_factory`` builds), attributed per query.
  * **devmem**: the CUDA caching allocator's live and peak bytes (a
    live-tensor estimate on the CPU).
  * **flightrec** / **doctor**: the flight recorder's bounded event ring
    and crash bundles, and ``python -m cylon_tpu_torch.observe.doctor``.

  * **exporter**: the live telemetry plane's export surface, an
    OpenMetrics endpoint on loopback (``CYLON_METRICS_PORT``) and the
    rotating JSON-lines event log (``CYLON_EVENT_LOG``); a scrape reads
    host counters only, never the card.
  * **timeseries**: :class:`TimeSeriesSampler`, the bounded ring-buffer
    sampler over the registry and a serving session, with its SLO
    anomaly alerts.
"""
from __future__ import annotations

from . import (compile, devmem, exporter, flightrec,  # noqa: F401
               histogram, locks, stats, timeseries)
from .analyze import analyze
from .compile import kernel_factory
from .export import export_chrome_trace
from .histogram import Histogram
from .locks import LockOrderViolation, OrderedLock
from .metrics import (COUNTER, GAUGE, HISTOGRAM, METRICS, REGISTRY,
                      WATERMARK, MetricSpec, MetricsRegistry,
                      counter_delta, exchange_count, row_bytes)
from .stats import STORE as STATS_STORE
from .timeseries import TimeSeriesSampler

__all__ = [
    "COUNTER", "WATERMARK", "GAUGE", "HISTOGRAM", "MetricSpec",
    "METRICS", "MetricsRegistry", "REGISTRY", "export_chrome_trace",
    "analyze", "exchange_count", "counter_delta", "row_bytes",
    "STATS_STORE", "stats", "compile", "devmem", "flightrec",
    "kernel_factory", "locks", "OrderedLock", "LockOrderViolation",
    "Histogram", "histogram", "exporter", "timeseries",
    "TimeSeriesSampler",
]
