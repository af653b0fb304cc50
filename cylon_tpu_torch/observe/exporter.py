"""The live telemetry plane's export surface: OpenMetrics + event log.

The port of ``cylon_tpu/observe/exporter.py``.  Two parts:

  * an **OpenMetrics/Prometheus text endpoint** (:func:`start` /
    ``CYLON_METRICS_PORT`` / ``config.set_metrics_port``): a stdlib
    ``ThreadingHTTPServer`` daemon thread on loopback serving ``GET
    /metrics`` with the registry snapshot — counters as ``_total``,
    watermarks and gauges as gauges, histograms as cumulative
    ``_bucket{le=...}`` series — plus a constant-1
    ``cylon_observe_config_info`` metric whose labels carry the flight
    recorder's config fingerprint.  ONLY catalogued metric names are
    exported (the METRICS catalogue is the exposition contract);
    uncatalogued names are tallied into ``observe.export_skipped``.
  * a **rotating JSON-lines event log** (:func:`start_event_log` /
    ``CYLON_EVENT_LOG`` / ``config.set_event_log_path``): a tap on the
    flight recorder's ring (:func:`flightrec.set_tap`) appending every
    noted event as one JSON object per line, rotated once to
    ``<path>.1`` at the size cap.

The start/stop state mutates only under ``OrderedLock
("observe.exporter")``; the server thread is joined outside it.  The
event-log writer uses a plain ``threading.Lock``: taps run inside
arbitrary engine threads, including under OrderedLocks.

Host-only by construction: a scrape reads the metrics registry and
nothing else — no tensor, no ``.item()``, no ``.cpu()``, no stream
synchronization — so scraping never adds a device sync to the serving
path, however much work is queued on the card.
"""
from __future__ import annotations

import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional

from . import flightrec
from .histogram import Histogram
from .locks import OrderedLock
from .metrics import COUNTER, GAUGE, HISTOGRAM, METRICS, REGISTRY, WATERMARK

__all__ = [
    "start", "stop", "port", "running", "render_openmetrics",
    "EventLogWriter", "start_event_log", "stop_event_log",
    "event_log_writer", "ensure_started", "family_name",
    "EVENT_LOG_MAX_BYTES",
]

EVENT_LOG_MAX_BYTES = 8 << 20    # one rotation keeps disk use bounded

GUARDED_STATE = {
    "_server": "_exporter_lock",    # module global
    "_thread": "_exporter_lock",    # module global
    "_writer": "_exporter_lock",    # module global
    "_fh": "_lock",                 # EventLogWriter
    "_size": "_lock",               # EventLogWriter
}

_exporter_lock = OrderedLock("observe.exporter")
_server: Optional[ThreadingHTTPServer] = None
_thread: Optional[threading.Thread] = None
_writer: Optional["EventLogWriter"] = None
_evtls = threading.local()


# ---------------------------------------------------------------------------
# OpenMetrics rendering
# ---------------------------------------------------------------------------

def family_name(name: str) -> str:
    """Catalogue name → OpenMetrics family name
    (``serve.latency_ms`` → ``cylon_serve_latency_ms``)."""
    return "cylon_" + name.replace(".", "_").replace("-", "_")


def _escape_label(value: Any) -> str:
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _escape_help(text: str) -> str:
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def _fmt(value: float) -> str:
    f = float(value)
    return str(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


def render_openmetrics() -> str:
    """One scrape payload: the registry snapshot as Prometheus/
    OpenMetrics text, catalogued names only, terminated by ``# EOF``.
    Bumps ``observe.export_scrapes`` (before the snapshot, so the
    scrape sees itself) and ``observe.export_skipped`` per
    uncatalogued name it refused to expose."""
    REGISTRY.bump("observe.export_scrapes")
    snap = REGISTRY.snapshot()
    lines = []
    skipped = 0

    def emit(name: str, kind: str, value: Any) -> bool:
        spec = METRICS.get(name)
        if spec is None or spec.kind != kind:
            return False
        try:
            v = float(value)
        except (TypeError, ValueError):
            return False
        fam = family_name(name)
        om_kind = "counter" if kind == COUNTER else "gauge"
        lines.append(f"# HELP {fam} {_escape_help(spec.doc)}")
        lines.append(f"# TYPE {fam} {om_kind}")
        suffix = "_total" if kind == COUNTER else ""
        lines.append(f"{fam}{suffix} {_fmt(v)}")
        return True

    for name, v in sorted(snap["counters"].items()):
        if not emit(name, COUNTER, v):
            skipped += 1
    for name, v in sorted(snap["watermarks"].items()):
        if not emit(name, WATERMARK, v):
            skipped += 1
    for name, v in sorted(snap["gauges"].items()):
        if not emit(name, GAUGE, v):
            skipped += 1
    for name, d in sorted(snap["histograms"].items()):
        spec = METRICS.get(name)
        if spec is None or spec.kind != HISTOGRAM:
            skipped += 1
            continue
        h = Histogram.from_dict(d)
        fam = family_name(name)
        lines.append(f"# HELP {fam} {_escape_help(spec.doc)}")
        lines.append(f"# TYPE {fam} histogram")
        for le, cum in h.cumulative():
            lines.append(f'{fam}_bucket{{le="{_fmt(le)}"}} {cum}')
        lines.append(f'{fam}_bucket{{le="+Inf"}} {h.count}')
        lines.append(f"{fam}_sum {_fmt(h.sum)}")
        lines.append(f"{fam}_count {h.count}")

    # constant-1 info metric: the config fingerprint as labels, so a
    # collector can tell WHICH knob state produced these series
    spec = METRICS["observe.config_info"]
    fam = family_name("observe.config_info")
    labels = ",".join(
        f'{k.lower().replace(".", "_")}="{_escape_label(v)}"'
        for k, v in sorted(flightrec.config_fingerprint().items()))
    lines.append(f"# HELP {fam} {_escape_help(spec.doc)}")
    lines.append(f"# TYPE {fam} gauge")
    lines.append(f"{fam}{{{labels}}} 1")

    if skipped:
        REGISTRY.bump("observe.export_skipped", skipped)
    lines.append("# EOF")
    return "\n".join(lines) + "\n"


class _MetricsHandler(BaseHTTPRequestHandler):
    """``GET /metrics`` → the OpenMetrics payload; anything else 404.
    Silent (no per-request stderr lines — a scraper polls forever)."""

    def do_GET(self) -> None:  # noqa: N802 (stdlib handler contract)
        if self.path.split("?", 1)[0] not in ("/metrics", "/"):
            self.send_error(404)
            return
        try:
            body = render_openmetrics().encode("utf-8")
        except Exception as e:  # graftlint: ok[broad-except]
            # a torn registry read answers 500; it
            # must not kill the server thread
            self.send_error(500, explain=str(e)[:200])
            return
        self.send_response(200)
        self.send_header("Content-Type",
                         "text/plain; version=0.0.4; charset=utf-8")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt: str, *args) -> None:
        pass


def start(port_num: Optional[int] = None) -> int:
    """Start the metrics endpoint on ``127.0.0.1:port_num`` (0 or None
    = ephemeral) and return the BOUND port.  Idempotent: a second call
    while running returns the live port without rebinding.  The server
    thread is a daemon — it never blocks interpreter exit."""
    global _server, _thread
    with _exporter_lock:
        if _server is not None:
            return _server.server_address[1]
        srv = ThreadingHTTPServer(("127.0.0.1", int(port_num or 0)),
                                  _MetricsHandler)
        srv.daemon_threads = True
        th = threading.Thread(target=srv.serve_forever,
                              name="cylon-metrics-exporter", daemon=True)
        _server = srv
        _thread = th
    th.start()
    return srv.server_address[1]


def stop() -> None:
    """Stop the endpoint and join its thread (no-op when not running).
    The shutdown + join happen OUTSIDE the exporter lock — a blocking
    rendezvous under a lock is the exact shape lint forbids."""
    global _server, _thread
    with _exporter_lock:
        srv, th = _server, _thread
        _server = None
        _thread = None
    if srv is not None:
        srv.shutdown()
        srv.server_close()
    if th is not None:
        th.join(timeout=5.0)


def running() -> bool:
    with _exporter_lock:
        return _server is not None


def port() -> Optional[int]:
    """The bound port of the live endpoint (None when stopped)."""
    with _exporter_lock:
        return None if _server is None else _server.server_address[1]


# ---------------------------------------------------------------------------
# JSON-lines event log (the flight-recorder tap)
# ---------------------------------------------------------------------------

class EventLogWriter:
    """Append-only JSON-lines sink for flight-recorder events.

    One event dict per line (the ring's exact payload — ``t`` epoch
    seconds + ``kind`` + event fields), flushed per event so ``tail
    -f`` and log shippers see it immediately.  At ``max_bytes`` the
    file rotates ONCE to ``<path>.1`` (``os.replace``) and a fresh
    file continues — two caps bound the total footprint.  Never
    raises out of :meth:`write`: a full disk must not take down the
    engine whose death it is recording.  A thread-local reentrancy
    flag drops events generated while already writing one (e.g. a
    warn_once fired inside the write path), mirroring the
    OrderedLock telemetry guard in observe/locks.py."""

    def __init__(self, path: str,
                 max_bytes: int = EVENT_LOG_MAX_BYTES) -> None:
        self.path = path
        self.max_bytes = int(max_bytes)
        self._lock = threading.Lock()
        self._fh = open(path, "a", encoding="utf-8")
        self._size = self._fh.tell()

    def write(self, ev: Dict[str, Any]) -> None:
        if getattr(_evtls, "writing", False):
            return
        _evtls.writing = True
        try:
            line = json.dumps(ev, sort_keys=True, default=str) + "\n"
            with self._lock:
                if self._fh is None:
                    return
                if self._size + len(line) > self.max_bytes > 0:
                    self._rotate_locked()
                self._fh.write(line)
                self._fh.flush()
                self._size += len(line)
            REGISTRY.bump("observe.events_logged")
        except Exception:  # graftlint: ok[broad-except]
            # a full disk must not take down the engine
            pass            # it records
        finally:
            _evtls.writing = False

    def _rotate_locked(self) -> None:
        self._fh.close()
        os.replace(self.path, self.path + ".1")
        self._fh = open(self.path, "a", encoding="utf-8")
        self._size = 0

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None


def start_event_log(path: str,
                    max_bytes: int = EVENT_LOG_MAX_BYTES
                    ) -> EventLogWriter:
    """Open ``path`` and install its writer as THE flight-recorder tap
    (replacing any previous writer).  Returns the writer."""
    global _writer
    w = EventLogWriter(path, max_bytes=max_bytes)
    with _exporter_lock:
        old, _writer = _writer, w
    flightrec.set_tap(w.write)
    if old is not None:
        old.close()
    return w


def stop_event_log() -> None:
    """Uninstall the tap and close the writer (no-op when none)."""
    global _writer
    with _exporter_lock:
        w, _writer = _writer, None
    if w is not None:
        flightrec.set_tap(None)
        w.close()


def event_log_writer() -> Optional[EventLogWriter]:
    with _exporter_lock:
        return _writer


# ---------------------------------------------------------------------------
# config-driven bring-up
# ---------------------------------------------------------------------------

def ensure_started() -> None:
    """Best-effort bring-up from config: start the endpoint when
    ``config.metrics_port()`` names one (and it is not already up) and
    the event log when ``config.event_log_path()`` names a file.  The
    serving session calls this at construction; failures warn once and
    never block serving — telemetry must not take down the service."""
    from .. import config
    from ..logging import warn_once  # logging imports observe: not at top
    try:
        p = config.metrics_port()
        if p is not None and not running():
            start(p)
    except Exception as e:  # graftlint: ok[broad-except]
        # a bad knob or an occupied port must not
        # block session construction
        warn_once(("exporter", "metrics"),
                  "metrics exporter failed to start: %s", e)
    try:
        path = config.event_log_path()
        if path and event_log_writer() is None:
            start_event_log(path)
    except Exception as e:  # graftlint: ok[broad-except] — ditto
        warn_once(("exporter", "eventlog"),
                  "event log failed to open: %s", e)
