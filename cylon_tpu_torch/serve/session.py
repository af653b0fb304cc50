"""Multi-query serving: the query queue, batch windows, shared execution.

The port of ``cylon_tpu/serve/session.py``.  One :class:`ServeSession`
turns the engine from run-one-query-at-a-time into an operator-DAG
service (docs/serving.md, the arXiv:2212.13732 framing): client threads ``submit()`` logical plans; a dispatcher thread
collects arrivals for one **batch window**, prices the batch against the
device-memory budget (serve/admission.py), and executes the admitted
queries through the planner — each captured via an
:class:`~cylon_tpu_torch.plan.ir.Builder` whose execution memo is SHARED
across the batch, so a subplan two queries both need (the same
scan→select→shuffle chain over a shared base table) crosses the wire
once and fans out to every consumer (``serve.subplan_shared``).

Threading model — deliberately simple and honest about the hardware:

  * ``submit()`` is thread-safe and cheap (enqueue + sync-free pricing);
    a full queue blocks the caller (backpressure) or, with
    ``block=False``, rejects loudly (``serve.rejected``).
  * ONE dispatcher thread captures and executes queries serially — the
    device has a single compute stream, so interleaving device dispatch
    from N threads buys contention, not throughput.  Serial execution
    is also what makes per-query counter attribution exact
    (``resilience.counter_scope``) and fault isolation structural: a
    query's error lands on ITS handle; batch peers never see it.
  * the host-side tail — Arrow/pandas conversion of a finished result —
    runs on a :class:`~cylon_tpu_torch.parallel.streaming.HostPipeline`
    worker, so export of query N overlaps device compute of query N+1
    (``serve.exports_async``).

CUDA state across threads.  The dispatcher and the export workers are
new threads: each makes the context's device current before any work
(a new thread's current device is device 0).  Queries run on the
dispatcher's current stream, and a subplan shared through the window
memo stays on it.  A result handed to an export worker goes with a
CUDA event recorded on the dispatcher's stream, which the worker's
stream waits on before the export reads it; a pinned view hit staged
in on a worker waits on the copy stream's event (``Staged.ready``).
Nothing on the dispatcher's path synchronizes the device: the host
clock's ``execute_ms`` ends when the Python call returns, and the
export (``to_pandas`` reads the rows) is where a latency includes the
device work.

Results come back through :class:`QueryHandle` (``result()`` blocks,
re-raises the query's own error) carrying per-query latency, counter
deltas, and the list of subplans served from the shared memo — the
"prove the share" surface the tests and the CI smoke assert on.
"""
from __future__ import annotations

import heapq
import os
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from .. import faults, resilience, topology, trace
from ..observe.histogram import Histogram
from ..observe.locks import OrderedLock
from ..status import Code, CylonError, Status
from . import admission

# Locking, by class: QueryQueue._items under the condition's
# OrderedLock; the breaker's entry table and the session's tallies and
# latency history under their own _lock.  ServeSession's _pending_count
# / _pending_bytes / _last_world are dispatcher-thread-only (readers
# tolerate one window of staleness) and _SharedExecMemo is batch-scoped
# and dispatcher-thread-only.

__all__ = ["QueryHandle", "QueryQueue", "ServeSession", "percentile",
           "Overloaded", "Quarantined", "CircuitBreaker",
           "CapacityRequest"]

_UNSET = object()


class Overloaded(CylonError):
    """Typed load-shed rejection (docs/serving.md "overload
    protection"): the session is under queue-depth or SLO pressure and
    refused this submission IMMEDIATELY rather than letting it queue
    toward a timeout.  Callers catch this type to back off / retry
    elsewhere; it never means the query was wrong."""

    def __init__(self, msg: str):
        super().__init__(Status(Code.CapacityError, msg))


class Quarantined(CylonError):
    """Typed circuit-breaker rejection: this submission's plan
    fingerprint has failed repeatedly and is quarantined (breaker open).
    Rejection happens at submit time in O(µs) — a poison query must not
    burn another batch window.  Service restores automatically via the
    half-open probe once the cooldown elapses."""

    def __init__(self, msg: str):
        super().__init__(Status(Code.CapacityError, msg))


@dataclass
class CapacityRequest:
    """One typed scale-up request (docs/robustness.md "Elasticity",
    the capacity-request lifecycle): a sustained SLO-pressure alert —
    the time-series sampler's ``p99-drift`` or ``qps-collapse`` rule
    firing against this session — becomes a durable, inspectable
    record that the session WANTS more devices, instead of a log line
    an operator has to grep for.  Requests open here; the topology
    grow branch (``_check_topology``) marks every open request
    ``fulfilled`` when the mesh actually expands, closing the loop:
    alert → request → ``mesh.device_joined`` → re-priced admission.
    The session keeps a bounded ring (newest 64)."""

    rule: str        # the alert rule that fired ("p99-drift", ...)
    detail: str      # the alert's human-readable evidence line
    t: float         # time.time() at request creation
    status: str = "open"   # "open" -> "fulfilled"


def percentile(sorted_xs: List[float], q: float) -> Optional[float]:
    """Nearest-rank percentile of an ALREADY SORTED list (the latency
    summaries: p50/p99 over completed-query latencies)."""
    if not sorted_xs:
        return None
    if q <= 0:
        return sorted_xs[0]
    import math
    rank = math.ceil(q / 100.0 * len(sorted_xs))
    return sorted_xs[min(max(rank, 1), len(sorted_xs)) - 1]


class QueryHandle:
    """One submitted query: status, result rendezvous, and the per-query
    observability slice (latency, counter deltas, shared subplans, the
    query-lifecycle trace id)."""

    __slots__ = ("id", "label", "op", "tables", "export", "status",
                 "priced_bytes", "deferrals", "shared_subplans",
                 "counters", "submitted_at", "started_at", "finished_at",
                 "execute_ms", "latency_ms", "error", "_value", "_event",
                 "trace_id", "admitted_at", "queue_wait_ms",
                 "plan_digests", "deadline_ms", "deadline_missed",
                 "compile_ms", "priority", "breaker_key", "probe",
                 "recovered", "view")

    def __init__(self, qid: int, label: str, op: Callable, tables,
                 export: Optional[Callable],
                 deadline_ms: Optional[float] = None,
                 priority: int = 0) -> None:
        self.id = qid
        self.label = label
        self.op = op
        self.tables = tables
        self.export = export
        self.status = "queued"
        self.priced_bytes: int = 0
        self.deferrals = 0
        # overload-protection state: the priority class load shedding
        # reads (0 = sheddable default; >= 1 rides out pressure), the
        # breaker fingerprint this query reports its outcome under, and
        # whether it is a half-open probe (its outcome alone decides
        # the breaker's next state)
        self.priority = priority
        self.breaker_key: Optional[Tuple] = None
        self.probe = False
        # True when the executor's escalation ladder healed this query
        # mid-flight (attributed directly, NOT via the counter
        # registry — stats() self-accounts with counters off)
        self.recovered = False
        # how the materialized-view store served this query: None
        # (full execution), "hit" (rebuilt from pooled blocks, zero
        # exchanges) or "fold" (delta-folded aggregation state)
        self.view: Optional[str] = None
        # per-query SLO deadline (submit(deadline_ms=...)): checked at
        # finish time against the submit→finish latency; a miss stamps
        # deadline_missed and bumps serve.slo_violations on the session
        self.deadline_ms = deadline_ms
        self.deadline_missed = False
        # jit builds this query triggered, attributed exactly
        # (observe.compile) — the latency-floor denominator per query
        self.compile_ms: Optional[float] = None
        self.shared_subplans: List[str] = []   # op names served from memo
        self.counters: Dict[str, int] = {}     # this query's counter slice
        # the query-lifecycle trace id (docs/observability.md): stamps
        # every span this query produces — queue wait, execution phases,
        # the async export — onto ONE Chrome-export track
        self.trace_id = f"{label}#{qid}"
        self.submitted_at = time.perf_counter()
        self.admitted_at: Optional[float] = None
        self.queue_wait_ms: Optional[float] = None
        self.started_at: Optional[float] = None
        self.finished_at: Optional[float] = None
        self.execute_ms: Optional[float] = None
        self.latency_ms: Optional[float] = None
        self.error: Optional[BaseException] = None
        self.plan_digests: List[str] = []  # run-stats store fingerprints
        self._value: Any = None
        self._event = threading.Event()

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None):
        """Block until the query finished; return its result or re-raise
        its OWN error (a batch peer's failure never lands here)."""
        if not self._event.wait(timeout):
            raise CylonError(Status(Code.ExecutionError,
                f"serve: query {self.label!r} not finished within "
                f"{timeout} s (status={self.status})"))
        if self.error is not None:
            raise self.error
        return self._value

    def __repr__(self) -> str:
        return (f"QueryHandle(#{self.id} {self.label!r} {self.status}, "
                f"priced={self.priced_bytes}B)")


class QueryQueue:
    """Bounded thread-safe FIFO of :class:`QueryHandle` — the admission
    queue's front door.  ``put`` blocks when full (backpressure) unless
    ``block=False``; the dispatcher ``drain()``s whole windows."""

    def __init__(self, capacity: int) -> None:
        if capacity < 1:
            raise CylonError(Status(Code.Invalid,
                f"QueryQueue capacity must be >= 1, got {capacity}"))
        self.capacity = capacity
        self._items: deque = deque()
        self._cv = threading.Condition(
            OrderedLock("serve.query_queue"))

    def put(self, item, block: bool = True,
            timeout: Optional[float] = None) -> bool:
        with self._cv:
            if len(self._items) >= self.capacity:
                if not block:
                    return False
                if not self._cv.wait_for(
                        lambda: len(self._items) < self.capacity, timeout):
                    return False
            self._items.append(item)
            self._cv.notify_all()
            return True

    def drain(self) -> List:
        with self._cv:
            items = list(self._items)
            self._items.clear()
            self._cv.notify_all()   # wake blocked producers
            return items

    def wait_nonempty(self, timeout: Optional[float] = None) -> bool:
        with self._cv:
            return self._cv.wait_for(lambda: len(self._items) > 0, timeout)

    def priced_bytes(self) -> int:
        """Sum of the queued handles' admission prices — the fleet
        router's queued-load component (serve/router.py)."""
        with self._cv:
            return sum(h.priced_bytes or 0 for h in self._items)

    def kick(self) -> None:
        """Wake any waiter (session close)."""
        with self._cv:
            self._cv.notify_all()

    def __len__(self) -> int:
        with self._cv:
            return len(self._items)


class _SharedExecMemo(dict):
    """Batch-scoped execution memo handed to every admitted query's
    Builder: keys are the executor's content signatures (op + statics +
    child signatures + runtime identities — see plan/executor.py), so
    two queries over the SAME base-table objects produce equal keys for
    identical subplans and the second is served from the first's result.
    Tracks which query produced each entry; a hit from a DIFFERENT
    query is a cross-query share (``serve.subplan_shared``), recorded on
    the consuming handle as proof."""

    def __init__(self, session: "ServeSession") -> None:
        super().__init__()
        self._session = session
        self._owner: Dict[Any, QueryHandle] = {}
        self._current: Optional[QueryHandle] = None
        # content signatures that earned a cross-query hit THIS window
        # — the hot set the view store harvests at window end
        # (docs/serving.md "Materialized subplans")
        self._shared_keys: set = set()

    def begin_query(self, handle: QueryHandle) -> None:
        self._current = handle

    def pop(self, key, *default):
        # the recovery ladder's replan arm rolls entries back — the
        # owner record must go too, or a peer's later re-insert keeps
        # the stale owner and its own hits miscount as cross-query
        # shares
        self._owner.pop(key, None)
        return dict.pop(self, key, *default)

    def __contains__(self, key) -> bool:
        # cross-window carry: a miss consults the session's view store
        # for a subplan a PREVIOUS window harvested; a valid carried
        # entry faults in here (epoch-checked, pool-rebuilt) so the
        # executor's root-down coverage pass sees it exactly like an
        # in-window memo entry.  Inserted via dict.__setitem__ — no
        # owner — so in-window share accounting never double-counts it.
        if dict.__contains__(self, key):
            return True
        vs = self._session._views
        if vs is None:
            return False
        fetched = vs.fetch_subplan(key)
        if fetched is None:
            return False
        dict.__setitem__(self, key, fetched)
        if self._current is not None:
            self._current.shared_subplans.append(fetched[0].op)
        return True

    def get(self, key, default=None):
        if not dict.__contains__(self, key):
            self.__contains__(key)   # may fault a carried subplan in
        hit = dict.get(self, key, default)
        if hit is not None:
            owner = self._owner.get(key)
            if owner is not None and owner is not self._current:
                trace.count("serve.subplan_shared")
                self._session._tally("subplan_shared")
                self._shared_keys.add(key)
                if self._current is not None:
                    self._current.shared_subplans.append(hit[0].op)
        return hit

    def __setitem__(self, key, value) -> None:
        self._owner.setdefault(key, self._current)
        dict.__setitem__(self, key, value)


class _BreakerEntry:
    """One fingerprint's breaker state.  ``op`` pins the keyed
    callable (and everything it captures) so identity-based key
    components stay unique while the entry carries state."""

    __slots__ = ("state", "fails", "opened_at", "probe_inflight", "op")

    def __init__(self, op: Callable):
        self.state = CircuitBreaker.CLOSED
        self.fails = 0              # consecutive failures while closed
        self.opened_at = 0.0
        self.probe_inflight = False
        self.op = op


class CircuitBreaker:
    """Per-plan-fingerprint circuit breaker (docs/serving.md "overload
    protection"): the serving queue must stop feeding a poison plan
    back into batch windows.

    State machine per fingerprint (the submitted op's code +
    captured-value identities — see :meth:`key_of` — so a fresh lambda
    per resubmission still collides on one entry):

      * **closed** — failures count; ``threshold`` CONSECUTIVE failures
        open the breaker (any success resets the count).
      * **open** — submissions are rejected with a typed
        :class:`Quarantined` error at submit time, before pricing or
        enqueue (``serve.breaker_rejected``).  After ``cooldown_s`` the
        breaker half-opens.
      * **half-open** — exactly ONE probe submission is admitted
        (``serve.breaker_probes``; the ``serve.breaker_probe`` fault
        point fires at its admission); peers keep being rejected until
        the probe resolves.  Probe success closes the breaker
        (``serve.breaker_closed``), failure re-opens it for another
        cooldown.

    Entries are bounded (``max_entries``, oldest-evicted) and pin their
    op callables so identity keys stay unique while tracked.  All
    methods are called under the session lock's absence — the breaker
    carries its own lock (submit threads + the dispatcher both touch
    it)."""

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half-open"

    def __init__(self, threshold: int = 3, cooldown_s: float = 5.0,
                 max_entries: int = 256):
        if threshold < 1:
            raise CylonError(Status(Code.Invalid,
                f"breaker threshold must be >= 1, got {threshold}"))
        if cooldown_s <= 0:
            raise CylonError(Status(Code.Invalid,
                f"breaker cooldown_s must be > 0, got {cooldown_s}"))
        self.threshold = threshold
        self.cooldown_s = cooldown_s
        self.max_entries = max_entries
        self._lock = OrderedLock("serve.breaker")
        self._entries: Dict[Tuple, _BreakerEntry] = {}

    @staticmethod
    def key_of(op: Callable) -> Tuple:
        """The plan fingerprint at submit altitude: the op's CODE
        identity plus the identities of its captured values (closure
        cells and argument defaults).  A client resubmitting a poison
        plan typically builds a FRESH lambda per submission
        (``submit(lambda t: q(ctx, t))`` in a loop) — raw callable
        identity would give every resubmission a fresh fingerprint and
        the breaker could never accumulate failures — while the same
        code object parameterized by a different captured plan
        (``lambda t, q=qfn: ...`` over q1 vs q6) is a different plan
        and must not share a breaker.  Non-function callables fall
        back to object identity (the plan cache's stable-callable
        contract, docs/query_planner.md)."""
        import functools
        if isinstance(op, functools.partial):
            # a fresh partial per resubmission is the same pattern as
            # a fresh lambda: fingerprint the wrapped callable plus
            # the bound-argument identities, not the wrapper object
            return ("partial", CircuitBreaker.key_of(op.func),
                    tuple(id(a) for a in op.args),
                    tuple(sorted((k, id(v))
                                 for k, v in op.keywords.items())))
        code = getattr(op, "__code__", None)
        if code is None:
            return (getattr(op, "__qualname__", type(op).__name__),
                    id(op))
        cells = []
        for cell in (getattr(op, "__closure__", None) or ()):
            try:
                cells.append(id(cell.cell_contents))
            except ValueError:      # unbound cell — still a stable key
                cells.append(0)
        defaults = tuple(id(d) for d in
                         (getattr(op, "__defaults__", None) or ()))
        # bound methods share one __code__ across instances — the
        # receiver is a captured value too, or runner_a's failures
        # would quarantine runner_b's identical-code-but-healthy plan
        bound_to = getattr(op, "__self__", None)
        return (getattr(op, "__qualname__", "<callable>"), id(code),
                defaults, tuple(cells),
                0 if bound_to is None else id(bound_to))

    def _entry_locked(self, key: Tuple, op: Callable) -> "_BreakerEntry":
        e = self._entries.get(key)
        if e is None:
            while len(self._entries) >= self.max_entries:
                # only CLOSED entries are evictable: an OPEN/HALF_OPEN
                # entry IS the quarantine — dropping one would silently
                # lift it and let the poison plan back into batch
                # windows.  When every tracked entry is a live
                # quarantine (table saturated), the NEW fingerprint
                # goes untracked instead: it behaves closed (admits;
                # failures do not accumulate) until capacity frees —
                # the safe direction, since an existing quarantine is
                # proven poison and the newcomer is merely unknown.
                victim = next(
                    (k for k, v in self._entries.items()
                     if v.state == self.CLOSED), None)
                if victim is None:
                    return _BreakerEntry(op)
                self._entries.pop(victim)
            e = _BreakerEntry(op)
            self._entries[key] = e
        return e

    def check(self, key: Tuple, op: Callable) -> str:
        """Gate one submission: ``"admit"``, ``"probe"`` (half-open —
        the caller marks the handle as the probe), or ``"reject"``.
        Never CREATES an entry: a fingerprint with no failure history
        is the default state, and storing it would pin every healthy
        op (and its captured payloads) for the session's lifetime."""
        now = time.monotonic()
        with self._lock:
            e = self._entries.get(key)
            if e is None or e.state == self.CLOSED:
                return "admit"
            if e.state == self.OPEN \
                    and now - e.opened_at >= self.cooldown_s:
                e.state = self.HALF_OPEN
                e.probe_inflight = False
            if e.state == self.HALF_OPEN and not e.probe_inflight:
                e.probe_inflight = True
                return "probe"
            return "reject"

    def on_probe_abort(self, key: Tuple) -> None:
        """The admitted probe never EXECUTED (queue rejection, session
        close): release the half-open slot so the next submission can
        probe instead of every caller being rejected forever."""
        with self._lock:
            e = self._entries.get(key)
            if e is not None and e.state == self.HALF_OPEN:
                e.probe_inflight = False

    def on_success(self, key: Tuple, probe: bool = False) -> None:
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                return
            if e.state != self.CLOSED and not probe:
                # a STALE success: this query was admitted before the
                # failures that opened the breaker (async exports can
                # outlast a whole cooldown) — letting it lift the
                # quarantine would bypass the cooldown/probe state
                # machine.  ONLY the half-open probe's own outcome
                # decides.
                return
            if e.state == self.HALF_OPEN:
                trace.count("serve.breaker_closed")
            # a closed zero-failure entry IS the default state: drop it
            # so recovered/healthy fingerprints stop pinning their ops
            self._entries.pop(key, None)

    def on_failure(self, key: Tuple, op: Callable,
                   probe: bool = False) -> bool:
        """Record one execution failure; returns True when this failure
        OPENED (or re-opened) the breaker.  An untracked entry (table
        saturated with live quarantines) reports False — telemetry
        must not claim a quarantine check() will not enforce.  During
        HALF_OPEN only the PROBE's failure re-opens: a stale pre-open
        query failing while the probe is queued must not pre-empt the
        probe's verdict (mirror of ``on_success``'s stale guard)."""
        now = time.monotonic()
        with self._lock:
            e = self._entry_locked(key, op)
            tracked = self._entries.get(key) is e
            if e.state == self.HALF_OPEN:
                if not probe:
                    return False    # stale evidence; the probe decides
                # the probe failed: straight back to open (half-open
                # entries are always tracked — they came from check())
                e.state, e.opened_at = self.OPEN, now
                e.probe_inflight = False
                trace.count("serve.breaker_open")
                return True
            e.fails += 1
            if e.state == self.CLOSED and e.fails >= self.threshold:
                e.state, e.opened_at = self.OPEN, now
                if tracked:
                    trace.count("serve.breaker_open")
                    return True
        return False

    def state_of(self, key: Tuple) -> str:
        with self._lock:
            e = self._entries.get(key)
            return e.state if e is not None else self.CLOSED


class ServeSession:
    """The serving loop: bounded admission queue + batch-window
    dispatcher + async export lane.  See the module docstring for the
    threading model and docs/serving.md for the semantics.

    Parameters:
      * ``tables`` — the session's shared base tables (a dict of
        DTables); ``submit`` may override per query.  Sharing REQUIRES
        submitting queries over the same table objects — the execution
        memo keys scans by table identity.
      * ``batch_window_ms`` — how long the dispatcher collects arrivals
        before admitting a batch: the sharing-vs-latency dial (0 = no
        wait — every query is its own batch, nothing shares).
      * ``max_queue`` — the backpressure bound; a full queue blocks
        submitters (or rejects with ``block=False``).
      * ``admission_budget`` — bytes co-admitted queries may price in
        one window; default: the live ``resilience.exchange_budget()``
        read at every window, so CYLON_MEMORY_BUDGET (and chaos budget
        perturbations) steer admission exactly as they steer the
        exchanges themselves.
      * ``export_workers`` — async export lane width (0 = export
        inline on the dispatcher; no overlap).
      * ``breaker_threshold`` / ``breaker_cooldown_s`` — the per-plan
        circuit breaker (docs/serving.md "overload protection"):
        threshold consecutive failures of one plan fingerprint open
        its breaker (typed :class:`Quarantined` rejections in O(µs));
        after the cooldown a single half-open probe decides whether
        service restores.  ``breaker_threshold=None`` disables.
      * ``shed_depth`` — queue-depth load shedding: once this many
        queries are waiting, priority-0 submissions are rejected with
        a typed :class:`Overloaded` instead of queueing toward a
        timeout (``submit(priority=1)`` and above ride out pressure
        until the queue is genuinely full).  Defaults to 3/4 of
        ``max_queue``; ``None`` keeps the default, 0 disables.
      * ``tail_keep_k`` / ``tail_window`` — tail-based trace sampling
        (docs/observability.md "Live telemetry plane"): with span
        tracing on, each query's retention is decided at COMPLETION —
        the slowest ``tail_keep_k`` per ``tail_window`` completions,
        plus every error / deadline miss / recovered query, keep
        their full span waterfalls; the rest are dropped from the
        span ring with visible ``trace.sampled_out`` accounting.
        ``tail_keep_k=None`` disables (every trace retained).
    """

    def __init__(self, ctx, tables=None, *, batch_window_ms: float = 4.0,
                 max_queue: int = 64,
                 admission_budget: Optional[int] = None,
                 export_workers: int = 1, name: str = "serve",
                 breaker_threshold: Optional[int] = 3,
                 breaker_cooldown_s: float = 5.0,
                 shed_depth: Optional[int] = None,
                 tail_keep_k: Optional[int] = 16,
                 tail_window: int = 128,
                 views: Optional[bool] = None,
                 pipelined: Optional[bool] = None) -> None:
        from ..context import refuse_multiprocess
        refuse_multiprocess("serve.ServeSession", ctx)
        if batch_window_ms < 0:
            raise CylonError(Status(Code.Invalid,
                f"batch_window_ms must be >= 0, got {batch_window_ms}"))
        if tail_keep_k is not None and (isinstance(tail_keep_k, bool)
                                        or not isinstance(tail_keep_k, int)
                                        or tail_keep_k < 1):
            raise CylonError(Status(Code.Invalid,
                f"tail_keep_k must be an int >= 1 or None to disable "
                f"tail sampling, got {tail_keep_k!r}"))
        if (isinstance(tail_window, bool)
                or not isinstance(tail_window, int) or tail_window < 1):
            raise CylonError(Status(Code.Invalid,
                f"tail_window must be an int >= 1, got {tail_window!r}"))
        self.ctx = ctx
        self.name = name
        self._tables = tables
        self._window_s = batch_window_ms / 1e3
        self._admission_budget = admission_budget
        self._breaker = (None if not breaker_threshold else
                         CircuitBreaker(breaker_threshold,
                                        breaker_cooldown_s))
        if shed_depth is None:
            shed_depth = max(2, (3 * max_queue) // 4)
        elif shed_depth < 0:
            raise CylonError(Status(Code.Invalid,
                f"shed_depth must be >= 0 (0 disables), got {shed_depth}"))
        self._shed_depth = shed_depth
        # EWMA of completed-query SERVICE time (execute only, queue
        # wait excluded — the shed check multiplies by depth itself):
        # the SLO-pressure shed's estimate of what one queued query
        # costs (host bookkeeping, updated in _finish under the lock)
        self._ewma_ms: Optional[float] = None
        # the dispatcher's deferred backlog size (admission-budget
        # deferrals live in the dispatcher's private pending list, not
        # the queue — the shed depth must see BOTH, or budget pressure
        # never engages overload protection).  Plain int, written by
        # the dispatcher only; readers tolerate one-window staleness.
        self._pending_count = 0
        # ... and its priced-bytes twin: the deferred backlog's
        # admission price, read (with the same staleness tolerance) by
        # load_bytes() for the fleet router's placement score
        self._pending_bytes = 0
        self._queue = QueryQueue(max_queue)
        self._pipeline = None
        if export_workers > 0:
            from ..parallel.streaming import HostPipeline
            self._pipeline = HostPipeline(workers=export_workers,
                                          name=f"{name}-export",
                                          device=ctx.device)
        self._lock = OrderedLock("serve.session")
        self._stats: Dict[str, int] = {
            "submitted": 0, "admitted": 0, "deferred": 0, "rejected": 0,
            "completed": 0, "failed": 0, "batches": 0,
            "subplan_shared": 0, "exports_async": 0,
            "slo_violations": 0, "shed": 0, "breaker_rejected": 0,
            "breaker_probes": 0, "recovered": 0, "mesh_degraded": 0,
            "mesh_expanded": 0, "capacity_requests": 0,
            "view_hits": 0, "view_folds": 0, "view_invalidations": 0,
            "view_subplan_hits": 0,
        }
        # the cross-window materialized-view store (serve/matview.py;
        # docs/serving.md "Materialized subplans"): ctor arg > env
        # CYLON_MATVIEW (default on).  Pipelined dispatch (ctor arg >
        # CYLON_SERVE_PIPELINE, default on) additionally needs the
        # export pipeline — clean view hits are host-phase-only, so
        # the window dispatches them onto its workers while compute
        # queries run on the dispatcher, overlapping the two.
        from . import matview
        if views is None:
            views = matview.matview_enabled()
        self._views = matview.ViewStore(self) if views else None
        if pipelined is None:
            pipelined = os.environ.get(
                "CYLON_SERVE_PIPELINE", "1") not in ("", "0")
        self._pipe_dispatch = bool(pipelined and self._views is not None
                                   and self._pipeline is not None)
        # elastic degraded-mesh state (docs/robustness.md
        # "Elasticity"): the session polls the topology epoch each
        # dispatcher turn — a mid-query device loss flips it into
        # degraded mode (re-priced admission budget, serve.degraded
        # gauge, mesh_degraded flight-recorder event) and every later
        # query's builder anchors on the survivor mesh
        self._base_world = max(ctx.get_world_size(), 1)
        self._topology_epoch = topology.epoch()
        # the last world size _check_topology observed (dispatcher-
        # thread-only): the grow-vs-shrink discriminator — a rejoin
        # that still leaves the mesh short of base must count as a
        # scale-UP (mesh_expanded, budget relaxes), never as another
        # degrade event
        self._last_world = self._base_world
        # open/fulfilled scale-up requests (bounded ring, newest 64):
        # the SLO loop's paper trail — see CapacityRequest
        self._capacity_requests: deque = deque(maxlen=64)
        # completed-query latency distribution: a fixed-memory
        # mergeable histogram (observe/histogram.py), NOT a raw sample
        # list — stats() percentiles stay O(1)-memory at any QPS
        self._lat_hist = Histogram()
        # tail-based trace sampling (docs/observability.md "Live
        # telemetry plane"): keep the slowest-k per tail_window
        # completions (streaming top-k min-heap) plus every error /
        # SLO miss / recovered query; drop the rest via
        # trace.finish_trace.  tail_keep_k=None disables (every trace
        # retained, the pre-sampling behavior).
        self._tail_keep_k = tail_keep_k
        self._tail_window = tail_window
        self._tail_heap: List[float] = []
        self._tail_seen = 0
        self._ids = 0
        self._closing = threading.Event()
        self._closed = False
        self._drained = False
        trace.gauge("serve.batch_window_ms", batch_window_ms)
        # live telemetry plane bring-up: start the OpenMetrics endpoint
        # / event log when config names them (best-effort — a bad knob
        # warns once and never blocks serving)
        from ..observe import exporter
        exporter.ensure_started()
        # pyarrow's first import must not happen on a pipeline worker
        # while the dispatcher runs torch ops: a process whose first
        # Arrow export ran there crashed (SIGSEGV) in later exports on
        # the CPU build of torch.  Load it here, on the caller's thread.
        import pyarrow  # noqa: F401
        self._dispatcher = threading.Thread(
            target=self._loop, name=f"{name}-dispatch", daemon=True)
        self._dispatcher.start()

    # -- client surface ------------------------------------------------------

    def submit(self, op: Callable, tables=_UNSET, *,
               export: Optional[Callable] = None,
               label: Optional[str] = None, block: bool = True,
               timeout: Optional[float] = None,
               deadline_ms: Optional[float] = None,
               priority: int = 0) -> QueryHandle:
        """Enqueue one query; returns its :class:`QueryHandle`.

        ``op`` receives the (logically wrapped) tables and composes dist
        ops — exactly the ``ctx.optimize`` contract; ``tables`` defaults
        to the session's shared base tables.  ``export`` is an optional
        host-side finisher (e.g. ``lambda r: r.to_pandas()``) run on the
        async export lane so its cost overlaps the next query's device
        compute.  A full queue blocks (backpressure) until space or
        ``timeout``; ``block=False`` turns that into an immediate
        CapacityError + ``serve.rejected`` bump.

        ``deadline_ms`` stamps a per-query latency SLO (submit→finish,
        export included): a query finishing past it still returns its
        result, but ``handle.deadline_missed`` is set, the session's
        ``slo_violations`` tally and the ``serve.slo_violations``
        counter bump, and the flight recorder logs the miss — the
        deadline is an observability contract, not a cancellation
        (docs/serving.md "deadlines").

        Overload protection (docs/serving.md) runs BEFORE pricing or
        enqueue, in O(µs): a quarantined plan fingerprint (circuit
        breaker open) raises :class:`Quarantined`; under queue-depth
        pressure (``shed_depth``) a ``priority=0`` submission — or any
        deadline the queue's estimated wait already busts — raises
        :class:`Overloaded` instead of queueing toward a timeout.
        ``priority >= 1`` classes ride out depth pressure until the
        queue is genuinely full."""
        if self._closed:
            raise CylonError(Status(Code.Invalid,
                f"serve session {self.name!r} is closed"))
        if deadline_ms is not None and not deadline_ms > 0:
            raise CylonError(Status(Code.Invalid,
                f"deadline_ms must be a positive latency budget, got "
                f"{deadline_ms!r}"))
        tabs = self._tables if tables is _UNSET else tables
        bkey = probe = None
        if self._breaker is not None:
            bkey = CircuitBreaker.key_of(op)
            verdict = self._breaker.check(bkey, op)
            if verdict == "reject":
                trace.count("serve.breaker_rejected")
                self._tally("breaker_rejected")
                raise Quarantined(
                    f"serve: plan {bkey[0]!r} is quarantined (circuit "
                    f"breaker open after repeated failures); a "
                    f"half-open probe will retry it after the "
                    f"{self._breaker.cooldown_s:.1f}s cooldown")
            probe = verdict == "probe"
            if probe:
                trace.count("serve.breaker_probes")
                self._tally("breaker_probes")
                try:
                    # the probe's own fault point (chaos: a probe that
                    # cannot even be admitted re-opens the breaker)
                    faults.check("serve.breaker_probe")
                except faults.FaultError:
                    self._breaker.on_failure(bkey, op, probe=True)
                    raise
        try:
            # overload depth = queued + the dispatcher's deferred
            # backlog (admission-budget deferrals left the queue but
            # are still ahead of this submission)
            depth = len(self._queue) + self._pending_count
            if self._shed_depth and depth >= self._shed_depth \
                    and priority <= 0 and not probe:
                trace.count("serve.shed")
                self._tally("shed")
                raise Overloaded(
                    f"serve: shedding priority-{priority} work at queue "
                    f"depth {depth} (shed_depth={self._shed_depth}) — "
                    "retry later or submit with priority>=1")
            if deadline_ms is not None and self._ewma_ms and not probe:
                est_wait = depth * self._ewma_ms
                # the retry elapsed-time budget (RetryPolicy
                # .max_elapsed_s) bounds the worst transient-retry
                # stall THIS query can hit — with a cap configured the
                # deadline estimate can honestly include it (without
                # one, retries that individually back off can exceed
                # any deadline and the estimate stays blind to them)
                cap_s = resilience.retry_policy().max_elapsed_s
                if cap_s:
                    est_wait += cap_s * 1e3
                if est_wait > deadline_ms:
                    trace.count("serve.shed")
                    self._tally("shed")
                    raise Overloaded(
                        f"serve: estimated queue wait {est_wait:.0f} ms "
                        f"({depth} queued x ~{self._ewma_ms:.0f} ms "
                        "service EWMA) already exceeds the "
                        f"{deadline_ms:.0f} ms deadline — rejecting now "
                        "instead of timing out later")
            with self._lock:
                self._ids += 1
                qid = self._ids
            h = QueryHandle(qid, label or f"q{qid}", op, tabs, export,
                            deadline_ms=deadline_ms, priority=priority)
            h.breaker_key = bkey
            h.probe = bool(probe)
            h.priced_bytes = admission.price_query(tabs)
            if (self._views is not None and h.priced_bytes
                    and self._views.would_hit(op, tabs)):
                # a probable view hit never dispatches an exchange —
                # it rebuilds from pooled host blocks — so it must not
                # consume the window's exchange budget and defer real
                # work behind it.  Advisory: the view can evict before
                # dispatch, and the probe re-validates (matview.py).
                h.priced_bytes = admission.PROBE_PRICE
            self._tally("submitted")
            if not self._queue.put(h, block=block, timeout=timeout):
                trace.count("serve.rejected")
                self._tally("rejected")
                h.status = "rejected"
                raise CylonError(Status(Code.CapacityError,
                    f"serve: queue full ({self._queue.capacity} queries)"
                    " — backpressure; retry, block, or widen max_queue"))
            trace.gauge("serve.queue_depth", len(self._queue))
            if self._closed and not self._dispatcher.is_alive():
                # raced close() AND lost: the dispatcher is gone, so
                # nothing will ever drain this queue — fail what is
                # stranded (this handle included) rather than block a
                # result() forever.  While the dispatcher is still
                # alive its exit condition (empty queue) guarantees it
                # drains us normally, so a query that merely arrived
                # during shutdown still executes; drain() hands each
                # handle to exactly one drainer either way.
                self._fail_stragglers()
            if h.error is not None:
                raise h.error
            return h
        except BaseException:
            # an admitted PROBE that never reached execution (queue
            # rejection, pricing error, close race) must release its
            # half-open slot, or the fingerprint stays quarantined
            # forever with no probe ever runnable.  Idempotent with
            # the _finish never-started release — double-abort is a
            # no-op.
            if probe and self._breaker is not None:
                self._breaker.on_probe_abort(bkey)
            raise

    def _fail_stragglers(self) -> None:
        for h in self._queue.drain():
            self._finish(h, error=CylonError(Status(Code.Invalid,
                f"serve session {self.name!r} closed before this query "
                "was admitted")))

    def run(self, op: Callable, tables=_UNSET, *,
            export: Optional[Callable] = None,
            label: Optional[str] = None,
            timeout: Optional[float] = None):
        """``submit`` + ``result`` — the synchronous convenience form."""
        return self.submit(op, tables, export=export,
                           label=label).result(timeout)

    def ingest(self, name: str, delta, *, block: bool = True,
               timeout: Optional[float] = None) -> QueryHandle:
        """Append ``delta`` to the session base table ``name`` THROUGH
        the dispatcher (docs/serving.md "Materialized subplans" —
        staleness model).  Routing writes through the queue serializes
        them against query execution on the one dispatcher thread:
        no query ever observes a half-applied append, every query
        admitted after the ingest completes observes it (the bench's
        measured visibility lag), and the table's content epoch bumps
        exactly once per batch — which is what the view store folds
        on.  Writes ride ``priority=1`` so load shedding never drops
        data."""
        if not isinstance(self._tables, dict) or name not in self._tables:
            raise CylonError(Status(Code.Invalid,
                f"serve: no session base table named {name!r} to "
                "ingest into"))
        base = self._tables[name]
        return self.submit(
            lambda base=base, delta=delta: base.append(delta),
            None, label=f"ingest:{name}", block=block, timeout=timeout,
            priority=1)

    def stats(self) -> Dict[str, Any]:
        """Session-level tallies + latency percentiles (independent of
        trace enablement — the serving loop always self-accounts).
        Percentiles are histogram quantiles (observe/histogram.py):
        exact-to-one-log2-bucket, O(1) memory at any QPS."""
        with self._lock:
            out: Dict[str, Any] = dict(self._stats)
            hist = self._lat_hist.copy()
        out["queue_depth"] = len(self._queue)
        out["batch_window_ms"] = self._window_s * 1e3
        out["p50_ms"] = hist.quantile(50)
        out["p99_ms"] = hist.quantile(99)
        out["p999_ms"] = hist.quantile(99.9)
        return out

    def telemetry_window(self, cursor: Optional[Histogram] = None):
        """One consistent cut for the time-series sampler
        (observe.timeseries): ``(stats tallies, window histogram of
        latencies completed since the ``cursor`` snapshot, new
        cursor)``.  Pass the returned cursor back on the next call;
        ``None`` means "from the beginning".  Host-side bookkeeping
        only — reading it never touches a device or blocks the
        dispatcher beyond the stats lock."""
        with self._lock:
            stats = dict(self._stats)
            cum = self._lat_hist.copy()
        window = cum.minus(cursor) if cursor is not None else cum
        stats["queue_depth"] = len(self._queue)
        return stats, window, cum

    def request_capacity(self, rule: str, detail: str = "") -> CapacityRequest:
        """Open a typed :class:`CapacityRequest` against this session —
        the SLO loop's demand half (docs/robustness.md "Elasticity").
        Called by the time-series sampler when a sustained ``p99-drift``
        or ``qps-collapse`` alert fires; callable directly by operators
        too.  Books ``serve.capacity_requests``, tallies on the
        session, and records a ``capacity_request`` flight-recorder
        event the doctor renders on the scale-up timeline.  The request
        stays ``open`` until a mesh expansion marks it ``fulfilled``
        (``_check_topology``'s grow branch)."""
        from ..observe import flightrec
        req = CapacityRequest(rule=rule, detail=detail, t=time.time())
        with self._lock:
            self._capacity_requests.append(req)
        trace.count("serve.capacity_requests")
        self._tally("capacity_requests")
        flightrec.note("capacity_request", session=self.name, rule=rule,
                       detail=detail)
        return req

    def capacity_requests(self) -> List[CapacityRequest]:
        """Snapshot of the bounded capacity-request ring, oldest
        first (the live objects — ``status`` flips in place when a
        scale-up fulfils them)."""
        with self._lock:
            return list(self._capacity_requests)

    def load_bytes(self) -> int:
        """This session's waiting load in PRICED bytes: everything
        queued plus the dispatcher's budget-deferred backlog, valued by
        the same admission cost model that gates windows.  The fleet
        router's placement score (serve/router.py) — comparable across
        replicas because every session prices with the one shared
        model.  Host bookkeeping only; one-window staleness on the
        deferred half is tolerated by design."""
        return self._queue.priced_bytes() + self._pending_bytes

    def holds_view(self, op: Callable) -> bool:
        """Whether this session's materialized-view store holds a live
        view for ``op``'s fingerprint — the fleet router's view-
        residency affinity signal (serve/router.py): routing a repeat
        query to the replica that can serve it from pooled blocks
        beats routing by load alone.  O(entries) over host bookkeeping."""
        return (self._views is not None
                and self._views.holds_view_for(op))

    def close(self) -> None:
        """Stop accepting queries, drain everything queued, stop the
        dispatcher and export lane.  Idempotent."""
        if self._closed:
            return
        self._closed = True
        self._closing.set()
        self._queue.kick()
        self._dispatcher.join()
        # a submit() racing this close can slip a query in AFTER the
        # dispatcher's final empty-queue check — fail it rather than
        # leave its result() blocking forever (submit re-checks too;
        # drain() guarantees exactly one of us finishes each handle)
        self._fail_stragglers()
        if self._pipeline is not None:
            self._pipeline.close()
        if self._views is not None:
            # release the retained views' host-budget bytes — the pool
            # is process-level, the store was per-session
            self._views.clear()

    def drain(self) -> Dict[str, Any]:
        """Graceful shutdown (docs/serving.md "drain"): stop admitting
        new queries, let the dispatcher finish everything already
        queued or deferred, join the async export lane (every in-flight
        export delivers to its handle), flush the run-stats store to
        its configured path, and record the drain in the flight
        recorder.  Returns the session's final :meth:`stats` snapshot.
        Idempotent, and ``close()``-compatible: a drained session is a
        closed session."""
        from ..observe import flightrec
        from ..observe import stats as obstats
        with self._lock:   # atomic claim: concurrent drain() calls
            already = self._drained    # must not both take the
            self._drained = True       # first-drain accounting path
        self.close()   # close() IS the in-flight completion barrier:
        #                the dispatcher only exits on an empty queue,
        #                and pipeline.close() joins the export workers
        out = self.stats()
        if not already:
            # idempotence covers the accounting too: a SECOND drain()
            # neither re-counts nor re-flushes — but the first drain
            # always flushes, even on a session close() already shut
            # down (the flush is what the caller asked for by name)
            obstats.STORE.save()
            trace.count("serve.drains")
            flightrec.note("drain", session=self.name,
                           completed=out.get("completed", 0),
                           failed=out.get("failed", 0),
                           shed=out.get("shed", 0))
        return out

    def __enter__(self) -> "ServeSession":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- internals -----------------------------------------------------------

    def _tally(self, key: str, n: int = 1) -> None:
        with self._lock:
            self._stats[key] = self._stats.get(key, 0) + n

    def _budget(self) -> int:
        base = (self._admission_budget
                if self._admission_budget is not None
                else resilience.exchange_budget(self.ctx.device))
        # degraded mesh: P' survivors hold P'/P of the fleet's
        # aggregate transient headroom, so a window may co-admit
        # proportionally less; a scale-up relaxes the squeeze along
        # the same line — admission.scaled_budget is the one re-pricing
        # rule for both directions (docs/robustness.md "Elasticity";
        # per-QUERY prices already re-derive from the re-meshed
        # tables' counts)
        eff = topology.effective(self.ctx)
        return admission.scaled_budget(base, eff.get_world_size(),
                                       self._base_world)

    def _check_topology(self) -> None:
        """One epoch poll (an int compare in the common case): on a new
        degrade, record the event once — the gauge, the session tally,
        and the flight-recorder ``mesh_degraded`` event the doctor
        renders; on a GROW (``mesh.device_joined`` applied), run the
        exact inverse — re-price the admission budget to the expanded
        world (``_budget`` re-reads the effective world every window,
        so relaxation is automatic once the gauge/tallies record the
        transition), mark open capacity requests fulfilled, and emit
        the ``mesh_expanded`` event the doctor's scale-up timeline
        renders.  In-flight work needs no action here: the victim's
        ladder already re-meshed the shared tables in place, and every
        later query's builder resolves the effective context."""
        ep = topology.epoch()
        if ep == self._topology_epoch:
            return
        self._topology_epoch = ep
        if self._views is not None:
            # pooled view blocks are laid out for the mesh that staged
            # them ([P*cap] shard-major); any topology change makes
            # them unloadable — purge rather than serve a wrong shape
            self._views.clear()
        eff = topology.effective(self.ctx)
        world = eff.get_world_size()
        prev = self._last_world
        self._last_world = world
        if world < prev:
            from ..observe import flightrec
            lost = self._base_world - world
            trace.gauge("serve.degraded", lost)
            self._tally("mesh_degraded")
            with self._lock:
                self._stats["degraded_world"] = world
            flightrec.note("mesh_degraded", session=self.name,
                           survivor_world=world, lost=lost)
            # session tables the victim's plan never scanned are still
            # sharded over the mesh containing the dead chip — their
            # first collective would cost ANOTHER healthy device.
            # Migrate them now, on the dispatcher thread (queries
            # execute here too, so nothing races the in-place move);
            # a failed migration degrades to the per-query lazy path
            self._migrate_tables("degraded-mode")
        elif world > prev and prev < self._base_world:
            from ..observe import flightrec
            # still-missing devices after the grow: 0 on a full
            # restore (gauge cleared — the degraded signal's inverse),
            # positive on a partial rejoin (still degraded, less so)
            lost = max(self._base_world - world, 0)
            trace.gauge("serve.degraded", lost)
            self._tally("mesh_expanded")
            with self._lock:
                if lost:
                    self._stats["degraded_world"] = world
                else:
                    self._stats.pop("degraded_world", None)
                for req in self._capacity_requests:
                    if req.status == "open":
                        req.status = "fulfilled"
            flightrec.note("mesh_expanded", session=self.name,
                           world=world, joined=world - prev,
                           still_lost=lost)
            # the inverse of the degrade migration: session tables the
            # scale-up's plan never scanned are still pinned to the
            # shrunken mesh — re-expand them now so the next window's
            # collectives span the full world
            self._migrate_tables("scale-up")

    def _migrate_tables(self, why: str) -> None:
        try:
            from ..parallel.remesh import ensure_current
            ensure_current(self._tables)
        except Exception as mig_err:
            # the lazy ensure_current in _execute_one retries
            # per query; a migration failure must not kill the
            # dispatcher
            from ..logging import warning as _warn
            _warn("%s table migration failed (per-query"
                  " migration will retry): %s: %s", why,
                  type(mig_err).__name__, str(mig_err)[:160])

    def _loop(self) -> None:
        if self.ctx.device.type == "cuda":
            torch.cuda.set_device(self.ctx.device)
        pending: List[QueryHandle] = []
        while True:
            got = self._queue.wait_nonempty(timeout=0.05)
            if topology.pending_joins(self.ctx):
                # flush hysteresis-held rejoins (flap damping,
                # CYLON_REMESH_COOLDOWN_MS): mark_joined(..., 0)
                # applies the pending joins iff the cooldown window
                # has elapsed, else it stays a cheap no-op — the
                # dispatcher turn is the session's stage boundary
                topology.mark_joined(self.ctx, 0)
            self._check_topology()
            if not got and not pending:
                if self._closing.is_set() and len(self._queue) == 0:
                    return
                continue
            # the batch window: let concurrent submitters' queries land
            # in the same batch (the sharing-vs-latency dial; skipped
            # when draining at close — nothing else is coming)
            if self._window_s > 0 and got and not self._closing.is_set():
                time.sleep(self._window_s)
            batch = pending + self._queue.drain()
            if not batch:
                continue
            pending = []
            self._pending_count = 0
            self._pending_bytes = 0
            try:
                admitted, deferred = admission.admit(batch,
                                                     self._budget())
            except BaseException as e:
                # a pricing/budget error (e.g. a malformed
                # CYLON_MEMORY_BUDGET read inside _budget()) must fail
                # THIS window's handles loudly, never kill the
                # dispatcher thread and strand every future result()
                for h in batch:
                    self._finish(h, error=e)
                continue
            pending = deferred
            self._pending_count = len(pending)
            self._pending_bytes = sum(h.priced_bytes or 0
                                      for h in pending)
            for h in pending:
                h.status = "deferred"
                h.deferrals += 1
                trace.count("serve.deferred")
                self._tally("deferred")
            for h in admitted:
                h.status = "admitted"
                # the queue-wait leg of the query's lifecycle trace:
                # submit() happened on a client thread, admission on
                # this one — record the already-elapsed wait as a span
                # on the query's OWN track, admission evidence in args
                # (docs/observability.md "query-lifecycle tracing")
                trace.record_span(
                    "serve.queue_wait", h.submitted_at,
                    h.queue_wait_ms or 0.0, trace_id=h.trace_id,
                    args={"priced_bytes": h.priced_bytes,
                          "deferrals": h.deferrals})
            trace.count("serve.admitted", len(admitted))
            self._tally("admitted", len(admitted))
            trace.count("serve.batches")
            self._tally("batches")
            trace.gauge("serve.queue_depth",
                        len(pending) + len(self._queue))
            memo = _SharedExecMemo(self)
            if self._views is not None:
                self._views.begin_window()
            with trace.span("serve.window"):
                run_now = admitted
                if self._pipe_dispatch:
                    # pipelined dispatch (docs/serving.md "Materialized
                    # subplans"): clean view hits are host-phase-only
                    # (pool lookup + H2D stage-in + export) — dispatch
                    # them onto the export pipeline's workers NOW, so
                    # they overlap the device phases of the window's
                    # compute queries instead of serializing behind
                    # them.  pin() validates epochs on this thread (the
                    # staleness model's snapshot instant) and holds the
                    # pool entry so eviction cannot race the worker.
                    run_now = []
                    for h in admitted:
                        if self._views.pin(h):
                            h.status = "running"
                            self._pipeline.submit(
                                lambda h=h: self._serve_overlapped(h),
                                trace_id=h.trace_id)
                        else:
                            run_now.append(h)
                for h in run_now:
                    self._execute_one(h, memo)
            if self._views is not None:
                # window-end harvest: subplans that earned a cross-
                # query hit this window persist into the pool for the
                # NEXT window's memo to fault in
                self._views.harvest(memo)
            # the memo dies with the window: its pinned results stay
            # live only while still referenced by handles/exports

    def _execute_one(self, h: QueryHandle, memo: _SharedExecMemo) -> None:
        from ..observe import compile as obcompile
        from ..observe import stats as obstats
        from ..plan import ir
        h.status = "running"
        h.started_at = time.perf_counter()
        memo.begin_query(h)
        deltas: Dict[str, int] = {}
        cevents: list = []
        recoveries: list = []
        if self._views is not None:
            # probe-before-execute (docs/serving.md "Materialized
            # subplans"): a live view serves this query from pooled
            # host blocks (zero exchanges) or folds pending deltas
            # through its captured aggregation state; any probe
            # failure falls through to a full execution — the cache
            # must never fail a query it cannot serve
            probe_deltas: Dict[str, int] = {}
            served = None
            try:
                with trace.trace_context(h.trace_id), \
                        resilience.counter_scope(probe_deltas):
                    with trace.span("serve.query"):
                        served = self._views.probe(h)
            except Exception:
                # the probe is pure cache: its errors degrade to a
                # recompute
                served = None
            if served is not None:
                out, mode = served
                h.view = mode
                h.counters = probe_deltas
                h.compile_ms = 0.0
                h.execute_ms = (time.perf_counter()
                                - h.started_at) * 1e3
                self._deliver(h, out)
                return
        roots: list = []
        vstates: list = []
        try:
            # the query's trace id wraps the WHOLE execution: the
            # serve.query span and every nested operator phase land on
            # this query's track in the Chrome export (the waterfall
            # view, docs/observability.md); the digest collector
            # attributes every plan-cache fingerprint the query
            # materializes to exactly this query (observe.stats); the
            # compile collector does the same for jit builds, so
            # handle.compile_ms separates "this query compiled" from
            # "this query was slow" (docs/observability.md "compile
            # tracking")
            with trace.trace_context(h.trace_id), \
                    obstats.collect_digests() as digests, \
                    obcompile.attribute_compiles() as cevents, \
                    resilience.collect_recoveries() as recoveries, \
                    resilience.counter_scope(deltas):
                with trace.span("serve.query"):
                    # the builder anchors on the EFFECTIVE context: a
                    # batch peer executing right after a victim's
                    # mid-window re-mesh runs on the survivor mesh
                    # (its tables were re-meshed in place) instead of
                    # dispatching a collective onto the dead chip
                    b = ir.Builder(topology.effective(self.ctx),
                                   exec_memo=memo)
                    if h.tables is not None:
                        # per-query tables (submit(tables=...)) are
                        # not covered by the session-table migration
                        # in _check_topology — move any stale one
                        # before pricing reads its layout
                        from ..parallel.remesh import ensure_current
                        ensure_current(h.tables)
                    wrapped = (b.wrap_tables(h.tables)
                               if h.tables is not None else None)
                    # view capture rides the execution: the executor's
                    # root hook hands every pre-rewrite root (the
                    # foldability walk needs runtime-attached scans),
                    # the dist-ops hook hands each mergeable
                    # aggregation state it was computing anyway —
                    # both one thread-local read when idle
                    from ..parallel import dist_ops as _dops
                    from ..plan import executor as _pexec
                    with ir.capture(b), \
                            _pexec.collect_roots() as roots, \
                            _dops.collect_agg_state() as vstates:
                        out = (h.op(wrapped) if h.tables is not None
                               else h.op())
                        out = b.finish(out)
        except BaseException as e:
            # fault ISOLATION is the serving contract: the error
            # belongs to THIS query's handle (BaseException included —
            # an escaping SystemExit must not kill the dispatcher and
            # strand every queued result()); batch peers keep executing
            h.counters = deltas
            h.compile_ms = round(sum(e2["compile_ms"]
                                     for e2 in cevents), 3)
            self._finish(h, error=e)
            return
        h.counters = deltas
        h.compile_ms = round(sum(e2["compile_ms"] for e2 in cevents), 3)
        h.recovered = "recovered" in recoveries
        h.execute_ms = (time.perf_counter() - h.started_at) * 1e3
        # run-stats store (its recording half): the served
        # execution's counter slice lands under every plan fingerprint
        # it materialized — observed-cardinality nodes come from
        # ANALYZE runs of the same fingerprints
        h.plan_digests = list(digests)
        for d in h.plan_digests:
            obstats.STORE.record_run(d, counters=deltas,
                                     latency_ms=h.execute_ms,
                                     label=h.label)
        if self._views is not None:
            try:
                self._views.offer(h, out, roots, vstates)
            except Exception:
                # retention is pure cache; a failed offer must never
                # fail a query that just executed successfully
                pass
        self._deliver(h, out)

    def _deliver(self, h: QueryHandle, out) -> None:
        if h.export is not None and self._pipeline is not None:
            trace.count("serve.exports_async")
            self._tally("exports_async")
            h.status = "exporting"
            # the result crosses to a worker thread: an event recorded
            # on the dispatcher's stream orders the export after the
            # query's queued work whatever stream the worker runs on
            ready = None
            if self.ctx.device.type == "cuda":
                ready = torch.cuda.Event()
                ready.record(torch.cuda.current_stream(self.ctx.device))
            self._pipeline.submit(
                lambda h=h, out=out, ready=ready:
                    self._run_export(h, out, ready),
                trace_id=h.trace_id)
        elif h.export is not None:
            self._run_export(h, out)
        else:
            self._finish(h, value=out)

    def _serve_overlapped(self, h: QueryHandle) -> None:
        """Serve one pinned view hit on an export-pipeline worker —
        the host half of pipelined dispatch.  The pin (taken on the
        dispatcher at window admission) holds the pooled blocks, so
        the only failure mode here is an injected stage-in fault; that
        degrades by requeueing the query for the next window's serial
        recompute path — never a failed or stale answer."""
        h.started_at = time.perf_counter()
        try:
            with trace.trace_context(h.trace_id):
                with trace.span("serve.query"):
                    out = self._views.serve_pinned(h)
        except Exception:
            # pure-cache degrade: recompute via requeue, not a failure
            self._views.unpin(h)
            h.status = "queued"
            if not self._queue.put(h, block=False):
                self._finish(h, error=CylonError(Status(
                    Code.CapacityError,
                    "serve: pipelined view serve failed and the queue "
                    "is full — cannot requeue for recompute")))
            return
        h.view = "hit"
        h.counters = {}
        h.compile_ms = 0.0
        h.execute_ms = (time.perf_counter() - h.started_at) * 1e3
        if h.export is not None:
            self._run_export(h, out)
        else:
            self._finish(h, value=out)

    def _run_export(self, h: QueryHandle, out, ready=None) -> None:
        try:
            if ready is not None:
                torch.cuda.current_stream(self.ctx.device).wait_event(ready)
            self._finish(h, value=h.export(out))
        except BaseException as e:
            # a failed export is the query's own error; BaseException
            # included, else e.g. a SystemExit from user export code
            # lands on the discarded HostTask and the handle never
            # finishes (result() would block forever)
            self._finish(h, error=e)

    def _finish(self, h: QueryHandle, value=None,
                error: Optional[BaseException] = None) -> None:
        from ..observe import flightrec
        h.finished_at = time.perf_counter()
        h.latency_ms = (h.finished_at - h.submitted_at) * 1e3
        if error is not None:
            h.error = error
            h.status = "failed"
            trace.count("serve.failed")
            self._tally("failed")
        else:
            h._value = value
            h.status = "done"
            trace.count("serve.completed")
            self._tally("completed")
            with self._lock:
                self._lat_hist.observe(h.latency_ms)
                # SLO-pressure estimate: EWMA of SERVICE time (execute
                # only).  Full submit→finish latency already contains
                # queue wait, and the shed check multiplies by depth —
                # an EWMA of latency would double-count queueing and
                # spiral into shedding feasible deadlines under load
                svc = (h.execute_ms if h.execute_ms is not None
                       else h.latency_ms)
                self._ewma_ms = (svc if self._ewma_ms is None
                                 else 0.8 * self._ewma_ms + 0.2 * svc)
            if h.recovered:
                # the executor's ladder healed this query mid-flight
                # (docs/robustness.md) — attributed directly via
                # resilience.collect_recoveries, so stats() keeps its
                # counters-off self-accounting contract
                self._tally("recovered")
            # registry-side distributions (the OpenMetrics exporter's
            # histogram series; no-ops with counters off — stats()
            # self-accounts through _lat_hist regardless)
            trace.hist("serve.latency_ms", h.latency_ms)
            if h.queue_wait_ms is not None:
                trace.hist("serve.queue_wait_ms", h.queue_wait_ms)
            if h.priced_bytes:
                trace.hist("serve.query_bytes", h.priced_bytes)
        # circuit-breaker bookkeeping: only queries that actually RAN
        # report an outcome (a straggler failed by session close must
        # not poison its fingerprint); a probe that never ran releases
        # its half-open slot instead.  Only EXECUTION failures count
        # against the plan (h.execute_ms is stamped exactly when
        # execution succeeded): a failing user export callable is the
        # export's problem, not the plan's — quarantining a healthy
        # plan over a flaky sink would be a false positive
        if self._breaker is not None and h.breaker_key is not None:
            if h.started_at is None:
                if h.probe:
                    self._breaker.on_probe_abort(h.breaker_key)
            elif error is not None and h.execute_ms is None:
                opened = self._breaker.on_failure(h.breaker_key, h.op,
                                                  probe=h.probe)
                if opened:
                    flightrec.note("breaker_open", query=h.label,
                                   key=str(h.breaker_key[0]),
                                   probe=h.probe)
            else:
                self._breaker.on_success(h.breaker_key, probe=h.probe)
        # per-query deadline SLO (submit(deadline_ms=...)): checked on
        # the submit→finish latency — a failure past its deadline is
        # both a failure AND an SLO violation, attributed to THIS handle
        if h.deadline_ms is not None and h.latency_ms > h.deadline_ms:
            h.deadline_missed = True
            trace.count("serve.slo_violations")
            self._tally("slo_violations")
            flightrec.note("deadline_miss", query=h.label, qid=h.id,
                           latency_ms=round(h.latency_ms, 3),
                           deadline_ms=h.deadline_ms)
        # every query completion is one bounded flight-recorder event —
        # the "last-K queries" section of a crash bundle
        flightrec.note("query", label=h.label, qid=h.id,
                       status=h.status,
                       latency_ms=round(h.latency_ms, 3),
                       priced_bytes=h.priced_bytes,
                       compile_ms=h.compile_ms,
                       digests=list(h.plan_digests),
                       counters=dict(h.counters),
                       error=(None if error is None
                              else f"{type(error).__name__}: "
                                   f"{str(error)[:160]}"))
        if isinstance(error, CylonError):
            # the post-mortem contract (docs/observability.md "flight
            # recorder"): a CylonError escaping a served query dumps a
            # diagnostic bundle when CYLON_FLIGHTREC_DIR is configured
            # (capped per process; never masks the original error)
            flightrec.maybe_dump_on_error(
                f"serve[{self.name}] query {h.label!r} failed", error)
        self._tail_retire(h, error)
        h._event.set()

    def _tail_retire(self, h: QueryHandle,
                     error: Optional[BaseException]) -> None:
        """The tail sampler's completion-time retention decision
        (docs/observability.md "Live telemetry plane"): always keep
        errors, deadline misses and recovered queries; otherwise keep
        iff this latency makes the window's slowest-k (streaming top-k
        min-heap, reset every ``tail_window`` completions).  Everything
        else is dropped from the span ring via ``trace.finish_trace``
        with visible ``trace.sampled_out`` accounting."""
        if (h.trace_id is None or self._tail_keep_k is None
                or not trace.enabled()):
            return
        keep = bool(error is not None or h.deadline_missed
                    or h.recovered)
        if not keep:
            lat = h.latency_ms if h.latency_ms is not None else 0.0
            with self._lock:
                self._tail_seen += 1
                if self._tail_seen > self._tail_window:
                    self._tail_seen = 1
                    self._tail_heap = []
                if len(self._tail_heap) < self._tail_keep_k:
                    heapq.heappush(self._tail_heap, lat)
                    keep = True
                elif lat > self._tail_heap[0]:
                    heapq.heapreplace(self._tail_heap, lat)
                    keep = True
        # the span-ring mutation happens OUTSIDE the session lock —
        # finish_trace takes the trace module's span lock
        trace.finish_trace(h.trace_id, keep)
