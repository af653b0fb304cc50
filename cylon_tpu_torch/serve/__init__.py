"""Multi-query serving layer (docs/serving.md).

The port of ``cylon_tpu/serve/``: the same surface and semantics, over
the port's planner, operators and spill pool.

The operator-DAG-as-service arm of the engine (arXiv:2212.13732's hybrid
framing, ROADMAP item 1): many concurrent queries over shared base
tables, executed through the logical planner with

  * a bounded admission queue + batch windows (:class:`ServeSession` /
    :class:`QueryQueue`) — backpressure instead of OOM;
  * **cross-query common-subplan sharing** inside a batch window: the
    same scan/select/shuffle chain crosses the wire once and fans out
    to every consumer (``serve.subplan_shared``);
  * **admission control priced against the device-memory budget**
    (serve/admission.py, the shared ``parallel/cost.py`` exchange cost
    model at admission altitude) — queries whose combined exchange transients
    would exceed the budget wait for a later window;
  * an async host export lane (``parallel/streaming.HostPipeline``) so
    Arrow conversion of one query overlaps device compute of the next;
  * per-query fault isolation: one query's error lands on its own
    handle (``resilience.counter_scope`` attributes its retries/faults
    to it alone); batch peers complete.
  * overload protection (docs/serving.md): a per-plan-fingerprint
    **circuit breaker** quarantines poison queries with typed
    :class:`Quarantined` rejections in O(µs) (half-open probes restore
    service automatically), queue-depth / SLO-pressure **load
    shedding** rejects low-priority work with a typed
    :class:`Overloaded` instead of letting it time out, and graceful
    ``drain()`` finishes in-flight work, flushes the async export lane
    and the run-stats store, then returns the final stats snapshot.
  * **fleet mode** (serve/router.py): N sessions over disjoint slot
    groups (``CylonContext(first_slot=...)``) behind one :class:`FleetRouter` — placement by plan-cache
    affinity (the shared run-stats store) then priced-bytes load,
    failover past quarantined/degraded/draining replicas, per-replica
    drain (docs/serving.md "Fleet mode").

Quick start::

    from cylon_tpu_torch.serve import ServeSession

    with ServeSession(ctx, tables=dts, batch_window_ms=4.0) as s:
        handles = [s.submit(lambda t, q=q: q(ctx, t),
                            export=lambda r: r.to_pandas())
                   for q in queries]
        frames = [h.result() for h in handles]
        print(s.stats())   # p50/p99 latency, admitted/deferred, shares
"""
from __future__ import annotations

from .admission import admit, price_query, price_table, scaled_budget
from .router import FleetRouter
from .session import (CapacityRequest, CircuitBreaker, Overloaded,
                      QueryHandle, QueryQueue, Quarantined, ServeSession,
                      percentile)

__all__ = ["ServeSession", "QueryHandle", "QueryQueue", "percentile",
           "price_query", "price_table", "admit", "scaled_budget",
           "CircuitBreaker", "Overloaded", "Quarantined",
           "CapacityRequest", "FleetRouter"]
