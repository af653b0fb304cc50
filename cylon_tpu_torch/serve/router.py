"""Fleet routing: one front door over N serving replicas.

The port of ``cylon_tpu/serve/router.py``.  A :class:`FleetRouter`
places queries across several
:class:`~cylon_tpu_torch.serve.session.ServeSession` replicas, each
serving its OWN disjoint group of shard slots (docs/serving.md "Fleet
mode"; a replica's slots are ``topology.slots(ctx)``: a context made
with ``first_slot=`` holds a range of them on its card) — the
multi-mesh arm of the elasticity story (docs/robustness.md): where a
single session shrinks and re-grows one mesh, a fleet trades whole
replicas in and out.  Placement is decided per query, in O(replicas),
from host-side evidence only:

  * **live-view affinity first** — a replica whose materialized-view
    store holds a live view for this fingerprint
    (:meth:`ServeSession.holds_view`) answers from pooled host blocks
    with zero exchanges, so it outranks every other signal
    (``serve.router_view_affinity_hits``).
  * **plan-cache affinity next** — a fingerprint that already ran
    routes back to the replica that compiled it, read from the SHARED
    run-stats store (``observe.stats.STORE``, the ``replica`` field
    ``set_replica`` stamps after each successful placement).  A hot
    plan re-compiling per replica would pay the jit tax once per mesh;
    affinity pays it once per fleet (``serve.router_affinity_hits``).
  * **priced-bytes load otherwise** — the least-loaded healthy replica
    by :meth:`ServeSession.load_bytes`: queued + budget-deferred work
    valued by the one shared admission cost model, so load compares
    honestly across replicas of different sizes.
  * **failover always** — a replica that is closed, draining, mesh-
    degraded, or whose breaker quarantines this fingerprint is skipped
    and the query fails over to the next-best healthy replica
    (``serve.router_failovers``); only when EVERY replica is out does
    the router re-raise the preferred replica's rejection.

Draining is per replica (:meth:`drain`): the fleet keeps serving on
the survivors while one replica finishes in-flight work — the serving
twin of the executor's shrink-to-survivors rung.

Replicas over disjoint slot ranges of ONE card share that card's
memory: each session prices admission against its own per-shard budget,
so the card holds the sum of what the replicas admit.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

from .. import topology, trace
from ..observe.locks import OrderedLock
from ..status import Code, CylonError, Status
from .session import CircuitBreaker, QueryHandle, ServeSession

# The draining set mutates under the router's own OrderedLock.  The
# session dict is frozen at construction (placement reads it lock-free).

__all__ = ["FleetRouter"]

_UNSET = object()


class FleetRouter:
    """Route queries across serving replicas by affinity, then load.

    ``sessions`` — the replicas, each a running :class:`ServeSession`
    over its own slot group; names must be unique (they key the
    run-stats store's affinity records and the drain API) and slot
    groups must be disjoint (two replicas sharing a slot would
    double-admit against one shard's budget and the placement score
    would lie).
    """

    def __init__(self, sessions: List[ServeSession]) -> None:
        from ..context import refuse_multiprocess
        refuse_multiprocess("serve.FleetRouter")
        if not sessions:
            raise CylonError(Status(Code.Invalid,
                "FleetRouter needs at least one ServeSession"))
        names = [s.name for s in sessions]
        if len(set(names)) != len(names):
            raise CylonError(Status(Code.Invalid,
                f"FleetRouter replica names must be unique, got {names}"))
        seen: Dict[Any, str] = {}
        for s in sessions:
            for d in topology.slots(s.ctx):
                if d in seen:
                    raise CylonError(Status(Code.Invalid,
                        f"FleetRouter replicas {seen[d]!r} and "
                        f"{s.name!r} share slot {d} — replica slot "
                        "groups must be disjoint"))
                seen[d] = s.name
        self._sessions: Dict[str, ServeSession] = {
            s.name: s for s in sessions}
        self._draining: set = set()
        self._lock = OrderedLock("serve.router")

    # -- introspection -------------------------------------------------------

    def sessions(self) -> List[ServeSession]:
        return list(self._sessions.values())

    def replica_of(self, op: Callable) -> Optional[str]:
        """The replica this op's fingerprint has affinity to, if any
        (the shared run-stats store's ``replica`` field) — exposed so
        tests and the doctor can explain a placement."""
        from ..observe import stats as obstats
        rec = obstats.STORE.get(self._digest(op))
        name = rec.get("replica") if rec else None
        return name if name in self._sessions else None

    # -- placement -----------------------------------------------------------

    @staticmethod
    def _digest(op: Callable) -> str:
        # the breaker's submit-altitude fingerprint (code identity +
        # captured-value identities) hashed into the stats store's
        # digest namespace: one key per logical plan per process, the
        # same collision behavior the breaker itself has
        from ..observe import stats as obstats
        return obstats.plan_digest(("router", CircuitBreaker.key_of(op)))

    def _healthy(self, s: ServeSession, op: Callable) -> bool:
        if s._closed or s.name in self._drain_snapshot():
            return False
        if topology.degraded(s.ctx):
            # a degraded replica still serves its own queue, but the
            # router stops SENDING to it — new work belongs on a
            # full-strength mesh while this one waits for its rejoin
            return False
        if s._breaker is not None:
            key = CircuitBreaker.key_of(op)
            if s._breaker.state_of(key) == CircuitBreaker.OPEN:
                return False
        return True

    def _drain_snapshot(self) -> set:
        with self._lock:
            return set(self._draining)

    def _place(self, op: Callable):
        """Return ``(session, affinity_hit, view_hit, failed_over)`` —
        the placement decision and its evidence.  A replica holding a
        LIVE materialized view for this fingerprint outranks plan-cache
        affinity: the view replica answers from pooled host blocks with
        zero exchanges (docs/serving.md "Materialized subplans"), where
        the compiled-plan replica still executes — so the view is the
        cheaper home whenever both exist and the former is healthy."""
        affinity = self.replica_of(op)
        view = next((s.name for s in self._sessions.values()
                     if s.holds_view(op)), None)
        preferred = [n for n in (view, affinity) if n is not None]
        order: List[ServeSession] = []
        for n in preferred:
            if n not in (s.name for s in order):
                order.append(self._sessions[n])
        # least priced-bytes load first among the rest — ties break on
        # name for determinism
        rest = sorted((s for s in self._sessions.values()
                       if s.name not in preferred),
                      key=lambda s: (s.load_bytes(), s.name))
        order.extend(rest)
        for i, s in enumerate(order):
            if self._healthy(s, op):
                view_hit = view is not None and s.name == view
                hit = (affinity is not None and s.name == affinity)
                failed_over = bool(preferred) and i > 0 and not (
                    view_hit or hit)
                return s, hit, view_hit, failed_over
        # every replica is out: surface the preferred replica's state
        # as a typed error instead of silently queueing on a corpse
        return order[0], False, False, False

    def submit(self, op: Callable, tables=_UNSET, **kw) -> QueryHandle:
        """Place ``op`` on a replica and ``submit`` it there; returns
        that session's :class:`QueryHandle`.  Accepts every
        :meth:`ServeSession.submit` keyword.  Per-query ``tables`` are
        discouraged in fleet mode (they pin data to one replica's
        mesh); the usual shape is replicas constructed over their own
        session tables and ops closing over none."""
        from ..observe import flightrec
        from ..observe import stats as obstats
        s, hit, view_hit, failed_over = self._place(op)
        trace.count("serve.router_routed")
        if hit:
            trace.count("serve.router_affinity_hits")
        if view_hit:
            trace.count("serve.router_view_affinity_hits")
        if failed_over:
            trace.count("serve.router_failovers")
            flightrec.note("router_failover", to=s.name,
                           digest=self._digest(op))
        if tables is _UNSET:
            h = s.submit(op, **kw)
        else:
            h = s.submit(op, tables, **kw)
        # affinity sticks from the first successful placement: the
        # record is created if this fingerprint never ran (set_replica
        # creates-on-miss by design) and re-stamped on failover so the
        # NEXT query follows the plan to its new home
        obstats.STORE.set_replica(self._digest(op), s.name)
        return h

    def run(self, op: Callable, tables=_UNSET, *,
            timeout: Optional[float] = None, **kw):
        """``submit`` + ``result`` — the synchronous convenience form."""
        return self.submit(op, tables, **kw).result(timeout)

    # -- lifecycle -----------------------------------------------------------

    def drain(self, name: str) -> Dict[str, Any]:
        """Drain ONE replica (graceful per-replica shutdown): stop
        routing to it, let it finish everything in flight
        (:meth:`ServeSession.drain`), return its final stats.  The
        rest of the fleet keeps serving throughout."""
        s = self._sessions.get(name)
        if s is None:
            raise CylonError(Status(Code.Invalid,
                f"FleetRouter has no replica {name!r} "
                f"(replicas: {sorted(self._sessions)})"))
        with self._lock:
            self._draining.add(name)
        return s.drain()

    def close(self) -> None:
        """Close every replica.  Idempotent."""
        for s in self._sessions.values():
            with self._lock:
                self._draining.add(s.name)
            s.close()

    def __enter__(self) -> "FleetRouter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def stats(self) -> Dict[str, Any]:
        """Per-replica :meth:`ServeSession.stats` snapshots keyed by
        replica name, plus the fleet's current draining set."""
        out: Dict[str, Any] = {name: s.stats()
                               for name, s in self._sessions.items()}
        out["draining"] = sorted(self._drain_snapshot())
        return out
