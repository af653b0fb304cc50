"""Admission control: pricing queries against the device-memory budget.

The port of ``cylon_tpu/serve/admission.py``: the same prices and the
same decisions, so one budget admits the same queries in both packages.

A serving workload runs many queries against one device's memory; the
failure mode this module prevents is ADDITIVE — each query's exchanges
are individually budget-guarded (parallel/shuffle.py degrades an
over-budget exchange to the chunked multi-round path), but a batch of
queries admitted together keeps earlier queries' result blocks live
(pinned by the shared execution memo and the async export lane) while
later queries dispatch their own exchanges.  Admission bounds the SUM:
a window's co-admitted queries must fit the budget *as priced*, or wait.

The pricing is the SHARED exchange cost model at admission altitude
(``parallel/cost.py``): one exchange over a table
with ``P`` shards of capacity ``cap`` prices
``(2·P·block + outcap) · row_bytes`` (``cost.single_shot_bytes`` —
grouped send buffer + all_to_all receive mirror + compacted output,
the same formula the runtime chooser prices single-shot candidates
with), and at admission time the sync-free evidence for
``block``/``outcap`` is exactly what ``rows_if_small`` uses for the
broadcast decision: ingest-cached counts when available, else the
``P × cap`` capacity bound.  A query's price is its WORST single
exchange — the largest base table it reads — because execution within
a query is serial: two of its exchanges never fly concurrently, but
its largest one will.  Admission deliberately prices the single-shot
UPPER BOUND even when the chooser would later degrade the exchange to
a cheaper staged lowering: admission runs before any count matrix
exists, and over-admitting on an optimistic price is the failure mode
this module exists to prevent.

The budget keeps the JAX package's per-shard meaning
(``resilience.exchange_budget()``).  On one card the P simulated shards
share one memory, so a window's priced bytes are per-shard bytes, not
the card's footprint.

Admission never starves: the window's head-of-line query is admitted
even when over budget alone (the exchange stack's chunked degrade
bounds its per-round transient; holding it back forever would turn a
big query into a deadlock).  Everything else waits for a later window
and bumps ``serve.deferred``.
"""
from __future__ import annotations

import time
from typing import Dict, List, Tuple

import numpy as np

# No shared mutable state: pricing is a pure function of its inputs (the
# empty catalogue is the lint contract saying so).
GUARDED_STATE: Dict[str, str] = {}

__all__ = ["price_table", "price_query", "admit", "scaled_budget",
           "PROBE_PRICE"]

# What a probable materialized-view hit prices: ~0.  A view-served
# query dispatches NO exchange — it rebuilds its result from pooled
# host blocks (serve/matview.py) — so charging it the worst-exchange
# price would defer real work behind queries that will never use the
# budget.  The session stamps this at submit time when the store's
# would_hit() says a live view covers the fingerprint; the signal is
# advisory (the view can evict or invalidate before dispatch), which
# is exactly the over-admission tolerance admission already grants the
# head-of-line query.
PROBE_PRICE = 0


def scaled_budget(base: int, world: int, base_world: int) -> int:
    """Re-price the window admission budget to the CURRENT mesh size
    (docs/robustness.md "Elasticity").  ``P'`` survivors of a ``P``
    -device session hold ``P'/P`` of the fleet's aggregate transient
    headroom, so a degraded window may co-admit proportionally less;
    a scale-up is the EXACT INVERSE — as the mesh re-expands the
    budget re-prices back up along the same line, and a full restore
    (``world >= base_world``) returns ``base`` verbatim, so degraded
    mode's admission squeeze relaxes the moment the world grows."""
    if base_world <= 0 or world >= base_world:
        return base
    return max(int(base * world / base_world), 1)


def price_table(dt) -> int:
    """Per-device transient price of ONE exchange over ``dt`` — the
    shared cost model's single-shot formula (``cost.single_shot_bytes``)
    fed with admission-time (sync-free) size evidence.  Static metadata
    only; never touches device data, so pricing N queued queries costs
    zero round trips.

    A SPILLED table (docs/out_of_core.md) prices as ONE admission-sized
    morsel instead of its whole block: its leaves live host-side, the
    engine streams them in morsels priced to fit, and reading
    ``dt.columns`` here would fault the whole table in just to price
    it — exactly the transfer admission exists to avoid scheduling."""
    from .. import observe
    from ..ops import compact as ops_compact
    from ..parallel import cost

    if getattr(dt, "is_spilled", False):
        from ..resilience import exchange_budget
        from ..spill import morsel as spill_morsel
        _k, _w, per_morsel = spill_morsel.plan_morsels(
            dt.nparts, dt.cap, spill_morsel._spilled_rbytes(dt),
            exchange_budget(dt.ctx.device))
        return per_morsel
    leaves = [lf for c in dt.columns for lf in (c.data, c.validity)
              if lf is not None]
    rbytes = max(observe.row_bytes(leaves), 1)
    ch = dt._counts_host
    if ch is not None and dt.pending_mask is None:
        total = int(np.asarray(ch).sum())
    else:
        total = dt.nparts * dt.cap
    outcap = ops_compact.next_bucket(max(total, 1), minimum=8)
    return cost.single_shot_bytes(dt.nparts, (dt.cap, outcap), rbytes)


def price_query(tables) -> int:
    """A query's admission price: the worst single exchange it can
    dispatch = the price of the largest base table it reads (``tables``
    is the dict/table handed to ``submit``).  Within one query,
    execution is serial, so exchanges do not stack — across queries in
    a window they effectively do (results stay live), which is what
    :func:`admit` sums."""
    from ..parallel.dtable import DTable

    if tables is None:
        return 0
    if isinstance(tables, DTable):
        return price_table(tables)
    if isinstance(tables, dict):
        prices = [price_table(t) for t in tables.values()
                  if isinstance(t, DTable)]
        return max(prices) if prices else 0
    return 0


def admit(batch: List, budget: int) -> Tuple[List, List]:
    """Split ``batch`` (arrival order) into ``(admitted, deferred)``:
    queries admit while the running price total stays within ``budget``;
    the head-of-line query always admits (progress guarantee — see the
    module docstring).  Each handle's ``priced_bytes`` must already be
    set (the session prices at submit time).

    Admission is a point on each query's lifecycle trace: admitted
    handles get ``admitted_at``/``queue_wait_ms`` stamped here, which
    the session records as the query's ``serve.queue_wait`` span
    (price + deferral count in its args) on the query's own track
    (docs/observability.md "query-lifecycle tracing")."""
    admitted: List = []
    deferred: List = []
    total = 0
    now = time.perf_counter()
    for h in batch:
        price = h.priced_bytes or 0
        if not admitted or total + price <= budget:
            h.admitted_at = now
            h.queue_wait_ms = (now - h.submitted_at) * 1e3
            admitted.append(h)
            total += price
        else:
            deferred.append(h)
    return admitted, deferred
