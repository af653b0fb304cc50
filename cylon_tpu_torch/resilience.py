"""Resilience: memory-budget guardrails + bounded retry-with-backoff.

The port's copy of ``cylon_tpu/resilience.py``.  Three parts:

**Memory budget.**  ``config.set_device_memory_budget(bytes)`` bounds
the per-shard transient footprint an exchange may price;
:func:`exchange_budget` is the engine-side read, with the
``resilience.budget`` fault point applied so a FaultPlan can simulate
allocation pressure.  Its consumers:

  * ``parallel/shuffle.shuffle_leaves`` prices every sized exchange
    through the shared cost model (``parallel/cost.py``) and degrades
    an over-budget one to the cheapest lowering that fits (chunked
    rounds, a ring of permutes, allgather-and-filter, the hierarchical
    two-level exchange);
  * ``parallel/broadcast.rows_if_small`` vetoes a broadcast whose
    replica would not fit (``cost.price_replicate``).

The budget keeps the JAX package's meaning: bytes PER SHARD.  On one
card the P simulated shards share one memory, so the card holds about P
times the priced bytes.

**Bounded retry.**  :func:`retry_call` wraps the transient-classed
failure boundary (the shuffle's host count read) with an attempt cap and
exponential backoff under decorrelated jitter: each sleep is drawn
uniformly from ``[base, min(max, prev·3)]`` (``jitter=False`` restores
the deterministic schedule).  Classification is type-based:
:class:`faults.TransientFault` plus ``ConnectionError`` /
``TimeoutError`` / ``InterruptedError`` retry; everything else —
:class:`faults.PermanentFault` included — propagates at once.  Retries
bump ``retry.attempts``; an exhausted loop bumps ``retry.exhausted`` and
re-raises the last transient error.

**Failure classes.**  :func:`classify` sorts any failure into transient /
resource / permanent / topology.  A CUDA out-of-memory error
(``torch.OutOfMemoryError``) is the resource class, as XLA's
``RESOURCE_EXHAUSTED`` is in the JAX package.  The escalation ladder that
acts on the class (``Ladder``, ``RecoveryPolicy``, the exchange
demotions, the recovery collectors) comes with the recovery driver,
which is not in the port yet: today nothing catches a failed exchange
and reroutes it.
"""
from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional, Tuple, Type

import torch

from . import config, faults
from .status import Code, CylonError, Status

__all__ = [
    "RetryPolicy", "retry_policy", "set_retry_policy", "retry_call",
    "exchange_budget", "classify",
]


@dataclass(frozen=True)
class RetryPolicy:
    """Attempt cap + jittered exponential backoff for one transient
    boundary.

    ``max_attempts`` counts TOTAL tries (1 = no retry).  With ``jitter``
    (the default) each sleep is drawn from ``[base_delay_s,
    min(max_delay_s, prev_sleep * 3)]`` — decorrelated jitter, so N
    concurrent serving queries tripping over the same transient do not
    re-arrive in lockstep (the thundering herd a fixed schedule
    produces).  With ``jitter=False`` delays grow ``base_delay_s *
    multiplier**k`` capped at ``max_delay_s`` — the deterministic
    schedule, kept for timing-sensitive tests.  Both shapes are bounded
    by construction: no unbounded spin (the failure mode the
    reference's missing fault tolerance would have had nothing to say
    about)."""

    max_attempts: int = 5
    base_delay_s: float = 0.005
    multiplier: float = 2.0
    max_delay_s: float = 0.25
    jitter: bool = True
    # total ELAPSED-time budget across one retry loop (first attempt's
    # wall-clock included), in seconds.  The attempt cap alone does not
    # bound latency: five attempts whose sleeps individually back off
    # can exceed any deadline a serving query carries.  With a budget
    # set, retry_call stops retrying once the next sleep would bust it
    # (retry.exhausted, the last transient error re-raised) — and the
    # serve layer's deadline estimates can SEE the cap
    # (docs/serving.md "deadlines").  None keeps the attempts-only
    # historical behavior.
    max_elapsed_s: Optional[float] = None
    transient_types: Tuple[Type[BaseException], ...] = (
        faults.TransientFault, ConnectionError, TimeoutError,
        InterruptedError)

    def __post_init__(self):
        if not isinstance(self.max_attempts, int) or self.max_attempts < 1:
            raise CylonError(Status(Code.Invalid,
                f"max_attempts must be a positive int, "
                f"got {self.max_attempts!r}"))
        if self.max_elapsed_s is not None:
            if isinstance(self.max_elapsed_s, bool) \
                    or not isinstance(self.max_elapsed_s, (int, float)) \
                    or not self.max_elapsed_s > 0:
                raise CylonError(Status(Code.Invalid,
                    f"max_elapsed_s must be a positive duration in "
                    f"seconds or None, got {self.max_elapsed_s!r}"))

    def is_transient(self, exc: BaseException) -> bool:
        if isinstance(exc, faults.PermanentFault):
            return False
        return isinstance(exc, self.transient_types)


_policy = RetryPolicy()

# the decorrelated-jitter draw source: one process-level RNG, OS-seeded
# (two processes — or two threads — must NOT share a backoff schedule;
# that is the herd).  Tests may reseed via _jitter_rng.seed(k) to pin a
# sequence; the lock keeps concurrent draws well-defined.
_jitter_rng = random.Random()
_jitter_lock = threading.Lock()


def _next_sleep(pol: RetryPolicy, prev_sleep: float,
                attempt: int) -> float:
    """One backoff delay.  Jittered: uniform over ``[base,
    min(max, max(prev, base)*3)]`` (decorrelated — the width tracks
    the previous ACTUAL sleep, desynchronizing callers that failed
    together; seeding prev with base keeps the FIRST retry's window
    ``[base, 3*base]`` wide too, since a degenerate first draw would
    re-arrive every herd member in lockstep exactly where it
    matters most).  Deterministic: ``base * multiplier**(attempt-1)``
    capped at max."""
    if not pol.jitter:
        return min(pol.base_delay_s * pol.multiplier ** (attempt - 1),
                   pol.max_delay_s)
    hi = min(pol.max_delay_s,
             max(prev_sleep, pol.base_delay_s) * 3.0)
    with _jitter_lock:
        return _jitter_rng.uniform(min(pol.base_delay_s, hi), hi)


def retry_policy() -> RetryPolicy:
    """The session-wide default policy."""
    return _policy


def set_retry_policy(policy: RetryPolicy) -> RetryPolicy:
    """Swap the session default; returns the previous policy (callers
    restore it in a finally — the same A/B idiom as the config knobs)."""
    global _policy
    if not isinstance(policy, RetryPolicy):
        raise CylonError(Status(Code.Invalid,
            f"expected a RetryPolicy, got {type(policy).__name__}"))
    prev = _policy
    _policy = policy
    return prev


def retry_call(fn: Callable, *, point: str = "",
               policy: Optional[RetryPolicy] = None):
    """Run ``fn()`` under ``policy`` (default: the session policy).

    Transient-classed failures are retried with backoff up to the
    attempt cap; each retry bumps ``retry.attempts``.  A non-transient
    error — or the last transient one once attempts are exhausted
    (``retry.exhausted``) — propagates unchanged.
    """
    from . import logging as glog
    from . import trace

    pol = policy if policy is not None else _policy
    sleep_s = 0.0
    t0 = time.monotonic()
    for attempt in range(1, pol.max_attempts + 1):
        try:
            return fn()
        except BaseException as e:
            if not pol.is_transient(e):
                raise
            if attempt >= pol.max_attempts:
                trace.count("retry.exhausted")
                glog.warning(
                    "retry exhausted after %d attempt(s) at %s: %s",
                    attempt, point or "<boundary>", e)
                raise
            sleep_s = _next_sleep(pol, sleep_s, attempt)
            if pol.max_elapsed_s is not None and \
                    time.monotonic() - t0 + sleep_s > pol.max_elapsed_s:
                # the elapsed-time budget: another backoff would bust
                # it — stop HERE, not after sleeping past the deadline
                # the caller is holding (the retries-exceed-any-
                # deadline failure mode the attempts cap alone allows)
                trace.count("retry.exhausted")
                glog.warning(
                    "retry elapsed budget (%.3f s) exhausted after %d "
                    "attempt(s) at %s: %s", pol.max_elapsed_s, attempt,
                    point or "<boundary>", e)
                raise
            # booked only once a retry is actually going to happen —
            # the budget abort above is an exhaustion, not an attempt
            trace.count("retry.attempts")
            glog.vlog(1, "transient failure at %s (attempt %d/%d), "
                         "retrying in %.0f ms: %s",
                      point or "<boundary>", attempt, pol.max_attempts,
                      sleep_s * 1e3, e)
            if sleep_s > 0:
                time.sleep(sleep_s)


def exchange_budget(device=None) -> int:
    """The effective per-shard memory budget for one exchange on
    ``device``, in bytes: ``config.device_memory_budget(device)``
    (explicit, env, or half the device's memory) with the
    ``resilience.budget`` fault point applied, so an installed FaultPlan
    can shrink it mid-query (simulated allocation pressure)."""
    return max(int(faults.perturb("resilience.budget",
                                  config.device_memory_budget(device))), 1)


# ---------------------------------------------------------------------------
# failure classes (docs/robustness.md "the escalation ladder")
# ---------------------------------------------------------------------------

TRANSIENT = "transient"
RESOURCE = "resource"
PERMANENT = "permanent"
TOPOLOGY = "topology"


def classify(exc: BaseException) -> str:
    """Sort one failure into the ladder's classes.

    ``transient`` — the retryable class (the types :class:`RetryPolicy`
    retries: an injected :class:`faults.TransientFault`, connection /
    timeout / interrupt).  A transient REACHING the ladder already
    exhausted the inner retries.

    ``resource`` — the allocation class: a typed OOM
    (:class:`faults.ResourceFault`, ``MemoryError``, a ``CylonError``
    carrying ``Code.OutOfMemory``) or a CUDA out-of-memory error
    (``torch.OutOfMemoryError``, the counterpart of XLA's
    ``RESOURCE_EXHAUSTED``), and any injected fault at a ``spill.*``
    staging point.  Retrying the same plan would re-request the same
    allocation.

    ``topology`` — an injected :class:`faults.TopologyFault` (a device
    lost mid-query): the answer is evacuate and re-mesh.

    ``permanent`` — everything else, :class:`faults.PermanentFault`
    included."""
    if isinstance(exc, faults.PermanentFault):
        return PERMANENT
    if isinstance(exc, faults.TopologyFault):
        return TOPOLOGY
    if isinstance(exc, faults.FaultError) \
            and getattr(exc, "point", "").startswith("spill."):
        return RESOURCE
    if isinstance(exc, (faults.ResourceFault, MemoryError,
                        torch.OutOfMemoryError)):
        return RESOURCE
    if isinstance(exc, CylonError) \
            and getattr(getattr(exc, "status", None), "code", None) \
            == Code.OutOfMemory:
        return RESOURCE
    if isinstance(exc, _policy.transient_types):
        return TRANSIENT
    return PERMANENT
