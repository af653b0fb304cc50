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

**Bounded retry.**  :func:`retry_call` (and its decorator form
:func:`retrying`) wraps the transient-classed failure boundary (the
shuffle's host count read) with an attempt cap and
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
``RESOURCE_EXHAUSTED`` is in the JAX package.

**The escalation ladder.**  The plan executor's recovery driver
(``plan/executor._execute_recovering``) runs one :class:`Ladder` per
materialization under the session :class:`RecoveryPolicy`: a transient
failure retries the stage (resuming from the execution memo), a
resource failure replans (the chooser runs under
:func:`demoted_exchanges`, off the lowerings the failed attempt picked,
which :func:`collect_strategy_choices` recorded), a topology failure
re-meshes onto the survivors, and anything else, or an exhausted arm,
fails with the attempt log attached.  :func:`note_recovery` hands
outcomes to the per-query collector the serving layer opens
(:func:`collect_recoveries`); without one it is a no-op.

**Attribution.**  :func:`counter_scope` fills a dict with the counter
deltas of the enclosed block: the serving dispatcher wraps each query's
execution in one, so a batch's global counter stream decomposes into
per-query slices.
"""
from __future__ import annotations

import contextlib
import functools
import random
import re
import threading
import time
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple, Type

import torch

from . import config, faults
from .status import Code, CylonError, Status

__all__ = [
    "RetryPolicy", "retry_policy", "set_retry_policy", "retry_call",
    "retrying", "exchange_budget", "counter_scope", "classify", "TRANSIENT",
    "RESOURCE", "PERMANENT", "TOPOLOGY", "RecoveryPolicy",
    "recovery_policy", "set_recovery_policy", "LadderAttempt", "Ladder",
    "collect_recoveries", "note_recovery", "note_strategy_choice",
    "collect_strategy_choices", "exchange_demotions", "demoted_exchanges",
]


@contextlib.contextmanager
def counter_scope(out: dict):
    """Per-query attribution window: fills ``out`` with the merged
    counter deltas of the enclosed block (counters subtract; watermarks
    report the block's new peak when it moved).  The serving dispatcher
    executes admitted queries serially, so their windows do not overlap
    and attribution is exact; an overlapping window (an async export
    tail) is charged every shared bump."""
    from . import trace
    before = trace.counters()
    try:
        yield out
    finally:
        from .observe.metrics import counter_delta
        out.update(counter_delta(before, trace.counters()))


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


def retrying(policy: Optional[RetryPolicy] = None) -> Callable:
    """Decorator form of :func:`retry_call`, its point the wrapped
    function's ``__qualname__``::

        @resilience.retrying()
        def read_counts(...): ...
    """

    def deco(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            return retry_call(lambda: fn(*args, **kwargs),
                              point=getattr(fn, "__qualname__", ""),
                              policy=policy)
        return wrapper

    return deco


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


# what a process group says when a peer is gone: gloo's "Connection
# closed by peer" / "Connection reset", NCCL's aborted communicator or
# watchdog timeout, a broken pipe or a timed-out rank
_PEER_LOSS = re.compile(
    r"closed by peer|connection (?:closed|reset|refused)|broken pipe"
    r"|(?:peer|rank|process)\b.{0,80}\b(?:lost|closed|abort\w*|exited"
    r"|gone|died|timed out)"
    r"|(?:nccl|gloo|process ?group|collective|communicator|watchdog)\b"
    r".{0,120}\b(?:abort\w*|timed out|timeout|closed|lost)", re.I)


def _peer_lost(exc: BaseException) -> bool:
    """Whether ``exc`` reports a lost peer of a process group."""
    if isinstance(exc, torch.OutOfMemoryError):
        return False
    try:
        from torch.distributed import DistBackendError, DistNetworkError
    except ImportError:  # a torch built without torch.distributed
        return False
    if isinstance(exc, (DistBackendError, DistNetworkError)):
        return True
    return isinstance(exc, RuntimeError) and not isinstance(exc, CylonError) \
        and _PEER_LOSS.search(str(exc)) is not None


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
    lost mid-query), or a peer process lost under the process
    communicator: a ``torch.distributed`` backend / network error, or a
    ``RuntimeError`` from the process group naming a lost, closed,
    aborted or timed-out peer (the counterpart of the JAX package's rule
    for a lost / unavailable / halted device).  The answer is evacuate
    and re-mesh.

    ``permanent`` — everything else, :class:`faults.PermanentFault`
    included."""
    if isinstance(exc, faults.PermanentFault):
        return PERMANENT
    if isinstance(exc, faults.TopologyFault) or _peer_lost(exc):
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


# ---------------------------------------------------------------------------
# the escalation ladder (plan/executor._execute_recovering runs it)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class RecoveryPolicy:
    """Bounds of one recovery ladder (the plan executor runs one per
    materialization).

    ``max_stage_retries``     transient-classed stage retries before the
                              ladder gives up (each resumes from the
                              last checkpoint).
    ``max_replans``           resource-classed replans; replan k excludes
                              the k cheapest catalogue strategies (and
                              every strategy the failed attempts chose)
                              — chunked is never excluded, its C = 1
                              floor is the last-resort lowering.
    ``max_remeshes``          topology-classed re-meshes (device loss):
                              each evacuates to the host tier and
                              shrinks the mesh onto the survivors.
    ``max_scaleups``          mid-plan mesh EXPANSIONS (device rejoin),
                              bounded apart from ``max_remeshes``: an
                              expansion is an opportunity taken and must
                              never consume the loss budget a later real
                              failure needs.
    ``checkpoint_fraction``   the share of ``exchange_budget()`` the
                              stage-checkpoint store may retain across
                              attempts (``cost.price_retained``; 0
                              disables checkpoints).
    """

    max_stage_retries: int = 2
    max_replans: int = 2
    max_remeshes: int = 1
    max_scaleups: int = 1
    checkpoint_fraction: float = 0.25

    def __post_init__(self):
        if self.max_stage_retries < 0 or self.max_replans < 0 \
                or self.max_remeshes < 0 or self.max_scaleups < 0:
            raise CylonError(Status(Code.Invalid,
                "RecoveryPolicy retry/replan/remesh/scaleup caps must "
                "be >= 0"))
        if not 0.0 <= self.checkpoint_fraction <= 1.0:
            raise CylonError(Status(Code.Invalid,
                f"checkpoint_fraction must be in [0, 1], got "
                f"{self.checkpoint_fraction!r}"))


_recovery_policy = RecoveryPolicy()


def recovery_policy() -> RecoveryPolicy:
    return _recovery_policy


def set_recovery_policy(policy: RecoveryPolicy) -> RecoveryPolicy:
    """Swap the session recovery policy; returns the previous one (the
    restore-in-finally idiom of :func:`set_retry_policy`)."""
    global _recovery_policy
    if not isinstance(policy, RecoveryPolicy):
        raise CylonError(Status(Code.Invalid,
            f"expected a RecoveryPolicy, got {type(policy).__name__}"))
    prev = _recovery_policy
    _recovery_policy = policy
    return prev


@dataclass
class LadderAttempt:
    """One rung taken: what failed, how it was classed, what the ladder
    did about it (the attempt log annotates the error and the
    flight-recorder event when the ladder fails)."""

    klass: str
    action: str               # retry | replan | remesh | fail
    error: str                # "<Type>: <message prefix>"

    def as_dict(self) -> dict:
        return {"class": self.klass, "action": self.action,
                "error": self.error}


class Ladder:
    """The decision state of one recovery session: bounded counts per
    arm, an attempt log, and the current demotion level.  The caller
    owns the loop; :meth:`decide` only classifies and books."""

    def __init__(self, policy: Optional[RecoveryPolicy] = None):
        self.policy = policy if policy is not None else _recovery_policy
        self.retries = 0
        self.replans = 0
        self.remeshes = 0
        self.attempts: List[LadderAttempt] = []

    @property
    def demote_level(self) -> int:
        return self.replans

    def decide(self, exc: BaseException) -> str:
        """Class ``exc``, record the attempt, return the action:
        ``"retry"`` (stage retry from checkpoint), ``"replan"``
        (re-lower the exchanges demoted one level), ``"remesh"``
        (evacuate + shrink the mesh onto the survivors), or
        ``"fail"``."""
        klass = classify(exc)
        if klass == TRANSIENT and self.retries < self.policy.max_stage_retries:
            self.retries += 1
            action = "retry"
        elif klass == RESOURCE and self.replans < self.policy.max_replans:
            self.replans += 1
            action = "replan"
        elif klass == TOPOLOGY and self.remeshes < self.policy.max_remeshes:
            self.remeshes += 1
            action = "remesh"
        else:
            action = "fail"
        self.attempts.append(LadderAttempt(
            klass, action, f"{type(exc).__name__}: {str(exc)[:160]}"))
        return action

    def as_dicts(self) -> List[dict]:
        return [a.as_dict() for a in self.attempts]


# recovery outcomes: the serving layer's stats() self-account
# independently of the counter registry, so the driver notes each healed
# query into a thread-local sink the dispatcher opens around the query
_recovery_notes = threading.local()


@contextlib.contextmanager
def collect_recoveries():
    """Open a per-query recovery-outcome window; yields the list the
    driver appends outcome strings (``"recovered"``) into."""
    prev = getattr(_recovery_notes, "sink", None)
    sink: List[str] = []
    _recovery_notes.sink = sink
    try:
        yield sink
    finally:
        _recovery_notes.sink = prev


def note_recovery(outcome: str) -> None:
    """Record one ladder outcome into the open collector (no-op without
    one: a single thread-local read)."""
    sink = getattr(_recovery_notes, "sink", None)
    if sink is not None:
        sink.append(outcome)


# per-attempt record of the strategies the costed chooser picked
# (parallel/shuffle._note_choice feeds it): a replan must demote off the
# lowering that FAILED, not only the cheapest prefix
_strategy_notes = threading.local()


@contextlib.contextmanager
def collect_strategy_choices():
    """Open a per-attempt window recording the chooser's strategy
    picks; yields the set (the recovery driver reads it on failure)."""
    prev = getattr(_strategy_notes, "sink", None)
    sink: set = set()
    _strategy_notes.sink = sink
    try:
        yield sink
    finally:
        _strategy_notes.sink = prev


def note_strategy_choice(strategy: str) -> None:
    """Record one chooser pick into the open window (no-op without
    one)."""
    sink = getattr(_strategy_notes, "sink", None)
    if sink is not None:
        sink.add(strategy)


_demote = threading.local()


def exchange_demotions() -> Tuple[str, ...]:
    """The catalogue strategies the costed chooser must NOT pick on this
    thread — empty except inside a replanned recovery attempt
    (:func:`demoted_exchanges`).  ``parallel/shuffle._choose`` reads it
    per exchange: a demoted attempt skips the single-shot fast path and
    hands ``exclude=`` to ``cost.choose``."""
    return getattr(_demote, "excluded", ())


@contextlib.contextmanager
def demoted_exchanges(level: int, failed: Sequence[str] = ()):
    """Scope one recovery attempt's demotion: exclude the first
    ``level`` strategies of the catalogue preference order (single-shot
    first, then allgather, ...) PLUS ``failed``, the strategies the
    chooser picked during attempts that then failed resource-class.
    The chunked lowering is never excluded, so a demoted chooser always
    has a candidate.  Level 0 with no failed set is a no-op."""
    from .parallel import cost
    excluded = tuple(dict.fromkeys(
        s for s in tuple(cost.STRATEGIES[:max(level, 0)]) + tuple(failed)
        if s != cost.CHUNKED))
    if not excluded:
        yield
        return
    prev = getattr(_demote, "excluded", ())
    _demote.excluded = excluded
    try:
        yield
    finally:
        _demote.excluded = prev
