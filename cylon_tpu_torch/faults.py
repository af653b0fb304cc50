"""Deterministic fault injection.

The port's copy of ``cylon_tpu/faults.py``: the engine's failure
boundaries each host a **named fault point** (the catalogue below), and a
seeded :class:`FaultPlan` decides, per call, whether that point fires.
Two shapes of fault exist:

  * **exception points** (``check(name)``) raise a typed
    :class:`TransientFault`, :class:`ResourceFault`,
    :class:`PermanentFault` or :class:`TopologyFault` — all
    :class:`~cylon_tpu_torch.status.CylonError` subclasses naming the
    point — exactly where a real host-read / IO / allocation failure
    would surface.  The transient class is what
    ``resilience.retry_call`` retries; inside a planned query the
    escalation ladder (``resilience.Ladder``, run by the plan
    executor) answers each class: stage retry, replan, re-mesh, or an
    annotated failure.
  * **value points** (``perturb(name, value)``) mutate an engine-internal
    value in flight, e.g. shrink the memory budget mid-query to simulate
    allocation pressure (degrading shuffles to a staged lowering).

Determinism: every probability draw is a pure function of ``(seed,
point, per-point call counter, rule index)`` — a keyed blake2b hash
mapped to [0, 1), bit for bit the JAX package's — the per-point counters
also drive ``nth`` triggers, and ``once``/``limit`` caps are scoped per
(rule, point).  The k-th consultation of a point therefore decides
identically no matter which thread makes it, and the same seed fires the
same points in the same order as in the JAX package.

Every fire bumps the ``fault.injected`` counter and the plan's own
``injected`` tally (visible without counters enabled).

The catalogue holds the points the port has sites for: the shuffle's
count read (``compact.read_counts``), the budget read
(``resilience.budget``), the spill pool's two staging boundaries
(``spill.*``), and the recovery driver's seams in the plan executor
(``exec.stage``, ``recover.*``, ``mesh.*``).  The JAX package's other
points (``io.*``, ``serve.*``, ``matview.fold``, ``compact.hint`` /
``compact.flush``) come with the sites that consult them.  A rule may
still name any point: the draws are keyed by the name, so a plan decides
the same consultations as in the JAX package.

``CYLON_CHAOS=<seed>`` installs ``FaultPlan.default(seed)`` when the
package is imported (:func:`install_chaos_from_env`): every recoverable
fault class, at low probability, at the port's points.

Scoped use::

    with faults.active(faults.FaultPlan(seed=7, rules=[
            faults.FaultRule("compact.read_counts", kind="transient",
                             nth=2)])):
        ...
"""
from __future__ import annotations

import contextlib
import fnmatch
import hashlib
import threading
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

from .status import Code, CylonError, Status

__all__ = [
    "POINTS", "FaultError", "TransientFault", "ResourceFault",
    "PermanentFault", "TopologyFault", "FaultRule", "FaultPlan",
    "install", "uninstall", "active", "plan", "check", "perturb",
    "poll", "install_chaos_from_env",
]

# ---------------------------------------------------------------------------
# the fault-point catalogue (docs/robustness.md mirrors it)
# ---------------------------------------------------------------------------

# Every sanctioned boundary that hosts a fault point, with what firing
# there simulates.  Exception points accept transient/permanent rules;
# value points accept kind="value" rules and are exercised via perturb().
POINTS: Dict[str, str] = {
    "compact.read_counts":
        "the blocking per-op host count read (ops/compact._read_counts) "
        "— a failed device→host transfer on a tunneled backend",
    "io.csv.read":
        "a CSV file read (io/csv._read_one) — flaky network filesystem / "
        "object store",
    "resilience.budget":
        "value point: the device memory budget read — a shrinking "
        "mutation simulates allocation pressure mid-query, degrading "
        "over-budget exchanges to the chunked multi-round path",
    # recovery seams: the self-healing executor's own failure surfaces
    # are fault points too, so the recovery machinery is chaos-testable
    # like everything it recovers
    "exec.stage":
        "the plan executor's per-stage dispatch at an exchange boundary "
        "(plan/executor._execute) — a mid-query failure between stages; "
        "transient rules exercise stage retry from checkpoint, resource "
        "rules exercise the replan arm, permanent rules the annotated "
        "bundle",
    "recover.checkpoint_restore":
        "a stage resume from a retained checkpoint — a failed restore "
        "drops the checkpoint and re-executes the stage from its "
        "inputs instead",
    "recover.replan":
        "the escalation ladder's replan trigger — a failure here means "
        "the degraded re-lowering itself could not be set up, and the "
        "ladder fails the query with the annotated bundle",
    # the host tier: the spill pool's two staging boundaries.  Failures
    # here are classed onto the RESOURCE arm of the escalation ladder,
    # transient kind included (an injected PERMANENT stays permanent)
    "spill.stage_out":
        "the spill pool's batched device->host staging transfer "
        "(spill/pool.stage_out_arrays) — a failed D2H on a tunneled "
        "backend, or host allocation failure for the pinned blocks",
    "spill.stage_in":
        "the spill pool's host->device staging transfer "
        "(spill/pool.stage_in_arrays; whole fault-ins and per-morsel "
        "slices) — a failed H2D or device allocation failure for the "
        "staged block",
    # elastic degraded-mesh execution: loss of a shard slot mid-query,
    # consulted at the executor's exchange-boundary dispatch next to
    # exec.stage; topology-kind rules raise a TopologyFault carrying how
    # many slots died, and the ladder's TOPOLOGY rung evacuates to the
    # host tier and re-meshes onto the survivors
    "mesh.device_lost":
        "loss of a device (or mesh slice) mid-query, surfacing as a "
        "collective failure at an exchange boundary "
        "(plan/executor._execute) — topology rules carry lost=k; the "
        "escalation ladder's TOPOLOGY rung evacuates and re-meshes "
        "onto the P-k survivors",
    "mesh.device_joined":
        "return of a repaired device (or mesh slice), surfacing at the "
        "same exchange-boundary dispatch (plan/executor._execute) — an "
        "EVENT point consulted via poll(), not check(): a rejoin is an "
        "opportunity, not a failure.  Topology rules carry lost=k as "
        "the rejoin count; the executor answers by growing the mesh "
        "back along the roster (topology.mark_joined) and expanding or "
        "deferring per the amortization bound",
}


class FaultError(CylonError):
    """Base of every injected fault; carries the fault point's name.
    ``detail`` overrides the default message — the engine reuses the
    typed classes for ORGANIC failures it classifies the same way (the
    exchange hang watchdog raises a TransientFault naming its boundary),
    and those must not claim to be injected."""

    def __init__(self, point: str, kind: str,
                 detail: Optional[str] = None):
        super().__init__(Status(Code.ExecutionError,
                                detail if detail is not None else
                                f"injected {kind} fault at {point!r}"))
        self.point = point


class TransientFault(FaultError):
    """A failure of the retryable class (network blip, flaky read) —
    ``resilience.retry_call`` boundaries absorb these.  Injected by
    transient rules, and raised ORGANICALLY (with ``detail``) by the
    exchange hang watchdog, whose wedged-collective timeout is exactly
    this class: retry from checkpoint, never spin forever."""

    def __init__(self, point: str, detail: Optional[str] = None):
        super().__init__(point, "transient", detail)


class ResourceFault(FaultError):
    """An injected failure of the resource class (a typed OOM: the
    allocation a strategy needed did not fit) — the escalation ladder
    (``resilience.Ladder``) answers these by REPLANNING the exchange
    onto a degraded catalogue strategy, not by blind retry."""

    def __init__(self, point: str):
        super().__init__(point, "resource")


class PermanentFault(FaultError):
    """An injected failure classed permanent: never retried, surfaces to
    the caller as a typed CylonError naming the fault point."""

    def __init__(self, point: str):
        super().__init__(point, "permanent")


class TopologyFault(FaultError):
    """A failure of the TOPOLOGY class: a device (or mesh slice) died
    mid-query, surfacing as a collective failure at an exchange
    boundary.  Carries ``lost`` — how many devices vanished — so the
    escalation ladder's topology rung (docs/robustness.md
    "Elasticity") knows how far to shrink the survivor mesh.  Neither
    retry nor replan is sound here: the same collective on the same
    mesh re-touches the dead chip; the recovery is evacuate + re-mesh
    onto the P−lost survivors."""

    def __init__(self, point: str, lost: int = 1,
                 detail: Optional[str] = None):
        super().__init__(point, "topology", detail)
        self.lost = max(int(lost), 1)


# ---------------------------------------------------------------------------
# plans and rules
# ---------------------------------------------------------------------------

@dataclass
class FaultRule:
    """One trigger: WHERE (a point name or fnmatch pattern), WHAT
    (transient / permanent exception, or a value mutation), and WHEN
    (probability per call, the exact nth matching call, at most once,
    or a total-fires cap)."""

    point: str                      # exact name or fnmatch pattern
    kind: str = "transient"   # transient|resource|permanent|topology|value
    probability: float = 1.0        # seeded draw per matching call
    nth: Optional[int] = None       # fire ONLY on the nth call (1-based)
    once: bool = False              # at most one fire PER POINT
    limit: Optional[int] = None     # max fires PER POINT
    mutate: Optional[Callable] = None  # kind="value": old -> new
    lost: int = 1     # kind="topology": devices that died (or, at join
    #                   points, returned)
    after: Optional[str] = None     # eligible only once this point fired
    window: Optional[int] = None    # ...within this many consultations
    # after/window sequence a PATTERN across points (lose→rejoin→lose at
    # bounded intervals): the rule is eligible only after some rule last
    # fired at the `after` point, and — when `window` is set — only
    # within that many subsequent consultations (of ANY point) of that
    # fire.  The sequencing reads a plan-global consultation counter, so
    # a pattern rule's eligibility does depend on how concurrent
    # consultations interleave — inherent to cross-point ordering, and
    # harmless in practice: the chaos flap rules fire at the executor's
    # single-threaded exchange-boundary dispatch, where the consult
    # order is the stage order and replays are exact.
    # once/limit caps are scoped per (rule, point): for an exact-name
    # rule that is the historical "once ever", while a PATTERN rule
    # ("io.*") caps each matching point independently — a shared
    # cross-point cap would make which point wins the single fire
    # depend on thread interleaving, breaking the deterministic-replay
    # contract the per-point draws provide

    def __post_init__(self):
        if self.kind not in ("transient", "resource", "permanent",
                             "topology", "value"):
            raise CylonError(Status(Code.Invalid,
                f"fault kind must be transient/resource/permanent/"
                f"topology/value, got {self.kind!r}"))
        if self.kind == "value" and self.mutate is None:
            raise CylonError(Status(Code.Invalid,
                f"value fault at {self.point!r} needs a mutate callable"))
        if isinstance(self.lost, bool) or not isinstance(self.lost, int) \
                or self.lost < 1:
            raise CylonError(Status(Code.Invalid,
                f"topology fault 'lost' must be a positive int device "
                f"count, got {self.lost!r}"))
        if self.window is not None and (
                isinstance(self.window, bool)
                or not isinstance(self.window, int) or self.window < 1):
            raise CylonError(Status(Code.Invalid,
                f"fault rule 'window' must be a positive int consultation "
                f"count, got {self.window!r}"))
        if self.window is not None and self.after is None:
            raise CylonError(Status(Code.Invalid,
                f"fault rule 'window' at {self.point!r} needs 'after' — "
                f"a window is measured from the prerequisite's fire"))


class FaultPlan:
    """A seeded set of rules; the same seed over the same call sequence
    reproduces the same fault pattern (chaos runs are debuggable)."""

    def __init__(self, seed: int = 0, rules: Sequence[FaultRule] = ()):
        self.seed = int(seed)
        self.rules: List[FaultRule] = list(rules)
        self.injected = 0               # total fires (no tracing needed)
        self._lock = threading.Lock()
        self._calls: Dict[str, int] = {}       # point -> times consulted
        # (rule index, point) -> times fired: per-point caps keep
        # once/limit deterministic under pattern rules (see FaultRule)
        self._fires: Dict[Tuple[int, str], int] = {}
        self.fired: List[Tuple[str, str]] = []  # (point, kind) log
        # cross-point pattern sequencing (FaultRule.after/window): a
        # plan-global consultation sequence and, per point, the seq of
        # its last fire
        self._seq = 0
        self._last_fire_seq: Dict[str, int] = {}

    def _draw(self, point: str, n: int, rule_idx: int) -> float:
        """The deterministic probability draw for the ``n``-th
        consultation of ``point`` against rule ``rule_idx``: a keyed
        hash mapped to [0, 1).  A pure function of its arguments, so
        the decision is identical no matter which THREAD consults the
        point or how concurrent consultations of OTHER points
        interleave — the property the old shared-RNG stream lacked
        (docs/robustness.md "fault points and plans")."""
        h = hashlib.blake2b(
            f"{self.seed}:{point}:{n}:{rule_idx}".encode(),
            digest_size=8).digest()
        return int.from_bytes(h, "big") / 2.0 ** 64

    @staticmethod
    def default(seed: int = 0) -> "FaultPlan":
        """The ``CYLON_CHAOS`` plan at the port's points: low-probability
        transient count reads and CSV reads, occasional allocation
        pressure on the
        memory budget, mid-query stage failures (transient and
        resource), host-tier staging faults, one device loss and the
        flap pattern on top.  Every injected class is recoverable — a
        suite that is correct under this plan demonstrated its retry,
        replan and re-mesh machinery end to end."""
        return FaultPlan(seed, [
            FaultRule("compact.read_counts", kind="transient",
                      probability=0.03),
            FaultRule("io.csv.read", kind="transient", probability=0.10),
            FaultRule("resilience.budget", kind="value", probability=0.02,
                      mutate=lambda b: max(int(b) // 8, 1 << 20)),
            # mid-query stage failures at the executor's exchange
            # boundaries: transient ones exercise checkpointed stage
            # retry, resource ones the replan arm of the ladder
            FaultRule("exec.stage", kind="transient", probability=0.02),
            FaultRule("exec.stage", kind="resource", probability=0.01),
            # host-tier staging faults, classed RESOURCE.  limit=1: a
            # morsel scan consults these points once per morsel, and an
            # uncapped per-call probability would fault every recovery
            # attempt afresh
            FaultRule("spill.stage_in", kind="resource",
                      probability=0.01, limit=1),
            FaultRule("spill.stage_out", kind="resource",
                      probability=0.01, limit=1),
            # one device loss per run (limit=1: the registry keeps the
            # process on the survivor mesh, so a second fire would
            # shrink again)
            FaultRule("mesh.device_lost", kind="topology",
                      probability=0.003, limit=1),
            # the flap pattern: the lost device returns within a bounded
            # interval, then may die again shortly after rejoining —
            # each leg eligible only within `window` consultations of
            # the previous one, each capped
            FaultRule("mesh.device_joined", kind="topology",
                      probability=0.25, limit=1,
                      after="mesh.device_lost", window=400),
            FaultRule("mesh.device_lost", kind="topology",
                      probability=0.10, limit=1,
                      after="mesh.device_joined", window=400),
        ])

    def _decide(self, point: str, want_value: bool) -> Optional[FaultRule]:
        """One consultation of ``point``: bump its call counter and
        return the first rule that fires (None for no fault)."""
        with self._lock:
            n = self._calls.get(point, 0) + 1
            self._calls[point] = n
            self._seq += 1
            seq = self._seq
            for i, rule in enumerate(self.rules):
                is_value = rule.kind == "value"
                if is_value != want_value:
                    continue
                if not fnmatch.fnmatchcase(point, rule.point):
                    continue
                fires = self._fires.get((i, point), 0)
                if rule.once and fires >= 1:
                    continue
                if rule.limit is not None and fires >= rule.limit:
                    continue
                if rule.after is not None:
                    last = self._last_fire_seq.get(rule.after)
                    if last is None:
                        continue
                    if rule.window is not None and seq - last > rule.window:
                        continue
                if rule.nth is not None:
                    if n != rule.nth:
                        continue
                elif self._draw(point, n, i) >= rule.probability:
                    continue
                self._fires[(i, point)] = fires + 1
                self.injected += 1
                self.fired.append((point, rule.kind))
                self._last_fire_seq[point] = seq
                return rule
        return None


# ---------------------------------------------------------------------------
# activation + the two hook shapes
# ---------------------------------------------------------------------------

_active_plan: Optional[FaultPlan] = None


def install(new_plan: FaultPlan) -> Optional[FaultPlan]:
    """Make ``new_plan`` the process-wide active plan; returns the
    previous one (callers restore it — or use :func:`active`)."""
    global _active_plan
    prev = _active_plan
    _active_plan = new_plan
    return prev


def uninstall() -> None:
    global _active_plan
    _active_plan = None


def plan() -> Optional[FaultPlan]:
    """The active plan, or None (the production state)."""
    return _active_plan


@contextlib.contextmanager
def active(new_plan: FaultPlan) -> Iterator[FaultPlan]:
    """Scoped activation; restores whatever plan was active before."""
    prev = install(new_plan)
    try:
        yield new_plan
    finally:
        global _active_plan
        _active_plan = prev


def _count_injection() -> None:
    from . import trace

    trace.count("fault.injected")


def check(point: str) -> None:
    """Exception hook: called at a sanctioned failure boundary right
    before the real operation.  No-op without an active plan (one global
    read — the production cost).  Raises :class:`TransientFault`,
    :class:`ResourceFault` or :class:`PermanentFault` when the plan
    fires."""
    p = _active_plan
    if p is None:
        return
    rule = p._decide(point, want_value=False)
    if rule is None:
        return
    _count_injection()
    if rule.kind == "permanent":
        raise PermanentFault(point)
    if rule.kind == "resource":
        raise ResourceFault(point)
    if rule.kind == "topology":
        raise TopologyFault(point, lost=rule.lost)
    raise TransientFault(point)


def poll(point: str) -> Optional[FaultRule]:
    """Event hook: consult ``point`` like :func:`check` but RETURN the
    firing rule instead of raising — for event-class points
    (``mesh.device_joined``) where an injected occurrence is an
    opportunity the caller acts on, not a failure to recover from.
    None without an active plan or firing rule.  Fires count into
    ``fault.injected`` and the plan's tally like any other."""
    p = _active_plan
    if p is None:
        return None
    rule = p._decide(point, want_value=False)
    if rule is None:
        return None
    _count_injection()
    return rule


def perturb(point: str, value):
    """Value hook: returns ``value`` unchanged without an active plan /
    firing rule, else the rule's mutation of it."""
    p = _active_plan
    if p is None:
        return value
    rule = p._decide(point, want_value=True)
    if rule is None:
        return value
    _count_injection()
    return rule.mutate(value)


def install_chaos_from_env() -> Optional[FaultPlan]:
    """``CYLON_CHAOS=<seed>`` (any value but empty or ``0``) installs
    ``FaultPlan.default(seed)`` process-wide and returns it; None (and
    nothing installed) otherwise."""
    import os
    seed = os.environ.get("CYLON_CHAOS", "")
    if seed in ("", "0"):
        return None
    new_plan = FaultPlan.default(int(seed))
    install(new_plan)
    return new_plan
