"""The shared exchange cost model: price a redistribution STRATEGY, not
just its chunking.

The port's copy of ``cylon_tpu/parallel/cost.py`` (numpy only, no torch):
the shuffle chooser, the chunked plan and the broadcast replica veto all
price through this one module, so the same count matrix and budget give
the same choice as in the JAX package.

Following arXiv:2112.01075, a resharding is a *sequence* of
all_gather / all_to_all / collective-permute steps with very different
peak-memory / latency / wire tradeoffs.  The catalogue priced here (the
collectives are the communicator's: ``all_to_all``, ``ppermute``,
``all_gather``):

  ``single-shot``  ONE ``all_to_all`` over [P, block] send/receive
                   buffers + the compacted [outcap] output.  1 round,
                   peak ``(2·P·block + outcap) · rbytes``.
  ``chunked``      K bounded all_to_all rounds of ≤ C rows per
                   (sender, target) cell, receiver-side folded.  Peak
                   is one round's transient
                   ``(2·P·bucket(C) + outcap_round) · rbytes``; the
                   accumulated result block is the shuffle's RESULT,
                   not a transient the path can shrink.
  ``ring``         P−1 staged ``ppermute`` rounds: round r moves each
                   shard's (me → me+r) cell whole — one [block] send +
                   one [block] receive live at a time, folded straight
                   into the result block.  Peak
                   ``2·bucket(maxcell) · rbytes`` plus one round's
                   routing state, P−1 rounds of latency.
  ``allgather``    replicate the payload (one ``all_gather`` per width
                   class) and let every shard keep its own rows: 1
                   round, peak ``(P·cap + outcap) · rbytes``, wire
                   ``(P−1)·cap`` rows — cheaper than the all_to_all's
                   2·P·block transient exactly when one sender-side cell
                   dominates (block > cap/2).
  ``replicate``    the broadcast-join replica (parallel/broadcast.py):
                   the same gather shape as ``allgather`` priced for
                   the "small side fits P times over" veto.
  ``hierarchical`` / ``hierarchical-combine``: the two-level exchange
                   over a (slow, fast) split of the world.
  ``staged-spill`` the host tier: the payload staged out to the spill
                   pool, then streamed back in the chunked plan's rounds,
                   one staged morsel at a time.  Peak = one chunked round
                   + the staged morsel block; 2 × payload crosses the
                   host link.

Pricing inputs are host-side metadata only — the [P, P] count matrix
the shuffle reads, or the ``P × cap`` capacity bound.  Nothing here
touches device data.

:func:`choose` picks among the candidates under the live
``resilience.exchange_budget()``: the cheapest FEASIBLE strategy by
``(rounds, wire_bytes, catalogue order)``.  ``single-shot`` therefore
keeps winning whenever it fits the budget (1 round, least wire); over
budget, the chooser degrades to the cheapest sequence that fits; past
every resident strategy it tries ``staged-spill``.  When NOTHING fits,
the chunked plan at its C = 1 floor runs best-effort.
``config.set_exchange_strategy`` / ``CYLON_EXCHANGE_STRATEGY`` force one
lowering session-wide.

The recovery driver's prices: :func:`price_retained` (a stage
checkpoint's resident bytes), :func:`price_remesh` (the elastic
re-partition P → P′ through the host tier, never chooser-selectable)
and :func:`amortized_remesh_win` (the scale-up deferral bound); and the
replan arm's ``choose(..., exclude=...)``.

The measured model: :func:`predicted_ms` prices one lowering in
milliseconds from a probed profile (``parallel/meshprobe.py``), per edge
when the profile carries per-axis coefficients; ``choose(...,
profile=, measured=True)`` (``CYLON_COST_MEASURED=1``) ranks the
feasible candidates by it instead of the (rounds, wire) proxy.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..ops.compact import next_bucket

__all__ = [
    "SINGLE_SHOT", "CHUNKED", "RING", "ALLGATHER", "REPLICATE",
    "STAGED_SPILL", "REMESH", "HIERARCHICAL", "HIER_COMBINE",
    "STRATEGIES", "StrategyPrice",
    "exchange_sizes", "single_shot_bytes", "price_single_shot",
    "price_chunked", "price_ring", "price_allgather", "price_replicate",
    "price_retained", "price_staged_spill", "price_remesh",
    "amortized_remesh_win", "chunk_plan", "hier_plan",
    "price_hierarchical", "price_hier_combine", "slow_share",
    "enumerate_strategies", "choose", "COLLECTIVE_OF", "predicted_ms",
]

SINGLE_SHOT = "single-shot"
CHUNKED = "chunked"
RING = "ring"
ALLGATHER = "allgather"
REPLICATE = "replicate"   # broadcast replication (priced, never chosen
#                           by the shuffle chooser — it changes the
#                           layout contract, not just the lowering)
STAGED_SPILL = "staged-spill"   # host-tier staging (spill/): the
#                           payload waits in the spill pool and comes back
#                           one rank-sliced morsel per round

REMESH = "remesh"   # the elastic re-partition P -> P': priced like any
#                     exchange but never chosen by the shuffle chooser —
#                     it changes the MESH, not the lowering, so only the
#                     recovery driver dispatches it (parallel/remesh.py;
#                     annotated remesh=P->P' in EXPLAIN ANALYZE)
HIERARCHICAL = "hierarchical"   # the 2-level shuffle (docs/
#                           tpu_perf_notes.md "Hierarchical
#                           collectives"): one all_to_all WITHIN the
#                           fast axis routes every row to its target's
#                           fast coordinate, then S−1 ppermute rounds
#                           ACROSS the slow axis deliver the slow hop —
#                           the arXiv:2112.01075 sequence-of-collectives
#                           idea applied to a (slow, fast) topology.
#                           Same rows, but the bytes that cross the
#                           expensive slow boundary shrink from
#                           (P−F)/P of the payload shipped point-to-
#                           point to ONE aggregated lane per slow peer.
HIER_COMBINE = "hierarchical-combine"   # the fused-groupby spelling:
#                           after the fast-axis hop, an AXIS-LOCAL
#                           fold-by-key pre-combines every slow group's
#                           partials, so only per-GROUP partial rows —
#                           not per-input rows — cross the slow axis
#                           (arXiv:2010.14596's hierarchical
#                           aggregation result).

# the shuffle chooser's selectable catalogue, in preference order for
# deterministic tie-breaks (counter names derive from these — see
# strategy_counter).  staged-spill sits last, as in the JAX package
STRATEGIES = (SINGLE_SHOT, ALLGATHER, CHUNKED, RING, HIERARCHICAL,
              HIER_COMBINE, STAGED_SPILL)


def strategy_counter(strategy: str) -> str:
    """Catalogued counter name for one strategy choice
    (``shuffle.strategy.single_shot`` etc. — observe.METRICS)."""
    return "shuffle.strategy." + strategy.replace("-", "_")


@dataclass(frozen=True)
class StrategyPrice:
    """One candidate lowering, priced.

    ``peak_bytes``  per-device transient footprint of one dispatch (or
                    one round, for the staged strategies — their result
                    block is excluded, matching the chunked path's
                    established accounting).
    ``wire_bytes``  per-device payload leaving the shard across the
                    whole exchange (padded block sizes — what actually
                    crosses the wire, not just live rows).
    ``rounds``      collective rounds dispatched (the latency axis).
    ``sizes``       strategy-specific size classes, enough to dispatch
                    without re-deriving (single-shot/allgather:
                    (block, outcap); ring: (cell_block, outcap);
                    chunked: (rounds, C, block, outcap_round)).
    """

    strategy: str
    peak_bytes: int
    wire_bytes: int
    rounds: int
    sizes: Tuple[int, ...]
    # bytes crossing the host link (staged-spill: the payload out and
    # back); 0 for every resident strategy
    host_bytes: int = 0
    # of wire_bytes, the share that crosses the SLOW mesh axis under the
    # live (slow, fast) split — the expensive edge the hierarchical
    # lowerings exist to starve.  Zero when the split is trivial (flat
    # mesh) or unknown; ``shuffle.bytes_sent_slow`` tallies it for the
    # executed choice.
    slow_wire_bytes: int = 0

    def describe(self) -> str:
        host = (f", {self.host_bytes} B host-staged"
                if self.host_bytes else "")
        return (f"{self.strategy}: peak {self.peak_bytes} B, "
                f"{self.rounds} round(s), {self.wire_bytes} B wire"
                f"{host}")


def exchange_sizes(counts: np.ndarray) -> Tuple[int, int, np.ndarray]:
    """counts [P, P] → (block, outcap, per_recv): THE sizing rule for a
    single-shot exchange, shared by the optimistic post(), the degraded
    steady-state branch and every candidate price below, so no two
    paths can dispatch different size classes for the same counts (the
    promotion comparison and the compile-reuse claim both rely on
    that)."""
    block = next_bucket(max(int(counts.max(initial=0)), 1), minimum=8)
    per_recv = counts.sum(axis=0)
    outcap = next_bucket(max(int(per_recv.max(initial=0)), 1), minimum=8)
    return block, outcap, per_recv


def single_shot_bytes(nparts: int, sizes: Sequence[int], rbytes: int) -> int:
    """Per-device transient of ONE single-shot dispatch: the grouped
    send buffer ([P, block] rows per leaf) + the all_to_all receive
    mirror + the compacted [outcap] output block, × the payload width
    of one row.  The historical ``shuffle._priced_bytes`` — still the
    single formula behind the budget comparison, the
    ``shuffle.exchange_bytes_peak`` watermark, and admission's
    worst-exchange price (serve/admission.py)."""
    block, outcap = sizes
    return int((2 * nparts * block + outcap) * rbytes)


def price_single_shot(nparts: int, block: int, outcap: int,
                      rbytes: int) -> StrategyPrice:
    return StrategyPrice(
        SINGLE_SHOT,
        peak_bytes=single_shot_bytes(nparts, (block, outcap), rbytes),
        wire_bytes=int((nparts - 1) * block * rbytes),
        rounds=1, sizes=(block, outcap))


_RING_ROUTING_BYTES = 10  # per-row routing state of ONE ring round:
#                           int32 send idx + int32 receive slots (4+4)
#                           and the two bool validity lanes (1+1).  The
#                           kernel computes each round's routing inside
#                           the round loop, so exactly one round's
#                           worth is live at the payload's side.


def price_ring(nparts: int, cell_block: int, outcap: int,
               rbytes: int) -> StrategyPrice:
    """P−1 ppermute rounds, each moving one whole (me → me+r) cell:
    transient = the [cell_block] send + receive payload buffers of the
    round in flight plus that round's routing state
    (:data:`_RING_ROUTING_BYTES`/row — received rows fold straight into
    the result block, so there is no outcap_round compaction term)."""
    return StrategyPrice(
        RING,
        peak_bytes=int(cell_block * (2 * rbytes + _RING_ROUTING_BYTES)),
        wire_bytes=int((nparts - 1) * cell_block * rbytes),
        rounds=max(nparts - 1, 1), sizes=(cell_block, outcap))


_PID_BYTES = 4  # the int32 routing lane the allgather must replicate
#                 (the all_to_all pre-routes rows instead of shipping
#                 their target ids — this term is what keeps allgather
#                 from tying single-shot when skew drives block to cap)


def price_allgather(nparts: int, cap: int, outcap: int,
                    rbytes: int) -> StrategyPrice:
    """Replicate-and-filter: gather every shard's [cap] block (payload
    leaves + the int32 pid lane the receiver filters on), keep own
    rows.  The gathered [P·cap] intermediates and the compacted output
    coexist — the same footprint shape as the broadcast replica."""
    return StrategyPrice(
        ALLGATHER,
        peak_bytes=int(nparts * cap * (rbytes + _PID_BYTES)
                       + outcap * rbytes),
        wire_bytes=int((nparts - 1) * cap * (rbytes + _PID_BYTES)),
        rounds=1, sizes=(cap, outcap))


def price_replicate(nparts: int, cap: int, outcap: int,
                    rbytes: int) -> StrategyPrice:
    """The broadcast-join replica (``broadcast.rows_if_small``'s veto
    arm): all_gather the small side's [cap] blocks, compact into the
    [outcap] replica every shard keeps.  Identical footprint math to
    :func:`price_allgather`; kept as its own strategy name so veto
    annotations and the chooser's catalogue cannot be conflated."""
    return StrategyPrice(
        REPLICATE,
        peak_bytes=int((nparts * cap + outcap) * rbytes),
        wire_bytes=int((nparts - 1) * cap * rbytes),
        rounds=1, sizes=(cap, outcap))


def price_retained(cap: int, rbytes: int) -> int:
    """Per-shard RESIDENT bytes of retaining one materialized stage
    result as a recovery checkpoint (plan/executor.py): the shard's
    [cap]-row block × the width of one row.  A checkpoint's footprint
    persists across attempts, which is why checkpointing is a costed
    decision against a bounded fraction of the memory budget
    (``resilience.RecoveryPolicy.checkpoint_fraction``)."""
    return int(max(cap, 0) * max(rbytes, 1))


def price_remesh(p_old: int, p_new: int, counts: np.ndarray,
                 rbytes: int) -> StrategyPrice:
    """The elastic re-partition: a table's rows move from a ``p_old``-
    shard layout onto ``p_new`` shards by staging OUT through the host
    tier (the spill pool's D2H boundary), re-blocking host-side, and
    staging back IN under the new world — a resharding lowered entirely
    through the host, because the old mesh can no longer run a
    collective.

    ``counts`` is the old layout's [p_old] per-shard row counts.
    ``peak_bytes`` is the NEW resident block, ``wire_bytes`` the payload
    that crosses shard boundaries, ``host_bytes`` the 2× payload D2H +
    H2D staging, 1 round."""
    total = int(np.asarray(counts).sum())
    per_new = -(-max(total, 1) // max(p_new, 1))
    cap_new = next_bucket(max(per_new, 1), minimum=8)
    payload = total * rbytes
    return StrategyPrice(
        REMESH,
        peak_bytes=int(max(p_new, 1) * cap_new * rbytes),
        wire_bytes=int(payload),
        rounds=1, sizes=(cap_new,),
        host_bytes=2 * payload)


def amortized_remesh_win(per_stage_bytes: float, stages_left: int,
                         p_old: int, p_new: int) -> float:
    """The scale-up deferral bound: priced bytes a mid-plan expansion
    P → P′ would save over the REMAINING stages.  Each stage's exchange
    payload is fixed by the data, but the per-shard share shrinks by
    ``1 − P/P′`` when the same rows spread over more shards.
    ``per_stage_bytes`` comes from the run-stats store's observed bytes
    for the plan's fingerprint.  The executor expands only when this
    win beats the migration cost (the summed ``price_remesh`` wire +
    host bytes of the plan's live tables); otherwise it defers and
    re-evaluates at the next stage boundary."""
    p_old_eff = max(int(p_old), 1)
    p_new_eff = max(int(p_new), p_old_eff)
    frac = 1.0 - p_old_eff / p_new_eff
    return max(float(per_stage_bytes), 0.0) * max(int(stages_left), 0) \
        * frac


def chunk_plan(nparts: int, counts: np.ndarray, rbytes: int,
               budget: int) -> Tuple[int, int, int, int]:
    """The chunk math (docs/robustness.md): pick the smallest per-round
    cell cap C such that a round's transient — send [P, bucket(C)] +
    receive mirror + compacted [outcap_round] — prices within budget,
    where outcap_round bounds EVERY round by round 0 (per-cell residues
    ``clip(count − k·C, 0, C)`` are non-increasing in k).  Returns
    ``(rounds, C, block, outcap_round)``; C = 1 is the floor — below it
    the exchange cannot shrink further and the budget is best-effort.
    (Moved here from ``shuffle._chunk_sizes`` so the chooser and the
    degraded path share one plan.)"""
    maxcell = max(int(counts.max(initial=0)), 1)
    C = maxcell
    while True:
        C = max(C // 2, 1)
        block = next_bucket(C, minimum=8)
        recv0 = int(np.minimum(counts, C).sum(axis=0).max(initial=0))
        outcap = next_bucket(max(recv0, 1), minimum=8)
        if single_shot_bytes(nparts, (block, outcap), rbytes) <= budget \
                or C <= 1:
            break
    return -(-maxcell // C), C, block, outcap


def price_chunked(nparts: int, counts: np.ndarray, rbytes: int,
                  budget: int) -> StrategyPrice:
    rounds, C, block, outcap_r = chunk_plan(nparts, counts, rbytes, budget)
    return StrategyPrice(
        CHUNKED,
        peak_bytes=single_shot_bytes(nparts, (block, outcap_r), rbytes),
        wire_bytes=int(rounds * (nparts - 1) * block * rbytes),
        rounds=rounds, sizes=(rounds, C, block, outcap_r))


def price_staged_spill(nparts: int, counts: np.ndarray, rbytes: int,
                       budget: int) -> StrategyPrice:
    """The host-tier lowering: stage the payload out to the spill pool
    (D2H), stream it back in the chunked plan's rounds, each a bounded
    ``[P, bucket(C)]`` exchange over a MORSEL-sized staged block, folded
    receiver-side like the chunked rounds.  The full input block is not
    needed on the device while the rounds run: the transient is one
    round (the chunked formula) plus the staged morsel block, and the
    payload crosses the host link twice (``host_bytes``)."""
    rounds, C, block, outcap_r = chunk_plan(nparts, counts, rbytes, budget)
    payload = int(counts.sum()) * rbytes
    return StrategyPrice(
        STAGED_SPILL,
        peak_bytes=(single_shot_bytes(nparts, (block, outcap_r), rbytes)
                    + nparts * block * rbytes),
        wire_bytes=int(rounds * (nparts - 1) * block * rbytes),
        rounds=rounds, sizes=(rounds, C, block, outcap_r),
        host_bytes=2 * payload)


def hier_plan(nparts: int, split: Tuple[int, int], counts: np.ndarray
              ) -> Tuple[int, int, int, np.ndarray]:
    """Size the two-level exchange from the [P, P] count matrix under a
    ``(slow, fast)`` split with ``slow·fast == nparts`` (device ``p``
    sits at slow coordinate ``p // fast``, fast coordinate ``p % fast``
    — the row-major ``context.mesh2d`` layout).

    Stage 1 (fast-axis all_to_all) routes every row to its TARGET's
    fast coordinate within the sender's slow group: cell ``c1[p, f']``
    = rows device ``p`` holds for fast column ``f'``; ``block1`` buckets
    the largest such cell and ``outcap1`` the largest stage-1 receive.
    Stage 2 (slow-axis ring) then moves whole per-slow-peer lanes:
    ``c2[s, f', s']`` = rows sitting at mesh position ``(s, f')`` after
    stage 1 that belong to slow group ``s'``; ``block2`` buckets the
    largest CROSS cell (the diagonal never rides the wire).  Returns
    ``(block1, outcap1, block2, c2)``."""
    slow, fast = int(split[0]), int(split[1])
    c = np.asarray(counts).reshape(slow, fast, slow, fast)
    # c1[p, f'] summed over target slow groups; flattened sender index
    c1 = c.sum(axis=2).reshape(nparts, fast)
    block1 = next_bucket(max(int(c1.max(initial=0)), 1), minimum=8)
    # stage-1 receive at (s, f') = everything s's group holds for f'
    recv1 = c1.reshape(slow, fast, fast).sum(axis=1)
    outcap1 = next_bucket(max(int(recv1.max(initial=0)), 1), minimum=8)
    # c2[s, f', s'] = rows at (s, f') after stage 1 destined to slow s'
    c2 = np.transpose(c.sum(axis=1), (0, 2, 1))
    cross = c2.copy()
    cross[np.arange(slow), :, np.arange(slow)] = 0
    block2 = next_bucket(max(int(cross.max(initial=0)), 1), minimum=8)
    return block1, outcap1, block2, c2


def price_hierarchical(nparts: int, split: Tuple[int, int],
                       counts: np.ndarray, rbytes: int) -> StrategyPrice:
    """The two-level shuffle: 1 fast-axis all_to_all + (S−1) slow-axis
    ppermute rounds, receiver-side folded like the ring.  Rows carry
    their int32 pid lane through both stages (stage 2 routes on it), so
    both stages price at ``rbytes + _PID_BYTES``.  ``sizes`` =
    ``(S, F, block1, outcap1, block2, outcap)``; ``slow_wire_bytes`` is
    the stage-2 share — the number the hierarchy exists to shrink."""
    slow, fast = int(split[0]), int(split[1])
    block1, outcap1, block2, _ = hier_plan(nparts, split, counts)
    _, outcap, _ = exchange_sizes(counts)
    rb2 = rbytes + _PID_BYTES
    peak1 = (2 * fast * block1 + outcap1) * rb2
    peak2 = (outcap1 * rb2 + block2 * (2 * rb2 + _RING_ROUTING_BYTES)
             + outcap * rbytes)
    wire_slow = (slow - 1) * block2 * rb2
    return StrategyPrice(
        HIERARCHICAL,
        peak_bytes=int(max(peak1, peak2)),
        wire_bytes=int((fast - 1) * block1 * rb2 + wire_slow),
        rounds=slow,  # 1 a2a + (S−1) ppermute — the latency axis
        sizes=(slow, fast, block1, outcap1, block2, outcap),
        slow_wire_bytes=int(wire_slow))


def price_hier_combine(nparts: int, split: Tuple[int, int],
                       counts: np.ndarray, rbytes: int) -> StrategyPrice:
    """The fused-groupby two-level exchange: stage 1 as above, then an
    AXIS-LOCAL fold-by-key (the chunked path's combine kernel) collapses
    each slow group's partials BEFORE the slow rounds, so stage 2 moves
    per-group partial rows only.  Priced conservatively from the RAW
    count matrix (the dispatch re-sizes stage 2 from the post-combine
    counts, which can only shrink); the stage-2 fold accumulates into a
    result block of at most ``outcap`` combined groups, which rides the
    peak like the chunked rounds' accumulator."""
    slow, fast = int(split[0]), int(split[1])
    block1, outcap1, block2, _ = hier_plan(nparts, split, counts)
    _, outcap, _ = exchange_sizes(counts)
    rb2 = rbytes + _PID_BYTES
    peak1 = (2 * fast * block1 + outcap1) * rb2
    peak2 = (outcap1 * rb2 + block2 * (2 * rb2 + _RING_ROUTING_BYTES)
             + 2 * outcap * rbytes)
    wire_slow = (slow - 1) * block2 * rb2
    return StrategyPrice(
        HIER_COMBINE,
        peak_bytes=int(max(peak1, peak2)),
        wire_bytes=int((fast - 1) * block1 * rb2 + wire_slow),
        rounds=slow,
        sizes=(slow, fast, block1, outcap1, block2, outcap),
        slow_wire_bytes=int(wire_slow))


def slow_share(price: StrategyPrice, nparts: int,
               split: Optional[Tuple[int, int]]) -> StrategyPrice:
    """Decorate a FLAT lowering's price with the share of its wire
    bytes that crosses the slow axis under ``split``: a flat collective
    treats all P−1 peers alike, and P−F of them sit across the slow
    boundary.  Identity for trivial/unknown splits or prices that
    already carry a slow share (the hierarchical lowerings)."""
    if (split is None or price.slow_wire_bytes or nparts <= 1
            or split[0] <= 1 or split[1] <= 1
            or split[0] * split[1] != nparts):
        return price
    frac = (nparts - split[1]) / (nparts - 1)
    return replace(price, slow_wire_bytes=int(price.wire_bytes * frac))


def enumerate_strategies(nparts: int, cap: int, counts: np.ndarray,
                         rbytes: int, budget: int,
                         staged_ok: bool = True,
                         spill_ok: bool = False,
                         split: Optional[Tuple[int, int]] = None
                         ) -> List[StrategyPrice]:
    """Every candidate lowering for one exchange, priced from the count
    matrix.  ``cap`` is the per-shard row capacity (the allgather
    payload).  ``staged_ok=False`` restricts the flat catalogue to
    single-shot + chunked — the combine-spec (fold-by-key partial
    aggregation) exchanges, whose receiver-side group fold only the
    chunked rounds implement.  ``spill_ok`` adds the host-tier
    ``staged-spill`` lowering (the spill tier is enabled), which the
    chooser reaches only when no resident strategy fits.  A non-trivial
    ``split`` (``(slow, fast)``,
    both > 1, tiling ``nparts``) adds the matching hierarchical
    lowering — the two-level shuffle for plain exchanges, the
    pre-combining spelling for combine-spec ones — and decorates every
    flat candidate with its slow-axis wire share."""
    block, outcap, _ = exchange_sizes(counts)
    out = [price_single_shot(nparts, block, outcap, rbytes)]
    if staged_ok and nparts > 1:
        out.append(price_allgather(nparts, cap, outcap, rbytes))
        out.append(price_ring(nparts, block, outcap, rbytes))
    out.append(price_chunked(nparts, counts, rbytes, budget))
    if spill_ok and nparts > 1:
        out.append(price_staged_spill(nparts, counts, rbytes, budget))
    hier = (split is not None and split[0] > 1 and split[1] > 1
            and split[0] * split[1] == nparts)
    if hier:
        out = [slow_share(c, nparts, split) for c in out]
        if staged_ok:
            out.append(price_hierarchical(nparts, split, counts, rbytes))
        else:
            out.append(price_hier_combine(nparts, split, counts, rbytes))
    return out


# which measured collective primitive (parallel/meshprobe.py) each
# strategy's rounds dispatch: the bridge between the priced catalogue and
# the fitted (latency, bytes/s) coefficients
COLLECTIVE_OF = {
    SINGLE_SHOT: "all_to_all",
    CHUNKED: "all_to_all",
    RING: "ppermute",
    ALLGATHER: "all_gather",
    REPLICATE: "all_gather",
    STAGED_SPILL: "all_to_all",   # the collective rounds; the host legs
    #                               add the measured h2d / d2h terms
}


def predicted_ms(price: StrategyPrice, profile) -> Optional[float]:
    """Predicted wall-clock of one exchange lowering from a measured
    profile (``meshprobe.MeshProfile``): α·rounds + wire/β of the
    strategy's collective, plus — for the host-staged lowering — the
    D2H / H2D legs from the measured ``d2h`` / ``h2d`` coefficients
    (``host_bytes`` split evenly between the two directions).  None
    without a profile or for an unmeasured collective.

    Per-edge model: when the profile holds per-axis coefficients
    (``all_to_all@fast``, ``ppermute@slow``, …), the hierarchical
    lowerings price each stage against its own axis, and a flat lowering
    with a known ``slow_wire_bytes`` share splits its wire between the
    two axes' bandwidths — the slow β is what makes a flat all_to_all
    lose to the two-level sequence on a real cross-host boundary."""
    if profile is None:
        return None
    if price.strategy in (HIERARCHICAL, HIER_COMBINE):
        fast_wire = max(price.wire_bytes - price.slow_wire_bytes, 0)
        t_fast = profile.predicted_s("all_to_all@fast", fast_wire, 1)
        t_slow = profile.predicted_s("ppermute@slow", price.slow_wire_bytes,
                                     max(price.rounds - 1, 1))
        if t_fast is None or t_slow is None:
            return None
        return (t_fast + t_slow) * 1e3
    coll = COLLECTIVE_OF.get(price.strategy, "")
    s = None
    if price.slow_wire_bytes:
        # a flat collective over a two-level split: rounds synchronize on
        # the slow edge; the fast / slow wire shares ride their own β
        alpha = profile.latency_s.get(coll + "@slow")
        bw_slow = profile.bytes_per_s.get(coll + "@slow")
        bw_fast = profile.bytes_per_s.get(coll + "@fast")
        if alpha is not None and bw_slow and bw_fast:
            s = (max(price.rounds, 1) * alpha
                 + price.slow_wire_bytes / max(bw_slow, 1.0)
                 + (price.wire_bytes - price.slow_wire_bytes)
                 / max(bw_fast, 1.0))
    if s is None:
        s = profile.predicted_s(coll, price.wire_bytes, price.rounds)
    if s is None:
        return None
    if price.host_bytes:
        half = price.host_bytes // 2
        for leg in ("d2h", "h2d"):
            t = profile.predicted_s(leg, half, 1)
            if t is not None:
                s += t
    return s * 1e3


def choose(candidates: Sequence[StrategyPrice], budget: int,
           forced: Optional[str] = None, profile=None,
           measured: bool = False, exclude: Sequence[str] = ()
           ) -> Tuple[StrategyPrice, str, bool]:
    """Pick one strategy under ``budget``.  Returns ``(price, reason,
    feasible)`` — ``feasible`` False only on the best-effort floor
    (nothing fits; the chunked plan runs anyway, matching the
    historical budget-floor warning path).

    Selection: feasible = ``peak_bytes <= budget``; among the feasible,
    minimize ``(rounds, wire_bytes, catalogue preference)``
    lexicographically.  Peak bytes deliberately do NOT rank feasible
    candidates — feasibility already enforced the budget, and ranking
    on peak would let a residual-footprint difference steal the
    single-shot fast path on wire ties; the catalogue order
    (``STRATEGIES``) breaks exact ties deterministically instead.
    ``forced`` (the ``CYLON_EXCHANGE_STRATEGY`` knob) short-circuits to
    the named candidate when present in ``candidates`` — feasibility is
    reported but not enforced for it (it is a diagnostic override).

    ``exclude`` removes named strategies from consideration — the
    escalation ladder's replan arm (``resilience.demoted_exchanges``):
    a resource-classed failure demotes the chooser off the lowerings
    that just failed.  An exclusion that would empty the candidate list
    is ignored (the chooser must always answer), and ``forced`` beats
    it.

    With ``measured=True`` and a probed ``profile``
    (``CYLON_COST_MEASURED=1``), feasible candidates are ranked by
    :func:`predicted_ms` instead of the (rounds, wire) proxy; candidates
    whose collective was not measured fall to the back, and the
    catalogue order breaks ties."""
    by_name = {c.strategy: c for c in candidates}
    if forced is not None and forced in by_name:
        c = by_name[forced]
        return c, f"forced by CYLON_EXCHANGE_STRATEGY ({c.describe()})", \
            c.peak_bytes <= budget
    demoted = ""
    if exclude:
        kept = [c for c in candidates if c.strategy not in exclude]
        if kept:
            candidates = kept
            by_name = {c.strategy: c for c in candidates}
            demoted = (f"replan demotion excluded "
                       f"{', '.join(exclude)}; ")
    # the host tier never competes with a FITTING resident strategy: it
    # trades host-link round trips for resident bytes, which pays only
    # when nothing resident fits.  It sits between "a resident strategy
    # fits" and the best-effort floor
    spill_c = by_name.get(STAGED_SPILL)
    feasible = [c for c in candidates
                if c.peak_bytes <= budget and c.strategy != STAGED_SPILL]
    if not feasible:
        if spill_c is not None and spill_c.peak_bytes <= budget:
            return spill_c, (demoted + "no resident strategy fits the "
                             f"{budget} B budget — host-tier staging: "
                             f"{spill_c.describe()}"), True
        c = by_name.get(CHUNKED, min(candidates,
                                     key=lambda s: s.peak_bytes))
        return c, (demoted + f"budget {budget} B below every strategy's "
                   f"floor — best-effort {c.describe()}"), False
    if measured and profile is not None:
        def meas_key(c):
            p = predicted_ms(c, profile)
            return (p is None, p if p is not None else 0.0,
                    STRATEGIES.index(c.strategy))
        best = min(feasible, key=meas_key)
        p = predicted_ms(best, profile)
        reason = (f"measured ranking: {best.describe()}, predicted "
                  f"{p:.3f} ms" if p is not None else
                  f"measured ranking (unmeasured collective): "
                  f"{best.describe()}")
        return best, demoted + reason, True
    best = min(feasible, key=lambda c: (c.rounds, c.wire_bytes,
                                        STRATEGIES.index(c.strategy)))
    if best.strategy == SINGLE_SHOT:
        return best, demoted + f"{best.describe()} <= budget {budget} B", \
            True
    ss = by_name.get(SINGLE_SHOT)
    over = (f"single-shot priced {ss.peak_bytes} B over the "
            f"{budget} B budget; " if ss is not None
            and ss.peak_bytes > budget else "")
    losers = [c.strategy for c in feasible if c is not best]
    beat = f" (beat {', '.join(losers)})" if losers else ""
    return best, demoted + over + best.describe() + beat, True
