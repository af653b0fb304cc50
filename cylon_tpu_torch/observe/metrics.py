"""The typed metric catalogue and the process-level metrics registry.

The port of ``cylon_tpu/observe/metrics.py``.  The CATALOGUE
(``METRICS``) names every metric the engine emits (name, kind, unit,
meaning), row for row the JAX package's, so a counter read by a
dashboard or a test means the same in both packages; the REGISTRY is the
store behind ``trace.count`` / ``count_max`` / ``gauge`` / ``hist``.

Registry semantics: counters sum, watermarks max, gauges last-write;
each thread writes to its own lock-free cell, reads merge every cell
under one lock with dead threads' totals folded into a retained
aggregate (a worker thread's bumps survive its exit).
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Tuple

from .histogram import Histogram

__all__ = [
    "COUNTER", "WATERMARK", "GAUGE", "HISTOGRAM", "MetricSpec",
    "METRICS", "MetricsRegistry", "REGISTRY", "exchange_count",
    "counter_delta", "row_bytes",
]

# ---------------------------------------------------------------------------
# metric kinds + catalogue
# ---------------------------------------------------------------------------

COUNTER = "counter"      # monotone sum (merge across threads: +)
WATERMARK = "watermark"  # peak value (merge across threads: max)
GAUGE = "gauge"          # last written value (process-level)
HISTOGRAM = "histogram"  # log2-bucket distribution (merge: bucket sums)


@dataclass(frozen=True)
class MetricSpec:
    """One catalogued metric: its kind, unit and meaning.  The catalogue
    lets ``snapshot()`` / ``trace.report()`` tag values by kind."""

    name: str
    kind: str
    unit: str
    doc: str


def _specs(*rows: Tuple[str, str, str, str]) -> Dict[str, MetricSpec]:
    return {n: MetricSpec(n, k, u, d) for n, k, u, d in rows}


def exchange_count(counters: Dict[str, int]) -> int:
    """Whole data exchanges of one counter window: two-phase shuffle
    dispatches (a chunked degraded exchange counts once) plus replica
    gathers actually executed (replica-cache hits cross no wire and do
    not count).  THE definition behind bench.py's per-query
    ``tpch_*_exchange_count`` column and the multiway-join parity
    tests — one place, so the CI gate and the tests cannot
    desynchronize."""
    return (counters.get("shuffle.exchanges", 0)
            + counters.get("join.broadcast_gather", 0)
            + counters.get("groupby.broadcast_gather", 0)
            + counters.get("groupby.psum_combine", 0))


# Every metric the engine emits, the JAX package's rows unchanged (their
# meanings name that package's documents and subsystems; a row whose
# subsystem the port does not have yet is simply never bumped).  Names
# are ``<subsystem>.<what>``; the registry accepts unknown names too
# (tests, ad-hoc probes), but a TPC-H run stays inside this catalogue
# (tests/test_torch_analyze_tpch_*.py).
METRICS: Dict[str, MetricSpec] = _specs(
    # planner decisions (one bump per decided join/groupby)
    ("join.broadcast", COUNTER, "joins",
     "joins that took the broadcast (replicated small side) path"),
    ("join.shuffle", COUNTER, "joins",
     "joins that took a shuffle (co-partition both sides) path"),
    ("join.broadcast_gather", COUNTER, "gathers",
     "small-side replica gathers actually executed for joins"),
    ("groupby.broadcast_gather", COUNTER, "gathers",
     "partial-group replica gathers executed for the groupby combine"),
    ("join.broadcast_replica_hit", COUNTER, "hits",
     "joins served from the replica cache (no gather ran)"),
    ("groupby.broadcast_combine", COUNTER, "combines",
     "groupby combines that replaced the shuffle with one all_gather"),
    ("join.out_rows", COUNTER, "rows", "distributed-join output rows"),
    # fused aggregation exchange — aggregation below/inside the exchange
    # (docs/query_planner.md "groupby pushdown",
    # docs/tpu_perf_notes.md "aggregation below the exchange")
    ("groupby.pushdown", COUNTER, "groupbys",
     "groupbys executed through the planner's fused aggregation "
     "exchange (dist_groupby_fused)"),
    ("groupby.partials_rows", COUNTER, "rows",
     "partial-group rows entering combine exchanges (the payload the "
     "fused path moves instead of the pre-aggregation input rows)"),
    ("groupby.psum_combine", COUNTER, "combines",
     "fused groupbys whose combine ran as ONE all-reduce over a "
     "plan-known dense slot space — no count protocol, no host read"),
    ("groupby.bytes_moved", COUNTER, "bytes",
     "exchange payload bytes attributable to groupby combines (partial "
     "shuffles, combine gathers, psum combines) — the input to bench's "
     "tpch_*_groupby_bytes_saved column"),
    ("shuffle.fold_combined", COUNTER, "folds",
     "chunk-round receiver folds that combined partial-group rows by "
     "key instead of concatenating (exchange_bytes_peak then scales "
     "with distinct groups, not received rows)"),
    # fused multiway (star) joins — partition-once/probe-N
    # (docs/query_planner.md "multiway join fusion")
    ("join.multiway", COUNTER, "joins",
     "fused multiway joins executed (one per dist_multiway_join node)"),
    ("join.multiway_probes", COUNTER, "probes",
     "dimension probes run inside multiway joins"),
    ("join.multiway_dims_broadcast", COUNTER, "dims",
     "multiway probes served by a replicated side under the effective "
     "threshold + replica pricing (the dimension, or the small fact "
     "side of an INNER edge) — no co-partitioning exchange ran"),
    ("join.multiway_dims_shuffled", COUNTER, "dims",
     "multiway dimensions that fell back to the per-edge "
     "co-partitioning shuffle (over threshold or budget-vetoed)"),
    # exchange volume (payload actually crossing the wire)
    ("shuffle.exchanges", COUNTER, "exchanges",
     "two-phase shuffle exchanges dispatched (one per shuffle_leaves "
     "call; a chunked degraded exchange still counts once) — with the "
     "broadcast gather counters this derives bench's per-query "
     "exchange_count"),
    ("shuffle.rows_sent", COUNTER, "rows",
     "rows that left their home shard in shuffle exchanges "
     "(off-diagonal of the count matrix), sent by THIS process's ranks "
     "(every rank with one process)"),
    ("shuffle.bytes_sent", COUNTER, "bytes",
     "payload bytes of shuffle.rows_sent, this process's senders "
     "(leaf dtypes x rows; validity lanes count 1 byte/row)"),
    ("broadcast.rows_sent", COUNTER, "rows",
     "rows x (P-1) replicated by broadcast gathers (each shard's rows "
     "travel to every other shard)"),
    ("broadcast.bytes_sent", COUNTER, "bytes",
     "payload bytes of broadcast.rows_sent"),
    # exchange footprint (allocated block capacity, not payload)
    ("shuffle.capacity_rows", COUNTER, "rows",
     "allocated receive-block slots summed over shuffles (P x outcap)"),
    ("shuffle.capacity_cells", COUNTER, "cells",
     "allocated slots x column leaves summed over shuffles"),
    ("shuffle.capacity_cells_max", WATERMARK, "cells",
     "largest single exchange block (peak transient footprint)"),
    ("shuffle.capacity_cells_live_peak", WATERMARK, "cells",
     "peak LIVE exchange cells of a staged plan (resident right "
     "co-partition + in-flight chunk, streaming join)"),
    # host-boundary accounting (the per-query sync floor)
    ("trace.sync", COUNTER, "syncs",
     "hard completion barriers (trace.hard_sync) — each costs one "
     "tunnel round trip on remote backends"),
    ("host.read", COUNTER, "reads",
     "batched device->host reads (count-protocol flushes, exports, "
     "optimistic-dispatch validations)"),
    ("broadcast.replica_cache_size", GAUGE, "entries",
     "live entries in the broadcast replica cache"),
    # resilience (docs/robustness.md): budget guardrails, degraded
    # exchanges, fault injection, bounded retries, pipeline replays
    # costed redistribution chooser (parallel/cost.py;
    # docs/tpu_perf_notes.md "Choosing the collective"): one tally per
    # budget-priced exchange for the lowering the chooser selected
    ("shuffle.strategy.single_shot", COUNTER, "exchanges",
     "exchanges the costed chooser lowered as ONE lax.all_to_all "
     "(the fast path: single-shot priced within the memory budget)"),
    ("shuffle.strategy.chunked", COUNTER, "exchanges",
     "exchanges the chooser lowered as K bounded all_to_all rounds "
     "(the fewest-rounds strategy fitting the budget)"),
    ("shuffle.strategy.ring", COUNTER, "exchanges",
     "exchanges the chooser lowered as the staged ring ppermute "
     "(P-1 collective-permute rounds, 2-block peak transient)"),
    ("shuffle.strategy.allgather", COUNTER, "exchanges",
     "exchanges the chooser lowered as replicate-and-filter "
     "(all_gather every leaf, keep own rows — beats the all_to_all "
     "transient under one-hot-cell skew)"),
    ("shuffle.strategy.staged_spill", COUNTER, "exchanges",
     "exchanges the chooser lowered as host-tier staged-spill morsel "
     "rounds (no resident strategy fit the budget; the payload staged "
     "out to the spill pool and streamed back — docs/out_of_core.md)"),
    # topology-aware hierarchical collectives (docs/tpu_perf_notes.md
    # "Hierarchical collectives"): two-level lowerings over the
    # (slow, fast) mesh split + the slow-edge traffic they shrink
    ("shuffle.strategy.hierarchical", COUNTER, "exchanges",
     "exchanges lowered as the two-level shuffle (all_to_all within "
     "the fast axis, then a ring ppermute across the slow axis — each "
     "row crosses the slow edge at most once, in one aggregated cell)"),
    ("shuffle.strategy.hierarchical_combine", COUNTER, "exchanges",
     "combine-spec exchanges lowered hierarchically with an axis-local "
     "pre-combine: stage 1's landing folds by (group key, target) so "
     "only per-group partials ever cross the slow axis"),
    ("shuffle.rows_sent_slow", COUNTER, "rows",
     "exchanged rows whose sender and receiver sit in different SLOW "
     "mesh groups (cross-host/DCN traffic under the (slow, fast) "
     "split; flat meshes tally nothing)"),
    ("shuffle.bytes_sent_slow", COUNTER, "bytes",
     "priced wire bytes crossing the slow axis for chosen lowerings "
     "(StrategyPrice.slow_wire_bytes x this process's ranks) — the "
     "number the hierarchy "
     "smoke and benchdiff's scaling_*_wire_bytes_slow gates compare"),
    ("groupby.axis_precombine", COUNTER, "exchanges",
     "hierarchical combine exchanges that ran the fast-axis-local "
     "pre-combine before crossing the slow axis"),
    ("groupby.axis_precombine_rows", COUNTER, "rows",
     "post-pre-combine partial rows that crossed the slow axis (the "
     "exact per-group payload; compare groupby.partials_rows for what "
     "a flat exchange would have moved)"),
    ("shuffle.strategy.downgrades", COUNTER, "exchanges",
     "exchanges the chooser moved OFF the single-shot fast path (sum "
     "of the non-single-shot strategy tallies) — bench's per-query "
     "tpch_*_strategy_downgrades column, gated UP by benchdiff"),
    ("shuffle.chunked", COUNTER, "exchanges",
     "shuffles degraded to the chunked multi-round exchange (single-"
     "shot priced over the device memory budget)"),
    ("shuffle.chunked_rounds", COUNTER, "rounds",
     "bounded all_to_all rounds run by chunked exchanges"),
    ("shuffle.exchange_bytes_peak", WATERMARK, "bytes",
     "largest per-device transient priced for one exchange dispatch "
     "(send + receive blocks + compacted round output)"),
    ("broadcast.budget_veto", COUNTER, "vetoes",
     "broadcast decisions vetoed because the replica would not fit the "
     "device memory budget (the join fell back to shuffle)"),
    ("fault.injected", COUNTER, "faults",
     "faults fired by the active FaultPlan (cylon_tpu.faults)"),
    ("retry.attempts", COUNTER, "retries",
     "transient failures retried at resilience.retrying boundaries"),
    ("retry.exhausted", COUNTER, "failures",
     "retry loops that ran out of attempts (the transient error "
     "propagated to the caller)"),
    ("pipeline.replays", COUNTER, "replays",
     "deferred pipeline attempts replayed after an undersized "
     "optimistic dispatch (ops/compact.run_pipeline)"),
    ("pipeline.fallback_plain", COUNTER, "fallbacks",
     "run_pipeline attempts exhausted — the warned plain-mode (per-op "
     "validated) fallback engaged"),
    # logical query planner (docs/query_planner.md): compiled-plan cache
    # traffic + rewrite activity of optimized plans
    ("plan.cache_hit", COUNTER, "hits",
     "materializations served from the compiled-plan cache (capture "
     "replayed; no rewrite, no strategy re-decision)"),
    ("plan.cache_miss", COUNTER, "misses",
     "materializations that rewrote + compiled a fresh plan"),
    ("plan.reads_trace", COUNTER, "traces",
     "referenced-column discovery traces actually run (eval_shape over "
     "one predicate/expression; cache-hit captures skip these)"),
    ("optimizer.rule_fires", COUNTER, "fires",
     "rewrite-rule fires embodied in executed plans (replayed from the "
     "plan cache on hits, so every run of an optimized plan reports "
     "the rules that shaped it)"),
    ("optimizer.row_bytes_pre", COUNTER, "bytes",
     "summed per-row exchange width of materialized plans BEFORE "
     "rewriting (the projection-pruning baseline)"),
    ("optimizer.row_bytes_post", COUNTER, "bytes",
     "summed per-row exchange width of materialized plans AFTER "
     "rewriting"),
    ("plan.cache_evictions", COUNTER, "evictions",
     "compiled plans evicted from the LRU plan cache (capacity: "
     "config.set_plan_cache_capacity / CYLON_PLAN_CACHE_CAP) — churn "
     "here means the serving working set exceeds the cap"),
    # multi-query serving layer (docs/serving.md): admission control,
    # cross-query subplan sharing, batch-window execution
    ("serve.admitted", COUNTER, "queries",
     "queries admitted to a batch window (their priced exchange "
     "transients fit the remaining admission budget, or they were the "
     "window's head-of-line query)"),
    ("serve.deferred", COUNTER, "deferrals",
     "admission deferrals — a query held back to a later window because "
     "the batch's priced exchange transients would exceed the device "
     "memory budget (a query deferred twice counts twice)"),
    ("serve.rejected", COUNTER, "queries",
     "submissions refused because the bounded query queue was full and "
     "the caller declined to block (backpressure made loud)"),
    ("serve.completed", COUNTER, "queries",
     "queries that finished through the serving layer with a result"),
    ("serve.failed", COUNTER, "queries",
     "queries that failed in the serving layer — the error lands on the "
     "query's own handle; batch peers are unaffected"),
    ("serve.batches", COUNTER, "batches",
     "batch windows executed by the serve dispatcher"),
    ("serve.subplan_shared", COUNTER, "subplans",
     "cross-query subplan reuses inside a batch window: an operator "
     "whose result another admitted query already produced was served "
     "from the shared execution memo instead of re-executing (the "
     "scan/select/shuffle crossed the wire once, fanned out to N "
     "consumers)"),
    ("serve.exports_async", COUNTER, "exports",
     "query exports handed to the async host pipeline (host Arrow "
     "conversion overlapping the next query's device compute)"),
    ("serve.queue_depth", GAUGE, "queries",
     "queries waiting in the serve queue (submitted, not yet admitted "
     "to a window — deferred queries count until re-admitted)"),
    # cross-window materialized subplans (serve/matview.py;
    # docs/serving.md "Materialized subplans"): the serve.view_* family
    # is the query's-eye view (hit/miss/fold outcomes), the matview.*
    # family the store's own lifecycle (retention, invalidation, loss)
    ("serve.view_hits", COUNTER, "queries",
     "queries served whole from a cross-window materialized view — "
     "result rebuilt from pooled host blocks, zero exchanges dispatched"),
    ("serve.view_misses", COUNTER, "queries",
     "view probes that fell through to full execution (no entry, or "
     "the pool's LRU reclaimed the blocks)"),
    ("serve.view_folds", COUNTER, "queries",
     "queries served by folding pending ingest deltas through the "
     "view's captured mergeable aggregation state — O(delta), the "
     "base table untouched"),
    ("serve.view_subplan_hits", COUNTER, "subplans",
     "carried SUBPLAN entries re-seeded into a later window's shared "
     "execution memo — cross-window cousins of serve.subplan_shared"),
    ("matview.retained", COUNTER, "views",
     "query results retained as materialized views (admission-by-cost "
     "passed, the spill pool admitted the blocks)"),
    ("matview.declined", COUNTER, "views",
     "retention offers declined — benefit per retained MiB under the "
     "CYLON_MATVIEW_MIN_BENEFIT floor, or the pool refused the bytes "
     "(host budget)"),
    ("matview.invalidations", COUNTER, "views",
     "views dropped because a base table's content epoch advanced past "
     "a non-foldable plan (or a fold failed) — the never-stale "
     "guarantee made visible"),
    ("matview.folds", COUNTER, "folds",
     "successful delta folds (serve.view_folds' store-side twin; one "
     "fold may merge several pending epochs)"),
    ("matview.fold_rows", COUNTER, "rows",
     "delta rows folded through captured aggregation state — the "
     "O(delta) in incremental maintenance, measured"),
    ("matview.fold_failures", COUNTER, "folds",
     "folds that failed (matview.fold fault point included) and "
     "degraded to invalidate + full recompute"),
    ("matview.lost", COUNTER, "views",
     "views whose pooled blocks the host-budget LRU evicted before the "
     "next probe — served as misses, never errors"),
    ("matview.subplans_retained", COUNTER, "subplans",
     "hot shared subplans harvested from a window's execution memo "
     "into the pool for cross-window reuse"),
    ("serve.batch_window_ms", GAUGE, "ms",
     "the serve session's configured batch-window length: how long the "
     "dispatcher collects concurrent arrivals before admitting a batch"),
    # runtime telemetry 2.0 (this package; docs/observability.md):
    # the mesh bandwidth probe and the persistent run-stats store
    ("meshprobe.probes", COUNTER, "probes",
     "mesh bandwidth microbench runs (parallel/meshprobe.py) — one per "
     "mesh fingerprint unless forced; the fitted (latency, bytes/s) "
     "coefficients are cached and surfaced through cost.predicted_ms"),
    ("meshprobe.axis_probes", COUNTER, "probes",
     "per-axis probe passes over a non-trivial (slow, fast) split — "
     "fits the @fast/@slow per-edge coefficients the hierarchical "
     "lowerings are priced against"),
    ("stats.records", COUNTER, "records",
     "run-stats store writes (observe.stats): ANALYZE reports or served "
     "executions recorded under their plan-cache fingerprint — the "
     "recording half of the adaptive-execution loop (ROADMAP §4)"),
    ("stats.fingerprints", GAUGE, "plans",
     "distinct plan fingerprints currently held by the run-stats store"),
    # compilation observability (observe/compile.py;
    # docs/observability.md "compile tracking"): every jit build through
    # an instrumented kernel factory is a measured event
    ("compile.builds", COUNTER, "builds",
     "jit programs built: first concrete dispatch of a new shape "
     "signature through an instrumented kernel factory (trace + XLA "
     "compile paid here)"),
    ("compile.build_us", COUNTER, "us",
     "wall-clock of compile.builds events (async dispatch: trace + "
     "lowering + compile + enqueue; device execution excluded) — "
     "report.totals['compile_ms'] and QueryHandle.compile_ms derive "
     "from the per-query attribution of the same events"),
    ("compile.trace_us", COUNTER, "us",
     "the pure tracing share of builds, measured via one eval_shape "
     "pre-pass while counters are enabled (production dispatch skips "
     "the pre-pass, so this is an observability-mode number)"),
    ("compile.cache_hits", COUNTER, "hits",
     "kernel-factory cache hits (the program already existed)"),
    ("compile.cache_misses", COUNTER, "misses",
     "kernel-factory cache misses (a new program was built for a new "
     "static key)"),
    ("compile.storms", COUNTER, "storms",
     "recompile-storm detections: one factory built STORM_KEYS distinct "
     "programs inside one sliding window (the warn_once names the "
     "thrashing key component)"),
    ("compile.plan_build_us", COUNTER, "us",
     "wall-clock of compiled-plan cache misses in plan/executor "
     "(rewrite rules + frozen-copy store) — the plan-altitude sibling "
     "of compile.build_us"),
    # device-truth memory (observe/devmem.py): allocator watermarks /
    # live-buffer accounting sampled at exchange boundaries
    ("devmem.samples", COUNTER, "samples",
     "device memory snapshots taken (memory_stats or live-buffer "
     "accounting; sampled at exchange boundaries under EXPLAIN "
     "ANALYZE, never on the production hot path)"),
    ("devmem.peak_bytes", WATERMARK, "bytes",
     "largest OBSERVED per-exchange memory transient (device-truth "
     "counterpart of the priced shuffle.exchange_bytes_peak; lower "
     "bound on CPU — see docs/observability.md 'device-truth memory')"),
    # flight recorder + SLO alerting (observe/flightrec.py,
    # observe/timeseries.py anomaly rules, serve deadlines)
    ("flightrec.dumps", COUNTER, "bundles",
     "diagnostic bundles written by the flight recorder (on-demand "
     "dumps + capped auto-dumps on CylonErrors escaping served "
     "queries)"),
    ("serve.slo_violations", COUNTER, "violations",
     "SLO violations: per-query deadline misses "
     "(submit(deadline_ms=...)) plus rolling-window anomaly alerts "
     "from the time-series sampler (p99 drift, QPS collapse, cache-hit "
     "collapse) — bench emits it, benchdiff gates it UP"),
    # self-healing recovery (docs/robustness.md "self-healing
    # execution"): the escalation ladder's stage checkpoints, retries,
    # replans, and outcomes in plan/executor.py
    ("recover.checkpoints", COUNTER, "checkpoints",
     "stage results retained at exchange boundaries by the recovery "
     "checkpoint store (a costed decision against "
     "RecoveryPolicy.checkpoint_fraction of the memory budget)"),
    ("recover.checkpoint_bytes", WATERMARK, "bytes",
     "largest total per-device footprint the checkpoint store priced "
     "as retained at once (cost.price_retained per entry)"),
    ("recover.checkpoint_skipped", COUNTER, "stages",
     "exchange-boundary results NOT checkpointed because their own "
     "retention price exceeded the checkpoint budget"),
    ("recover.checkpoint_evictions", COUNTER, "evictions",
     "older checkpoints evicted to admit a newer one under the "
     "checkpoint budget (the newest checkpoint is the resume point)"),
    ("recover.checkpoint_hits", COUNTER, "restores",
     "stages served from a retained checkpoint during a recovery "
     "attempt (the work partial replay did NOT redo)"),
    ("recover.restore_failed", COUNTER, "failures",
     "checkpoint restores that failed (recover.checkpoint_restore "
     "fault point) — the checkpoint was dropped and the stage "
     "recomputed from its inputs"),
    ("recover.stages_replayed", COUNTER, "stages",
     "exchange-boundary stages RE-executed by recovery attempts after "
     "completing in an earlier attempt — the partial-replay proof is "
     "this staying below the plan's stage count"),
    ("recover.stage_retries", COUNTER, "retries",
     "transient-classed stage retries taken by the escalation ladder "
     "(resume from the last checkpoint, re-run downstream)"),
    ("recover.replans", COUNTER, "replans",
     "resource-classed replans: the ladder demoted the costed chooser "
     "off the failed lowering and resumed from checkpoint with a "
     "degraded catalogue strategy (chunked / ring)"),
    ("recover.recovered", COUNTER, "queries",
     "materializations that COMPLETED after one or more ladder "
     "attempts — failures that healed instead of killing the query"),
    ("recover.failures", COUNTER, "failures",
     "ladders that gave up: an engaged ladder exhausting its rungs, or "
     "an injected permanent fault — the error propagates annotated "
     "with the attempt log and the flight recorder holds a "
     "recover_failed event (organic first failures the ladder never "
     "engaged with are annotated but NOT booked here)"),
    # elastic degraded-mesh execution (docs/robustness.md
    # "Elasticity"): the topology rung — device loss answered by
    # evacuation to the host tier + re-meshing onto the survivors
    ("recover.remesh", COUNTER, "remeshes",
     "topology-rung re-meshes: a device loss (mesh.device_lost / an "
     "XLA device-lost error) evacuated live state through the host "
     "tier and resumed the plan on a shrunken survivor mesh"),
    ("recover.remesh_us", COUNTER, "us",
     "wall-clock spent inside re-mesh evacuations (memo drop + scan "
     "table + checkpoint re-partition + restage) — bench emits it as "
     "serve_meshchaos_remesh_ms"),
    ("recover.evacuated_bytes", COUNTER, "bytes",
     "bytes evacuated device->host through the spill pool's staging "
     "boundary during topology-rung re-meshes (spilled tables "
     "re-block from their pooled copies and add nothing here)"),
    ("recover.survivor_world", GAUGE, "devices",
     "world size of the current survivor mesh after the most recent "
     "device loss (cylon_tpu/topology.py)"),
    ("serve.degraded", GAUGE, "devices",
     "devices the serving session has lost vs its construction-time "
     "mesh — nonzero means degraded mode: admission budgets re-price "
     "to the survivor fraction and new builders anchor on the "
     "survivor mesh; cleared back to 0 by a full scale-up"),
    # elastic scale-UP (docs/robustness.md "Elasticity", scale-up
    # half): the inverse arm — repaired devices rejoining, expansion
    # vs deferral, and the SLO loop that asks for capacity
    ("recover.scaleups", COUNTER, "scaleups",
     "applied mesh expansions: a device rejoin (mesh.device_joined / "
     "topology.mark_joined) grew the live mesh back along the roster "
     "and bumped the topology epoch"),
    ("recover.scaleup_deferred", COUNTER, "deferrals",
     "mid-plan expansions the executor deferred because the amortized "
     "win (observed per-stage priced bytes x stages left) did not "
     "beat the migration cost — annotated remesh=deferred(P->P') and "
     "re-evaluated at each later stage boundary"),
    ("recover.join_damped", COUNTER, "joins",
     "device rejoins held pending by the flap-damping hysteresis "
     "window (CYLON_REMESH_COOLDOWN_MS) instead of applied — a "
     "flapping device pays one damped interval, not two evacuations"),
    ("serve.capacity_requests", COUNTER, "requests",
     "typed capacity requests booked on a serving session by "
     "sustained p99-drift / qps-collapse SLO alerts "
     "(observe.timeseries) — fulfilled by the next mesh_expanded "
     "event, rendered by doctor in the scale-up timeline"),
    ("serve.router_routed", COUNTER, "queries",
     "queries placed onto a fleet replica by serve.router — by "
     "plan-cache affinity when the fingerprint's compiling replica is "
     "known and healthy, else by least priced-bytes load"),
    ("serve.router_affinity_hits", COUNTER, "queries",
     "fleet routings that hit plan-cache affinity: the query's "
     "fingerprint routed to the replica recorded as having compiled "
     "it (observe.stats set_replica)"),
    ("serve.router_view_affinity_hits", COUNTER, "queries",
     "fleet routings that hit LIVE-VIEW affinity: the query's "
     "fingerprint routed to the replica whose materialized-view store "
     "holds a live view for it (serve/matview.py) — that replica "
     "answers from pooled host blocks with zero exchanges, so view "
     "affinity outranks plan-cache affinity in serve.router placement"),
    ("serve.router_failovers", COUNTER, "queries",
     "fleet routings diverted off their preferred replica because it "
     "was draining, quarantined (breaker OPEN), degraded, or closed"),
    ("shuffle.watchdog_timeouts", COUNTER, "timeouts",
     "collective dispatches aborted by the exchange hang watchdog "
     "(CYLON_EXCHANGE_TIMEOUT_MS): the wedged exchange raised a "
     "classified TransientFault naming its boundary instead of "
     "hanging the dispatcher forever"),
    # out-of-core execution (docs/out_of_core.md): the host-tier spill
    # pool, device<->host staging, and morsel-partitioned scans
    ("spill.spills", COUNTER, "tables",
     "tables whose leaves were staged out to the host-tier spill pool "
     "(device arrays dropped; a content-signature re-spill hit does "
     "not re-read the device)"),
    ("spill.respill_hits", COUNTER, "tables",
     "re-spills served from a retained host copy (content signature "
     "unchanged since the last spill — no device read ran)"),
    ("spill.faultins", COUNTER, "tables",
     "spilled tables faulted back onto the device (transparent on "
     "first device use, or explicit ensure_device)"),
    ("spill.evictions", COUNTER, "entries",
     "resident (cache-tier) pool entries evicted to admit a new "
     "stage-out under the host memory budget"),
    ("spill.stage_outs", COUNTER, "transfers",
     "batched device->host staging transfers through the spill pool "
     "(the sanctioned leaf-sized D2H boundary — the "
     "host-array-unpooled lint rule routes here)"),
    ("spill.stage_out_bytes", COUNTER, "bytes",
     "payload bytes staged device->host through the pool"),
    ("spill.stage_ins", COUNTER, "transfers",
     "host->device staging transfers through the spill pool (whole "
     "fault-ins and per-morsel slices both count)"),
    ("spill.stage_in_bytes", COUNTER, "bytes",
     "payload bytes staged host->device through the pool"),
    ("spill.host_bytes_peak", WATERMARK, "bytes",
     "largest total host memory the spill pool held at once (pinned + "
     "resident entries; the CYLON_HOST_MEMORY_BUDGET watermark)"),
    ("spill.morsels", COUNTER, "morsels",
     "admission-priced morsels streamed through out-of-core operators "
     "(morsel scans and staged-spill exchange rounds)"),
    ("spill.morsel_groupbys", COUNTER, "groupbys",
     "groupbys executed through the morsel-partitioned scan (per "
     "morsel: staged slice -> local partials -> fold; one final "
     "partial exchange + combine)"),
    ("spill.morsel_joins", COUNTER, "joins",
     "joins whose probe side streamed from the spill pool in morsels"),
    ("spill.exchanges", COUNTER, "exchanges",
     "exchanges run as the staged-spill lowering (payload staged out, "
     "morsel rounds staged back in)"),
    # sketch-based approximate aggregation (docs/out_of_core.md
    # "sketches"; arXiv:2010.14596): mergeable per-group sketches ARE
    # the partials, so cross-shard wire bytes are constant per group
    ("sketch.groupbys", COUNTER, "groupbys",
     "sketch groupbys executed (dist_groupby_sketch: local sketch "
     "build -> partial exchange -> sketch merge -> finalize)"),
    ("sketch.partial_rows", COUNTER, "rows",
     "per-shard sketch partial rows entering the combine exchange "
     "(<= groups x shards regardless of input rows — the "
     "constant-per-group wire contract)"),
    ("sketch.register_bytes", COUNTER, "bytes",
     "sketch state bytes moved through combine exchanges (HLL "
     "register arrays + bottom-k sample lanes)"),
    # serving-layer overload protection (docs/serving.md): the
    # per-plan circuit breaker, load shedding, and graceful drain
    ("serve.shed", COUNTER, "queries",
     "submissions rejected by load shedding with a typed Overloaded "
     "error — queue-depth pressure on priority-0 work, or a deadline "
     "the estimated queue wait already busts"),
    ("serve.breaker_open", COUNTER, "transitions",
     "circuit-breaker openings (threshold consecutive failures of one "
     "plan fingerprint, or a failed half-open probe)"),
    ("serve.breaker_rejected", COUNTER, "queries",
     "submissions rejected in O(us) with a typed Quarantined error "
     "because their plan fingerprint's breaker was open"),
    ("serve.breaker_probes", COUNTER, "probes",
     "half-open probe submissions admitted after a breaker cooldown "
     "(exactly one in flight per fingerprint; its outcome decides "
     "closed vs re-opened)"),
    ("serve.breaker_closed", COUNTER, "transitions",
     "breakers closed by a successful probe — quarantined service "
     "restored without operator action"),
    ("serve.drains", COUNTER, "drains",
     "graceful session drains: admission stopped, in-flight queries "
     "finished, async exports joined, run-stats store flushed"),
    ("lock.acquires", COUNTER, "acquires",
     "OrderedLock outermost acquisitions across every catalogued lock "
     "(docs/static_analysis.md 'Concurrency discipline'); per-lock "
     "counts live on the lock objects (observe.locks.known_locks)"),
    ("lock.held_us", WATERMARK, "us",
     "longest time any OrderedLock was held, microseconds — launch "
     "serialization pressure (serial_call's dispatch lock) and "
     "lock-convoy triage both read this watermark"),
    ("lock.order_violations", COUNTER, "violations",
     "AB/BA lock-order inversions detected at acquire time; raises "
     "LockOrderViolation under CYLON_LOCKCHECK=1 / config.sanitize(), "
     "else flightrec + warn_once"),
    ("lock.hold_watchdog", COUNTER, "events",
     "hold-time watchdog firings: an OrderedLock released after "
     "holding past config.lock_hold_watchdog_ms (flightrec carries "
     "the lock name and duration)"),
    # live telemetry plane (docs/observability.md "Live telemetry
    # plane"): mergeable latency/bytes histograms, tail-based trace
    # sampling accounting, and the OpenMetrics/event-log export surface
    ("serve.latency_ms", HISTOGRAM, "ms",
     "submit->finish latency distribution of completed served queries "
     "(log2 buckets; the source of ServeSession.stats() p50/p99/p999 "
     "and the sampler's window percentiles)"),
    ("serve.queue_wait_ms", HISTOGRAM, "ms",
     "queue-wait distribution of admitted queries (submit->admission; "
     "the admission-pressure histogram next to serve.latency_ms)"),
    ("serve.query_bytes", HISTOGRAM, "bytes",
     "priced exchange-transient bytes per served query (the admission "
     "price distribution — heavy-tail drift here predicts deferrals)"),
    ("trace.sampled_out", COUNTER, "spans",
     "span records dropped by tail-based trace sampling: fast, "
     "uneventful queries released at completion, plus retained traces "
     "evicted past the trace.set_tail_budget ring bound — dropped "
     "counts are visible, never silent"),
    ("trace.tail_kept", COUNTER, "queries",
     "query traces RETAINED by the tail sampler's completion-time "
     "decision (slowest-k per window, errors, SLO misses, recovered "
     "queries)"),
    ("flightrec.dumps_suppressed", COUNTER, "bundles",
     "auto-dumps suppressed by the MAX_AUTO_DUMPS per-process cap: a "
     "CylonError escaped a served query but no bundle was written — "
     "doctor notes this so operators know bundles are missing"),
    ("observe.export_scrapes", COUNTER, "scrapes",
     "OpenMetrics endpoint scrapes served (observe/exporter.py)"),
    ("observe.export_skipped", COUNTER, "metrics",
     "metric names present in the registry but NOT in this catalogue "
     "at scrape time, skipped from the exposition (the exporter only "
     "exports catalogued metrics — the same catalogue-as-contract "
     "pinning as graftlint's counter rule)"),
    ("observe.events_logged", COUNTER, "events",
     "structured events appended to the JSON-lines event log "
     "(CYLON_EVENT_LOG): flightrec events, SLO alerts, recovery and "
     "remesh events, lock-order violations"),
    ("observe.config_info", GAUGE, "info",
     "constant-1 info metric whose labels carry the config "
     "fingerprint (mesh/budget/knob state) on the OpenMetrics "
     "endpoint"),
)


# ---------------------------------------------------------------------------
# registry: per-thread cells, process-level merge at snapshot time
# ---------------------------------------------------------------------------

class _Cell:
    """One thread's lock-free metric buffers."""

    __slots__ = ("thread", "counters", "watermarks", "hists", "events")

    def __init__(self) -> None:
        self.thread = threading.current_thread()
        self.counters: Dict[str, int] = {}
        self.watermarks: Dict[str, int] = {}
        self.hists: Dict[str, Histogram] = {}
        # (t_seconds, name, delta_or_value, thread_id) — recorded only
        # while span tracing is on; the Chrome exporter's C-event input.
        # Counter events carry the bump DELTA (not the thread-local
        # cumulative): the exporter re-accumulates across the merged,
        # time-sorted series, so a counter bumped from several threads
        # renders as ONE monotone process-level track whose final value
        # equals merged() — not a per-thread sawtooth
        self.events: List[Tuple[float, str, Any, int]] = []


class MetricsRegistry:
    """Process-level metric store with per-thread write buffers.

    Writes (``bump``/``watermark``) touch only the calling thread's cell
    — no lock on the hot path.  Reads (``merged``/``snapshot``) take the
    registry lock, fold cells of DEAD threads into a retained aggregate
    (so a worker thread's counts survive its exit), and merge the live
    cells: counters sum, watermarks max, gauges last-write."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._tls = threading.local()
        self._cells: List[_Cell] = []
        self._retired = _Cell()          # dead threads' folded totals
        self._gauges: Dict[str, Any] = {}
        self._kinds: Dict[str, str] = {}

    # -- writes (per-thread, lock only on first touch) ----------------------

    def _cell(self) -> _Cell:
        cell = getattr(self._tls, "cell", None)
        if cell is None:
            cell = _Cell()
            with self._lock:
                self._cells.append(cell)
            self._tls.cell = cell
        return cell

    def bump(self, name: str, n: int = 1, record_event: bool = False) -> None:
        cell = self._cell()
        # read the dict reference ONCE: reset() swaps live cells' dicts
        # from another thread, and a get/set pair spanning the swap
        # would carry a pre-reset total into the fresh window.  Against
        # a single snapshot the race collapses to "a bump concurrent
        # with reset may land in the discarded window" — inherently
        # ambiguous timing, never a resurrected count.
        d = cell.counters
        d[name] = d.get(name, 0) + int(n)
        self._kinds.setdefault(name, COUNTER)
        if record_event:
            cell.events.append((time.perf_counter(), name, int(n),
                                threading.get_ident()))

    def watermark(self, name: str, n: int,
                  record_event: bool = False) -> None:
        cell = self._cell()
        d = cell.watermarks  # single snapshot — same race note as bump
        v = max(d.get(name, 0), int(n))
        d[name] = v
        self._kinds.setdefault(name, WATERMARK)
        if record_event:
            cell.events.append((time.perf_counter(), name, v,
                                threading.get_ident()))

    def observe(self, name: str, value: float) -> None:
        """Record one observation into a per-thread histogram cell
        (``trace.hist``'s store).  Same lock-free/read-once discipline
        as ``bump``: a reset swaps ``cell.hists`` wholesale, and an
        observation racing the swap lands in the discarded window.
        Histograms record no Chrome events — a distribution has no
        single monotone series to render."""
        cell = self._cell()
        d = cell.hists  # single snapshot — same race note as bump
        h = d.get(name)
        if h is None:
            h = d[name] = Histogram()
        h.observe(value)
        self._kinds.setdefault(name, HISTOGRAM)

    def gauge(self, name: str, value: Any,
              record_event: bool = False) -> None:
        self._kinds.setdefault(name, GAUGE)
        with self._lock:
            self._gauges[name] = value
        if record_event:
            self._cell().events.append((time.perf_counter(), name,
                                        value, threading.get_ident()))

    # -- reads (merge under the lock) ---------------------------------------

    def _fold_dead_locked(self) -> None:
        live = []
        for cell in self._cells:
            if cell.thread.is_alive():
                live.append(cell)
                continue
            for k, v in cell.counters.items():
                self._retired.counters[k] = \
                    self._retired.counters.get(k, 0) + v
            for k, v in cell.watermarks.items():
                self._retired.watermarks[k] = \
                    max(self._retired.watermarks.get(k, 0), v)
            for k, h in cell.hists.items():
                r = self._retired.hists.get(k)
                if r is None:
                    r = self._retired.hists[k] = Histogram()
                r.merge(h)
            self._retired.events.extend(cell.events)
        self._cells = live

    def merged(self) -> Dict[str, int]:
        """Flat process-level view: counters summed + watermarks maxed
        across every thread that ever bumped (the ``trace.counters()``
        payload; gauges are typed separately — see ``snapshot``)."""
        with self._lock:
            self._fold_dead_locked()
            cells = [self._retired] + list(self._cells)
            out: Dict[str, int] = {}
            for cell in cells:
                for k, v in cell.counters.items():
                    out[k] = out.get(k, 0) + v
            for cell in cells:
                for k, v in cell.watermarks.items():
                    out[k] = max(out.get(k, 0), v)
            return out

    def histograms(self) -> Dict[str, Histogram]:
        """Merged process-level histograms (one lossless bucket-sum
        fold per name across retired + live cells; returned copies are
        the caller's to quantile/serialize)."""
        with self._lock:
            self._fold_dead_locked()
            out: Dict[str, Histogram] = {}
            for cell in [self._retired] + list(self._cells):
                for k, h in cell.hists.items():
                    tgt = out.get(k)
                    if tgt is None:
                        tgt = out[k] = Histogram()
                    tgt.merge(h)
            return out

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        """One-shot typed snapshot: ``{"counters": {...}, "watermarks":
        {...}, "gauges": {...}, "histograms": {...}}`` merged across
        threads under one lock acquisition (a consistent cut, not four
        racing reads).  Histograms are JSON-safe ``to_dict`` forms —
        the flight-recorder bundle embeds this snapshot verbatim."""
        with self._lock:
            self._fold_dead_locked()
            cells = [self._retired] + list(self._cells)
            counters: Dict[str, int] = {}
            marks: Dict[str, int] = {}
            hists: Dict[str, Histogram] = {}
            for cell in cells:
                for k, v in cell.counters.items():
                    counters[k] = counters.get(k, 0) + v
                for k, v in cell.watermarks.items():
                    marks[k] = max(marks.get(k, 0), v)
                for k, h in cell.hists.items():
                    tgt = hists.get(k)
                    if tgt is None:
                        tgt = hists[k] = Histogram()
                    tgt.merge(h)
            return {"counters": counters, "watermarks": marks,
                    "gauges": dict(self._gauges),
                    "histograms": {k: h.to_dict()
                                   for k, h in hists.items()}}

    def counter_events(self) -> List[Tuple[float, str, Any, int]]:
        """Time-ordered PROCESS-LEVEL value series across threads
        (Chrome C events): the merged raw events re-accumulated by kind
        — counters sum their deltas, watermarks keep the running max,
        gauges pass through — so the exported track's last sample
        agrees with ``merged()`` no matter which threads bumped."""
        with self._lock:
            self._fold_dead_locked()
            raw: List[Tuple[float, str, Any, int]] = []
            for cell in [self._retired] + list(self._cells):
                raw.extend(cell.events)
        out: List[Tuple[float, str, Any, int]] = []
        running: Dict[str, Any] = {}
        for t, name, val, tid in sorted(raw, key=lambda e: e[0]):
            kind = self.kind_of(name)
            if kind == COUNTER:
                running[name] = running.get(name, 0) + val
            elif kind == WATERMARK:
                running[name] = max(running.get(name, 0), val)
            else:
                running[name] = val
            out.append((t, name, running[name], tid))
        return out

    def kind_of(self, name: str) -> str:
        spec = METRICS.get(name)
        if spec is not None:
            return spec.kind
        return self._kinds.get(name, COUNTER)

    def reset(self) -> None:
        with self._lock:
            self._retired = _Cell()
            for cell in self._cells:
                cell.counters = {}
                cell.watermarks = {}
                cell.hists = {}
                cell.events = []
            self._gauges = {}


REGISTRY = MetricsRegistry()


# ---------------------------------------------------------------------------
# shared pricing / delta helpers
# ---------------------------------------------------------------------------

def row_bytes(leaves) -> int:
    """Payload width of ONE row across exchanged column leaves: element
    size times the trailing elements per row (a validity lane is bool,
    1 byte a row).  The single definition behind ``shuffle.bytes_sent``
    and ``broadcast.bytes_sent``: both exchange paths price a row through
    this, so the metric cannot drift between them.  Metadata only; never
    reads device data."""
    import math

    return sum(lf.element_size() * math.prod(lf.shape[1:])
               for lf in leaves)


def counter_delta(before: Dict[str, int],
                  after: Dict[str, int]) -> Dict[str, int]:
    """Kind-aware difference of two merged-counter snapshots: counters
    subtract; a watermark reports the window's NEW PEAK when it moved
    (a watermark's difference is meaningless); unchanged keys are
    omitted.  The one definition behind both EXPLAIN ANALYZE's per-node
    stitching and ``resilience.counter_scope``'s per-query attribution
    windows — a new metric kind handled here is handled in both.
    Histograms never enter the flat merged view: their windows come
    from ``Histogram.minus`` (bucket-wise difference), not from this
    scalar delta."""
    out: Dict[str, int] = {}
    for k, v in after.items():
        v0 = before.get(k, 0)
        if v == v0:
            continue
        out[k] = v if REGISTRY.kind_of(k) == WATERMARK else v - v0
    return out
