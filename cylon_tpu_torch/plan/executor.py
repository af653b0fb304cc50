"""Plan executor: lowering onto the eager dist ops + compiled-plan cache.

The port of the lowering, plan-cache and execution parts of
``cylon_tpu/plan/executor.py``.  ``materialize(builder, root)`` is the one
entry point: every materialization boundary of a captured plan
(``LogicalTable.to_table`` / ``head`` / ``num_rows``, ``dist_aggregate``,
``dist_head``) lands here.

Flow per call:

  1. fingerprint the PRE-rewrite DAG (plan structure, schemas,
     ingest-cached scan row counts, callable identities: everything a
     rewrite decision can read) together with the configuration the
     rules read (device, world, broadcast threshold, explicit memory
     budget);
  2. look it up in the module-level **compiled-plan cache**: a hit
     replays the cached rewrite outcome (optimized DAG, rule fires,
     pre/post exchange row bytes) with no rule evaluation and, because
     ``ir.referenced_columns`` memoizes its discovery, no predicate
     re-run; a miss runs plan/rules.py once and stores the outcome;
  3. execute the optimized DAG through the LOWERING table, each node
     calling the ordinary eager operator under ``ir.suspended()``, so the
     runtime decisions (broadcast re-checks against the live memory
     budget, the dense FK paths, psum re-checks) are made again on every
     execution of a cached plan.

Runtime payloads (scan DTables, select ``params``, predicates) are
rebound from the current capture on every run through each cached node's
``origin_idx``, its pre-order position in the pre-rewrite DAG, which
fingerprint equality keeps aligned across runs.  Cached entries pin no
user tables.  Execution is memoized per run by content signature
(``Builder.exec_memo``): a subplan feeding two materialization boundaries
(the q11 / q15 correlated-aggregate shape) executes once.

Counters (``trace``): ``plan.cache_hit`` / ``plan.cache_miss`` /
``plan.cache_evictions`` (the LRU cap is ``config.plan_cache_capacity``),
``compile.plan_build_us`` (the rewrite's host time on a miss),
``optimizer.rule_fires`` (replayed on hits), ``optimizer.row_bytes_pre``
/ ``optimizer.row_bytes_post``.

Recovery: ``materialize`` runs the optimized DAG under the recovery
driver (:func:`_execute_recovering`), the classified escalation ladder
around ``_execute``: a transient failure retries the stage from the
intact execution memo; a resource failure (a CUDA out-of-memory error
included) drops this ladder's memo insertions and re-lowers with the
exchanges demoted (``resilience.demoted_exchanges``), resuming from the
priced stage-checkpoint store (:class:`_CheckpointStore`); a topology
failure (``mesh.device_lost``) drops the whole memo, evacuates the plan's
scan tables and the retained checkpoints through the host tier onto a
survivor context (``topology.mark_lost``, ``parallel/remesh.py``) and
resumes there; permanent or exhausted fails with the attempt log on the
error (``e.ladder``).  A ``mesh.device_joined`` event at a stage boundary
grows the world back mid-plan, or defers per the amortization bound.
``CYLON_RECOVERY=0`` / ``config.set_recovery_enabled(False)`` runs the
plan without any of it.  Counters: the ``recover.*`` family.
"""
from __future__ import annotations

import threading
import time
import traceback
from contextlib import contextmanager
from typing import Any, Dict, List, Optional, Set, Tuple

import numpy as np

from .. import faults, trace
from ..analysis import plan_check
from ..observe import stats as obstats
from ..status import Code, CylonError, Status
from . import ir, rules
from .ir import Node

__all__ = ["materialize", "LOWERING", "clear_plan_cache", "plan_cache_len",
           "collect_roots"]


# ---------------------------------------------------------------------------
# lowering table: IR op -> eager call
# ---------------------------------------------------------------------------

def _key_spec(names: Tuple[str, ...]):
    return names[0] if len(names) == 1 else tuple(names)


class _MappedEnv:
    """Env adapter for a pushed-down select: the predicate keeps reading
    its original (post-rename / post-join) column names while the
    underlying recording env sees the pre-rewrite names, so the null veto
    lands on exactly the columns the predicate read.  Mirrors the whole
    ``_RecordingEnv`` read surface (items / values / keys, ``in``,
    iteration), and every read still lands on the recording env."""

    __slots__ = ("_base", "_map")

    def __init__(self, base, mapping):
        self._base = base
        self._map = mapping

    def __getitem__(self, k):
        return self._base[self._map.get(k, k)]

    def get(self, k, default=None):
        try:
            return self[k]
        except KeyError:
            return default

    def valid(self, k):
        return self._base.valid(self._map.get(k, k))

    def _names(self):
        inv = {b: p for p, b in self._map.items()}
        return [inv.get(k, k) for k in self._base.keys()]

    def keys(self):
        return self._names()

    def __iter__(self):
        return iter(self._names())

    def __len__(self):
        return len(self._base)

    def __contains__(self, k):
        return self._map.get(k, k) in self._base

    def items(self):
        return [(k, self[k]) for k in self._names()]

    def values(self):
        return [self[k] for k in self._names()]


def _mapped_pred(pred, env_map: Tuple[Tuple[str, str], ...]):
    mapping = dict(env_map)

    def wrapped(env, *params):
        return pred(_MappedEnv(env, mapping), *params)

    return wrapped


def _lower_scan(ctx, ins, static, rt):
    return rt["dtable"]


def _lower_rename(ctx, ins, static, rt):
    m = dict(static["mapping"])
    dt = ins[0]
    return dt.rename([m.get(n, n) for n in dt.column_names])


def _lower_select(ctx, ins, static, rt):
    from ..parallel import dist_ops
    pred = rt["predicate"]
    if static.get("env_map"):
        pred = _mapped_pred(pred, static["env_map"])
    return dist_ops.dist_select(ins[0], pred, tuple(rt.get("params", ())),
                                static["compact"])


def _lower_project(ctx, ins, static, rt):
    from ..parallel import dist_ops
    return dist_ops.dist_project(ins[0], list(static["columns"]))


def _lower_with_column(ctx, ins, static, rt):
    from ..parallel import dist_ops
    return dist_ops.dist_with_column(ins[0], static["name"], rt["fn"],
                                     static["out_type"],
                                     list(static["validity_from"]))


def _join_config(static):
    from ..config import JoinAlgorithm, JoinConfig, JoinType
    planned = static.get("planned")
    thr = static.get("broadcast_threshold")
    if planned is not None and planned[0] == "shuffle":
        thr = 0  # decided at plan time: skip the per-call small-side check
    return JoinConfig(JoinType(static["how"]),
                      JoinAlgorithm(static["alg"]),
                      _key_spec(static["left_on"]),
                      _key_spec(static["right_on"]),
                      broadcast_threshold=thr)


def _lower_join(ctx, ins, static, rt):
    from ..parallel import dist_ops
    return dist_ops.dist_join(ins[0], ins[1], _join_config(static),
                              static["dense_key_range"])


def _lower_join_streaming(ctx, ins, static, rt):
    from ..parallel import streaming
    return streaming.dist_join_streaming(ins[0], ins[1],
                                         _join_config(static),
                                         static["chunks"])


def _lower_multiway(ctx, ins, static, rt):
    from ..parallel import dist_ops
    return dist_ops.dist_multiway_join(ins[0], list(ins[1:]),
                                       static["edges"])


def _semi_threshold(static):
    planned = static.get("planned")
    if planned is not None and planned[0] == "shuffle":
        return 0
    return static.get("broadcast_threshold")


def _lower_semi(ctx, ins, static, rt):
    from ..parallel import dist_ops
    return dist_ops.dist_semi_join(ins[0], ins[1],
                                   _key_spec(static["left_on"]),
                                   _key_spec(static["right_on"]),
                                   static["dense_key_range"],
                                   _semi_threshold(static))


def _lower_anti(ctx, ins, static, rt):
    from ..parallel import dist_ops
    return dist_ops.dist_anti_join(ins[0], ins[1],
                                   _key_spec(static["left_on"]),
                                   _key_spec(static["right_on"]),
                                   static["dense_key_range"],
                                   _semi_threshold(static))


def _lower_groupby(ctx, ins, static, rt):
    from ..parallel import dist_ops
    return dist_ops.dist_groupby(ins[0], list(static["keys"]),
                                 [(c, op) for c, op in static["aggs"]],
                                 where=rt.get("where"),
                                 dense_key_range=static["dense_key_range"],
                                 pre_aggregate=static["pre_aggregate"],
                                 emit_empty=static["emit_empty"])


def _lower_groupby_fused(ctx, ins, static, rt):
    from ..parallel import dist_ops
    where = rt.get("where")
    if where is not None and static.get("env_map"):
        # a select folded into the aggregation mask after prior filter
        # pushdowns keeps reading its original column names
        where = _mapped_pred(where, static["env_map"])
    return dist_ops.dist_groupby_fused(
        ins[0], list(static["keys"]),
        [(c, op) for c, op in static["aggs"]], where=where,
        dense_key_range=static["dense_key_range"],
        emit_empty=static["emit_empty"], mode=static["mode"],
        reason=static["reason"])


def _lower_groupby_sketch(ctx, ins, static, rt):
    from ..parallel import dist_ops
    return dist_ops.dist_groupby_sketch(
        ins[0], list(static["keys"]),
        [(c, op) for c, op in static["aggs"]], where=rt.get("where"))


def _lower_aggregate(ctx, ins, static, rt):
    from ..parallel import dist_ops
    return dist_ops.dist_aggregate(ins[0],
                                   [(c, op) for c, op in static["aggs"]],
                                   where=rt.get("where"))


def _lower_sort(ctx, ins, static, rt):
    from ..parallel import dist_ops
    return dist_ops.dist_sort(ins[0], static["keys"][0],
                              static["ascending"][0])


def _lower_sort_multi(ctx, ins, static, rt):
    from ..parallel import dist_ops
    return dist_ops.dist_sort_multi(ins[0], list(static["keys"]),
                                    list(static["ascending"]))


def _lower_head(ctx, ins, static, rt):
    from ..parallel import dist_ops
    return dist_ops.dist_head(ins[0], static["n"])


def _lower_setop(name):
    def lower(ctx, ins, static, rt):
        from ..parallel import dist_ops
        return getattr(dist_ops, name)(ins[0], ins[1])
    return lower


def _lower_shuffle(ctx, ins, static, rt):
    from ..parallel import dist_ops
    return dist_ops.shuffle_table(ins[0], list(static["keys"]))


def _lower_morsel_scan(ctx, ins, static, rt):
    """The out-of-core seam: price the scan again against the LIVE budget
    (``resilience.exchange_budget``, which the budget fault point can move
    under a cached plan) and spill its leaves to the host pool when it
    still does not fit.  The spilled table flows to the
    consumer unchanged; dist_groupby_fused / dist_groupby_sketch /
    dist_join / dist_join_streaming detect the spilled input and stream
    it in morsels."""
    from ..config import spill_enabled
    from ..resilience import exchange_budget
    from ..spill import morsel as spill_morsel
    dt = ins[0]
    if not spill_enabled() or dt.is_spilled:
        return dt
    priced = spill_morsel.table_priced_bytes(
        ctx.get_world_size(), dt.cap, spill_morsel._spilled_rbytes(dt))
    budget = exchange_budget(ctx.device)
    node = plan_check.note("morsel_scan", priced_bytes=priced,
                           budget=budget)
    if priced <= budget:
        plan_check.annotate(node, decision="resident",
                            reason=f"{priced} B fits the {budget} B "
                                   "budget at execution — no spill")
        return dt
    plan_check.annotate(node, decision="spill",
                        reason=f"{priced} B over the {budget} B budget "
                               "— leaves staged to the host pool")
    dt.spill()
    return dt


LOWERING = {
    "scan": _lower_scan,
    "rename": _lower_rename,
    "dist_select": _lower_select,
    "dist_project": _lower_project,
    "dist_with_column": _lower_with_column,
    "dist_join": _lower_join,
    "dist_join_streaming": _lower_join_streaming,
    "dist_multiway_join": _lower_multiway,
    "dist_semi_join": _lower_semi,
    "dist_anti_join": _lower_anti,
    "dist_groupby": _lower_groupby,
    "dist_groupby_fused": _lower_groupby_fused,
    "dist_groupby_sketch": _lower_groupby_sketch,
    "dist_aggregate": _lower_aggregate,
    "dist_sort": _lower_sort,
    "dist_sort_multi": _lower_sort_multi,
    "dist_head": _lower_head,
    "dist_union": _lower_setop("dist_union"),
    "dist_intersect": _lower_setop("dist_intersect"),
    "dist_subtract": _lower_setop("dist_subtract"),
    "shuffle_table": _lower_shuffle,
    "morsel_scan": _lower_morsel_scan,
}


# ---------------------------------------------------------------------------
# fingerprinting (the compiled-plan cache key)
# ---------------------------------------------------------------------------

def _preorder(root: Node) -> Tuple[List[Node], Dict[int, int]]:
    out: List[Node] = []
    index: Dict[int, int] = {}
    stack = [root]
    while stack:
        n = stack.pop()
        if id(n) in index:
            continue
        index[id(n)] = len(out)
        out.append(n)
        for c in reversed(n.inputs):
            stack.append(c)
    return out, index


def _runtime_sig(node: Node) -> Tuple:
    """Per-node runtime signature for the cache key: scan tables match by
    ingest counts (with the schema, a re-ingested identical table still
    hits); tables without cached counts match by identity only.  Select
    ``params`` match by shape / dtype and callables by id, both already
    in the statics."""
    if node.op == "scan":
        dt = node.runtime["dtable"]
        ch = dt._counts_host
        pend = dt.pending_mask is not None
        if ch is not None and not pend:
            return ("scan", tuple(int(c) for c in np.asarray(ch)))
        return ("scan-id", id(dt), pend)
    return ()


def fingerprint(root: Node) -> Tuple:
    pre, index = _preorder(root)
    sig = []
    for n in pre:
        sig.append((n.op, rules._static_sig(n), ir.sig_of_schema(n.schema),
                    tuple(index[id(c)] for c in n.inputs),
                    _runtime_sig(n)))
    return tuple(sig)


def _config_fingerprint(ctx) -> Tuple:
    """The configuration the rules read: a plan rewritten under another
    device, world, process split ``(processes, local ranks)``, broadcast
    threshold or explicit memory budget must not be replayed (a 2 × 4
    process world and a single-process world of 8 on one device are
    different worlds)."""
    from ..config import broadcast_join_threshold, explicit_memory_budget
    return (str(ctx.device), ctx.get_world_size(), ctx.get_process_count(),
            ctx.get_local_world_size(), broadcast_join_threshold(),
            explicit_memory_budget())


# root fingerprint -> _Entry.  A bounded LRU (``config.plan_cache_capacity``)
# whose entries pin schemas (and so dictionaries) but no user tables;
# guarded by a lock so concurrent materializations do not race the
# pop / reinsert recency bump.
_plan_cache: Dict[Tuple, "_Entry"] = {}
_plan_cache_lock = threading.Lock()


class _Entry:
    __slots__ = ("root", "fires", "pre_bytes", "post_bytes")

    def __init__(self, root: Node, fires: List[str], pre: int, post: int):
        self.root = root
        self.fires = fires
        self.pre_bytes = pre
        self.post_bytes = post


def clear_plan_cache() -> None:
    """Drop every compiled plan (tests / knob changes mid-session)."""
    with _plan_cache_lock:
        _plan_cache.clear()


def plan_cache_len() -> int:
    return len(_plan_cache)


def _cache_get(key) -> Optional[_Entry]:
    """LRU lookup: a hit is re-inserted at the recency tail (dicts keep
    insertion order; the oldest entry is ``next(iter(...))``)."""
    with _plan_cache_lock:
        entry = _plan_cache.pop(key, None)
        if entry is not None:
            _plan_cache[key] = entry
        return entry


def _cache_put(key, entry: _Entry) -> None:
    from ..config import plan_cache_capacity
    cap = plan_cache_capacity()
    with _plan_cache_lock:
        _plan_cache.pop(key, None)  # concurrent miss: last store wins
        evicted = 0
        while len(_plan_cache) >= cap:
            _plan_cache.pop(next(iter(_plan_cache)))
            evicted += 1
        _plan_cache[key] = entry
    if evicted:
        trace.count("plan.cache_evictions", evicted)


def _frozen_copy(root: Node) -> Node:
    """A cache-resident copy of the optimized DAG: same structure, statics
    and schemas, but EMPTY runtime dicts wherever origin rebinding will
    supply them.  (The live DAG shares unchanged nodes with the
    pre-rewrite DAG, whose runtime the current run still needs, so the
    strip happens on a copy.)"""
    memo: Dict[int, Node] = {}

    def walk(n: Node) -> Node:
        hit = memo.get(id(n))
        if hit is not None:
            return hit
        out = Node(n.op, [walk(c) for c in n.inputs], dict(n.static),
                   {} if n.origin_idx is not None else dict(n.runtime),
                   n.schema, n.name, list(n.opt_notes), n.origin_idx)
        memo[id(n)] = out
        return out

    return walk(root)


# ---------------------------------------------------------------------------
# stage checkpoints + the recovery driver
# ---------------------------------------------------------------------------

_MISS = object()


def _table_leaves(dt) -> List:
    """A DTable's leaves (data, then validity, per column) for pricing:
    the pooled host blocks when it is spilled, so no fault-in."""
    if dt._spill_entry is not None:
        return [a for d, v in dt._spill_entry.leaves
                for a in (d, v) if a is not None]
    out = []
    for c in dt._columns:
        out.append(c.data)
        if c.validity is not None:
            out.append(c.validity)
    return out


def _release_frames(exc: BaseException) -> None:
    """Clear the locals of the failed attempt's frames (everything below
    the driver's own): until the exception object goes, its traceback
    would keep the attempt's intermediate tensors allocated on the card
    while the ladder frees memory, re-meshes or re-lowers."""
    tb = exc.__traceback__
    if tb is not None:
        traceback.clear_frames(tb.tb_next)


class _CheckpointStore:
    """Costed retention of stage results across recovery attempts.

    During ONE ``_execute`` attempt every intermediate is live in the
    walk's ``results`` anyway; what a checkpoint buys is survival across
    a REPLAN — the resource arm frees the failed attempt's memo
    insertions before retrying, so a fault in stage k then resumes from
    the last retained exchange output instead of replaying the whole
    plan.  Retention is priced (``cost.price_retained``: the [cap]-row
    block × row width, per shard) against a bounded fraction of the
    memory budget (``RecoveryPolicy.checkpoint_fraction``).  Admission
    keeps the NEWEST checkpoints (the resume points) and evicts
    oldest-first; a result whose own price exceeds the whole budget is
    skipped (``recover.checkpoint_skipped``)."""

    def __init__(self, budget_bytes: int):
        self.budget = max(int(budget_bytes), 0)
        self._entries: Dict[Any, Tuple[Any, int]] = {}
        self._order: List[Any] = []
        self.total = 0

    def holds(self, esig) -> bool:
        return esig in self._entries

    def _evict_oldest(self) -> None:
        oldest = self._order.pop(0)
        _, old_price = self._entries.pop(oldest)
        self.total -= old_price
        trace.count("recover.checkpoint_evictions")

    def offer(self, esig, out, node: Node) -> None:
        if esig in self._entries or self.budget <= 0:
            return
        cap = getattr(out, "cap", None)
        if cap is None:
            return  # local-table stage outputs are not retained
        from ..parallel import cost
        price = cost.price_retained(int(cap),
                                    max(ir.row_width(node.schema), 1))
        if price > self.budget:
            trace.count("recover.checkpoint_skipped")
            return
        while self.total + price > self.budget and self._order:
            self._evict_oldest()
        self._entries[esig] = (out, price)
        self._order.append(esig)
        self.total += price
        trace.count("recover.checkpoints")
        trace.count_max("recover.checkpoint_bytes", self.total)

    def restore(self, esig):
        """The retained result for ``esig`` or ``_MISS``.  The
        ``recover.checkpoint_restore`` fault point fires here: an
        injected restore failure DROPS the checkpoint and recomputes the
        stage from its inputs — a bad checkpoint must degrade to replay,
        never to a wrong answer."""
        entry = self._entries.get(esig)
        if entry is None:
            return _MISS
        try:
            faults.check("recover.checkpoint_restore")
        except faults.FaultError:
            self._entries.pop(esig, None)
            if esig in self._order:
                self._order.remove(esig)
            self.total -= entry[1]
            trace.count("recover.restore_failed")
            return _MISS
        trace.count("recover.checkpoint_hits")
        return entry[0]

    def remesh(self, new_ctx) -> int:
        """Evacuate + re-partition every retained checkpoint onto
        ``new_ctx`` in place — a checkpoint that cannot move is dropped
        (its stage replays) rather than poisoning the resumed attempt
        with old-world tensors.  Prices are re-derived for the new
        layout and the store is evicted back under its budget; returns
        the bytes evacuated through the host boundary."""
        from .. import observe
        from ..parallel import cost
        from ..parallel.remesh import remesh_table
        evac = 0
        for esig in list(self._order):
            out, old_price = self._entries[esig]
            try:
                evac += remesh_table(out, new_ctx)
                price = cost.price_retained(
                    int(out.cap),
                    max(observe.row_bytes(_table_leaves(out)), 1))
            except Exception:  # graftlint: ok[broad-except]
                # a checkpoint that fails to evacuate degrades to replay
                # of its stage, never to a failed recovery
                self._entries.pop(esig, None)
                self._order.remove(esig)
                self.total -= old_price
                trace.count("recover.restore_failed")
                continue
            self._entries[esig] = (out, price)
            self.total += price - old_price
        # the same rows over fewer shards mean bigger resident blocks:
        # evict oldest-first back under the budget, keeping the newest
        # resume points
        while self.total > self.budget and self._order:
            self._evict_oldest()
        trace.count_max("recover.checkpoint_bytes", self.total)
        return evac


def _scan_tables(pre_nodes: List[Node]) -> List:
    """The distinct DTables the plan scans, in pre-order."""
    seen: Set[int] = set()
    out = []
    for n in pre_nodes:
        if n.op != "scan":
            continue
        dt = n.runtime.get("dtable")
        if dt is None or id(dt) in seen:
            continue
        seen.add(id(dt))
        out.append(dt)
    return out


def _remesh_scan_tables(pre_nodes: List[Node], new_ctx) -> int:
    """Evacuate + re-partition every scan table of the plan onto
    ``new_ctx`` in place (parallel/remesh.py) — identity-preserving, so
    execution-memo signatures and plan fingerprints keep lining up
    across the resumed attempt.  Staging faults (``spill.stage_out`` /
    ``spill.stage_in`` fire inside the evacuation too) are retried up to
    three times per table: aborting mid-evacuation would strand a
    mixed-world plan, the one state no rung can resume.  Returns bytes
    evacuated."""
    from ..parallel.remesh import remesh_table
    evac = 0
    for dt in _scan_tables(pre_nodes):
        for attempt in range(3):
            try:
                evac += remesh_table(dt, new_ctx)
                break
            except faults.FaultError:
                if attempt == 2:
                    raise
    return evac


class _MeshExpansion(Exception):
    """Control flow, not failure: a stage boundary decided to take a
    pending world EXPANSION (a rejoin).  Raised by :func:`_maybe_expand`
    and caught by ``_execute_recovering`` BEFORE the ladder — an
    expansion is an opportunity, never a rung, and must not consume the
    loss budget (``RecoveryPolicy.max_remeshes``)."""

    def __init__(self, new_ctx, note: str):
        super().__init__(note)
        self.new_ctx = new_ctx
        self.note = note


def _expansion_decision(pre_nodes: List[Node], plan_key, p_old: int,
                        p_new: int, stages_left: int) -> Tuple[bool, str]:
    """The amortization bound on a mid-plan expansion P → P′: expand
    only when the priced bytes the remaining stages save on the grown
    world beat the migration cost of moving the plan's scan tables
    (``cost.amortized_remesh_win``).  The per-stage savings come from
    the run-stats store's OBSERVED bytes for this plan's fingerprint; a
    fingerprint never observed (or observed moving nothing) expands
    eagerly.  Returns ``(expand, note)``; ``note`` carries the math for
    the annotation either way."""
    from .. import observe
    from ..parallel import cost
    move = 0
    for dt in _scan_tables(pre_nodes):
        counts = np.asarray(dt.counts_host()).astype(np.int64)
        rbytes = max(observe.row_bytes(_table_leaves(dt)), 1)
        price = cost.price_remesh(p_old, p_new, counts, rbytes)
        move += price.wire_bytes + price.host_bytes
    rec = None
    if plan_key is not None:
        rec = obstats.STORE.get(obstats.plan_digest(plan_key))
    observed = 0
    nstages = 0
    if rec:
        observed = sum(int(node.get("bytes_moved") or 0)
                       for node in rec.get("nodes", []))
        nstages = sum(1 for node in rec.get("nodes", [])
                      if node.get("exchange"))
        if not observed:
            observed = sum(int(v) for k, v in
                           (rec.get("counters") or {}).items()
                           if k in ("shuffle.bytes_sent",
                                    "broadcast.bytes_sent"))
    if observed <= 0:
        return True, (f"no observed bytes for fingerprint — expanding "
                      f"eagerly (migration {move} B)")
    per_stage = observed / max(nstages, stages_left, 1)
    win = cost.amortized_remesh_win(per_stage, stages_left, p_old, p_new)
    note = (f"win {int(win)} B ({int(per_stage)} B/stage x "
            f"{stages_left} left) vs migration {move} B")
    return win >= move, note


def _maybe_expand(builder, pre_nodes: List[Node], stages_left: int,
                  expand: Optional[Dict[str, int]], plan_key) -> None:
    """The stage-boundary scale-up consult (the inverse of the
    ``mesh.device_lost`` consult next to it in ``_execute``): poll the
    ``mesh.device_joined`` event point, flush any hysteresis-pending
    joins, and — when the effective world has GROWN past the builder's —
    either take the expansion (raise :class:`_MeshExpansion`) or defer
    it per the amortization bound, annotating ``remesh=deferred(P->P')``.
    With recovery disabled (``expand`` is None) joins still register in
    the topology registry, so the NEXT query anchors on the grown
    world."""
    from .. import topology
    rule = faults.poll("mesh.device_joined")
    if rule is not None:
        topology.mark_joined(builder.ctx, rule.lost)
    elif topology.pending_joins(builder.ctx):
        topology.mark_joined(builder.ctx, 0)
    new_ctx = topology.effective(builder.ctx)
    if new_ctx is builder.ctx:
        return
    p_old = builder.ctx.get_world_size()
    p_new = new_ctx.get_world_size()
    if p_new <= p_old:
        return      # a shrink routes through the ladder's topology rung
    if expand is None or expand.get("left", 0) <= 0:
        return
    do_expand, note = _expansion_decision(pre_nodes, plan_key, p_old,
                                          p_new, stages_left)
    if do_expand:
        raise _MeshExpansion(new_ctx, note)
    trace.count("recover.scaleup_deferred")
    plan_check.annotate_append("remesh",
                               f"deferred({p_old}->{p_new}): {note}")


def _evacuate(builder, pre_nodes: List[Node], ckpt: _CheckpointStore,
              inserted: Set[Any], new_ctx) -> int:
    """The re-mesh dance shared by the topology rung and the scale-up
    arm: drop EVERY memo result (old-world tensors cannot feed new-world
    collectives, and the drop is what lets the card free them), migrate
    the scan tables and the retained checkpoints onto ``new_ctx``, drop
    the replicas cached from old-world columns.  Returns bytes
    evacuated."""
    from ..parallel import broadcast
    for esig in list(builder.exec_memo.keys()):
        builder.exec_memo.pop(esig, None)
    inserted.clear()
    evac = _remesh_scan_tables(pre_nodes, new_ctx)
    evac += ckpt.remesh(new_ctx)
    broadcast.clear_replica_cache()
    return evac


def _fail_annotated(ladder, exc: BaseException, klass: str,
                    what: str) -> None:
    """Book a failure of the ladder's own machinery (a replan whose setup
    failed, an evacuation that failed mid-flight): the attempt log says
    what happened, the error carries it, the flight recorder holds it."""
    from .. import resilience
    from ..observe import flightrec
    trace.count("recover.failures")
    ladder.attempts.append(resilience.LadderAttempt(
        klass, "fail", f"{what}: {type(exc).__name__}: {str(exc)[:120]}"))
    exc.ladder = ladder.as_dicts()
    flightrec.note("recover_failed", attempts=ladder.as_dicts(),
                   error=f"{what}: {exc}")


def _execute_across_processes(builder, opt_root: Node,
                              pre_nodes: List[Node], plan_key=None):
    """The plan over a world that spans processes: no rung of the ladder
    engages (the elastic re-mesh across processes is not ported, and a
    retry or replan in one process would re-enter collectives its peers
    have left).  A failure raises at once, in every process:

      * an injected fault (the same seeded ``FaultPlan`` in every
        process) and the engine's own checks (``CylonError``) raise at the
        same point in every process, since every process runs the same
        plan on the same global counts;
      * any other error (an out-of-memory error, a CUDA or backend error)
        may be this process's alone, with its peers already waiting in
        the next collective: the process group is torn down
        (``comm.abort``) before the error propagates, so every peer's
        collective fails at once (C5 classifies that TOPOLOGY) instead
        of waiting for the group's timeout.  The context cannot run
        collectives afterwards.  An abstract run (``plan_check``) made
        no collective, so no peer waits on it: its failure leaves the
        group up."""
    from ..analysis._abstract import PlanExportReached
    from ..ops.compact import ReplayNeeded
    try:
        return _execute(builder, opt_root, pre_nodes, plan_key=plan_key)
    except (PlanExportReached, ReplayNeeded, CylonError,
            KeyboardInterrupt, SystemExit, GeneratorExit):
        raise
    except BaseException:
        if not any(n.op == "scan" and n.runtime["dtable"]._is_abstract()
                   for n in pre_nodes):
            builder.ctx.comm.abort()
        raise


def _execute_recovering(builder, opt_root: Node, pre_nodes: List[Node],
                        plan_key=None):
    """The classified escalation ladder around ``_execute``: transient →
    bounded stage retry resuming from the INTACT execution memo
    (completed results are immutable: only the failed stage and
    downstream re-run); resource → replan: this ladder's memo insertions
    are dropped to free memory and the next attempt runs under
    ``resilience.demoted_exchanges`` (off the cheap prefix of the
    catalogue and every lowering the failed attempts picked), resuming
    from the priced checkpoint store; topology (a lost shard slot) →
    REMESH: the whole memo is dropped, the plan's scan tables and the
    retained checkpoints evacuate through the host tier onto a survivor
    context, the builder re-anchors on it, and the attempt resumes from
    the re-meshed checkpoints — every remaining stage re-lowers under
    the new world because the eager operators read it from their
    (re-meshed) input tables; permanent or exhausted → fail, with the
    attempt log attached to the error (``e.ladder``) and a
    ``recover_failed`` flight-recorder event.  ``CYLON_RECOVERY=0`` /
    ``config.set_recovery_enabled(False)`` bypasses all of it, and so
    does a world that spans processes (:func:`_execute_across_processes`:
    a rung re-runs collectives or re-meshes, which every process would
    have to do alike)."""
    from .. import resilience, topology
    from ..config import recovery_enabled
    from ..logging import warning as _warn
    from ..observe import flightrec
    if builder.ctx.get_process_count() > 1:
        return _execute_across_processes(builder, opt_root, pre_nodes,
                                         plan_key)
    if not recovery_enabled():
        return _execute(builder, opt_root, pre_nodes, plan_key=plan_key)
    ladder = resilience.Ladder()
    ckpt = _CheckpointStore(int(ladder.policy.checkpoint_fraction
                                * resilience.exchange_budget(
                                    builder.ctx.device)))
    prior: Set[Any] = set()
    inserted: Set[Any] = set()
    failed_strategies: Set[str] = set()
    # the mid-plan scale-up budget (RecoveryPolicy.max_scaleups): a
    # flapping device cannot re-raise expansions forever
    expand = {"left": ladder.policy.max_scaleups}
    while True:
        try:
            with resilience.demoted_exchanges(
                    ladder.demote_level,
                    failed=tuple(sorted(failed_strategies))), \
                    resilience.collect_strategy_choices() as chosen:
                out = _execute(builder, opt_root, pre_nodes, ckpt=ckpt,
                               prior=prior, inserted=inserted,
                               expand=expand, plan_key=plan_key)
            if ladder.attempts:
                trace.count("recover.recovered")
                resilience.note_recovery("recovered")
                flightrec.note("recover", action="recovered",
                               attempts=ladder.as_dicts(),
                               stages=ir.stage_count(opt_root))
            return out
        except BaseException as e:
            from ..analysis._abstract import PlanExportReached
            from ..ops.compact import ReplayNeeded
            if isinstance(e, (PlanExportReached, ReplayNeeded,
                              KeyboardInterrupt, SystemExit,
                              GeneratorExit)):
                # control flow, not failure: PlanExportReached means the
                # abstract run REACHED its export boundary (a success
                # signal, even after an engaged ladder healed an earlier
                # attempt); ReplayNeeded is run_pipeline's replay of an
                # undersized optimistic dispatch; interpreter shutdown is
                # never a recovery outcome
                raise
            if isinstance(e, _MeshExpansion):
                # the scale-up arm: an opportunity taken, not a rung —
                # the ladder never sees it
                expand["left"] -= 1
                _release_frames(e)
                t0 = time.perf_counter()
                try:
                    evac = _evacuate(builder, pre_nodes, ckpt, inserted,
                                     e.new_ctx)
                except BaseException as re_err:
                    # mid-flight failure: the plan may be mixed-world,
                    # the one state nothing can resume
                    _fail_annotated(ladder, re_err, resilience.TOPOLOGY,
                                    "scale-up evacuation failed")
                    raise
                new_world = e.new_ctx.get_world_size()
                builder.ctx = e.new_ctx
                trace.count("recover.remesh_us",
                            int((time.perf_counter() - t0) * 1e6))
                _warn("recovery: mesh expansion — evacuated %d B and "
                      "re-meshed onto %d devices mid-plan (%s), "
                      "resuming from checkpoint", evac, new_world,
                      e.note)
                flightrec.note("recover", action="scaleup",
                               new_world=new_world,
                               evacuated_bytes=evac, note=e.note)
                continue
            action = ladder.decide(e)
            if action == "fail":
                if len(ladder.attempts) == 1 \
                        and not isinstance(e, (CylonError, MemoryError)):
                    # plain first-failure user errors pass through
                    # untouched: the ladder only annotates failures it
                    # engaged with
                    raise
                if not (ladder.retries or ladder.replans) \
                        and not isinstance(e, faults.FaultError):
                    # an organic first failure the ladder never engaged
                    # with: annotate, but do not book recover.failures
                    try:
                        e.ladder = ladder.as_dicts()
                    except Exception:  # graftlint: ok[broad-except]
                        pass   # an unannotatable error still raises
                    raise
                trace.count("recover.failures")
                attempts = ladder.as_dicts()
                try:
                    e.ladder = attempts
                except Exception:  # graftlint: ok[broad-except]
                    pass       # an unannotatable error still raises
                flightrec.note("recover_failed", attempts=attempts,
                               error=f"{type(e).__name__}: "
                                     f"{str(e)[:160]}")
                raise
            err = f"{type(e).__name__}: {str(e)[:160]}"
            if action == "replan":
                # the RESOURCE arm frees memory before the degraded
                # retry: every memo entry this ladder inserted is
                # dropped, and the priced checkpoint store becomes the
                # only retained state.  (The transient arm keeps the
                # memo: completed results are immutable and correct.)
                _release_frames(e)
                for esig in inserted:
                    builder.exec_memo.pop(esig, None)
                inserted.clear()
                # never re-pick a lowering the failed attempt chose
                # (chunked excepted, see demoted_exchanges)
                failed_strategies |= set(chosen)
                try:
                    faults.check("recover.replan")
                except faults.FaultError as fe:
                    _fail_annotated(ladder, fe, resilience.RESOURCE,
                                    "replan setup failed")
                    raise
                trace.count("recover.replans")
                _warn("recovery: resource-class failure (%s) — "
                      "replanning exchanges at demotion level %d and "
                      "resuming from checkpoint",
                      type(e).__name__, ladder.demote_level)
                flightrec.note("recover", action="replan",
                               level=ladder.demote_level, error=err)
            elif action == "remesh":
                # the TOPOLOGY rung: a shard slot died — retrying any
                # collective on the old world re-touches it, so shrink
                # the world instead.  A world of one has no survivors;
                # the rung degrades to a checkpointed stage retry there
                lost = max(int(getattr(e, "lost", 1) or 1), 1)
                new_ctx = topology.mark_lost(builder.ctx, lost)
                if new_ctx is builder.ctx:
                    ladder.attempts[-1].action = "retry (no survivors)"
                    trace.count("recover.stage_retries")
                    flightrec.note("recover", action="stage_retry",
                                   retries=ladder.retries, error=err)
                    continue
                _release_frames(e)
                t0 = time.perf_counter()
                try:
                    evac = _evacuate(builder, pre_nodes, ckpt, inserted,
                                     new_ctx)
                except BaseException as re_err:
                    _fail_annotated(ladder, re_err, resilience.TOPOLOGY,
                                    "remesh evacuation failed")
                    raise
                builder.ctx = new_ctx
                trace.count("recover.remesh")
                trace.count("recover.remesh_us",
                            int((time.perf_counter() - t0) * 1e6))
                _warn("recovery: topology-class failure (%s) — lost %d "
                      "device(s); evacuated %d B and re-meshed onto %d "
                      "survivors, resuming from checkpoint",
                      type(e).__name__, lost, evac,
                      new_ctx.get_world_size())
                flightrec.note("recover", action="remesh", lost=lost,
                               survivor_world=new_ctx.get_world_size(),
                               evacuated_bytes=evac, error=err)
            else:
                trace.count("recover.stage_retries")
                flightrec.note("recover", action="stage_retry",
                               retries=ladder.retries, error=err)


# ---------------------------------------------------------------------------
# materialization
# ---------------------------------------------------------------------------

# pre-rewrite roots collector: ``collect_roots()`` hands every root the
# executor materializes on this thread (full runtime attached) to its
# sink, the input ``ir.fold_analysis`` expects.  One thread-local read
# when no collector is open.
_roots_tls = threading.local()


@contextmanager
def collect_roots():
    prev = getattr(_roots_tls, "sink", None)
    sink: List[Node] = []
    _roots_tls.sink = sink
    try:
        yield sink
    finally:
        _roots_tls.sink = prev


def _note_root(root: Node) -> None:
    sink = getattr(_roots_tls, "sink", None)
    if sink is not None:
        sink.append(root)


def materialize(builder, root: Node):
    """Optimize + execute the captured DAG under ``root``; returns the
    concrete DTable (or local Table for dist_aggregate / dist_head
    roots).  Memoized per builder: a root materializes once."""
    hit = builder.memo_get(root)
    if hit is not None:
        return hit
    _note_root(root)
    pre_nodes, _ = _preorder(root)
    for i, n in enumerate(pre_nodes):
        n.origin_idx = i
    key = (_config_fingerprint(builder.ctx), fingerprint(root))
    # run-stats store (observe.stats): hand the cache key's digest to the
    # active digest collector (EXPLAIN ANALYZE opens one), which then
    # records the run's observations under it; one thread-local read
    # and no digest otherwise
    obstats.note_plan(key)
    entry = _cache_get(key)
    if entry is None:
        t0 = time.perf_counter()
        opt_root, fires, pre_b, post_b = rules.optimize(builder, root)
        entry = _Entry(_frozen_copy(opt_root), fires, pre_b, post_b)
        _cache_put(key, entry)
        trace.count("plan.cache_miss")
        trace.count("compile.plan_build_us",
                    int((time.perf_counter() - t0) * 1e6))
        builder.stats["cache_misses"] += 1
    else:
        trace.count("plan.cache_hit")
        builder.stats["cache_hits"] += 1
    nfires = len(entry.fires)
    if nfires:
        trace.count("optimizer.rule_fires", nfires)
    trace.count("optimizer.row_bytes_pre", entry.pre_bytes)
    trace.count("optimizer.row_bytes_post", entry.post_bytes)
    builder.stats["rule_fires"] += nfires
    builder.stats["fires"] += entry.fires
    builder.stats["pre_exchange_row_bytes"] += entry.pre_bytes
    builder.stats["post_exchange_row_bytes"] += entry.post_bytes
    out = _execute_recovering(builder, entry.root, pre_nodes, plan_key=key)
    builder.memo_put(root, out)
    return out


def _bound_runtime(node: Node, pre_nodes: List[Node]) -> Dict[str, Any]:
    if node.origin_idx is not None:
        if node.origin_idx >= len(pre_nodes):
            raise CylonError(Status(Code.ExecutionError,
                "plan cache: cached node origin out of range — the "
                "fingerprint failed to isolate plan structure (bug)"))
        return pre_nodes[node.origin_idx].runtime
    return node.runtime


def _execute(builder, opt_root: Node, pre_nodes: List[Node],
             ckpt: Optional[_CheckpointStore] = None,
             prior: Optional[Set[Any]] = None,
             inserted: Optional[Set[Any]] = None,
             expand: Optional[Dict[str, int]] = None,
             plan_key=None):
    """Children-first walk of the optimized DAG; each node lowers through
    LOWERING under suspended capture, memoized per run by content
    signature so shared subplans (within and across materialization
    boundaries) execute once.

    Under the recovery driver (:func:`_execute_recovering`) the extra
    seams are live: ``ckpt`` serves stage results retained from a prior
    attempt (and receives new exchange-boundary results, costed);
    ``prior`` is the set of signatures lowered by EARLIER attempts, so
    re-lowering one counts ``recover.stages_replayed``; ``inserted``
    records this attempt's memo insertions for rollback; ``expand`` is
    the scale-up budget.  Before each exchange-boundary lowering the
    ``exec.stage`` and ``mesh.device_lost`` fault points are consulted
    and the ``mesh.device_joined`` event polled — once per lowered
    boundary, in ``ir.topo`` order, never for memo hits or restored
    checkpoints.

    Signatures are pure structure + runtime identity, computed for the
    whole DAG up front; the root-down coverage pass then restores
    retained checkpoints ON DEMAND and skips every subtree the memo
    covers, so a resumed attempt never re-dispatches the upstream of a
    restored boundary."""
    order = ir.topo(opt_root)
    esigs: Dict[int, Tuple] = {}
    rts: Dict[int, Dict[str, Any]] = {}
    for node in order:
        rt = _bound_runtime(node, pre_nodes)
        rts[id(node)] = rt
        esigs[id(node)] = (node.op, rules._static_sig(node),
                           tuple(esigs[id(c)] for c in node.inputs),
                           tuple(sorted((k, id(v)) for k, v in rt.items())))
    # root-down coverage: a memo'd node serves its whole subtree; a
    # retained checkpoint restores on demand during the descent (one
    # subsumed by a newer downstream checkpoint is never reinstated, and
    # recover.checkpoint_hits counts only restores the replay consumed);
    # a failed restore drops the checkpoint and descends into the subtree
    needed: set = set()
    stack = [opt_root]
    while stack:
        n = stack.pop()
        if id(n) in needed:
            continue
        needed.add(id(n))
        esig = esigs[id(n)]
        if esig in builder.exec_memo:
            continue
        if ckpt is not None and ckpt.holds(esig):
            kept = ckpt.restore(esig)
            if kept is not _MISS:
                builder.exec_memo[esig] = (n, kept)
                if inserted is not None:
                    inserted.add(esig)
                continue
        stack.extend(n.inputs)
    # stages this attempt will actually lower: the scale-up consult
    # prices its amortization bound against how many are LEFT
    stages_left = sum(1 for n in order
                      if id(n) in needed and ir.is_stage_boundary(n)
                      and esigs[id(n)] not in builder.exec_memo)
    results: Dict[int, Any] = {}
    for node in order:
        if id(node) not in needed:
            continue
        esig = esigs[id(node)]
        hit = builder.exec_memo.get(esig)
        if hit is not None:
            results[id(node)] = hit[1]
            continue
        boundary = ir.is_stage_boundary(node)
        if boundary:
            faults.check("exec.stage")
            # a shard slot dying surfaces as a collective failure at an
            # exchange boundary: the recovering driver's TOPOLOGY rung
            # answers by evacuating + re-meshing onto the survivors
            faults.check("mesh.device_lost")
            # ...and the inverse event: a repaired slot rejoining —
            # expand onto it now, or defer per the amortization bound
            _maybe_expand(builder, pre_nodes, stages_left, expand,
                          plan_key)
            if prior is not None and esig in prior:
                trace.count("recover.stages_replayed")
        lower = LOWERING.get(node.op)
        if lower is None:
            raise CylonError(Status(Code.Invalid,
                f"plan executor: no lowering for {node.op!r}"))
        ins = [results[id(c)] for c in node.inputs]
        idx = plan_check.capture_index()
        with ir.suspended():
            out = lower(builder.ctx, ins, node.static, rts[id(node)])
        if node.opt_notes:
            plan_check.annotate_at(idx, optimizer="; ".join(node.opt_notes))
        builder.exec_memo[esig] = (node, out)
        if inserted is not None:
            inserted.add(esig)
        if boundary:
            stages_left -= 1
            if prior is not None:
                prior.add(esig)
            if ckpt is not None:
                ckpt.offer(esig, out, node)
        results[id(node)] = out
    return results[id(opt_root)]
