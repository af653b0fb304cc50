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

The reference's recovery driver (stage checkpoints, re-meshing) is not
ported: ``materialize`` executes the optimized DAG directly.
"""
from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .. import trace
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
    device, world, broadcast threshold or explicit memory budget must not
    be replayed."""
    from ..config import broadcast_join_threshold, explicit_memory_budget
    return (str(ctx.device), ctx.get_world_size(),
            broadcast_join_threshold(), explicit_memory_budget())


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
    out = _execute(builder, entry.root, pre_nodes)
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


def _execute(builder, opt_root: Node, pre_nodes: List[Node]):
    """Children-first walk of the optimized DAG; each node lowers through
    LOWERING under suspended capture, memoized per run by content
    signature so shared subplans (within and across materialization
    boundaries) execute once.  Signatures are pure structure + runtime
    identity, computed for the whole DAG up front; a root-down pass then
    skips every subtree the memo already covers."""
    order = ir.topo(opt_root)
    esigs: Dict[int, Tuple] = {}
    rts: Dict[int, Dict[str, Any]] = {}
    for node in order:
        rt = _bound_runtime(node, pre_nodes)
        rts[id(node)] = rt
        esigs[id(node)] = (node.op, rules._static_sig(node),
                           tuple(esigs[id(c)] for c in node.inputs),
                           tuple(sorted((k, id(v)) for k, v in rt.items())))
    needed: set = set()
    stack = [opt_root]
    while stack:
        n = stack.pop()
        if id(n) in needed:
            continue
        needed.add(id(n))
        if esigs[id(n)] not in builder.exec_memo:
            stack.extend(n.inputs)
    results: Dict[int, Any] = {}
    for node in order:
        if id(node) not in needed:
            continue
        esig = esigs[id(node)]
        hit = builder.exec_memo.get(esig)
        if hit is not None:
            results[id(node)] = hit[1]
            continue
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
        results[id(node)] = out
    return results[id(opt_root)]
