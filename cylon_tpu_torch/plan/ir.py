"""Logical-plan IR: lazy capture of the distributed-operator surface.

The port of ``cylon_tpu/plan/ir.py``.  The query layer is ordinary Python
composing the public dist ops, which execute eagerly: every call shuffles
or gathers before the next line runs, so no decision can see the ops that
come after it.  While a :class:`Builder` is active, the
``plan_check.instrument`` hook routes every public dist-op call here
instead of executing it, and the call returns a :class:`LogicalTable`: a
schema-carrying handle on a :class:`Node` of the growing operator DAG.
Nothing touches a device until a materialization boundary (``to_table`` /
``num_rows`` / ``head``, ``dist_head``, ``dist_aggregate``), where the
DAG goes to the optimizer and executor (plan/rules.py, plan/executor.py)
and is lowered back onto the eager ops.

Building a Node is plain Python object construction, which is what lets
the compiled-plan cache skip the rewrite work on repeated queries.
Runtime payloads (predicate callables, ``params`` tensors, the scan
tables) ride each Node's ``runtime`` dict and are rebound on every
execution; everything else is static and hashable, the structure key the
plan cache is built on.

Predicate / expression callables are identified by object identity:
stable callables (module-level functions, ``lru_cache``'d factories) let
repeated queries hit the plan cache; fresh lambdas re-plan every call.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..analysis import plan_check
from ..dtypes import DataType, Type, device_dtype, numpy_dtype
from ..status import Code, CylonError, Status

__all__ = ["ColSpec", "Node", "LogicalTable", "Builder", "CAPTURED_OPS",
           "capture", "capturing", "suspended", "referenced_columns",
           "sig_of_schema", "params_sig", "topo", "known_rows",
           "row_width", "infer_schema", "EXCHANGE_OPS", "ROW_PRESERVING",
           "fold_analysis", "is_stage_boundary", "stage_count"]


# ---------------------------------------------------------------------------
# schema metadata
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ColSpec:
    """Plan-time metadata of one column: everything the optimizer (and
    host-side plan code like dictionary-literal lookups) needs without a
    device array behind it."""

    name: str
    dtype: DataType
    nullable: bool = False
    dictionary: Optional[np.ndarray] = None
    arrow_type: Any = None

    def width(self) -> int:
        """Exchanged bytes per row of this column (validity lane = 1)."""
        return (int(numpy_dtype(self.dtype.type).itemsize)
                + (1 if self.nullable else 0))


Schema = Tuple[ColSpec, ...]


def schema_of_dtable(dt) -> Schema:
    return tuple(ColSpec(c.name, c.dtype, c.validity is not None,
                         c.dictionary, c.arrow_type) for c in dt.columns)


def _names(schema: Schema) -> List[str]:
    return [c.name for c in schema]


def _col(schema: Schema, name: str) -> ColSpec:
    for c in schema:
        if c.name == name:
            return c
    raise CylonError(Status(Code.KeyError, f"plan: no column {name!r} in "
                            f"schema {_names(schema)}"))


def row_width(schema: Schema) -> int:
    return sum(c.width() for c in schema)


# ---------------------------------------------------------------------------
# IR nodes
# ---------------------------------------------------------------------------

@dataclass
class Node:
    """One logical operator.  ``static`` holds only hashable plan
    structure (normalized column NAMES, join type, dense ranges, …);
    ``runtime`` holds per-run payloads (predicates, params arrays, the
    scan DTable) that the executor rebinds on every run.  ``opt_notes``
    collects rule-fire descriptions, surfaced as ``optimizer=…``
    annotations on the corresponding plan_check node at lowering time."""

    op: str
    inputs: List["Node"]
    static: Dict[str, Any]
    runtime: Dict[str, Any]
    schema: Schema
    name: Optional[str] = None          # scan: name in the tables dict
    opt_notes: List[str] = field(default_factory=list)
    origin_idx: Optional[int] = None    # pre-order index in the pre-DAG

    def __repr__(self) -> str:
        return (f"Node({self.op}, cols={_names(self.schema)}, "
                f"static={ {k: v for k, v in self.static.items()} })")


# ops whose lowering runs a data exchange (or prices one): the targets
# projection pruning narrows inputs for
EXCHANGE_OPS = frozenset({
    "shuffle_table", "dist_join", "dist_join_streaming", "dist_semi_join",
    "dist_anti_join", "dist_groupby", "dist_aggregate", "dist_sort",
    "dist_sort_multi", "dist_union", "dist_intersect", "dist_subtract",
    "dist_multiway_join", "dist_groupby_fused", "dist_groupby_sketch",
})

# row-count-preserving ops: plan-time row bounds flow through these
ROW_PRESERVING = frozenset({
    "dist_project", "rename", "dist_sort", "dist_sort_multi",
    "shuffle_table", "dist_with_column", "morsel_scan",
})


def topo(root: Node) -> List[Node]:
    """Children-first topological order (deduplicated)."""
    out: List[Node] = []
    seen = set()
    stack: List[Tuple[Node, bool]] = [(root, False)]
    while stack:
        node, done = stack.pop()
        if done:
            out.append(node)
            continue
        if id(node) in seen:
            continue
        seen.add(id(node))
        stack.append((node, True))
        for i in node.inputs:
            stack.append((i, False))
    return out


# ---------------------------------------------------------------------------
# foldable-tail detection (incremental view maintenance): a materialized
# view folds an appended delta in O(delta) only when its
# plan is ROW-LINEAR — the result over base ∪ delta equals the merge of
# the result over base and the result over delta.  That holds when the
# tail is a mergeable aggregation (partial sums/counts/min/max, sketch
# lanes — arXiv:2010.14596's merge contract) and every op beneath it
# distributes over row-set union: per-row ops trivially, inner join
# because (A ∪ dA) ⋈ B = (A ⋈ B) ∪ (dA ⋈ B) when only ONE side grew.
# Semi/anti joins, set ops and outer joins are NOT per-side linear (a
# delta on the right can change which EXISTING left rows survive), so
# they force invalidate-on-append.
# ---------------------------------------------------------------------------

FOLDABLE_AGG_TAILS = frozenset({
    "dist_groupby", "dist_groupby_fused", "dist_groupby_sketch",
})

FOLD_LINEAR_OPS = frozenset({
    "scan", "rename", "dist_select", "dist_project", "dist_with_column",
    "shuffle_table", "morsel_scan",
})


def fold_analysis(root: Node):
    """Walk the PRE-rewrite DAG under ``root`` (full runtime attached:
    the executor's ``collect_roots`` hook hands exactly that) and
    return ``(bases, foldable, scan_counts)``:

    * ``bases`` — ``id(dtable) -> dtable`` for every DTable the plan
      reads: scan payloads plus any DTable riding another op's runtime
      (a table-valued predicate parameter).  This is the view's
      invalidation frontier — a content-epoch mismatch on ANY of these
      at probe time means the cached result no longer reflects its
      inputs.
    * ``foldable`` — the tail is a mergeable aggregation over a
      row-linear DAG (see above).  Runtime-payload tables void
      linearity: they are invisible to the row-set algebra.
    * ``scan_counts`` — ``id(dtable) -> scan-node count``.  Folding an
      append to a base scanned TWICE is unsound even in a linear plan
      (the self-join cross terms ``dA ⋈ dA`` never appear in a
      single-delta rerun), so the view store only folds bases with
      exactly one scan."""
    bases: Dict[int, Any] = {}
    scan_counts: Dict[int, int] = {}
    foldable = root.op in FOLDABLE_AGG_TAILS
    for node in topo(root):
        if node.op == "scan":
            dt = node.runtime.get("dtable")
            if dt is not None:
                bases[id(dt)] = dt
                scan_counts[id(dt)] = scan_counts.get(id(dt), 0) + 1
            continue
        for v in node.runtime.values():
            if _is_dtable(v):
                bases[id(v)] = v
                foldable = False
        if node is root:
            continue
        if node.op == "dist_join":
            if node.static.get("how") != "inner":
                foldable = False
            continue
        if node.op not in FOLD_LINEAR_OPS:
            foldable = False
    return bases, foldable, scan_counts


def is_stage_boundary(node: Node) -> bool:
    """Is ``node`` a recovery STAGE boundary?  The exchange-shaped ops
    are the failure points (every collective dispatch lives under one),
    so they are also where the recovery driver checkpoints and resumes
    (plan/executor.py): the materialized output of an exchange is a
    consistent cut of the plan."""
    return node.op in EXCHANGE_OPS


def stage_count(root: Node) -> int:
    """Number of stage boundaries in the plan under ``root`` — the
    denominator of the partial-replay claim (``recover.stages_replayed``
    below it proves a resumed query did not start over)."""
    return sum(1 for n in topo(root) if is_stage_boundary(n))


def known_rows(node: Node) -> Optional[int]:
    """Plan-time global row bound: exact for ingest scans (cached
    counts), propagated through row-preserving ops, None elsewhere —
    the sync-free evidence the join-strategy rule decides from (the
    same evidence ``broadcast.rows_if_small`` uses at runtime)."""
    while node.op in ROW_PRESERVING and node.inputs:
        node = node.inputs[0]
    if node.op == "scan":
        dt = node.runtime.get("dtable")
        ch = getattr(dt, "_counts_host", None)
        if ch is not None and getattr(dt, "pending_mask", None) is None:
            return int(np.asarray(ch).sum())
    return None


# ---------------------------------------------------------------------------
# referenced-column discovery for opaque callables
# ---------------------------------------------------------------------------

def params_sig(params: Sequence) -> Tuple:
    """Shape/dtype signature of a select's extra predicate arguments —
    plan structure, where the VALUES rebind per run (the q11/q15/q22
    device-threshold shape)."""
    return tuple((tuple(getattr(p, "shape", ())),
                  str(getattr(p, "dtype", "py"))) for p in params)


def sig_of_schema(schema: Schema) -> Tuple:
    """Hashable schema signature (dictionaries by identity — the caller
    pins them; ndarray contents must never enter a hash)."""
    return tuple((c.name, c.dtype.type, c.nullable,
                  None if c.dictionary is None
                  else (id(c.dictionary), len(c.dictionary)))
                 for c in schema)


# (id(fn), schema sig, params sig) -> referenced column names.  Repeated
# queries re-capture (cheap Python) but must NOT re-run the meta-tensor
# discovery: this memo is what keeps a plan-cache hit free of predicate
# runs.  Entries pin ``fn`` so ids stay unique while cached.
_reads_cache: dict = {}
_READS_CACHE_MAX = 512


def referenced_columns(fn: Callable, schema: Schema,
                       params: Sequence = ()) -> Optional[Tuple[str, ...]]:
    """The column names ``fn`` (a dist_select predicate / dist_with_column
    expression, reading ``env[name]``) actually touches, discovered by
    running it once over ``device="meta"`` tensors of the schema's dtypes
    (shapes and dtypes only: no data, no device work).  Returns None when
    discovery fails (a data-dependent access pattern): the optimizer then
    treats the callable as reading EVERYTHING, which only costs missed
    pruning, never correctness."""
    from .. import trace
    from ..parallel.dist_ops import _RecordingEnv

    key = (id(fn), sig_of_schema(schema), params_sig(params))
    hit = _reads_cache.get(key)
    if hit is not None:
        return hit[1]
    trace.count("plan.reads_trace")
    meta = torch.device("meta")
    leaves = {c.name: torch.empty(8, dtype=device_dtype(c.dtype.type),
                                  device=meta) for c in schema}
    vals = {c.name: (torch.empty(8, dtype=torch.bool, device=meta)
                     if c.nullable else None) for c in schema}
    pvals = tuple(torch.empty(tuple(p.shape), dtype=p.dtype, device=meta)
                  if isinstance(p, torch.Tensor)
                  else torch.empty((), dtype=torch.float32, device=meta)
                  for p in params)
    env = _RecordingEnv(leaves, vals)
    try:
        fn(env, *pvals)
        accessed = env.accessed | env.null_handled
        out = tuple(n for n in _names(schema) if n in accessed)
    except Exception:  # graftlint: ok[broad-except]
        # discovery is advisory: None reads all columns
        out = None
    while len(_reads_cache) >= _READS_CACHE_MAX:
        _reads_cache.pop(next(iter(_reads_cache)))
    _reads_cache[key] = (fn, out)
    return out


# ---------------------------------------------------------------------------
# schema inference (shared by capture and the post-rewrite recompute)
# ---------------------------------------------------------------------------

def _agg_spec(base: ColSpec, op: str) -> ColSpec:
    from ..compute import _agg_output_type
    return ColSpec(f"{op}_{base.name}",
                   DataType(_agg_output_type(base.dtype.type, op)),
                   nullable=op not in ("sum", "count"))


def infer_schema(op: str, ins: Sequence[Schema], static: Dict) -> Schema:
    """Output schema of ``op`` from its input schemas + static args —
    the one definition capture and the rewrite engine's recompute pass
    share, so a rewritten DAG cannot drift from what lowering produces."""
    if op == "scan":
        return static["schema"]
    if op in ("dist_select", "shuffle_table", "dist_sort",
              "dist_sort_multi", "dist_head", "dist_semi_join",
              "dist_anti_join", "morsel_scan"):
        return ins[0]
    if op == "dist_project":
        return tuple(_col(ins[0], n) for n in static["columns"])
    if op == "rename":
        m = dict(static["mapping"])
        return tuple(ColSpec(m.get(c.name, c.name), c.dtype, c.nullable,
                             c.dictionary, c.arrow_type) for c in ins[0])
    if op == "dist_with_column":
        base = ins[0]
        nullable = any(_col(base, n).nullable
                       for n in static["validity_from"])
        return base + (ColSpec(static["name"],
                               DataType(static["out_type"]),
                               nullable),)
    if op in ("dist_join", "dist_join_streaming"):
        how = static["how"]
        lnull = how in ("right", "full_outer")
        rnull = how in ("left", "full_outer")
        out = [ColSpec("lt-" + c.name, c.dtype, c.nullable or lnull,
                       c.dictionary, c.arrow_type) for c in ins[0]]
        out += [ColSpec("rt-" + c.name, c.dtype, c.nullable or rnull,
                        c.dictionary, c.arrow_type) for c in ins[1]]
        return tuple(out)
    if op == "dist_multiway_join":
        # fold the fused binary-join schemas forward: per edge the probe
        # output is [lt-<running>, rt-<dim>] (rt nullable under a
        # LEFT-fact edge) renamed through the edge's consumed mapping
        run = tuple(ins[0])
        for (how, _alg, _lo, _ro, _dkr, _thr, ren), dim in \
                zip(static["edges"], ins[1:]):
            rnull = how == "left"
            joined = [ColSpec("lt-" + c.name, c.dtype, c.nullable,
                              c.dictionary, c.arrow_type) for c in run]
            joined += [ColSpec("rt-" + c.name, c.dtype,
                               c.nullable or rnull, c.dictionary,
                               c.arrow_type) for c in dim]
            m = dict(ren)
            run = tuple(ColSpec(m.get(c.name, c.name), c.dtype,
                                c.nullable, c.dictionary, c.arrow_type)
                        for c in joined)
        return run
    if op in ("dist_union", "dist_intersect", "dist_subtract"):
        return tuple(ColSpec(a.name, a.dtype, a.nullable or b.nullable,
                             a.dictionary, a.arrow_type)
                     for a, b in zip(ins[0], ins[1]))
    if op in ("dist_groupby", "dist_groupby_fused"):
        # the fused aggregation exchange preserves dist_groupby's output
        # contract exactly: keys, then {op}_{col} (plan/rules.py
        # "groupby-pushdown" relies on this schema identity)
        keys = tuple(_col(ins[0], n) for n in static["keys"])
        aggs = tuple(_agg_spec(_col(ins[0], n), agg)
                     for n, agg in static["aggs"])
        return keys + aggs
    if op == "dist_aggregate":
        return tuple(_agg_spec(_col(ins[0], n), agg)
                     for n, agg in static["aggs"])
    if op == "dist_groupby_sketch":
        # keys, then one result lane per sketch aggregation:
        # distinct-count int64, quantile float32 (null for all-null
        # groups)
        from ..parallel.dist_ops import _parse_sketch_op, \
            sketch_output_name
        out = [_col(ins[0], n) for n in static["keys"]]
        for n, sop in static["aggs"]:
            kind, _q = _parse_sketch_op(sop)
            if kind == "distinct":
                out.append(ColSpec(sketch_output_name(n, sop),
                                   DataType(Type.INT64),
                                   nullable=False))
            else:
                out.append(ColSpec(sketch_output_name(n, sop),
                                   DataType(Type.FLOAT), nullable=True))
        return tuple(out)
    raise CylonError(Status(Code.Invalid, f"plan: no schema rule for {op}"))


# ---------------------------------------------------------------------------
# capture plumbing
# ---------------------------------------------------------------------------

def active_builder() -> "Optional[Builder]":
    return getattr(plan_check._capture, "lazy", None)


def capturing() -> bool:
    return active_builder() is not None


@contextlib.contextmanager
def capture(builder: "Builder"):
    cap = plan_check._capture
    prev = getattr(cap, "lazy", None)
    cap.lazy = builder
    try:
        yield builder
    finally:
        cap.lazy = prev


@contextlib.contextmanager
def suspended():
    """Temporarily disable capture on this thread — the executor lowers
    through the REAL ops, whose own instrumented calls must execute (and
    record plan_check nodes / analyze windows) normally."""
    cap = plan_check._capture
    prev = getattr(cap, "lazy", None)
    cap.lazy = None
    try:
        yield
    finally:
        cap.lazy = prev


# ---------------------------------------------------------------------------
# the logical table handle
# ---------------------------------------------------------------------------

class _LogicalColumn:
    """Read-only column metadata view (`.dictionary` feeds the host-side
    literal→code lookups plan functions do at build time)."""

    __slots__ = ("name", "dtype", "dictionary", "arrow_type", "nullable")

    def __init__(self, spec: ColSpec):
        self.name = spec.name
        self.dtype = spec.dtype
        self.dictionary = spec.dictionary
        self.arrow_type = spec.arrow_type
        self.nullable = spec.nullable


class LogicalTable:
    """A deferred DTable: schema now, rows on demand.  Supports the
    metadata surface plan functions read between dist-op calls
    (column names/dictionaries, ingest row counts, ``rename``) and
    materializes — optimize + execute the captured DAG — at the export
    boundaries (``to_table``/``head``/``num_rows``)."""

    def __init__(self, builder: "Builder", node: Node):
        self._builder = builder
        self._node = node

    # -- metadata ------------------------------------------------------------

    @property
    def columns(self) -> List[_LogicalColumn]:
        return [_LogicalColumn(c) for c in self._node.schema]

    @property
    def column_names(self) -> List[str]:
        return _names(self._node.schema)

    @property
    def num_columns(self) -> int:
        return len(self._node.schema)

    @property
    def ctx(self):
        return self._builder.ctx

    def column(self, i) -> _LogicalColumn:
        if isinstance(i, str):
            return _LogicalColumn(_col(self._node.schema, i))
        return _LogicalColumn(self._node.schema[i])

    def column_index(self, i) -> int:
        if isinstance(i, str):
            for j, c in enumerate(self._node.schema):
                if c.name == i:
                    return j
            raise CylonError(Status(Code.KeyError, f"no column {i!r}"))
        return i

    def rename(self, names: Sequence[str]) -> "LogicalTable":
        old = self.column_names
        if len(names) != len(old):
            raise CylonError(Status(Code.Invalid,
                f"rename: {len(names)} names for {len(old)} columns"))
        mapping = tuple((o, n) for o, n in zip(old, names) if o != n)
        if not mapping:
            return self
        node = Node("rename", [self._node], {"mapping": mapping}, {},
                    infer_schema("rename", [self._node.schema],
                                 {"mapping": mapping}))
        return LogicalTable(self._builder, node)

    # the tiny-dimension host cache (tpch.queries._host_cols) lives on the
    # SOURCE DTable for scans, so repeated captures of a query hit it;
    # derived tables cache on the handle (dies with the run)
    @property
    def _host_cols_cache(self):
        if self._node.op == "scan":
            return getattr(self._node.runtime["dtable"],
                           "_host_cols_cache", None)
        return self.__dict__.get("_host_cols")

    @_host_cols_cache.setter
    def _host_cols_cache(self, cols) -> None:
        if self._node.op == "scan":
            self._node.runtime["dtable"]._host_cols_cache = cols
        else:
            self.__dict__["_host_cols"] = cols

    @property
    def _concrete(self):
        """A scan of a table an abstract plan run keeps ``concrete``: the
        real table behind it, whose values plan-time host probes read
        (``analysis.plan_check.concrete_source``)."""
        if self._node.op == "scan":
            return getattr(self._node.runtime["dtable"], "_concrete", None)
        return None

    # -- materialization boundaries ------------------------------------------

    def materialize(self):
        """Optimize + execute the captured DAG; returns the concrete
        DTable (memoized: shared subplans execute once per run)."""
        from . import executor
        return executor.materialize(self._builder, self._node)

    @property
    def num_rows(self) -> int:
        if self._node.op == "scan":
            return self._node.runtime["dtable"].num_rows
        return self.materialize().num_rows

    def counts_host(self):
        return self.materialize().counts_host()

    def to_table(self):
        return self.materialize().to_table()

    def head(self, n: int):
        return self.materialize().head(n)

    def to_pandas(self):
        return self.to_table().to_pandas()

    def __repr__(self) -> str:
        cols = ", ".join(f"{c.name}:{c.dtype.type.name}"
                         for c in self._node.schema)
        return (f"LogicalTable[{self._node.op}, "
                f"{len(self._node.schema)} cols]({cols})")


# ---------------------------------------------------------------------------
# per-op capture: argument normalization → Node
# ---------------------------------------------------------------------------

def _bind(names: Sequence[str], defaults: Dict[str, Any], args, kwargs
          ) -> Dict[str, Any]:
    out = dict(defaults)
    for n, v in zip(names, args):
        out[n] = v
    out.update(kwargs)
    return out


def _key_names(schema: Schema, spec) -> Tuple[str, ...]:
    """Normalize a key spec (index/name or sequence of them) to a tuple
    of NAMES — rewrites stay valid no matter how columns move."""
    if isinstance(spec, (tuple, list)):
        items = spec
    else:
        items = [spec]
    out = []
    for s in items:
        if isinstance(s, str):
            _col(schema, s)  # raise early on a bad name
            out.append(s)
        else:
            out.append(schema[int(s)].name)
    return tuple(out)


def _capture_join(b: "Builder", v: Dict, streaming: bool) -> Node:
    left, right = b.as_node(v["left"]), b.as_node(v["right"])
    cfg = v["config"]
    static = {
        "how": cfg.join_type.value,
        "alg": cfg.algorithm.value,
        "left_on": _key_names(left.schema, cfg.left_column_idx),
        "right_on": _key_names(right.schema, cfg.right_column_idx),
        "broadcast_threshold": cfg.broadcast_threshold,
        "dense_key_range": (None if v.get("dense_key_range") is None
                            else (int(v["dense_key_range"][0]),
                                  int(v["dense_key_range"][1]))),
    }
    op = "dist_join_streaming" if streaming else "dist_join"
    if streaming:
        static["chunks"] = int(v.get("chunks", 4))
    return Node(op, [left, right], static, {},
                infer_schema(op, [left.schema, right.schema], static))


def _capture_semi(b: "Builder", v: Dict, anti: bool) -> Node:
    left, right = b.as_node(v["left"]), b.as_node(v["right"])
    static = {
        "left_on": _key_names(left.schema, v["left_on"]),
        "right_on": _key_names(right.schema, v["right_on"]),
        "dense_key_range": (None if v.get("dense_key_range") is None
                            else (int(v["dense_key_range"][0]),
                                  int(v["dense_key_range"][1]))),
        "broadcast_threshold": v.get("broadcast_threshold"),
    }
    op = "dist_anti_join" if anti else "dist_semi_join"
    return Node(op, [left, right], static, {}, left.schema)


def _capture_select(b: "Builder", v: Dict) -> Node:
    dt = b.as_node(v["dt"])
    pred, params = v["predicate"], tuple(v.get("params", ()))
    reads = referenced_columns(pred, dt.schema, params)
    static = {"compact": bool(v.get("compact", True)),
              "pred_id": id(pred), "params_sig": params_sig(params),
              "reads": reads, "env_map": ()}
    return Node("dist_select", [dt], static,
                {"predicate": pred, "params": params}, dt.schema)


def _capture_groupby(b: "Builder", v: Dict) -> Node:
    dt = b.as_node(v["dt"])
    keys = _key_names(dt.schema, list(v["key_columns"]))
    aggs = tuple((_key_names(dt.schema, c)[0], op)
                 for c, op in v["aggregations"])
    where = v.get("where")
    reads = (referenced_columns(where, dt.schema)
             if where is not None else ())
    static = {"keys": keys, "aggs": aggs,
              "where_id": None if where is None else id(where),
              "where_reads": reads,
              "dense_key_range": (None if v.get("dense_key_range") is None
                                  else (int(v["dense_key_range"][0]),
                                        int(v["dense_key_range"][1]))),
              "pre_aggregate": v.get("pre_aggregate"),
              "emit_empty": bool(v.get("emit_empty", False))}
    node = Node("dist_groupby", [dt], static, {"where": where},
                infer_schema("dist_groupby", [dt.schema], static))
    return node


def _capture_groupby_sketch(b: "Builder", v: Dict) -> Node:
    dt = b.as_node(v["dt"])
    keys = _key_names(dt.schema, list(v["key_columns"]))
    aggs = tuple((_key_names(dt.schema, c)[0], op)
                 for c, op in v["aggregations"])
    where = v.get("where")
    reads = (referenced_columns(where, dt.schema)
             if where is not None else ())
    static = {"keys": keys, "aggs": aggs,
              "where_id": None if where is None else id(where),
              "where_reads": reads}
    return Node("dist_groupby_sketch", [dt], static, {"where": where},
                infer_schema("dist_groupby_sketch", [dt.schema], static))


def _capture_aggregate(b: "Builder", v: Dict) -> Node:
    dt = b.as_node(v["dt"])
    aggs = tuple((_key_names(dt.schema, c)[0], op)
                 for c, op in v["aggregations"])
    where = v.get("where")
    reads = (referenced_columns(where, dt.schema)
             if where is not None else ())
    static = {"aggs": aggs,
              "where_id": None if where is None else id(where),
              "where_reads": reads}
    return Node("dist_aggregate", [dt], static, {"where": where},
                infer_schema("dist_aggregate", [dt.schema], static))


def _capture_with_column(b: "Builder", v: Dict) -> Node:
    dt = b.as_node(v["dt"])
    fn = v["fn"]
    reads = referenced_columns(fn, dt.schema)
    static = {"name": v["name"], "out_type": v["out_type"],
              "validity_from": tuple(v.get("validity_from", ())),
              "fn_id": id(fn), "reads": reads}
    return Node("dist_with_column", [dt], static, {"fn": fn},
                infer_schema("dist_with_column", [dt.schema], static))


def _capture_project(b: "Builder", v: Dict) -> Node:
    dt = b.as_node(v["dt"])
    cols = tuple(_key_names(dt.schema, c)[0] for c in v["columns"])
    static = {"columns": cols}
    return Node("dist_project", [dt], static, {},
                infer_schema("dist_project", [dt.schema], static))


def _capture_sort(b: "Builder", v: Dict) -> Node:
    dt = b.as_node(v["dt"])
    static = {"keys": _key_names(dt.schema, v["sort_column"]),
              "ascending": (bool(v.get("ascending", True)),)}
    return Node("dist_sort", [dt], static, {}, dt.schema)


def _capture_sort_multi(b: "Builder", v: Dict) -> Node:
    dt = b.as_node(v["dt"])
    keys = _key_names(dt.schema, list(v["sort_columns"]))
    asc = v.get("ascending", True)
    asc = (tuple(bool(a) for a in asc) if isinstance(asc, (tuple, list))
           else (bool(asc),) * len(keys))
    static = {"keys": keys, "ascending": asc}
    return Node("dist_sort_multi", [dt], static, {}, dt.schema)


def _capture_setop(op: str):
    def build(b: "Builder", v: Dict) -> Node:
        a, c = b.as_node(v["a"]), b.as_node(v["b"])
        return Node(op, [a, c], {}, {},
                    infer_schema(op, [a.schema, c.schema], {}))
    return build


def _capture_shuffle(b: "Builder", v: Dict) -> Node:
    dt = b.as_node(v["dt"])
    static = {"keys": _key_names(dt.schema, list(v["key_columns"]))}
    return Node("shuffle_table", [dt], static, {}, dt.schema)


def _capture_head(b: "Builder", v: Dict) -> Node:
    dt = b.as_node(v["dt"])
    return Node("dist_head", [dt], {"n": int(v["n"])}, {}, dt.schema)


@dataclass(frozen=True)
class _OpSpec:
    arg_names: Tuple[str, ...]
    defaults: Dict[str, Any]
    build: Callable
    materializes: bool = False


# The captured operator surface: every ``@plan_check.instrument``
# ``dist_*`` / ``shuffle_*`` entry point outside it runs eagerly under a
# capture (``Builder.intercept``); the executor's LOWERING table
# (plan/executor.py) mirrors these keys, and a test keeps the two total.
CAPTURED_OPS: Dict[str, _OpSpec] = {
    "dist_join": _OpSpec(
        ("left", "right", "config", "dense_key_range"),
        {"dense_key_range": None},
        lambda b, v: _capture_join(b, v, streaming=False)),
    "dist_join_streaming": _OpSpec(
        ("left", "right", "config", "chunks"), {"chunks": 4},
        lambda b, v: _capture_join(b, v, streaming=True)),
    "dist_semi_join": _OpSpec(
        ("left", "right", "left_on", "right_on", "dense_key_range",
         "broadcast_threshold"),
        {"dense_key_range": None, "broadcast_threshold": None},
        lambda b, v: _capture_semi(b, v, anti=False)),
    "dist_anti_join": _OpSpec(
        ("left", "right", "left_on", "right_on", "dense_key_range",
         "broadcast_threshold"),
        {"dense_key_range": None, "broadcast_threshold": None},
        lambda b, v: _capture_semi(b, v, anti=True)),
    "dist_select": _OpSpec(
        ("dt", "predicate", "params", "compact"),
        {"params": (), "compact": True}, _capture_select),
    "dist_project": _OpSpec(("dt", "columns"), {}, _capture_project),
    "dist_with_column": _OpSpec(
        ("dt", "name", "fn", "out_type", "validity_from"),
        {"validity_from": ()}, _capture_with_column),
    "dist_groupby": _OpSpec(
        ("dt", "key_columns", "aggregations", "where", "dense_key_range",
         "pre_aggregate", "emit_empty"),
        {"where": None, "dense_key_range": None, "pre_aggregate": None,
         "emit_empty": False}, _capture_groupby),
    "dist_groupby_sketch": _OpSpec(
        ("dt", "key_columns", "aggregations", "where"), {"where": None},
        _capture_groupby_sketch),
    "dist_aggregate": _OpSpec(
        ("dt", "aggregations", "where"), {"where": None},
        _capture_aggregate, materializes=True),
    "dist_sort": _OpSpec(
        ("dt", "sort_column", "ascending"), {"ascending": True},
        _capture_sort),
    "dist_sort_multi": _OpSpec(
        ("dt", "sort_columns", "ascending"), {"ascending": True},
        _capture_sort_multi),
    "dist_head": _OpSpec(("dt", "n"), {}, _capture_head,
                         materializes=True),
    "dist_union": _OpSpec(("a", "b"), {}, _capture_setop("dist_union")),
    "dist_intersect": _OpSpec(("a", "b"), {},
                              _capture_setop("dist_intersect")),
    "dist_subtract": _OpSpec(("a", "b"), {},
                             _capture_setop("dist_subtract")),
    "shuffle_table": _OpSpec(("dt", "key_columns"), {}, _capture_shuffle),
}


# ---------------------------------------------------------------------------
# the capture session
# ---------------------------------------------------------------------------

class Builder:
    """One optimize run: the growing DAG, the per-run execution memo
    (shared subplans execute once), and the run's optimizer statistics.
    Installed on the instrument hook via :func:`capture`; thread-local,
    like the rest of the plan_check capture state."""

    def __init__(self, ctx, exec_memo: Optional[Dict[Any, Any]] = None):
        self.ctx = ctx
        self.memo: Dict[int, Any] = {}        # id(Node) -> concrete result
        self._memo_pins: List[Node] = []      # keep memo'd nodes alive
        # content-addressed execution memo (plan/executor.py): a subplan
        # shared by two materialization boundaries executes once per run.
        # The serving layer passes a BATCH-scoped memo, so a subplan
        # shared ACROSS the queries of one batch window executes once
        self.exec_memo: Dict[Any, Any] = \
            {} if exec_memo is None else exec_memo
        self._scans: Dict[int, Node] = {}     # id(DTable) -> scan node
        self._scan_pins: List[Any] = []
        self.stats: Dict[str, Any] = {
            "cache_hits": 0, "cache_misses": 0, "rule_fires": 0,
            "fires": [], "pre_exchange_row_bytes": 0,
            "post_exchange_row_bytes": 0,
        }

    # -- node plumbing -------------------------------------------------------

    def scan(self, dt, name: Optional[str] = None) -> Node:
        node = self._scans.get(id(dt))
        if node is None:
            schema = schema_of_dtable(dt)
            node = Node("scan", [], {"schema": schema}, {"dtable": dt},
                        schema, name=name)
            self._scans[id(dt)] = node
            self._scan_pins.append(dt)  # ids stay unique for the run
        return node

    def as_node(self, x) -> Node:
        if isinstance(x, LogicalTable):
            return x._node
        from ..parallel.dtable import DTable
        if isinstance(x, DTable):
            return self.scan(x)
        raise CylonError(Status(Code.Invalid,
            f"plan capture: expected a (logical) table, got "
            f"{type(x).__name__}"))

    def memo_get(self, node: Node):
        return self.memo.get(id(node))

    def memo_put(self, node: Node, value) -> None:
        self.memo[id(node)] = value
        self._memo_pins.append(node)

    # -- the instrument hook -------------------------------------------------

    def intercept(self, fn: Callable, args, kwargs):
        spec = CAPTURED_OPS.get(fn.__name__)
        if spec is None:
            # an instrumented op outside the captured surface (e.g. a
            # strategy-level helper): run it eagerly on concrete inputs
            with suspended():
                return fn(*[self._concrete(a) for a in args],
                          **{k: self._concrete(v)
                             for k, v in kwargs.items()})
        v = _bind(spec.arg_names, spec.defaults, args, kwargs)
        node = spec.build(self, v)
        if spec.materializes:
            from . import executor
            return executor.materialize(self, node)
        return LogicalTable(self, node)

    def _concrete(self, x):
        if isinstance(x, LogicalTable):
            return x.materialize()
        if isinstance(x, (list, tuple)):
            return type(x)(self._concrete(v) for v in x)
        return x

    def wrap_tables(self, tables):
        if isinstance(tables, dict):
            return {k: (LogicalTable(self, self.scan(v, name=k))
                        if _is_dtable(v) else v)
                    for k, v in tables.items()}
        if _is_dtable(tables):
            return LogicalTable(self, self.scan(tables))
        return tables

    def finish(self, out):
        """Materialize any logical handles riding the plan function's
        return value — callers get concrete tables, always."""
        if isinstance(out, LogicalTable):
            return out.materialize()
        if isinstance(out, dict):
            return {k: self.finish(v) for k, v in out.items()}
        if isinstance(out, (list, tuple)):
            return type(out)(self.finish(v) for v in out)
        return out


def _is_dtable(x) -> bool:
    from ..parallel.dtable import DTable
    return isinstance(x, DTable)
