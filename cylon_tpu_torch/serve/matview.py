"""Cross-window materialized subplans with incremental maintenance.

The port of ``cylon_tpu/serve/matview.py``.  A serving window's
:class:`~cylon_tpu_torch.serve.session._SharedExecMemo` dies with the
window, so dashboard-style repeat traffic pays full
price every window even when nothing changed.  This module is the
steady-state answer (docs/serving.md "Materialized subplans"): a
per-session :class:`ViewStore` that

* **caches whole query results across windows** — keyed at submit
  altitude (the op's code identity + captured-value identities, the
  circuit breaker's fingerprint, plus the identities of the tables it
  reads), with the result's leaves parked in the spill pool as
  UNPINNED entries (``SpillPool.retain_view``) so retained views share
  ``CYLON_HOST_MEMORY_BUDGET`` with every spilled table and evict
  through the same LRU;
* **admits by cost** — a view is retained only when the fingerprint's
  observed mean latency × optimistic hit-rate clears a configurable
  floor per retained MiB (``cost.price_retained``, the checkpoint
  pricing) — see :func:`matview_min_benefit`;
* **invalidates by content-signature epoch** — every DTable carries a
  ``content_epoch`` bumped by the ingest path (``DTable.append``); a
  view records the epoch of every base its plan reads (the executor's
  ``collect_roots`` hook hands the pre-rewrite DAG, ``ir.fold_analysis``
  walks it) and a mismatch at probe time invalidates — a view NEVER
  serves rows that do not reflect its bases' recorded epochs;
* **folds appends instead of invalidating** when the plan's tail is a
  mergeable aggregation over a row-linear DAG
  (``ir.FOLDABLE_AGG_TAILS`` / ``ir.FOLD_LINEAR_OPS``): the captured
  combine-spec partial state (``dist_ops.AggState`` — sums/counts/
  min/max slots, HLL and bottom-k sketch lanes) merges with the state
  of a DELTA-ONLY rerun of the same op in O(delta)
  (``dist_ops.merge_agg_state`` → ``finalize_agg_state``), so an
  append advances the view without touching the base table.  The
  ``matview.fold`` fault point guards the merge: any fold failure —
  injected or real — degrades to invalidate + recompute, never a
  stale or wrong answer;
* **carries hot shared subplans across windows** — subplan entries
  that earned a cross-query hit inside a window (the memo's content
  signatures) are harvested into the pool and re-seeded into the next
  window's memo on demand (``fetch_subplan``), conservatively epoch-
  guarded by every base table of the owning query.

Thread model: probes, folds, offers and harvests run on the session's
dispatcher thread; ``would_hit``/``pin`` are called from submit
threads (pricing) and the dispatcher (pipelined split);
``serve_pinned`` runs on the export pipeline's workers.  All mutable
store state lives under one OrderedLock, never held across device
work or pool staging.

On a card a view's blocks are page-locked host tensors.  A rebuild
stages them in on the spill pool's copy stream and the rebuilding
thread's stream waits on the copy's event (``stage_in_arrays``); a hit
served on a pipeline worker does so on the worker.  The pooled entry a
pin captured keeps its blocks referenced until the rebuild has queued
its copies, and the caching host allocator holds a freed page-locked
block until the copies that read it have run, so an eviction racing an
in-flight copy cannot hand its memory to another block.  The rebuilt
table's host counts come from the entry's snapshot: no device read.
"""
from __future__ import annotations

import os
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .. import faults, topology, trace
from ..observe.locks import OrderedLock
from ..status import Code, CylonError, Status

# Every mutable ViewStore attribute lives under its _lock.  The knob
# globals below follow config.py's explicit-set-else-env pattern (one
# assignment per set_ call; racing readers see either value, both valid).

GUARDED_STATE = {"_entries": "_lock", "_subplans": "_lock",
                 "_pinned": "_lock", "_freq": "_lock"}

__all__ = ["ViewStore", "view_key", "matview_enabled",
           "set_matview_enabled", "matview_min_runs",
           "set_matview_min_runs", "matview_min_benefit",
           "set_matview_min_benefit", "matview_max_views",
           "matview_subplan_keep"]


# ---------------------------------------------------------------------------
# knobs (docs/serving.md "Materialized subplans" — knob table)
# ---------------------------------------------------------------------------

_enabled: Optional[bool] = None      # None -> CYLON_MATVIEW env
_min_runs: Optional[int] = None      # None -> CYLON_MATVIEW_MIN_RUNS
_min_benefit: Optional[float] = None  # None -> CYLON_MATVIEW_MIN_BENEFIT


def matview_enabled() -> bool:
    """Whether serve sessions keep a materialized-view store (explicit
    knob, else ``CYLON_MATVIEW`` — any value but ``0``/empty enables)."""
    if _enabled is not None:
        return _enabled
    return os.environ.get("CYLON_MATVIEW", "1") not in ("", "0")


def set_matview_enabled(on: Optional[bool]) -> Optional[bool]:
    """Set the store switch (``None`` restores env resolution); returns
    the previous EXPLICIT setting so callers restore it in a finally."""
    global _enabled
    prev = _enabled
    _enabled = on
    return prev


def matview_min_runs() -> int:
    """Executions a fingerprint needs before its result may be retained
    (``CYLON_MATVIEW_MIN_RUNS``, default 1 — retain on first sight, so
    the second window already serves from the view)."""
    if _min_runs is not None:
        return _min_runs
    try:
        return max(int(os.environ.get("CYLON_MATVIEW_MIN_RUNS", "1")), 1)
    except ValueError:
        raise CylonError(Status(Code.Invalid,
            "CYLON_MATVIEW_MIN_RUNS must be an int, got "
            f"{os.environ.get('CYLON_MATVIEW_MIN_RUNS')!r}")) from None


def set_matview_min_runs(n: Optional[int]) -> Optional[int]:
    global _min_runs
    prev = _min_runs
    _min_runs = n
    return prev


def matview_min_benefit() -> float:
    """Admission-by-cost floor: minimum (observed mean ms × optimistic
    hit-rate) per retained MiB (``cost.price_retained`` of the result)
    for a view to be worth its host bytes.  Default 0.0 — any repeated
    fingerprint retains as long as the pool admits it; raise it to
    bias the budget toward expensive-per-byte views
    (``CYLON_MATVIEW_MIN_BENEFIT``)."""
    if _min_benefit is not None:
        return _min_benefit
    try:
        return float(os.environ.get("CYLON_MATVIEW_MIN_BENEFIT", "0"))
    except ValueError:
        raise CylonError(Status(Code.Invalid,
            "CYLON_MATVIEW_MIN_BENEFIT must be a float, got "
            f"{os.environ.get('CYLON_MATVIEW_MIN_BENEFIT')!r}")) from None


def set_matview_min_benefit(x: Optional[float]) -> Optional[float]:
    global _min_benefit
    prev = _min_benefit
    _min_benefit = x
    return prev


def matview_max_views() -> int:
    """Entry-count bound on root-level views (oldest-evicted; the pool
    budget bounds BYTES, this bounds bookkeeping)."""
    return max(int(os.environ.get("CYLON_MATVIEW_MAX", "128")), 1)


def matview_subplan_keep() -> int:
    """Entry-count bound on carried shared subplans."""
    return max(int(os.environ.get("CYLON_MATVIEW_SUBPLAN_KEEP", "32")), 1)


# ---------------------------------------------------------------------------
# keying
# ---------------------------------------------------------------------------

def view_key(op, tables) -> Optional[Tuple]:
    """The root-view fingerprint: the submitted op's code + captured-
    value identities (``CircuitBreaker.key_of`` — stable across the
    fresh-lambda-per-submission pattern) plus the name → table-identity
    binding it runs over.  ``None`` (uncacheable) when the query runs
    without a tables dict — there is nothing to epoch-track by name."""
    if not isinstance(tables, dict):
        return None
    from .session import CircuitBreaker
    return (CircuitBreaker.key_of(op),
            tuple(sorted((k, id(v)) for k, v in tables.items())))


def _col_meta(dt) -> List[Tuple]:
    """Rebuild metadata for one result table: everything a pooled
    entry's host blocks cannot carry themselves."""
    return [(c.name, c.dtype, c.validity is not None, c.dictionary,
             c.arrow_type) for c in dt.columns]


class _View:
    """One retained root-level view."""

    __slots__ = ("key", "label", "sig", "col_meta", "bases", "states",
                 "foldable", "fold_ids", "hits", "folds", "created_at",
                 "wgen")

    def __init__(self, key, label, sig, col_meta, bases, states,
                 foldable, fold_ids, wgen=0):
        self.wgen = wgen            # window generation at retain time
        self.key = key
        self.label = label          # first retaining query's label
        self.sig = sig              # pool signature of the result blocks
        self.col_meta = col_meta
        self.bases = bases          # [(dtable, content_epoch)] — strong refs
        self.states = states        # [AggState] when foldable, else None
        self.foldable = foldable
        self.fold_ids = fold_ids    # ids of bases an append may fold on
        self.hits = 0
        self.folds = 0
        self.created_at = time.time()


class ViewStore:
    """The per-session materialized-view store (see module docstring)."""

    def __init__(self, session) -> None:
        self._session = session
        self._lock = OrderedLock("serve.matview")
        self._entries: Dict[Tuple, _View] = {}      # insertion order = age
        self._subplans: Dict[Any, Tuple] = {}       # esig -> carried entry
        self._pinned: Dict[int, Tuple] = {}         # qid -> (_View, entry)
        self._freq: Dict[Tuple, List] = {}          # key -> [runs, hits, ms]
        self._wgen = 0                              # dispatcher-thread only

    def begin_window(self) -> None:
        """Dispatcher hook at each window start.  Views retained in
        window N first SERVE in window N+1: an identical query co-
        admitted with its producer is the shared memo's job (one
        execution, ``serve.subplan_shared``), and gating the probe on
        the retain-time generation keeps the cross-window tier from
        shadowing the in-window one.  Dispatcher-thread only, like the
        probe/retain sites that read it."""
        self._wgen += 1

    # -- probe (dispatcher thread) -------------------------------------------

    def probe(self, h) -> Optional[Tuple[Any, str]]:
        """Probe-before-execute: ``(result, "hit"|"fold")`` when the
        view serves this query, ``None`` to fall through to a full
        execution.  A clean hit rebuilds the result from its pooled
        host blocks (zero exchanges); an epoch drift on exactly one
        fold-eligible base folds the missing deltas through the
        captured aggregation state; anything else invalidates."""
        key = view_key(h.op, h.tables)
        if key is None:
            return None
        with self._lock:
            e = self._entries.get(key)
        if e is None:
            trace.count("serve.view_misses")
            return None
        if e.wgen >= self._wgen:
            # retained THIS window: the co-admitted duplicate falls
            # through to the shared memo (begin_window), silently —
            # the memo share is not a view miss
            return None
        stale = [(dt, ep) for dt, ep in e.bases if dt.content_epoch != ep]
        if not stale:
            pe = (get_pool().view_entry(e.sig)
                  if e.sig is not None else None)
            if pe is None:
                # the pool's LRU reclaimed the blocks under budget
                # pressure — a lost view is a miss, never an error
                self._forget(key, e)
                trace.count("matview.lost")
                trace.count("serve.view_misses")
                return None
            out = self._rebuild(e.col_meta, pe)
            self._note_hit(e, h)
            return out, "hit"
        return self._try_fold(h, key, e, stale)

    def _note_hit(self, e: _View, h) -> None:
        from ..observe import flightrec
        with self._lock:
            e.hits += 1
            rec = self._freq.get(e.key)
            if rec is not None:
                rec[1] += 1
        trace.count("serve.view_hits")
        self._session._tally("view_hits")
        flightrec.note("matview", action="hit", label=h.label,
                       view=e.label, hits=e.hits)

    # -- incremental maintenance (dispatcher thread) -------------------------

    def _try_fold(self, h, key, e: _View, stale) -> Optional[Tuple]:
        from ..parallel import dist_ops
        deltas: List = []
        names: List[str] = []
        ok = (e.foldable and e.states and len(stale) == 1
              and id(stale[0][0]) in e.fold_ids)
        if ok:
            dt, rec_ep = stale[0]
            names = [n for n, t in h.tables.items() if t is dt]
            deltas = [dt.delta_for(ep)
                      for ep in range(rec_ep + 1, dt.content_epoch + 1)]
            # every missing epoch must still hold its delta batch
            # (DTable keeps the newest _DELTA_KEEP) and the advanced
            # base must be swappable by exactly one name
            ok = len(names) == 1 and deltas and None not in deltas
        if not ok:
            self._invalidate(key, e, h, why="non-foldable change")
            return None
        try:
            faults.check("matview.fold")
            st = e.states[0]
            rows = 0
            for d in deltas:
                swapped = dict(h.tables)
                swapped[names[0]] = d
                st = dist_ops.merge_agg_state(
                    st, self._run_delta(h, swapped))
                rows += int(np.asarray(d.counts_host()).sum())
            out = dist_ops.finalize_agg_state(st)
        except Exception:  # graftlint: ok[broad-except]
            # the degrade contract: a failed fold — chaos-injected at
            # matview.fold or a real merge error — must produce a
            # recompute, NEVER a stale or wrong answer
            trace.count("matview.fold_failures")
            self._invalidate(key, e, h, why="fold failed")
            return None
        pool = get_pool()
        old_sig = e.sig
        sig = pool.retain_view(out)
        with self._lock:
            if self._entries.get(key) is e:
                if sig is None:
                    del self._entries[key]   # pool declined; still serve
                else:
                    e.sig = sig
                    e.states = [st]
                    e.col_meta = _col_meta(out)
                    e.bases = [(bdt, bdt.content_epoch)
                               for bdt, _ in e.bases]
                    e.folds += 1
        if old_sig is not None and sig != old_sig:
            pool.drop_entry(old_sig)
        trace.count("matview.folds")
        trace.count("matview.fold_rows", rows)
        self._session._tally("view_folds")
        from ..observe import flightrec
        flightrec.note("matview", action="fold", label=h.label,
                       view=e.label, rows=rows)
        return out, "fold"

    def _run_delta(self, h, tables):
        """Rerun the view's op over the delta-swapped tables and return
        its captured aggregation state (the O(delta) half of the fold).
        The rerun uses a PRIVATE builder — its intermediate results
        must not leak into the window memo as if they covered the full
        base."""
        from ..parallel import dist_ops
        from ..plan import ir
        b = ir.Builder(topology.effective(self._session.ctx))
        with dist_ops.collect_agg_state() as sink:
            wrapped = b.wrap_tables(tables)
            with ir.capture(b):
                b.finish(h.op(wrapped))
        if len(sink) != 1:
            raise CylonError(Status(Code.NotImplemented,
                f"matview: delta rerun produced {len(sink)} mergeable "
                "aggregation states (need exactly 1 to fold)"))
        return sink[0]

    def _invalidate(self, key, e: _View, h, why: str) -> None:
        from ..observe import flightrec
        self._forget(key, e)
        trace.count("matview.invalidations")
        self._session._tally("view_invalidations")
        flightrec.note("matview", action="invalidate", label=h.label,
                       view=e.label, why=why)

    def _forget(self, key, e: _View) -> None:
        with self._lock:
            if self._entries.get(key) is e:
                del self._entries[key]
        if e.sig is not None:
            get_pool().drop_entry(e.sig)

    # -- capture (dispatcher thread, after a full execution) -----------------

    def offer(self, h, out, roots, states) -> None:
        """Offer a fully-executed query's result for retention.  The
        admission-by-cost gate runs first (observed ms × hit-rate per
        retained MiB, the checkpoint pricing); the foldability analysis
        (``ir.fold_analysis`` over the collected pre-rewrite roots)
        decides whether the captured AggState rides along."""
        from ..observe import metrics as obmetrics
        from ..parallel import cost
        from ..parallel.dtable import DTable
        from ..plan import ir
        key = view_key(h.op, h.tables)
        if key is None or not isinstance(out, DTable) or not roots:
            return
        with self._lock:
            rec = self._freq.get(key)
            if rec is None:
                while len(self._freq) >= 512:
                    self._freq.pop(next(iter(self._freq)))
                rec = self._freq[key] = [0, 0, 0.0]
            rec[0] += 1
            rec[2] += h.execute_ms or 0.0
            runs, hits, ms_total = rec
        if runs < matview_min_runs():
            return
        leaves = [lf for c in out.columns
                  for lf in (c.data, c.validity) if lf is not None]
        rbytes = max(obmetrics.row_bytes(leaves), 1)
        price = max(cost.price_retained(out.cap, rbytes), 1)
        # optimistic prior: assume the NEXT arrival of this fingerprint
        # repeats — without it a first retention could never happen and
        # the observed hit-rate could never move off zero
        gain_ms = (ms_total / runs) * ((hits + 1.0) / (runs + 1.0))
        if gain_ms < matview_min_benefit() * (price / float(1 << 20)):
            trace.count("matview.declined")
            return
        bases: Dict[int, Any] = {}
        scan_counts: Dict[int, int] = {}
        foldable = len(roots) == 1 and len(states) == 1
        for r in roots:
            bs, f, sc = ir.fold_analysis(r)
            bases.update(bs)
            for i, n in sc.items():
                scan_counts[i] = scan_counts.get(i, 0) + n
            foldable = foldable and f
        if not bases:
            return   # reads no tables — nothing to epoch-track
        fold_ids: set = set()
        if foldable:
            tab_ids = {id(v) for v in h.tables.values()}
            fold_ids = {i for i, n in scan_counts.items()
                        if n == 1 and i in tab_ids}
            foldable = bool(fold_ids)
        sig = get_pool().retain_view(out)
        if sig is None:
            trace.count("matview.declined")
            return
        e = _View(key, h.label, sig, _col_meta(out),
                  [(dt, dt.content_epoch) for dt in bases.values()],
                  [states[0]] if foldable else None, foldable, fold_ids,
                  wgen=self._wgen)
        dropped: List[_View] = []
        with self._lock:
            old = self._entries.pop(key, None)
            self._entries[key] = e
            while len(self._entries) > matview_max_views():
                k2 = next(iter(self._entries))
                dropped.append(self._entries.pop(k2))
        if old is not None and old.sig not in (None, sig):
            dropped.append(old)
        for v in dropped:
            if v.sig is not None:
                get_pool().drop_entry(v.sig)
        trace.count("matview.retained")
        from ..observe import flightrec
        flightrec.note("matview", action="retain", label=h.label,
                       foldable=foldable,
                       bytes=int(out.cap) * rbytes)

    # -- cheap probes (submit threads + dispatcher) --------------------------

    def would_hit(self, op, tables) -> bool:
        """O(µs) check whether a submission would serve from a live
        view — the admission pricer's evidence that this query costs a
        stage-in, not an exchange (``admission.PROBE_PRICE``).  Racy by
        design (the view can evict or invalidate before dispatch);
        admission is advisory, the probe itself re-validates."""
        key = view_key(op, tables)
        if key is None:
            return False
        with self._lock:
            e = self._entries.get(key)
        if e is None or e.sig is None:
            return False
        if any(dt.content_epoch != ep for dt, ep in e.bases):
            return False
        return get_pool().view_entry(e.sig) is not None

    def pin(self, h) -> bool:
        """Pin a clean view hit for pipelined serving: validates epochs
        NOW (on the dispatcher — the window's admission instant, which
        is the staleness model's snapshot point) and holds the pool
        entry object so a concurrent eviction cannot free the blocks
        before the export worker rebuilds from them."""
        key = view_key(h.op, h.tables)
        if key is None:
            return False
        with self._lock:
            e = self._entries.get(key)
        if e is None or e.sig is None or e.wgen >= self._wgen:
            return False
        if any(dt.content_epoch != ep for dt, ep in e.bases):
            return False
        pe = get_pool().view_entry(e.sig)
        if pe is None:
            return False
        with self._lock:
            self._pinned[h.id] = (e, pe)
        return True

    def serve_pinned(self, h):
        """Rebuild + account a pinned hit (export-pipeline worker)."""
        with self._lock:
            e, pe = self._pinned.pop(h.id)
        out = self._rebuild(e.col_meta, pe)
        self._note_hit(e, h)
        return out

    def unpin(self, h) -> None:
        with self._lock:
            self._pinned.pop(h.id, None)

    # -- cross-window subplan carry (dispatcher thread) ----------------------

    def harvest(self, memo) -> None:
        """Window-end sweep: persist every memo entry that earned a
        cross-query hit THIS window (the hot set — exactly what the
        next window is likely to re-derive).  Conservatively epoch-
        guarded by every base table of the owning query: any of them
        advancing invalidates the carried entry."""
        from ..parallel.dtable import DTable
        for key in list(getattr(memo, "_shared_keys", ())):
            with self._lock:
                if key in self._subplans:
                    continue
            hit = dict.get(memo, key)
            if hit is None:
                continue
            node, result = hit
            if not isinstance(result, DTable):
                continue
            owner = memo._owner.get(key)
            tabs = owner.tables if owner is not None else None
            if not isinstance(tabs, dict):
                continue
            bases = [(t, t.content_epoch) for t in tabs.values()
                     if isinstance(t, DTable)]
            sig = get_pool().retain_view(result)
            if sig is None:
                trace.count("matview.declined")
                continue
            dropped: List[int] = []
            with self._lock:
                self._subplans[key] = (node, sig, _col_meta(result),
                                       bases)
                while len(self._subplans) > matview_subplan_keep():
                    k2 = next(iter(self._subplans))
                    dropped.append(self._subplans.pop(k2)[1])
            for s in dropped:
                get_pool().drop_entry(s)
            trace.count("matview.subplans_retained")

    def fetch_subplan(self, key):
        """Re-seed one carried subplan into a window memo: ``(node,
        rebuilt table)`` or ``None`` (unknown / stale / evicted)."""
        with self._lock:
            rec = self._subplans.get(key)
        if rec is None:
            return None
        node, sig, col_meta, bases = rec
        if any(dt.content_epoch != ep for dt, ep in bases):
            with self._lock:
                self._subplans.pop(key, None)
            get_pool().drop_entry(sig)
            trace.count("matview.invalidations")
            return None
        pe = get_pool().view_entry(sig)
        if pe is None:
            with self._lock:
                self._subplans.pop(key, None)
            trace.count("matview.lost")
            return None
        out = self._rebuild(col_meta, pe)
        trace.count("serve.view_subplan_hits")
        self._session._tally("view_subplan_hits")
        return node, out

    # -- shared plumbing -----------------------------------------------------

    def _rebuild(self, col_meta, pe):
        """A fresh DTable from a pooled entry's host blocks — the view
        hit's only device work is this H2D stage-in."""
        from ..parallel.dtable import DColumn, DTable
        from ..spill.pool import stage_in_arrays
        blocks: List[Any] = []
        for d, v in pe.leaves:
            blocks.append(d)
            if v is not None:
                blocks.append(v)
        blocks.append(pe.counts.astype(np.int32))
        ctx = topology.effective(self._session.ctx)
        devs = stage_in_arrays(ctx, blocks)
        cols = []
        hi = 0
        for name, dtype, has_v, dictionary, arrow_type in col_meta:
            data = devs[hi]
            hi += 1
            validity = None
            if has_v:
                validity = devs[hi]
                hi += 1
            cols.append(DColumn(name, dtype, data, validity,
                                dictionary, arrow_type))
        dt = DTable(ctx, cols, pe.cap, devs[hi])
        # pe.counts is the host ndarray snapshotted at retain time, not a
        # device value: no read of the card happens here
        dt._counts_host = np.asarray(pe.counts)  # graftlint: ok[implicit-host-sync]
        return dt

    def holds_view_for(self, op) -> bool:
        """Fleet-router evidence: does ANY live entry fingerprint this
        op?  Table identities differ per replica, so residency is
        matched on the op half of the key only (docs/serving.md "Fleet
        mode" — view-residency affinity)."""
        from .session import CircuitBreaker
        bkey = CircuitBreaker.key_of(op)
        with self._lock:
            keys = list(self._entries.keys())
        return any(k[0] == bkey for k in keys)

    def clear(self) -> None:
        """Purge everything — the re-mesh hook: pooled view blocks are
        laid out for the mesh that staged them; a topology change makes
        every one unloadable, so the store starts over."""
        with self._lock:
            entries = list(self._entries.values())
            subs = list(self._subplans.values())
            self._entries.clear()
            self._subplans.clear()
            self._pinned.clear()
        pool = get_pool()
        for e in entries:
            if e.sig is not None:
                pool.drop_entry(e.sig)
        for rec in subs:
            pool.drop_entry(rec[1])

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"views": len(self._entries),
                    "subplans": len(self._subplans)}


def get_pool():
    from ..spill.pool import get_pool as _gp
    return _gp()
