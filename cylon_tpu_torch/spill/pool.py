"""The spillable leaf pool: DTable leaves held host-side.

The port of ``cylon_tpu/spill/pool.py``.  A DTable can ``spill()``: its
column leaves move to host blocks held here, the device tensors are
dropped, and the table keeps working through transparent fault-in on
first device use (``DTable.columns`` / ``counts`` are properties that
call :func:`ensure_device`).  The morsel scan (``spill/morsel.py``) stages
row SLICES straight from the pooled blocks without faulting the whole
table back.

Pool semantics (the JAX package's):

  * entries are keyed by **content signature**, stamped on the table at
    its first spill and cleared whenever its contents change
    (``_collapse_pending``), so an unchanged table re-spills without a
    device read (``spill.respill_hits``);
  * a **pinned** entry (the device side was dropped) is the only copy of
    its data and is never evicted; a **resident** entry (the host copy
    kept after a fault-in) is cache, in an LRU within the host budget;
  * the budget is ``config.host_memory_budget()``.  A stage-out admits by
    evicting resident entries oldest first; when the pinned bytes alone
    would exceed the budget it raises a typed ``Code.OutOfMemory``
    CylonError (the RESOURCE class of ``resilience.classify``).

The two staging boundaries, :func:`stage_out_arrays` and
:func:`stage_in_arrays`, are the engine's only leaf-sized device↔host
transfers outside ingest and export, and host the ``spill.stage_out`` /
``spill.stage_in`` fault points.  On the card:

  * host blocks are page-locked (pinned) CPU tensors, allocated once per
    stage-out; a failed pin raises ``Code.OutOfMemory``, it never falls
    back to pageable memory;
  * a stage-out is one batched device→host copy on the device's copy
    stream, recorded by one CUDA event that the host waits on before it
    returns the blocks (so no host read can see a block mid-copy);
  * a stage-in is ``non_blocking`` host→device copies from pinned memory
    on the copy stream, recorded by an event; the consumer's stream waits
    on that event before it reads (:meth:`Staged.ready`), and each staged
    tensor is ``record_stream``-ed on the consumer's stream so the
    caching allocator cannot hand its block out while the consumer still
    reads it.

On a CPU context (the tests) the host tier holds plain CPU tensors: the
caller asked for the CPU, so no copy stream or event exists.

One pool lock (an ``OrderedLock``) orders spill, fault-in and eviction;
two consumers racing the fault-in of one spilled table resolve to one
stage-in.
"""
from __future__ import annotations

import itertools
import threading
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from .. import faults, trace
from ..config import host_memory_budget, spill_enabled
from ..observe.locks import OrderedLock
from ..status import Code, CylonError, Status

__all__ = ["SpillPool", "Staged", "get_pool", "clear_pool", "spill_table",
           "ensure_device", "stage_out_arrays", "stage_in_arrays",
           "pinned_empty"]

_sig_counter = itertools.count(1)

_streams: Dict[torch.device, "torch.cuda.Stream"] = {}
_streams_lock = threading.Lock()


def _copy_stream(device: torch.device) -> "torch.cuda.Stream":
    """The device's copy stream (one per device, made on first use)."""
    with _streams_lock:
        s = _streams.get(device)
        if s is None:
            s = _streams[device] = torch.cuda.Stream(device)
        return s


def pinned_empty(shape, dtype: torch.dtype, device: torch.device
                 ) -> torch.Tensor:
    """An uninitialised host block for data of ``device``: page-locked
    when ``device`` is a card (a failed pin raises ``Code.OutOfMemory``,
    never a pageable fallback), a plain CPU tensor otherwise."""
    if device.type != "cuda":
        return torch.empty(shape, dtype=dtype)
    try:
        return torch.empty(shape, dtype=dtype, pin_memory=True)
    except RuntimeError as e:
        nbytes = int(np.prod(shape, dtype=np.int64)) * \
            torch.empty((), dtype=dtype).element_size()
        raise CylonError(Status(Code.OutOfMemory,
            f"spill: pinning a {nbytes} B host block failed ({e}) — "
            "lower CYLON_HOST_MEMORY_BUDGET or the device budget")) from e


def stage_out_arrays(arrays: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """ONE batched device→host transfer of ``arrays`` (the D2H staging
    boundary): host copies, readable when this returns.  Hosts the
    ``spill.stage_out`` fault point and counts ``spill.stage_outs`` /
    ``spill.stage_out_bytes``."""
    faults.check("spill.stage_out")
    arrays = list(arrays)
    nbytes = sum(int(a.numel()) * a.element_size() for a in arrays)
    if not arrays or arrays[0].device.type != "cuda":
        hosts = [a.detach().clone() for a in arrays]
    else:
        dev = arrays[0].device
        hosts = [pinned_empty(tuple(a.shape), a.dtype, dev) for a in arrays]
        copy = _copy_stream(dev)
        # the producer's queued work (the leaves themselves) comes first
        copy.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(copy):
            for h, a in zip(hosts, arrays):
                h.copy_(a, non_blocking=True)
        done = torch.cuda.Event()
        done.record(copy)
        for a in arrays:
            # the caller may drop a leaf at once: its block stays out of
            # the allocator until the copy stream has read it
            a.record_stream(copy)
        done.synchronize()
    trace.count("spill.stage_outs")
    trace.count("spill.stage_out_bytes", nbytes)
    return hosts


class Staged(list):
    """Device tensors of one stage-in, with the copy's event.  Before the
    consumer's stream may read them it calls :meth:`ready` (on its own
    thread): that stream waits on the event, and every tensor is
    recorded on it.  A no-op on the CPU, and after the first call.
    ``sources`` keeps the host blocks the copies read referenced for as
    long as the staged tensors are held."""

    def __init__(self, tensors, event=None, sources=None):
        super().__init__(tensors)
        self.event = event
        self.sources = sources

    def ready(self) -> "Staged":
        ev, self.event = self.event, None
        if ev is not None:
            consumer = torch.cuda.current_stream(self[0].device)
            consumer.wait_event(ev)
            for t in self:
                t.record_stream(consumer)
        return self


Block = Union[torch.Tensor, np.ndarray, Sequence[torch.Tensor]]


def _host_tensor(b) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(b)) \
        if isinstance(b, np.ndarray) else b


def stage_in_arrays(ctx, blocks: Sequence[Block], defer: bool = False
                    ) -> Staged:
    """Host→device staging of ``blocks`` onto ``ctx``'s device (the H2D
    staging boundary).  A block is a host tensor (or numpy array), or a
    list of host tensors that land back to back in one device tensor (a
    morsel's per-shard row slices, each contiguous in its pinned block).
    Hosts the ``spill.stage_in`` fault point and counts
    ``spill.stage_ins`` / ``spill.stage_in_bytes``.

    On the card the copies run ``non_blocking`` on the copy stream.  The
    calling thread's stream waits for them before this returns, unless
    ``defer``: then the consumer calls ``ready()`` on its own thread (a
    ``HostPipeline`` worker stages morsel k+1 while the consumer computes
    on morsel k)."""
    faults.check("spill.stage_in")
    dev = ctx.device
    parts = [[_host_tensor(p) for p in b] if isinstance(b, (list, tuple))
             else [_host_tensor(b)] for b in blocks]
    nbytes = sum(int(p.numel()) * p.element_size()
                 for ps in parts for p in ps)
    if dev.type != "cuda":
        out = Staged([torch.cat(ps) if len(ps) > 1 else ps[0].clone()
                      for ps in parts])
    else:
        copy = _copy_stream(dev)
        outs = []
        with torch.cuda.stream(copy):
            for ps in parts:
                rows = sum(int(p.shape[0]) for p in ps)
                d = torch.empty((rows,) + tuple(ps[0].shape[1:]),
                                dtype=ps[0].dtype, device=dev)
                at = 0
                for p in ps:
                    n = int(p.shape[0])
                    d[at:at + n].copy_(p, non_blocking=True)
                    at += n
                outs.append(d)
        done = torch.cuda.Event()
        done.record(copy)
        out = Staged(outs, done, parts)
        if not defer:
            out.ready()
    trace.count("spill.stage_ins")
    trace.count("spill.stage_in_bytes", nbytes)
    return out


class _Entry:
    """One spilled table's host-side state: ``leaves`` holds ``(data,
    validity or None)`` host blocks per column in column order,
    ``counts`` the [P] host row counts; ``pinned`` while the host copy is
    the ONLY copy (device side dropped) — pinned entries never evict."""

    __slots__ = ("sig", "leaves", "counts", "cap", "nbytes", "pinned")

    def __init__(self, sig: int, leaves, counts: np.ndarray, cap: int):
        self.sig = sig
        self.leaves = leaves
        self.counts = counts
        self.cap = int(cap)
        self.nbytes = sum(
            int(d.numel()) * d.element_size()
            + (0 if v is None else int(v.numel()) * v.element_size())
            for d, v in leaves)
        self.pinned = True


def _flat_leaves(cols) -> List[torch.Tensor]:
    flat = []
    for c in cols:
        flat.append(c.data)
        if c.validity is not None:
            flat.append(c.validity)
    return flat


class SpillPool:
    """The process-level host-tier pool (module singleton via
    :func:`get_pool`; a fresh one per test via ``clear_pool``)."""

    def __init__(self) -> None:
        self._lock = OrderedLock("spill.pool", reentrant=True)
        # sig -> entry; dict order doubles as the LRU recency of the
        # RESIDENT entries (pop and reinsert on touch)
        self._entries: Dict[int, _Entry] = {}
        # host bytes reserved by in-flight staged-spill exchanges: they
        # live outside the entry table but price against the budget too
        self._transient = 0

    # -- accounting ----------------------------------------------------------

    def _pinned_bytes_locked(self) -> int:
        return (sum(e.nbytes for e in self._entries.values() if e.pinned)
                + self._transient)

    def _total_bytes_locked(self) -> int:
        return sum(e.nbytes for e in self._entries.values()) + self._transient

    def host_bytes(self) -> int:
        with self._lock:
            return self._total_bytes_locked()

    def pinned_bytes(self) -> int:
        with self._lock:
            return self._pinned_bytes_locked()

    def entries(self) -> int:
        with self._lock:
            return len(self._entries)

    # -- admission -----------------------------------------------------------

    def _admit_locked(self, need: int) -> None:
        """Make room for ``need`` new pinned bytes: evict RESIDENT entries
        oldest first; when the pinned set alone cannot fit, raise the typed
        OutOfMemory."""
        budget = host_memory_budget()
        pinned = self._pinned_bytes_locked()
        if pinned + need > budget:
            raise CylonError(Status(Code.OutOfMemory,
                f"spill pool exhausted: {need} B stage-out over the "
                f"{budget} B host budget ({pinned} B already pinned) — "
                "raise CYLON_HOST_MEMORY_BUDGET or let the replan "
                "ladder degrade the plan"))
        while self._total_bytes_locked() + need > budget:
            victim = next((sig for sig, e in self._entries.items()
                           if not e.pinned), None)
            if victim is None:
                break  # only pinned entries left; the check above held
            self._entries.pop(victim)
            trace.count("spill.evictions")

    def reserve_transient(self, nbytes: int) -> None:
        """Admit ``nbytes`` of transient host staging (a staged-spill
        exchange's payload) against the budget: the same eviction and
        typed-OOM contract as a table spill, undone by
        :meth:`release_transient`."""
        nbytes = max(int(nbytes), 0)
        with self._lock:
            self._admit_locked(nbytes)
            self._transient += nbytes
            trace.count_max("spill.host_bytes_peak",
                            self._total_bytes_locked())

    def release_transient(self, nbytes: int) -> None:
        with self._lock:
            self._transient = max(self._transient - max(int(nbytes), 0), 0)

    # -- the table-level operations ------------------------------------------

    def spill_table(self, dt) -> None:
        """Move ``dt``'s leaves host-side and drop the device tensors.
        Idempotent; an unchanged table whose host copy is still pooled
        re-spills without a device read.  The whole operation, stage-out
        included, runs under the pool lock: two threads spilling one table
        resolve to one entry."""
        with self._lock:
            if dt._spill_entry is not None:
                return  # already spilled
            dt._collapse_pending()
            counts = np.asarray(dt.counts_host()).copy()
            sig = dt._spill_sig
            hit = self._entries.get(sig) if sig is not None else None
            if hit is not None:
                # content-signature hit: the host copy of the last spill
                # still holds; only the device side goes
                self._entries.pop(sig)
                self._entries[sig] = hit     # LRU touch
                hit.pinned = True
                trace.count("spill.respill_hits")
                self._drop_device(dt, hit)
                return
            cols = dt._columns
            flat = _flat_leaves(cols)
            # admit BEFORE the transfer (the byte counts are metadata): an
            # over-budget spill raises without paying the copy
            self._admit_locked(sum(int(lf.numel()) * lf.element_size()
                                   for lf in flat))
            hosts = iter(stage_out_arrays(flat))
            leaves = tuple((next(hosts),
                            None if c.validity is None else next(hosts))
                           for c in cols)
            del flat
            entry = _Entry(next(_sig_counter), leaves, counts, dt.cap)
            self._entries[entry.sig] = entry
            trace.count("spill.spills")
            trace.count_max("spill.host_bytes_peak",
                            self._total_bytes_locked())
            self._drop_device(dt, entry)

    @staticmethod
    def _drop_device(dt, entry: _Entry) -> None:
        """Point ``dt`` at ``entry`` and swap in FRESH column objects
        holding the spilled sentinel (names, dtypes, dictionaries and
        nullability stay readable without a fault-in).  Fresh objects, not
        in-place mutation: derived tables may share this table's column
        objects.  Replicas cached from these columns go too: the replica
        cache pins its source columns, which would keep the dropped
        tensors alive."""
        from dataclasses import replace

        from ..parallel import broadcast
        from ..parallel.dtable import _SPILLED
        old = dt._columns
        broadcast.forget_replicas_of(old)
        cols = [replace(c, data=_SPILLED,
                        validity=_SPILLED if v is not None else None)
                for c, (_, v) in zip(old, entry.leaves)]
        dt._counts_host = entry.counts
        dt._spill_sig = entry.sig
        # publish order matters for lock-free readers of the columns /
        # counts properties: _spill_entry is visible BEFORE the sentinel
        # columns land (a reader that saw it unset still holds the live
        # column list; one that sees it set takes the fault-in path,
        # which waits on the pool lock)
        dt._spill_entry = entry
        dt._columns = cols
        dt._counts = _SPILLED

    def ensure_device(self, dt) -> None:
        """Fault ``dt``'s leaves back in.  The host copy is kept as a
        resident LRU entry, so an unchanged table re-spills for free.  The
        whole fault-in runs under the pool lock, and ``_spill_entry`` stays
        set until the device tensors are installed: a second thread racing
        the same table waits, then finds it resident (one stage-in).  A
        failed stage-in leaves the table consistently spilled."""
        with self._lock:
            entry = dt._spill_entry
            if entry is None:
                return  # another thread faulted it in already
            blocks: List[torch.Tensor] = []
            for d, v in entry.leaves:
                blocks.append(d)
                if v is not None:
                    blocks.append(v)
            blocks.append(entry.counts.astype(np.int32))
            devs = iter(stage_in_arrays(dt.ctx, blocks))
            for c, (_, v) in zip(dt._columns, entry.leaves):
                c.data = next(devs)
                if v is not None:
                    c.validity = next(devs)
            dt._counts = next(devs)
            # the host copy becomes evictable cache only once the device
            # side exists again
            entry.pinned = False
            dt._spill_entry = None
            trace.count("spill.faultins")

    # -- retained materialized views (serve/matview.py) ----------------------

    def retain_view(self, dt) -> Optional[int]:
        """Stage a materialized view's leaves into an UNPINNED entry
        (LRU-evictable cache sharing the one host budget with every
        spilled table) and return its signature.  A view is pure cache:
        over-budget retention, or an injected ``spill.stage_out`` fault,
        DECLINES (returns None) instead of raising.  An already spilled
        table reuses its pooled entry."""
        with self._lock:
            if dt._spill_entry is not None:
                return dt._spill_entry.sig
            dt._collapse_pending()
            counts = np.asarray(dt.counts_host()).copy()
            cols = dt._columns
            flat = _flat_leaves(cols)
            need = sum(int(lf.numel()) * lf.element_size() for lf in flat)
            if self._pinned_bytes_locked() + need > host_memory_budget():
                return None
            try:
                self._admit_locked(need)
                hosts = iter(stage_out_arrays(flat))
            except CylonError:
                return None
            leaves = tuple((next(hosts),
                            None if c.validity is None else next(hosts))
                           for c in cols)
            entry = _Entry(next(_sig_counter), leaves, counts, dt.cap)
            entry.pinned = False
            self._entries[entry.sig] = entry
            trace.count_max("spill.host_bytes_peak",
                            self._total_bytes_locked())
            return entry.sig

    def view_entry(self, sig: int) -> Optional[_Entry]:
        """LRU-touch lookup of a retained view's entry: None once the
        budget's eviction reclaimed it (the view store recomputes).  The
        returned entry keeps its host blocks alive for as long as the
        caller holds it, eviction or not."""
        with self._lock:
            e = self._entries.get(sig)
            if e is not None:
                self._entries.pop(sig)
                self._entries[sig] = e
            return e

    def drop_entry(self, sig: int) -> None:
        """Forget one pooled entry by signature."""
        with self._lock:
            self._entries.pop(sig, None)

    def pin_for_scan(self, dt) -> _Entry:
        """Spill ``dt`` if needed and capture its entry under ONE lock
        hold (the morsel scan's entry point): a concurrent consumer's
        fault-in cannot clear ``_spill_entry`` between the check and the
        capture, and the captured entry keeps the host blocks readable
        for the whole scan even if the table faults in mid-scan."""
        with self._lock:
            if dt._spill_entry is None:
                spill_table(dt)   # the module function keeps the switch
            return dt._spill_entry

    def slice_blocks(self, dt, lo: int, hi: int,
                     col_ids: Optional[Sequence[int]] = None,
                     entry: Optional[_Entry] = None):
        """Rows [lo, hi) of every shard's block of a SPILLED table, read
        host-side (no fault-in, no device traffic).  Returns ``(blocks,
        counts, w)``: per selected column ``(data pieces, validity pieces
        or None)``, each a list of P contiguous views of the pooled blocks
        (shard order), the clipped per-shard counts, and ``w = hi - lo``.
        ``entry``, captured when the scan started (``pin_for_scan``), pins
        the blocks even if the table faults in or is evicted mid-scan."""
        if entry is None:
            entry = dt._spill_entry
        if entry is None:
            raise CylonError(Status(Code.Invalid,
                "slice_blocks needs a spilled table (call spill() first)"))
        cap = entry.cap
        nparts = len(entry.counts)
        ids = range(len(entry.leaves)) if col_ids is None else col_ids

        def pieces(x):
            return [x[s * cap + lo:s * cap + hi] for s in range(nparts)]

        out = []
        for i in ids:
            d, v = entry.leaves[i]
            out.append((pieces(d), None if v is None else pieces(v)))
        counts = np.clip(entry.counts - lo, 0, hi - lo).astype(np.int32)
        return out, counts, hi - lo


_pool: Optional[SpillPool] = None
_pool_lock = OrderedLock("spill.pool_registry")


def get_pool() -> SpillPool:
    global _pool
    with _pool_lock:
        if _pool is None:
            _pool = SpillPool()
        return _pool


def clear_pool() -> None:
    """Drop every pooled entry (test isolation).  Tables still spilled
    keep their own entry references, so their data survives: only the
    pool's accounting and resident cache reset."""
    global _pool
    with _pool_lock:
        _pool = None


def spill_table(dt) -> None:
    from ..context import refuse_multiprocess
    refuse_multiprocess("the host tier (DTable.spill)", dt.ctx)
    if not spill_enabled():
        raise CylonError(Status(Code.Invalid,
            "spill is disabled (CYLON_SPILL=0 / "
            "config.set_spill_enabled(False))"))
    get_pool().spill_table(dt)


def ensure_device(dt) -> None:
    get_pool().ensure_device(dt)
