"""Mask → index compaction with a static output capacity, and the
optimistic count protocol that sizes it.

Mirror of ``cylon_tpu/ops/compact.py``.  Data-dependent output sizes
follow a two-phase protocol: phase 1 computes the exact row counts on the
device, the host reads them and rounds them up to a size-class bucket
(``next_bucket``), and phase 2 materializes into that capacity.
Compaction produces a fixed-capacity index vector padded with a fill
value plus a valid count, so capacities (and the layout of distributed
blocks) match the JAX package's for the same counts.

The host read is taken off the critical path three ways:

  * **optimistic dispatch** (:func:`optimistic_dispatch`): an operator
    remembers the sizes its last call of the same signature needed (a
    *size hint*, grow-fast / shrink-slow, :func:`update_size_hint`) and
    dispatches phase 2 at the hinted size before the counts arrive.  The
    counts' device→host copy starts first (``non_blocking`` into pinned
    memory, an event recorded behind it), so the host waits on that
    event alone and not on the hinted work queued after it; an
    undersized hint is detected from the counts and redone at the true
    size.
  * **deferred regions** (:func:`deferred_region`, :func:`run_pipeline`):
    inside one, a hinted dispatch does not wait at all — its validation
    is queued, and :func:`flush_pending_with` resolves every queued
    count plus a caller's payload in ONE batched host read.  If any
    hinted dispatch was undersized the region replays (everything after
    it computed on truncated data, so later queued posts are skipped and
    a host boundary raises :class:`ReplayNeeded`).
  * **abstract plan runs** (``analysis/plan_check``): the counts are meta
    tensors; the dispatch is sized from zeroed counts and the hints are
    left untouched.

Every read that cannot be optimistic (:func:`read_host`,
:func:`read_counts`) flushes queued validations first inside a deferred
region, and aborts for replay when that flush finds an undersized
dispatch: a count computed downstream of truncated data must never size
anything.

In a world that spans processes every count tensor handed to these
reads is REPLICATED (all-gathered by the communicator: the shuffle's
count matrix, the operators' per-shard counts, ``DTable.counts_host``),
so every process sizes, chooses a lowering and replays alike; a size
decided from one process's shards alone would leave the next collective
waiting for a peer that chose otherwise.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Tuple

import numpy as np
import torch

from ..analysis._abstract import is_abstract


def _np_dtype(dtype: torch.dtype):
    return torch.empty((), dtype=dtype).numpy().dtype


def _zeros_like_host(t: torch.Tensor) -> np.ndarray:
    """Zeroed host counts of a meta tensor's shape and dtype (the abstract
    run's stand-in for a count read)."""
    return np.zeros(tuple(t.shape), _np_dtype(t.dtype))


class _HostCopy:
    """A device→host copy started now and waited on later: on the card
    the copy is queued ``non_blocking`` into page-locked memory with an
    event recorded behind it, so the wait covers the copy alone, not
    device work queued after it.  A CPU tensor is read in place.  The
    source tensor stays referenced (never reused) until the copy is
    waited on.  ``own`` (the count reads) copies the values out of the
    page-locked block, so the block goes back to the host allocator's
    cache instead of living as long as the counts do."""

    __slots__ = ("src", "host", "event", "own")

    def __init__(self, t: torch.Tensor, own: bool = True):
        self.src = t
        self.event = None
        self.own = own
        if t.device.type == "cuda":
            self.host = torch.empty(tuple(t.shape), dtype=t.dtype,
                                    pin_memory=True)
            self.host.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(t.device))
        else:
            self.host = t

    def wait(self) -> np.ndarray:
        if self.event is None:
            self.src = None
            return self.host.numpy()
        self.event.synchronize()
        self.src = None
        out = self.host.numpy()
        return out.copy() if self.own else out


def read_host(t: torch.Tensor) -> np.ndarray:
    """The host's blocking read of a device count tensor (the sync-floor
    unit): counted as ``host.read``.  Inside a deferred region it rides
    the region's batched flush (queued validations first; an undersized
    one aborts for replay).  A meta tensor (abstract plan run) reads as
    zeros, with no read."""
    if is_abstract(t):
        return _zeros_like_host(t)
    if _deferred.depth > 0:
        return _flush_then_read(t)
    from .. import trace
    trace.count("host.read")
    return _HostCopy(t).wait()


def read_counts(t: torch.Tensor) -> np.ndarray:
    """A sizing count read: the host read behind the
    ``compact.read_counts`` fault point, retried under the session
    ``resilience`` policy (the read has no side effect, so a transient
    transfer failure is safely retried).  One ``host.read`` however many
    attempts.  Deferred regions and meta tensors as :func:`read_host`."""
    if is_abstract(t):
        return _zeros_like_host(t)
    if _deferred.depth > 0:
        return _flush_then_read(t)
    return _read_counts_now(t)


def _read_counts_now(t) -> np.ndarray:
    """:func:`read_counts` of a device tensor or of a copy already started
    (:class:`_HostCopy`), outside the deferred and abstract arms."""
    from .. import faults, resilience, trace
    trace.count("host.read")
    copy = t if isinstance(t, _HostCopy) else _HostCopy(t)

    def attempt():
        faults.check("compact.read_counts")
        return copy.wait()

    return resilience.retry_call(attempt, point="compact.read_counts")


def _flush_then_read(t: torch.Tensor) -> np.ndarray:
    """The no-hint arm inside a deferred region: resolve the queued
    validations and read ``t`` in the same batched read; abort for replay
    when an upstream dispatch was undersized."""
    ok, vals = flush_pending_with((t,))
    if not ok:
        _abort_if_poisoned()
    return vals[0]


def bincount(x: torch.Tensor, minlength: int) -> torch.Tensor:
    """``torch.bincount(x, minlength=minlength)`` for values below
    ``minlength`` (the length is then static); a meta ``x`` (an abstract
    plan run) gives a meta result of that length, since bincount has no
    meta kernel."""
    if is_abstract(x):
        return torch.empty((minlength,), dtype=torch.int64, device="meta")
    return torch.bincount(x, minlength=minlength)


def scatter_drop(size: int, tgt: torch.Tensor, values: torch.Tensor,
                 fill=0, dtype=None) -> torch.Tensor:
    """``full(size, fill).at[tgt].set(values, mode="drop")``: targets outside
    ``[0, size)`` are dropped (torch would raise, or assert on the card)."""
    dtype = values.dtype if dtype is None else dtype
    out = torch.full((size + 1,), fill, dtype=dtype, device=values.device)
    tgt = tgt.to(torch.int64)
    tgt = torch.where((tgt >= 0) & (tgt < size), tgt, size)
    out.scatter_(0, tgt, values.to(dtype))
    return out[:size]


def compact_indices(mask: torch.Tensor, size: int, fill: int = -1) -> torch.Tensor:
    """Indices of True entries in order, padded with ``fill`` to ``size``
    (int32); entries past ``size`` are dropped."""
    n = mask.shape[0]
    pos = torch.cumsum(mask, 0) - 1
    tgt = torch.where(mask, pos, size)
    return scatter_drop(size, tgt,
                        torch.arange(n, dtype=torch.int32, device=mask.device),
                        fill=fill)


def mask_to_indices(mask: torch.Tensor, capacity: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Indices of True entries, padded with −1 to ``capacity``; plus count."""
    idx = compact_indices(mask, capacity, fill=-1)
    return idx, torch.sum(mask).to(torch.int32)


def pad_to(x: torch.Tensor, capacity: int, fill=0) -> torch.Tensor:
    """Right-pad axis 0 to ``capacity`` with ``fill``."""
    n = x.shape[0]
    if n == capacity:
        return x
    if n > capacity:
        raise ValueError(f"cannot pad length {n} into capacity {capacity}")
    pad = torch.full((capacity - n,) + tuple(x.shape[1:]), fill,
                     dtype=x.dtype, device=x.device)
    return torch.cat([x, pad])


def update_size_hint(hints: dict, key, need: tuple,
                     shrink_after: int = 3) -> None:
    """Grow-fast / shrink-slow policy for optimistic-dispatch size hints
    (``need`` is a tuple of size classes, compared component-wise).

    Growing immediately is mandatory (an undersized hint forces a redo
    every call); shrinking only after ``shrink_after`` consecutive smaller
    observations keeps alternating small/large workloads from paying a
    wasted full dispatch on every large call.
    """
    cur = hints.get(key)
    if cur is None:
        hints[key] = (tuple(need), 0)
        return
    cv = cur[0]
    if any(n > c for n, c in zip(need, cv)):
        hints[key] = (tuple(max(n, c) for n, c in zip(need, cv)), 0)
        return
    if tuple(need) == cv:
        hints[key] = (cv, 0)
        return
    streak = cur[1] + 1
    hints[key] = ((tuple(need), 0) if streak >= shrink_after
                  else (cv, streak))


def hint_value(hints: dict, key):
    cur = hints.get(key)
    return None if cur is None else cur[0]


def optimistic_dispatch(hints: dict, key, dispatch, cnt_dev, post):
    """The optimistic two-phase pattern shared by the shuffle, the join,
    the groupby and the row filters:

    1. with a hint, start the counts' host copy, then ``dispatch(hint)``
       at once (the device works while the copy is in flight);
    2. wait for the counts and derive ``need = post(counts)``, the
       bucketed size tuple actually required;
    3. redo ``dispatch(need)`` on a miss or any undersized component —
       this validation is what makes the optimism safe (an undersized
       dispatch produced truncated output);
    4. record the observation (grow-fast / shrink-slow).

    Returns ``(result, used_sizes, counts_or_None)``.

    **Deferred mode** (inside ``deferred_region``, with a hint): steps
    2-4 are queued instead — the host never waits here, and
    ``flush_pending()`` later resolves every queued count in one batched
    read; a caller that sees ``False`` replays the region
    (``run_pipeline`` automates this).  The returned counts are ``None``.

    **Abstract mode** (``cnt_dev`` a meta tensor, a plan_check run): the
    dispatch is sized from zeroed counts — any size class is equally
    valid for shape/dtype checking, and ``post`` still runs so its
    contract checks see a clean header.  The hints are left untouched: a
    plan run must not steer the sizes of later real dispatches.
    """
    if is_abstract(cnt_dev):
        counts = _zeros_like_host(cnt_dev)
        need = tuple(post(counts))
        return dispatch(need), need, counts
    _abort_if_poisoned()  # don't pile device work onto a doomed attempt
    hint = hint_value(hints, key)
    if hint is not None:
        # fault point: an installed FaultPlan may shrink the hint, forcing
        # the undersized-dispatch validation / replay machinery to run.
        # An undersized hint is always safe — the validation below (or
        # the deferred flush) detects and redoes it — and the hints dict
        # is never polluted (update_size_hint records the TRUE need)
        from .. import faults
        hint = faults.perturb("compact.hint", hint)
    if hint is not None and _deferred.depth > 0:
        copy = _HostCopy(cnt_dev)  # in flight while the flush is pending
        result = dispatch(hint)
        _deferred.pending.append((hints, key, hint, copy, post))
        return result, hint, None
    if _deferred.depth > 0:
        # no hint ⇒ the host must wait on the count; resolve queued
        # upstream validations first — a count computed downstream of an
        # undersized dispatch must never size a dispatch or feed a hint
        flush_pending()
        _abort_if_poisoned()
    if hint is not None:
        copy = _HostCopy(cnt_dev)  # queued BEFORE the hinted work
        result = dispatch(hint)
        counts = _read_counts_now(copy)
    else:
        result = None
        counts = _read_counts_now(cnt_dev)
    need = tuple(post(counts))
    if hint is None or any(n > h for n, h in zip(need, hint)):
        result = None  # the undersized result goes before the redo
        result = dispatch(need)
        used = need
    else:
        used = hint
    update_size_hint(hints, key, need)
    return result, used, counts


class _DeferredState(threading.local):
    def __init__(self):
        self.depth = 0
        self.pending = []
        self.ok = True
        self.flushing = False


_deferred = _DeferredState()


def in_flush() -> bool:
    """True while flush_pending_with is walking queued posts — a post
    that wants to signal a degraded dispatch (the shuffle's over-budget
    case) must not raise from inside the batch walk; it calls
    :func:`invalidate_flush` instead and the region replays."""
    return _deferred.flushing


def invalidate_flush() -> None:
    """Fail the current flush / region WITHOUT marking downstream counts
    poisoned: the dispatch that calls this was correctly SIZED (its
    outputs and every downstream count are valid) but should not have
    run — the shuffle's over-budget case, where the replay must re-enter
    through the degraded lowering.  Later queued posts still validate;
    the region's flush returns False and ``run_pipeline`` replays.
    Outside a deferred region this is a no-op by construction: region
    entry resets the flag and ``_abort_if_poisoned`` only fires at
    depth > 0."""
    _deferred.ok = False


class ReplayNeeded(Exception):
    """Raised at a host boundary inside a deferred region once an
    optimistic dispatch is known to have been undersized: everything
    downstream of it computed on truncated data, so continuing the
    attempt would consume poisoned counts (a zero-filled exchange can
    drive a join count toward cap² — an allocation of that size).
    ``run_pipeline`` catches this, keeps the hints corrected so far, and
    replays."""


def _abort_if_poisoned() -> None:
    if _deferred.depth > 0 and not _deferred.ok:
        raise ReplayNeeded()


def deferred_mode() -> bool:
    return _deferred.depth > 0


@contextlib.contextmanager
def deferred_region():
    """Queue optimistic-dispatch validations instead of waiting per op.

    On exit the caller must ``flush_pending()`` and replay the region if
    it returns False (see ``run_pipeline``).  The reference analogue:
    Cylon's AllToAll is asynchronous with completion checked by a
    progress loop (reference net/ops/all_to_all.cpp isComplete); here the
    progress loop collapses into one batched count read at the end of
    the region.  Thread-local: a region on one thread never sees another
    thread's queue.
    """
    _deferred.depth += 1
    if _deferred.depth == 1:
        _deferred.ok = True
    try:
        yield
    except BaseException:
        if _deferred.depth == 1:
            # don't leak this region's queued validations into later
            # flushes (they would pin device buffers and force a spurious
            # replay of an unrelated pipeline)
            _deferred.pending.clear()
        raise
    finally:
        _deferred.depth -= 1
        if _deferred.depth == 0:
            # a failed attempt must not leak ok=False to depth 0: later
            # flush_pending() calls outside any region would observe a
            # stale failure
            _deferred.ok = True


def flush_pending() -> bool:
    """Resolve every queued validation with one batched host read.

    Returns True when all hinted dispatches since the last flush were
    correctly sized (accumulated into the region-level flag).  Hints are
    updated for the trusted prefix only — entries queued after the first
    undersized dispatch carry poisoned counts, so their posts are skipped
    and the replay re-validates them on sound inputs.
    """
    ok, _ = flush_pending_with(())
    return ok


def flush_pending_with(extra):
    """``flush_pending`` + read the ``extra`` device tensors in the SAME
    batched host read — one wait covers both the queued validations and
    a caller's payload (a ``head`` result, a table's counts).  Returns
    ``(ok, extra_values)`` with numpy values."""
    batch = _deferred.pending
    _deferred.pending = []
    if not batch and not extra:
        return _deferred.ok, []
    from .. import faults, resilience, trace
    trace.count("host.read")  # ONE batched read for the whole flush
    copies = [c for _, _, _, c, _ in batch] + [_HostCopy(t, own=False)
                                               for t in extra]

    def attempt():
        faults.check("compact.flush")
        return [c.wait() for c in copies]

    values = resilience.retry_call(attempt, point="compact.flush")
    # Entries queue in dispatch order, so everything after the first
    # undersized dispatch computed on truncated inputs — its counts are
    # poisoned (a zero-filled exchange can explode a downstream join
    # count toward cap², and a contract-validating post would raise a
    # spurious hard error on the garbage) — skip their posts entirely;
    # the replay re-dispatches and re-validates them on sound inputs.
    # The failing entry itself is trustworthy: its count came from
    # inputs that validated.
    trusted = _deferred.ok
    _deferred.flushing = True
    try:
        for (hints, key, hint, _, post), v in zip(batch, values):
            if not trusted:
                continue
            need = tuple(post(v))
            update_size_hint(hints, key, need)
            if any(n > h for n, h in zip(need, hint)):
                _deferred.ok = False
                trusted = False
    finally:
        _deferred.flushing = False
    return _deferred.ok, values[len(batch):]


def run_pipeline(fn, max_attempts: int = 3):
    """Run ``fn()`` (a pure pipeline of distributed ops) with deferred
    capacity validation; replay on an undersized optimistic dispatch.

    ``fn`` must be re-runnable: it may not mutate external state based
    on exported values (the standard shape — build DTables, chain dist
    ops, export at the end — satisfies this).  Steady state is one
    batched count read per host boundary instead of one blocking read
    per op.

    Every replayed attempt bumps ``pipeline.replays``; exhausting
    ``max_attempts`` bumps ``pipeline.fallback_plain`` and WARNS before
    the plain (per-op validated) run — a pipeline that replays on every
    call would otherwise be invisible.

    Across processes every process runs ``fn`` (SPMD).  Every count the
    flush reads is replicated and every hint was updated from replicated
    counts, so every process finds the same undersized dispatch and
    replays the same attempts: none is left waiting in a collective.
    """
    from .. import trace
    for _ in range(max_attempts):
        try:
            with deferred_region():
                out = fn()
                ok = flush_pending()
        except ReplayNeeded:
            # a host boundary detected the undersize mid-attempt
            trace.count("pipeline.replays")
            continue
        if ok:
            return out
        trace.count("pipeline.replays")
    trace.count("pipeline.fallback_plain")
    from .. import logging as glog
    glog.warning(
        "run_pipeline: %d deferred attempt(s) all required replay — "
        "falling back to plain per-op validation for this run.  Hints "
        "were corrected along the way; if this warning recurs on every "
        "call, the workload's sizes oscillate faster than the grow-fast/"
        "shrink-slow hint policy converges.", max_attempts)
    return fn()  # hints now corrected; plain mode validates per op


def next_bucket(n: int, minimum: int = 1024) -> int:
    """Round a dynamic size up to a quarter-step size-class bucket
    (2^k · {4,5,6,7}/4 — ≤25% padding overhead vs ≤100% for pure powers
    of two).  Identical to the JAX package's rule, so capacities match.
    """
    cap = max(int(n), minimum)
    pow2 = 1 << (cap - 1).bit_length()
    for num in (5, 6, 7):  # 2^(k-1)·{1.25, 1.5, 1.75}
        q = (pow2 // 8) * num
        if q >= cap:
            return q
    return pow2
