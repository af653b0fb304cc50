"""Streaming (chunked) distributed join and the host export lane.

Mirror of ``cylon_tpu/parallel/streaming.py`` (reference:
cpp/src/cylon/arrow/arrow_join.cpp, the ArrowJoin streaming pipeline: the
right table resident, left batches streamed through the AllToAll and
joined as they land).  The right side is co-partitioned ONCE and stays
resident; the left side goes through in ``chunks`` row slices of its
padded block, so the left shuffle's buffers are one slice wide.  Slices
run one after another: each slice's join sizes its output from a host
read of its counts.

The per-slice outputs are concatenated and their valid rows compacted to
the front of each shard block (``_concat_compact``), so the result keeps
the DTable invariant (rows ``[0, count)`` valid).  Slice widths and the
output capacity are ``next_bucket`` size classes, as in the JAX package,
so every capacity matches it.

INNER and LEFT equal ``dist_join``'s rows; RIGHT and FULL_OUTER fall back
to ``dist_join`` (a right row is unmatched only against ALL left slices,
which no single slice can decide).

``HostPipeline`` is the second streaming primitive: a bounded FIFO of
worker threads for host-side work (the export of one query's result, the
ingest of the next query's frames), so host conversion of query N
overlaps device work of query N+1.  Device work stays on the submitting
thread.
"""
from __future__ import annotations

import math
import queue as _queue
import threading
from typing import Any, Callable, List, Optional

import torch

from .. import trace
from ..analysis import plan_check
from ..config import JoinConfig
from ..ops import compact as ops_compact
from ..ops import gather as ops_gather
from ..status import Code, CylonError, Status
from .dist_ops import (_copartition, _join_copartitioned, _join_prologue,
                       dist_join)
from .dtable import DColumn, DTable


def _slice_rows(dt: DTable, lo: int, hi: int) -> DTable:
    """Rows ``[lo, hi)`` of every local shard's padded block, as a
    narrower DTable (trailing dimensions of a leaf pass through)."""
    P, cap, w = dt.nlocal, dt.cap, hi - lo

    def f(a: torch.Tensor) -> torch.Tensor:
        tail = tuple(a.shape[1:])
        return a.reshape((P, cap) + tail)[:, lo:hi].reshape((P * w,) + tail)

    cols = [DColumn(c.name, c.dtype, f(c.data),
                    None if c.validity is None else f(c.validity),
                    c.dictionary, c.arrow_type) for c in dt.columns]
    counts = torch.clamp(dt.counts - lo, 0, w).to(torch.int32)
    return DTable(dt.ctx, cols, w, counts)


def _concat_compact(parts: List[DTable]) -> DTable:
    """Concatenate same-schema DTables shard by shard and compact the
    valid rows to the front of an ``outcap``-wide block (``outcap`` = the
    size class of the summed capacities): the JAX package's repack.  One
    column at a time, so the transient is one column's concatenation, not
    the whole table's.  Across processes each process concatenates its
    own L shards (``cap`` is the same in every process, so is
    ``outcap``)."""
    if len(parts) == 1:
        return parts[0]
    head = parts[0]
    P = head.nlocal
    dev = head.counts.device
    width = sum(p.cap for p in parts)
    outcap = ops_compact.next_bucket(width, minimum=8)
    valid = torch.cat([torch.arange(p.cap, device=dev)[None, :]
                       < p.counts[:, None] for p in parts], 1)   # [P, width]
    idx, counts = zip(*(ops_compact.mask_to_indices(valid[s], outcap)
                        for s in range(P)))
    # row −1 (past a shard's count) reads the shard's first row, as the
    # per-shard gather of the JAX package does
    rows = (torch.arange(P, device=dev)[:, None] * width
            + torch.clamp(torch.stack(idx), min=0)).reshape(-1)

    def concat(leaves, caps):
        blocks = [lf.reshape((P, cap) + tuple(lf.shape[1:]))
                  for lf, cap in zip(leaves, caps)]
        return torch.cat(blocks, 1).reshape((P * width,)
                                            + tuple(blocks[0].shape[2:]))

    cols = []
    for i, c in enumerate(head.columns):
        data = concat([p.columns[i].data for p in parts],
                      [p.cap for p in parts])
        v = None
        if any(p.columns[i].validity is not None for p in parts):
            v = concat([torch.ones(P * p.cap, dtype=torch.bool, device=dev)
                        if p.columns[i].validity is None
                        else p.columns[i].validity for p in parts],
                       [p.cap for p in parts])
        d, v = ops_gather.take(data, v, rows)
        cols.append(DColumn(c.name, c.dtype, d, v, c.dictionary,
                            c.arrow_type))
        del data
    return DTable(head.ctx, cols, outcap, torch.stack(counts))


@plan_check.instrument
def dist_join_streaming(left: DTable, right: DTable, config: JoinConfig,
                        chunks: int = 4) -> DTable:
    """Chunked distributed join of ``left`` against a resident ``right``.

    ``chunks`` bounds the left side's shuffle buffers to about
    ``cap / chunks`` rows per shard; the right side is co-partitioned once.
    The output rows equal ``dist_join``'s (in slice-major order on each
    shard).  RIGHT / FULL_OUTER, ``chunks <= 1`` and a left block narrower
    than ``chunks`` take the one-shot ``dist_join``.  The strategies of
    ``dist_join`` that move no left rows (broadcast, dense FK) are not
    tried here: the streaming join always co-partitions.  A SPILLED left
    side of an INNER / LEFT join streams from the spill pool through the
    morsel scan instead (``spill.morsel.morsel_join``): the first leaf
    read here would otherwise fault the whole block back in.

    Across processes the slices are cut from ``left.cap``, which every
    process shares, so every process runs the same slices' exchanges in
    the same order."""
    if left.is_spilled and config.join_type.value in ("inner", "left") \
            and not right.is_spilled:
        from ..spill import morsel as spill_morsel
        return spill_morsel.morsel_join(left, right, config)
    how = config.join_type.value
    if chunks <= 1 or left.cap < chunks or how in ("right", "full_outer"):
        return dist_join(left, right, config)
    plan_check.note("dist_join_streaming", left, right, how=how,
                    chunks=chunks, decision="streaming-shuffle")
    left, right, li_key, ri_key, alg, splitters = _join_prologue(
        left, right, config)
    rsh = _copartition(right, ri_key, alg, splitters)  # once, resident

    def _cells(dt: DTable) -> int:
        per_row = sum(1 + (c.validity is not None) for c in dt.columns)
        return dt.ctx.get_world_size() * dt.cap * per_row

    w = ops_compact.next_bucket(math.ceil(left.cap / chunks), minimum=8)
    parts: List[DTable] = []
    with trace.span("join.streaming"):
        for lo in range(0, left.cap, w):
            chunk = _slice_rows(left, lo, min(lo + w, left.cap))
            csh = _copartition(chunk, li_key, alg, splitters)
            # the live exchange transient of the staged plan: the
            # resident right co-partition plus the in-flight chunk block
            trace.count_max("shuffle.capacity_cells_live_peak",
                            _cells(rsh) + _cells(csh))
            parts.append(_join_copartitioned(csh, rsh, li_key, ri_key, how,
                                             alg))
            del chunk, csh
    return _concat_compact(parts)


# ---------------------------------------------------------------------------
# the host export / ingest lane
# ---------------------------------------------------------------------------

class HostTask:
    """Handle on one submitted host task: ``wait()`` blocks until a worker
    ran it, then returns its result or re-raises its error (the error
    reaches the waiting consumer, not only the worker's stderr)."""

    __slots__ = ("_event", "_value", "_error")

    def __init__(self) -> None:
        self._event = threading.Event()
        self._value: Any = None
        self._error: Optional[BaseException] = None

    def done(self) -> bool:
        return self._event.is_set()

    def wait(self, timeout: Optional[float] = None):
        if not self._event.wait(timeout):
            raise CylonError(Status(Code.ExecutionError,
                f"host task not finished within {timeout} s"))
        if self._error is not None:
            raise self._error
        return self._value


class HostPipeline:
    """A bounded FIFO lane of worker threads for host-boundary work.

    A serving loop submits each finished query's export (the device →
    host gather and the conversion) here and starts the next query's
    device work at once.  ``depth`` bounds the queued, not yet started
    tasks: a producer that outruns the lane blocks in ``submit``.  With
    ``workers=1`` (the default) tasks run in submission order.
    """

    def __init__(self, workers: int = 1, depth: int = 16,
                 name: str = "host-pipeline",
                 device: Optional[torch.device] = None) -> None:
        if workers < 1 or depth < 1:
            raise CylonError(Status(Code.Invalid,
                f"HostPipeline needs workers >= 1 and depth >= 1, got "
                f"workers={workers} depth={depth}"))
        self._q: "_queue.Queue" = _queue.Queue(maxsize=depth)
        self._closed = False
        # a new thread's current CUDA device is device 0: each worker
        # makes the pipeline's device current before it runs any task
        self._device = (torch.device(device) if device is not None
                        else None)
        # orders submit's check-then-put against close's set-closed: a
        # task enqueued behind close()'s stop sentinels would never run
        self._lock = threading.Lock()
        self._threads = [threading.Thread(target=self._run,
                                          name=f"{name}-{i}", daemon=True)
                         for i in range(workers)]
        for t in self._threads:
            t.start()

    def _run(self) -> None:
        if self._device is not None and self._device.type == "cuda":
            torch.cuda.set_device(self._device)
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            task, fn, trace_id = item
            try:
                # the task's query trace id (if any) stamps the worker's
                # span onto that query's track
                with trace.trace_context(trace_id):
                    with trace.span("serve.export"):
                        task._value = fn()
            except BaseException as e:  # delivered to the wait()ing caller
                task._error = e
            finally:
                task._event.set()
                self._q.task_done()
            # the result belongs to the submitter: an idle worker must not
            # keep the last one (a device table) alive
            del item, task, fn

    def submit(self, fn: Callable[[], Any],
               trace_id: Optional[str] = None) -> HostTask:
        """Queue ``fn`` for a worker and return its ``HostTask``; blocks
        while ``depth`` tasks wait (the workers keep draining).
        ``trace_id`` stamps the worker-side span onto that query's
        lifecycle track."""
        task = HostTask()
        with self._lock:
            if self._closed:
                raise CylonError(Status(Code.Invalid,
                                        "HostPipeline is closed"))
            self._q.put((task, fn, trace_id))
        return task

    def drain(self) -> None:
        """Block until every submitted task has finished."""
        self._q.join()

    def close(self, timeout: float = 5.0) -> None:
        """Finish the queued tasks, then stop the workers (each join
        bounded by ``timeout``).  Idempotent."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self._q.join()
        for _ in self._threads:
            self._q.put(None)
        for t in self._threads:
            t.join(timeout)
