"""meshprobe — measure what each collective costs on THIS context.

The exchange cost model (parallel/cost.py) ranks strategies on
(rounds, wire bytes): a good proxy, but a proxy — the right collective
sequence depends on the topology, and a topology is known only by
measurement.  This module is the measurement: a microbench times the
three collective primitives every exchange lowering is built from —
the communicator's ``all_to_all`` (single-shot and the chunked rounds),
``ppermute`` (the staged ring) and ``all_gather`` (replicate-and-filter
and the broadcast replica) — at a few payload sizes through the live
context's communicator (``LocalCommunicator`` on one device, NCCL or
gloo through ``ProcessCommunicator``), and least-squares fits each to
the classic α/β model::

    t(wire_bytes) = latency_s + wire_bytes / bytes_per_s

The fitted coefficients are cached per context fingerprint
(:func:`mesh_fingerprint`), optionally persisted through
``CYLON_MESHPROBE_PATH`` (the JAX package's JSON layout, so one
``analysis.calibrate --meshprobe`` reads either package's file), and
surfaced through ``cost.predicted_ms``: EXPLAIN ANALYZE annotates every
exchange with predicted-vs-observed ms (``exchange_ms``).

The coefficients are reported, not steering: the chooser keeps ranking
on (rounds, wire) unless ``CYLON_COST_MEASURED=1`` /
``config.set_cost_measured(True)`` flips it to rank feasible strategies
by predicted time.

Probing is always explicit (``probe(ctx)``): it dispatches collectives
and waits for the device, which a latency-sensitive path must never do
by surprise.  ``get_profile(ctx)`` is the read side and never probes.
A meta context (the abstract plan check) has no profile.  Across
processes the probe refuses (``context.refuse_multiprocess``): the JAX
probe's host legs fetch a global array, which JAX refuses for an array
that spans another process's devices.  There ``get_profile`` returns
only what :func:`put_profile` installed.
"""
from __future__ import annotations

import functools
import hashlib
import json
import os
import threading
import time
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .. import trace
from ..status import Code, CylonError, Status

__all__ = ["MeshProfile", "mesh_fingerprint", "probe", "get_profile",
           "put_profile", "clear_profiles", "COLLECTIVES", "TRANSFERS"]

COLLECTIVES = ("all_to_all", "ppermute", "all_gather")

# the host-boundary legs every staged-spill lowering pays: host→device
# and device→host copies of the payload through a pinned host block on
# the card's copy stream (what spill/pool.stage_in_arrays /
# stage_out_arrays do), fitted to the same α/β model under the same
# fingerprint, so cost.predicted_ms prices a spill's host round trips
# next to its collective rounds
TRANSFERS = ("h2d", "d2h")

# fingerprint -> MeshProfile; lock-guarded (a serve dispatcher may probe
# while clients read).  _misses caches fingerprints whose persisted-file
# lookup came back empty: get_profile sits on the exchange path, so an
# unprobed context costs one dict lookup, not one file read, per
# exchange
_profiles: Dict[Tuple, "MeshProfile"] = {}
_misses: set = set()
_lock = threading.Lock()


@functools.lru_cache(maxsize=None)
def _device_label(device: torch.device) -> Tuple[str, str]:
    """(type:index, name) of one device (reading the card's name is a
    CUDA call: memoized per device)."""
    if device.type == "cuda":
        return str(device), torch.cuda.get_device_name(device)
    return str(device), device.type


def mesh_fingerprint(ctx) -> Tuple:
    """Stable identity of one context's collectives: the communicator's
    kind, the device's type, index and name, the world, the process split
    ``(nproc, proc, L)`` and the ``(slow, fast)`` axis split.  The profile
    cache key: a rebuilt context over the same device, world and
    communicator reuses the measured coefficients, and two contexts that
    share one card through different communicators do not."""
    from .. import topology
    comm = ctx.comm
    slow, fast = topology.axis_split(ctx)
    dev, name = _device_label(ctx.device)
    return (comm.backend,
            (dev, name, f"world={comm.world}",
             f"procs={comm.nproc}/{comm.proc}/{comm.local}",
             f"split={slow}x{fast}"))


@dataclass(frozen=True)
class MeshProfile:
    """Fitted per-collective coefficients of one context.

    ``latency_s[c]``    α: fixed per-dispatch cost of collective ``c``
                        (the completion wait + launch overhead).
    ``bytes_per_s[c]``  β⁻¹: sustained per-shard wire bandwidth.
    ``samples``         the raw ``(collective, wire_bytes, seconds)``
                        points the fit consumed.

    Per-edge coefficients: when the context has a non-trivial
    ``(slow, fast)`` split, :func:`probe` also times each collective
    restricted to one axis (the communicator's group-local form) and
    fits those under ``"<collective>@fast"`` / ``"<collective>@slow"`` —
    what turns ``cost.predicted_ms`` from a flat model into a per-edge
    one.  ``axis_split`` records the split they were measured under.
    """

    fingerprint: Tuple
    latency_s: Dict[str, float]
    bytes_per_s: Dict[str, float]
    samples: Tuple[Tuple[str, int, float], ...]
    axis_split: Optional[Tuple[int, int]] = None

    def predicted_s(self, collective: str, wire_bytes: int,
                    rounds: int = 1) -> Optional[float]:
        """α·rounds + wire/β for one exchange; None for an unmeasured
        collective (a profile from a partial probe)."""
        lat = self.latency_s.get(collective)
        bw = self.bytes_per_s.get(collective)
        if lat is None or bw is None:
            return None
        return max(rounds, 1) * lat + wire_bytes / max(bw, 1.0)

    def describe(self) -> str:
        parts = []
        axis_keys = tuple(sorted(k for k in self.latency_s if "@" in k))
        for c in COLLECTIVES + TRANSFERS + axis_keys:
            if c in self.latency_s:
                parts.append(f"{c}: {self.latency_s[c] * 1e3:.3f} ms + "
                             f"{self.bytes_per_s[c] / 1e9:.3f} GB/s")
        return "; ".join(parts)


def _fit(points) -> Tuple[float, float]:
    """Least-squares α + bytes/β over (wire_bytes, seconds) points;
    degenerate fits (negative slope from noise, single point) degrade
    to a zero-latency / measured-minimum model rather than returning
    nonsense coefficients."""
    xs = np.asarray([p[0] for p in points], dtype=np.float64)
    ts = np.asarray([p[1] for p in points], dtype=np.float64)
    if len(xs) >= 2 and float(np.ptp(xs)) > 0:
        slope, intercept = np.polyfit(xs, ts, 1)
    else:
        slope, intercept = 0.0, float(ts.min())
    if slope <= 0:
        # bandwidth too high to resolve at these sizes: latency-bound
        return max(float(ts.min()), 1e-9), 1e15
    return max(float(intercept), 0.0), 1.0 / float(slope)


def _best_of(fn, reps: int) -> float:
    """Dispatch ``fn`` once outside the clock, then ``reps`` times timed
    to completion (``trace.hard_sync``: ``torch.cuda.synchronize`` on the
    card — what an exchange dispatch pays); the minimum is the sample."""
    trace.hard_sync(fn())
    best = None
    for _ in range(max(reps, 1)):
        t0 = time.perf_counter()
        trace.hard_sync(fn())
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    return best


def _transfer_legs(x: torch.Tensor, reps: int) -> Tuple[float, float]:
    """Best h2d and d2h seconds of ``x``'s bytes, each leg copied the way
    the spill pool's staging boundaries copy: a pinned host block, the
    card's copy stream, one wait.  The pool's functions themselves are
    not called, so a probe books no ``spill.*`` tally and hits no
    ``spill.stage_*`` fault point.  On the CPU each leg is a clone, as
    the staging boundaries' is."""
    from ..spill import pool
    dev = x.device
    host = pool.pinned_empty(tuple(x.shape), x.dtype, dev)
    host.copy_(x)
    if dev.type != "cuda":
        return _best_of(lambda: host.clone(), reps), \
            _best_of(lambda: x.clone(), reps)
    copy = pool._copy_stream(dev)

    def wait(stream) -> None:
        done = torch.cuda.Event()
        done.record(stream)
        done.synchronize()

    def h2d():
        with torch.cuda.stream(copy):
            d = torch.empty_like(x)
            d.copy_(host, non_blocking=True)
        wait(copy)
        return d

    def d2h():
        out = pool.pinned_empty(tuple(x.shape), x.dtype, dev)
        copy.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(copy):
            out.copy_(x, non_blocking=True)
        wait(copy)
        return out

    return _best_of(h2d, reps), _best_of(d2h, reps)


def probe(ctx, sizes: Tuple[int, ...] = (1 << 12, 1 << 15, 1 << 18),
          reps: int = 2, force: bool = False) -> MeshProfile:
    """Run the microbench on ``ctx``'s communicator and cache the fitted
    profile (a cached fingerprint returns at once unless ``force``).

    ``sizes`` are per-shard payload BYTES per collective dispatch
    (float32, rounded down to whole elements; the all_to_all block is
    [P, size/P] per shard, the exchange's shape).  The wire bytes per
    shard: ``(P−1)·m·4`` for the all_to_all of m elements per cell, the
    whole block for the ring's shift of one, ``(P−1)·n·4`` for the
    all_gather.  The transfer legs move every local shard's block."""
    from .. import topology
    from ..context import refuse_multiprocess
    if ctx.device.type == "meta":
        raise CylonError(Status(Code.Invalid,
            "the mesh probe times real collectives: a meta context "
            "(an abstract plan run) has none"))
    refuse_multiprocess("the mesh probe", ctx)
    fp = mesh_fingerprint(ctx)
    if not force:
        hit = get_profile(ctx)
        if hit is not None:
            return hit
    comm = ctx.comm
    Pn, L, dev = ctx.get_world_size(), ctx.get_local_world_size(), ctx.device
    gen = torch.Generator(device=dev).manual_seed(7)
    samples = []
    with trace.span("meshprobe"):
        for size in sizes:
            # per-shard element count, padded so the [P, m] all_to_all
            # block divides evenly
            n = max((size // 4 // max(Pn, 1)) * max(Pn, 1), Pn)
            m = n // Pn
            x = torch.randn((L, n), generator=gen, device=dev)
            for coll, fn, wire in (
                    ("all_to_all",
                     lambda: comm.all_to_all(x.view(L, Pn, m)),
                     (Pn - 1) * m * 4),
                    ("ppermute", lambda: comm.ppermute(x, 1), n * 4),
                    ("all_gather", lambda: comm.all_gather(x),
                     (Pn - 1) * n * 4)):
                samples.append((coll, int(wire), float(_best_of(fn, reps))))
            best_h, best_d = _transfer_legs(x, reps)
            nbytes = int(x.numel()) * x.element_size()
            samples.append(("h2d", nbytes, float(best_h)))
            samples.append(("d2h", nbytes, float(best_d)))
            del x
        # per-edge probes: on a two-level split, time each collective
        # restricted to one axis (the payload stays one block per shard;
        # only the collective's group narrows).  The "@fast" / "@slow"
        # fits are what let cost.predicted_ms price a two-level sequence
        # edge by edge
        split = None
        s_f = topology.axis_split(ctx)
        if s_f[0] > 1 and s_f[1] > 1 and s_f[0] * s_f[1] == Pn:
            split = (int(s_f[0]), int(s_f[1]))
            for size in sizes:
                for edge, nA in (("fast", split[1]), ("slow", split[0])):
                    n = max((size // 4 // nA) * nA, nA)
                    m = n // nA
                    x = torch.randn((L, n), generator=gen, device=dev)
                    kw = {"split": split, "axis": edge}
                    for coll, fn, wire in (
                            ("all_to_all",
                             lambda: comm.all_to_all(x.view(L, nA, m), **kw),
                             (nA - 1) * m * 4),
                            ("ppermute", lambda: comm.ppermute(x, 1, **kw),
                             n * 4),
                            ("all_gather", lambda: comm.all_gather(x, **kw),
                             (nA - 1) * n * 4)):
                        samples.append((f"{coll}@{edge}", int(wire),
                                        float(_best_of(fn, reps))))
                    del x
            trace.count("meshprobe.axis_probes")
    latency: Dict[str, float] = {}
    bw: Dict[str, float] = {}
    for coll in dict.fromkeys(c for c, _, _ in samples):
        latency[coll], bw[coll] = _fit(
            [(w, t) for c, w, t in samples if c == coll])
    profile = MeshProfile(fp, latency, bw, tuple(samples), axis_split=split)
    trace.count("meshprobe.probes")
    with _lock:
        _profiles[fp] = profile
        _misses.discard(fp)
    _persist(profile)
    return profile


def get_profile(ctx) -> Optional[MeshProfile]:
    """The cached profile for ``ctx``, or None.  Never probes: reads the
    in-memory cache, falling back (in a single-process context) to the
    ``CYLON_MESHPROBE_PATH`` file when one is configured.  Misses are
    cached too (until ``probe`` / ``put_profile`` / ``clear_profiles``),
    so an unprobed context costs one lookup per call.  A meta context
    gets None without a lookup."""
    if ctx.device.type == "meta":
        return None
    fp = mesh_fingerprint(ctx)
    with _lock:
        hit = _profiles.get(fp)
        if hit is not None or fp in _misses:
            return hit
    loaded = (_load_persisted(fp) if ctx.get_process_count() == 1
              else None)
    with _lock:
        if loaded is not None:
            loaded = _profiles.setdefault(fp, loaded)
        else:
            _misses.add(fp)
    return loaded


def put_profile(profile: MeshProfile) -> None:
    """Register a profile under its own fingerprint (and persist it when
    ``CYLON_MESHPROBE_PATH`` is set).  The injection seam for synthetic
    per-edge coefficients: a simulated world on one device has no
    physical slow edge, so a test installs a profile whose ``@slow``
    bandwidth reflects the topology being modelled and lets the chooser
    rank for real."""
    with _lock:
        _profiles[profile.fingerprint] = profile
        _misses.discard(profile.fingerprint)
    _persist(profile)


def clear_profiles() -> None:
    """Forget every cached profile and cached miss (the persisted file,
    if any, is untouched)."""
    with _lock:
        _profiles.clear()
        _misses.clear()


# ---------------------------------------------------------------------------
# optional persistence (CYLON_MESHPROBE_PATH): coefficients survive the
# process, so a restart on the same device and world skips the re-probe
# ---------------------------------------------------------------------------

def _fp_key(fp: Tuple) -> str:
    return hashlib.sha1(repr(fp).encode()).hexdigest()[:16]


def _persist(profile: MeshProfile) -> None:
    path = os.environ.get("CYLON_MESHPROBE_PATH")
    if not path:
        return
    try:
        data = {}
        if os.path.exists(path):
            with open(path) as f:
                data = json.load(f)
        data[_fp_key(profile.fingerprint)] = {
            "fingerprint": list(profile.fingerprint[1]),
            "axis": profile.fingerprint[0],
            "latency_s": profile.latency_s,
            "bytes_per_s": profile.bytes_per_s,
            "samples": [list(s) for s in profile.samples],
            "axis_split": (list(profile.axis_split)
                           if profile.axis_split else None),
        }
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(data, f, sort_keys=True)
        os.replace(tmp, path)
    except (OSError, ValueError):
        pass  # persistence is best-effort; the in-memory cache stands


def _load_persisted(fp: Tuple) -> Optional[MeshProfile]:
    path = os.environ.get("CYLON_MESHPROBE_PATH")
    if not path or not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            data = json.load(f)
        rec = data.get(_fp_key(fp))
        if not isinstance(rec, dict):
            return None
        split = rec.get("axis_split")
        return MeshProfile(
            fp, dict(rec.get("latency_s", {})),
            dict(rec.get("bytes_per_s", {})),
            tuple(tuple(s) for s in rec.get("samples", ())),
            axis_split=tuple(split) if split else None)
    except (OSError, ValueError):
        return None
