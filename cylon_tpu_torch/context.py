"""Runtime context: device, world size, rank, config map, barrier.

Mirrors the reference's ``CylonContext`` (reference:
cpp/src/cylon/ctx/cylon_context.hpp:29-138).  Where the reference wraps an
MPI communicator and the JAX package a device mesh, this context owns one
torch device and a communicator over ``world`` ranks.

``LocalCommunicator`` keeps all P ranks' row shards on that one device
(the counterpart of the JAX tests' 8 virtual CPU devices): a collective is
a tensor operation over a leading rank axis.  Every operator reaches the
other ranks only through the context's communicator, so a multi-process
communicator can replace it without touching the operators.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch

from .status import Code, CylonError, Status


class LocalCommunicator:
    """``world`` ranks simulated on one device.

    Per-rank values travel as tensors whose leading axis is the rank.
    ``all_to_all``, ``all_gather`` and ``ppermute`` also run GROUP-LOCAL
    over one axis of a ``(slow, fast)`` split of the world (``split``,
    ``axis`` "slow" or "fast"; rank ``p`` sits at slow coordinate
    ``p // fast`` and fast coordinate ``p % fast``): a group is the
    ranks that share the other coordinate, and its size ``G`` is that
    axis's extent.  On one device a group-local collective is a reshape
    to ``[slow, fast, ...]`` and a transpose or roll inside each group.
    """

    def __init__(self, world: int, device: torch.device):
        self.world = world
        self.device = device

    def _split(self, split, axis) -> Tuple[int, int]:
        slow, fast = int(split[0]), int(split[1])
        if slow * fast != self.world or axis not in ("slow", "fast"):
            raise CylonError(Status(Code.Invalid,
                f"a group-local collective wants a (slow, fast) split of "
                f"world {self.world} and axis 'slow' or 'fast', got "
                f"{tuple(split)!r}, {axis!r}"))
        return slow, fast

    def _want(self, what: str, x: torch.Tensor, lead) -> None:
        if tuple(x.shape[:len(lead)]) != tuple(lead):
            raise CylonError(Status(Code.Invalid,
                f"{what} wants {list(lead) + ['...']}, got "
                f"{tuple(x.shape)}"))

    def all_to_all(self, x: torch.Tensor, split=None,
                   axis: Optional[str] = None) -> torch.Tensor:
        """``x[src, dst, ...]`` is what rank ``src`` sends to ``dst``;
        returns ``y[dst, src, ...]``, what each rank received from each.
        Group-local (``split``): ``x[p, g]`` goes to the ``g``-th rank of
        ``p``'s group, and ``y[p, g]`` came from the ``g``-th."""
        if split is None:
            self._want("all_to_all", x, (self.world, self.world))
            return x.transpose(0, 1).contiguous()
        slow, fast = self._split(split, axis)
        tail = tuple(x.shape[2:])
        if axis == "fast":
            self._want("all_to_all", x, (self.world, fast))
            return (x.reshape((slow, fast, fast) + tail).transpose(1, 2)
                    .reshape((self.world, fast) + tail))
        self._want("all_to_all", x, (self.world, slow))
        return (x.reshape((slow, fast, slow) + tail).transpose(0, 2)
                .reshape((self.world, slow) + tail))

    def all_gather(self, x: torch.Tensor, split=None,
                   axis: Optional[str] = None) -> torch.Tensor:
        """``x[rank, ...]`` one value block per rank → the same blocks,
        visible to every rank (here: one tensor all ranks share).
        Group-local (``split``): ``y[p, g]`` is the block of the
        ``g``-th rank of ``p``'s group."""
        self._want("all_gather", x, (self.world,))
        if split is None:
            return x
        slow, fast = self._split(split, axis)
        tail = tuple(x.shape[1:])
        xv = x.reshape((slow, fast) + tail)
        if axis == "fast":
            y = xv.unsqueeze(1).expand((slow, fast, fast) + tail)
            return y.reshape((self.world, fast) + tail)
        y = xv.transpose(0, 1).unsqueeze(0).expand((slow, fast, slow) + tail)
        return y.reshape((self.world, slow) + tail)

    def ppermute(self, x: torch.Tensor, shift: int, split=None,
                 axis: Optional[str] = None) -> torch.Tensor:
        """Rank ``i``'s block ``x[i]`` goes to rank ``(i + shift) % P``;
        returns what each rank received.  Group-local (``split``): the
        shift runs along ``axis`` inside each group."""
        self._want("ppermute", x, (self.world,))
        if split is None:
            return torch.roll(x, int(shift), 0)
        slow, fast = self._split(split, axis)
        tail = tuple(x.shape[1:])
        dim = 0 if axis == "slow" else 1
        return torch.roll(x.reshape((slow, fast) + tail), int(shift),
                          dim).reshape(x.shape)

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """``x[rank, ...]`` one block per rank → their sum over the ranks,
        visible to every rank (``psum``); shape ``x.shape[1:]``."""
        if x.dim() == 0 or x.shape[0] != self.world:
            raise CylonError(Status(Code.Invalid,
                f"all_reduce wants [{self.world}, ...], got {tuple(x.shape)}"))
        return x.sum(0)

    def barrier(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


class CylonContext:
    """Entry point to the runtime.

    ``CylonContext()`` runs on the CUDA card and raises when there is none:
    it never falls back to the CPU.  ``device="cpu"`` asks for the CPU
    explicitly (the tests do).  ``world=P`` keeps P row shards on that
    device.  ``config`` is an optional dict seeding the string config map.

    ``first_slot=s`` places the context's shards on the slots ``s ..
    s + P − 1`` of its device (``topology.slots``): the counterpart of
    the JAX package's ``CylonContext({"devices": subset})``, so two
    contexts over disjoint slot ranges are disjoint replicas of one
    card (a serving fleet, ``serve.FleetRouter``).  They share the
    card's memory.
    """

    def __init__(self, config: Optional[Dict[str, str]] = None,
                 device: Union[str, torch.device, None] = None,
                 world: int = 1, first_slot: int = 0):
        if config is not None and not isinstance(config, dict):
            raise CylonError(Status(Code.Invalid,
                                    f"unknown config {config!r}"))
        if int(world) < 1:
            raise CylonError(Status(Code.Invalid,
                                    f"world size must be >= 1, got {world}"))
        dev = torch.device("cuda" if device is None else device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise CylonError(Status(Code.ExecutionError,
                "no CUDA device is available; pass device='cpu' to run "
                "on the CPU"))
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        if int(first_slot) < 0:
            raise CylonError(Status(Code.Invalid,
                f"first_slot must be >= 0, got {first_slot}"))
        self._device = dev
        self._first_slot = int(first_slot)
        self._comm = LocalCommunicator(int(world), dev)
        self._config: Dict[str, str] = dict(config or {})

    def with_world(self, world: int) -> "CylonContext":
        """A context on the same device with ``world`` shards and a copy
        of this one's config map, starting at the same slot: the
        survivor (or grown) context of an elastic re-mesh
        (``topology.mark_lost`` / ``mark_joined``)."""
        return CylonContext(dict(self._config), self._device, world,
                            self._first_slot)

    def with_device(self, device: Union[str, torch.device]
                    ) -> "CylonContext":
        """A context with this one's world, first slot and a copy of its
        config map on ``device``: the ``meta`` view over which an
        abstract plan run (``analysis/plan_check``) rebuilds its tables,
        so every allocation the plan makes lands on the meta device."""
        return CylonContext(dict(self._config), device,
                            self.get_world_size(), self._first_slot)

    def get_rank(self) -> int:
        """Lowest rank this process drives (all of them: 0)."""
        return 0

    def get_world_size(self) -> int:
        return self._comm.world

    def add_config(self, key: str, value: str) -> None:
        self._config[key] = value

    def get_config(self, key: str, default: str = "") -> str:
        return self._config.get(key, default)

    def barrier(self) -> None:
        """Block the host until the device has drained queued work."""
        self._comm.barrier()

    def optimize(self, op, tables=None):
        """Run ``op(tables)`` (or ``op()`` when ``tables`` is None) through
        the logical query planner: the plan is captured lazily, rewritten
        and executed via the compiled-plan cache, so a repeated query
        skips the rewrite.  Returns the query's concrete result.
        ``CYLON_OPTIMIZER=0`` (or ``config.set_optimizer_enabled(False)``)
        makes this a plain eager call."""
        from . import plan
        return plan.optimize(self, op, tables)

    def analyze(self, op, tables=None):
        """EXPLAIN ANALYZE a plan: run ``op(tables)`` (or ``op()`` when
        ``tables`` is None) for real, once, with every distributed
        operator instrumented; returns the runtime-annotated
        ``PlanReport`` (``report.output`` is the result).  The
        context-level spelling of ``DTable.explain(op, tables=...,
        analyze=True)``."""
        from . import observe
        if tables is None:
            return observe.analyze(op)
        return observe.analyze(op, tables)

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def comm(self) -> LocalCommunicator:
        return self._comm

    @property
    def first_slot(self) -> int:
        """The first of this context's shard slots on its device."""
        return self._first_slot

    def __repr__(self) -> str:
        slot = (f", first_slot={self._first_slot}" if self._first_slot
                else "")
        return (f"CylonContext(world={self.get_world_size()}, "
                f"device={self._device}{slot})")
