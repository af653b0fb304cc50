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

from typing import Dict, Optional, Union

import torch

from .status import Code, CylonError, Status


class LocalCommunicator:
    """``world`` ranks simulated on one device.

    Per-rank values travel as tensors whose leading axis is the rank.
    """

    def __init__(self, world: int, device: torch.device):
        self.world = world
        self.device = device

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """``x[src, dst, ...]`` is what rank ``src`` sends to ``dst``;
        returns ``y[dst, src, ...]``, what each rank received from each."""
        if x.shape[0] != self.world or x.shape[1] != self.world:
            raise CylonError(Status(Code.Invalid,
                f"all_to_all wants [{self.world}, {self.world}, ...], "
                f"got {tuple(x.shape)}"))
        return x.transpose(0, 1).contiguous()

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """``x[rank, ...]`` one value block per rank → the same blocks,
        visible to every rank (here: one tensor all ranks share)."""
        if x.shape[0] != self.world:
            raise CylonError(Status(Code.Invalid,
                f"all_gather wants [{self.world}, ...], got {tuple(x.shape)}"))
        return x

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
    """

    def __init__(self, config: Optional[Dict[str, str]] = None,
                 device: Union[str, torch.device, None] = None,
                 world: int = 1):
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
        self._device = dev
        self._comm = LocalCommunicator(int(world), dev)
        self._config: Dict[str, str] = dict(config or {})

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

    def __repr__(self) -> str:
        return (f"CylonContext(world={self.get_world_size()}, "
                f"device={self._device})")
