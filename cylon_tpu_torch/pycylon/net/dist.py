"""pycylon.net.dist over the port — reference:
python/pycylon/net/dist.pyx:71-88.

``dist_init()`` in reference scripts joined the MPI world; here it pins
one module-global distributed context (``CylonContext("mpi")``: the
default world on the card).
"""
from __future__ import annotations

from typing import Optional

from ..ctx.context import CylonContext

_ctx: Optional[CylonContext] = None


def dist_init() -> CylonContext:
    global _ctx
    if _ctx is None:
        _ctx = CylonContext("mpi")
    return _ctx


def get_ctx() -> CylonContext:
    return dist_init()


def rank() -> int:
    return dist_init().get_rank()


def size() -> int:
    return dist_init().get_world_size()


def dist_finalize() -> None:
    global _ctx
    if _ctx is not None:
        _ctx.finalize()
        _ctx = None
