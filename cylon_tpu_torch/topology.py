"""Mesh topology: the ``(slow, fast)`` split of a world.

The port's copy of ``axis_split`` from ``cylon_tpu/topology.py``: the
factorization that the hierarchical exchange lowerings price and run on.
The survivor bookkeeping of that module (``mark_lost``, ``mark_joined``,
``effective``, ``epoch``) comes with the remesh and the recovery driver
that call it (ROADMAP A12.2).
"""
from __future__ import annotations

from typing import Tuple

__all__ = ["axis_split"]


def axis_split(ctx) -> Tuple[int, int]:
    """The ``(slow, fast)`` factorization of ``ctx``'s world.

    Resolution: explicit ``config.set_mesh_shape`` / ``CYLON_MESH_SHAPE``
    first, else the flat ``(1, world)`` (one process holds every shard,
    so there is no host grouping to read).  A configured shape that does
    not tile the world keeps its FAST extent when that still divides,
    and otherwise degrades to flat.  Always a valid factorization of the
    world size."""
    from . import config
    world = int(ctx.get_world_size())
    if world <= 0:
        return (1, 1)
    shape = config.mesh_shape()
    if shape is None:
        return (1, world)
    slow, fast = shape
    if slow * fast == world:
        return (slow, fast)
    if fast > 1 and world % fast == 0:
        return (world // fast, fast)
    return (1, world)
