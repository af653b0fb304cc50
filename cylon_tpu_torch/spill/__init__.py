"""Out-of-core execution: the host-tier spill subsystem.

The port of ``cylon_tpu/spill/``.  Three pieces:

  * :mod:`spill.pool` — the spillable leaf pool: DTable leaves moved to
    pinned host blocks (an LRU within ``CYLON_HOST_MEMORY_BUDGET``), with
    transparent fault-in on first device use and the two staging
    boundaries (``stage_out_arrays`` / ``stage_in_arrays``, on the card's
    copy stream).
  * :mod:`spill.morsel` — morsel-partitioned scans: a spilled table
    streams through its consumer in admission-priced morsels, morsel k+1
    staged on a ``HostPipeline`` worker while morsel k computes, the
    per-morsel partials folded through the combine-spec machinery.
  * the ``staged-spill`` lowering of the exchange (``parallel/cost.py``,
    ``parallel/shuffle.py``): the payload staged out to the pool and
    streamed back one rank-sliced morsel per round.  Its price carries
    the host bytes of both legs; ``cost.predicted_ms`` times them with
    the ``d2h`` / ``h2d`` coefficients that ``parallel/meshprobe.py``
    measured on this pool's path (a pinned block, the copy stream, one
    wait).
"""
from . import morsel, pool  # noqa: F401
from .pool import (SpillPool, clear_pool, ensure_device, get_pool,  # noqa: F401
                   spill_table, stage_in_arrays, stage_out_arrays)

__all__ = ["pool", "morsel", "SpillPool", "get_pool", "clear_pool",
           "spill_table", "ensure_device", "stage_out_arrays",
           "stage_in_arrays"]
