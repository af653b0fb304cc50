"""cylon_tpu_torch — the distributed dataframe engine on PyTorch and CUDA.

The port of ``cylon_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA GPU.
Columns live in device memory as torch tensors; a distributed table keeps
P row shards, and every collective goes through the context's
communicator.  The hot-path kernel (the hash shuffle's partition id) is a
CUDA kernel built from ``csrc/`` on first use; every other operator is
plain torch.  The package imports neither JAX nor ``cylon_tpu``.

Layer map:

    compute.py        local join, set ops, sort, select, hash and
                      round-robin partition, merge, groupby
    parallel/         DTable (with the deferred-select mask), the
                      all_to_all shuffle, dist_join (SORT and HASH),
                      dist_sort / dist_sort_multi / dist_head,
                      dist_union / dist_intersect / dist_subtract,
                      dist_select / dist_project / dist_with_column,
                      dist_groupby (pre-aggregation, broadcast and shuffle
                      combine, dense keys) / dist_aggregate;
                      broadcast.py: replicate_table
    ops/              hash (plain + CUDA), compaction, gathers, join, sort,
                      set-op and groupby kernels
    config.py         JoinConfig, the broadcast threshold, memory budget
    context.py        CylonContext: device, world, communicator
"""

from .config import JoinAlgorithm, JoinConfig, JoinType
from .context import CylonContext
from .dtypes import DataType, Layout, Type
from .status import Code, CylonError, Status
from .table import Column, Table

__version__ = "0.1.0"

__all__ = [
    "CylonContext", "Table", "Column", "Status", "Code", "CylonError",
    "DataType", "Type", "Layout", "JoinConfig", "JoinType", "JoinAlgorithm",
    "__version__",
]
