"""pycylon over the port — source-compatible Python API over
cylon_tpu_torch.

The surface of the reference's Cython binding (reference:
python/pycylon/__init__.py, docs/docs/python.md:12-58) and of the JAX
package's ``pycylon``: the same modules, classes and call signatures, but
every operator dispatches to the PyTorch engine on the card.
``CylonContext('mpi')`` is accepted and means "distributed over the
context's world of row shards" (8 by default, ``world=`` to choose);
``device=`` chooses the device (the card unless the caller names another:
no fallback to the CPU).

    from cylon_tpu_torch.pycylon import CylonContext, csv_reader

The id-addressed table registry the reference uses for FFI
(cpp/src/cylon/table_api.cpp:45-73) survives here only at this boundary:
compat Tables carry a uuid and a module registry resolves uuid → backing
device table.  The Java binding reaches this package through
``java_gateway`` (``java_launcher.py`` stands in for the interpreter Java
spawns).
"""
from .ctx.context import CylonContext
from .common.join_config import JoinAlgorithm, JoinConfig, JoinType, \
    PJoinAlgorithm, PJoinType
from .common.status import Status
from .common.code import Code
from .data.table import Table, csv_reader

__all__ = [
    "CylonContext", "Table", "csv_reader", "Status", "Code",
    "JoinConfig", "JoinType", "JoinAlgorithm", "PJoinType", "PJoinAlgorithm",
]
