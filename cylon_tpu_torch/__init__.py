"""cylon_tpu_torch — the distributed dataframe engine on PyTorch and CUDA.

The port of ``cylon_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA GPU.
Columns live in device memory as torch tensors; a distributed table keeps
P row shards, and every collective goes through the context's
communicator.  The hot-path kernel (the hash shuffle's partition id) is a
CUDA kernel built from ``csrc/`` on first use; every other operator is
plain torch.  The package imports neither JAX nor ``cylon_tpu``.

Layer map:

    table.py, row.py  Table / Column (host copies, with_data) and Row
    compute.py        local join, set ops, sort, select, hash and
                      round-robin partition, merge, groupby
    io/               CSV read (a thread per file) and write, via pyarrow
    strings.py        hash64 string keys: two int32 lanes per string, the
                      payloads in a host StringStore
    native/           host runtime: dictionary encode, murmur3 of byte
                      strings, the staging arena of the ingest path
    parallel/         DTable (ingest from Arrow / pandas / partitions
                      through StagedIngest, append with content epochs,
                      the deferred-select mask), the
                      all_to_all shuffle, dist_join (SORT and HASH; the
                      broadcast join and the dense FK join),
                      dist_semi_join / dist_anti_join,
                      dist_sort / dist_sort_multi / dist_head,
                      dist_union / dist_intersect / dist_subtract,
                      dist_select / dist_project / dist_with_column,
                      dist_groupby (pre-aggregation, broadcast and shuffle
                      combine, dense keys) / dist_aggregate;
                      broadcast.py: replicate_table + replica cache
    serve/            multi-query serving: the admission queue and batch
                      windows, cross-query subplan sharing, the async
                      export lane, the circuit breaker and load shedding,
                      materialized views with O(delta) folds, and the
                      fleet router over disjoint slot ranges
    plan/             the logical planner behind ``ctx.optimize``: lazy
                      capture (ir), rewrite rules, lowering + plan cache
                      and the recovery driver (executor)
    analysis/         plan_check: the capture hook on every dist op and
                      the plan nodes EXPLAIN ANALYZE annotates
    trace.py          phase spans (off by default; on, they synchronize
                      the card), named counters, tail sampling, export
    logging.py        glog-style lines, ``vlog``, ``warn_once``
    observe/          metrics catalogue + registry, histograms, ordered
                      locks, devmem, build events, the run-stats store,
                      the flight recorder + doctor, EXPLAIN ANALYZE,
                      the OpenMetrics exporter and event log, the
                      time-series sampler
    tpch/             the TPC-H generator (on the device, with a numpy
                      mirror) and all 22 queries
    ops/              hash (plain + CUDA), compaction, gathers, join, sort,
                      set-op and groupby kernels
    config.py         JoinConfig, the broadcast threshold, memory budget,
                      the optimizer switch, the plan-cache capacity, the
                      recovery switch
    faults.py         named fault points + seeded fault plans
    resilience.py     budget reads, bounded retry, failure classes, the
                      recovery ladder's decisions and exchange demotions
    topology.py       the survivor-context registry (device loss and
                      rejoin) and the (slow, fast) mesh split
    context.py        CylonContext: device, world (from ``first_slot``),
                      communicator (one process, or a torch.distributed
                      group through ``InitMultiHost``), the controller
                      API, optimize, analyze
"""

from . import faults
from .config import JoinAlgorithm, JoinConfig, JoinType
from .context import CylonContext
from .dtypes import DataType, Layout, Type
from .row import Row
from .status import Code, CylonError, Status
from .table import Column, Table

__version__ = "0.1.0"

# CYLON_CHAOS=<seed>: run the process under the seeded default fault plan
faults.install_chaos_from_env()

__all__ = [
    "CylonContext", "Table", "Column", "Row", "Status", "Code", "CylonError",
    "DataType", "Type", "Layout", "JoinConfig", "JoinType", "JoinAlgorithm",
    "__version__",
]
