#!/usr/bin/env python
"""Distributed join from CSV — the reference's flagship example, on the
port's pycylon.

Mirrors cpp/src/examples/join_example.cpp:21-80: read two CSVs, inner
DistributedJoin on column 0, log read/join timings.  Usage:

    python join_example.py [left.csv right.csv] [--device D]

With no CSV arguments, inputs are generated (scaling-protocol shape).
"""
import sys
import time

from example_utils import device_arg, input_csvs

from cylon_tpu_torch import logging as glog
from cylon_tpu_torch.pycylon import CylonContext, csv_reader


def main() -> int:
    device, argv = device_arg(sys.argv)
    left_path, right_path = input_csvs(argv)
    ctx = CylonContext("mpi", device=device)

    t0 = time.perf_counter()
    first = csv_reader.read(ctx, left_path, ",")
    second = csv_reader.read(ctx, right_path, ",")
    glog.info("Read tables in %.1f [ms]", (time.perf_counter() - t0) * 1e3)

    t0 = time.perf_counter()
    joined = first.distributed_join(
        ctx, table=second, join_type="inner", algorithm="hash",
        left_col=0, right_col=0)
    glog.info("First table had: %d and Second table had: %d rows",
              first.rows, second.rows)
    glog.info("Joined has: %d rows, join done in %.1f [ms]",
              joined.rows, (time.perf_counter() - t0) * 1e3)
    ctx.finalize()
    return 0


if __name__ == "__main__":
    sys.exit(main())
