#!/usr/bin/env python
"""Distributed groupby-aggregate + sample-sort on the port's native API.

BASELINE configs 3 and 4 as a runnable demo: hash-shuffle groupby with
sum/mean/count, then a distributed sample-sort of the aggregate, printed
via dist_head (ORDER BY ... LIMIT), at world 8.  Usage:

    python groupby_sort_example.py [a.csv b.csv] [--device D]
"""
import sys
import time

from example_utils import device_arg, input_csvs

from cylon_tpu_torch import CylonContext
from cylon_tpu_torch import logging as glog
from cylon_tpu_torch.io import read_csv
from cylon_tpu_torch.parallel import DTable, dist_groupby, dist_head, dist_sort

WORLD = 8  # the reference tests' ranks


def main() -> int:
    device, argv = device_arg(sys.argv)
    path, _ = input_csvs(argv)
    ctx = CylonContext(device=device, world=WORLD)
    t = read_csv(ctx, path)
    dt = DTable.from_table(ctx, t)
    key, val = t.column_names[0], t.column_names[1]

    t0 = time.perf_counter()
    g = dist_groupby(dt, [key], [(val, "sum"), (val, "mean"), (key, "count")])
    glog.info("groupby: %d rows -> %d groups in %.1f [ms]", dt.num_rows,
              g.num_rows, (time.perf_counter() - t0) * 1e3)

    t0 = time.perf_counter()
    top = dist_head(dist_sort(g, f"sum_{val}", ascending=False), 5)
    glog.info("sample-sort + head in %.1f [ms]",
              (time.perf_counter() - t0) * 1e3)
    top.show()
    ctx.finalize()
    return 0


if __name__ == "__main__":
    sys.exit(main())
