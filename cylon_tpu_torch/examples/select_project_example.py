#!/usr/bin/env python
"""Select (row filter) and Project (column subset) on the port's native
API.

Mirrors cpp/src/examples/select_example.cpp + project_example.cpp: filter
rows of a CSV table by a predicate on column 0, then project two columns.
The predicate is a vectorized expression over named columns (torch
tensors) — the replacement for the reference's per-row lambda.  Usage:

    python select_project_example.py [a.csv b.csv] [--device D]
"""
import sys
import time

from example_utils import device_arg, input_csvs

from cylon_tpu_torch import CylonContext, compute
from cylon_tpu_torch import logging as glog
from cylon_tpu_torch.io import read_csv


def main() -> int:
    device, argv = device_arg(sys.argv)
    path, _ = input_csvs(argv)
    ctx = CylonContext(device=device)
    t = read_csv(ctx, path)

    t0 = time.perf_counter()
    key = t.column_names[0]
    selected = compute.select(t, lambda env: env[key] % 2 == 0)
    glog.info("Select kept %d of %d rows in %.1f [ms]", selected.num_rows,
              t.num_rows, (time.perf_counter() - t0) * 1e3)

    projected = selected.project([0, 1])
    glog.info("Projected to %d columns: %s", projected.num_columns,
              projected.column_names)
    projected.show(0, 5)
    ctx.finalize()
    return 0


if __name__ == "__main__":
    sys.exit(main())
