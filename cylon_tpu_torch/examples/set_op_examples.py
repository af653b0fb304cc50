#!/usr/bin/env python
"""Distributed union / intersect / subtract from CSV, on the port's
pycylon.

Mirrors cpp/src/examples/union_example.cpp, intersect_example.cpp,
subtract_example.cpp (one script, op selected by argv — the three
reference programs differ only in the operator line).  Usage:

    python set_op_examples.py [union|intersect|subtract] [a.csv b.csv]
                              [--device D]
"""
import sys
import time

from example_utils import device_arg, input_csvs

from cylon_tpu_torch import logging as glog
from cylon_tpu_torch.pycylon import CylonContext, csv_reader


def main() -> int:
    device, argv = device_arg(sys.argv)
    op = argv[1] if len(argv) > 1 else "union"
    a_path, b_path = input_csvs([argv[0]] + argv[2:])
    ctx = CylonContext("mpi", device=device)

    a = csv_reader.read(ctx, a_path, ",")
    b = csv_reader.read(ctx, b_path, ",")

    t0 = time.perf_counter()
    out = getattr(a, f"distributed_{op}")(ctx, b)
    glog.info("%s of %d and %d rows -> %d rows in %.1f [ms]", op,
              a.rows, b.rows, out.rows, (time.perf_counter() - t0) * 1e3)
    ctx.finalize()
    return 0


if __name__ == "__main__":
    sys.exit(main())
