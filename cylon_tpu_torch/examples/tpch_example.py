#!/usr/bin/env python
"""TPC-H end to end on the port: generate SF-0.01 data on the device, run
every query.

The JAX package's example generates the tables on the host with pandas;
the port's generator (``tpch.generate_device``) computes them on the
context's device, at world 8.  Usage:

    python tpch_example.py [scale_factor] [--device D]
"""
import sys
import time

from example_utils import device_arg

from cylon_tpu_torch import CylonContext
from cylon_tpu_torch import logging as glog
from cylon_tpu_torch.tpch import QUERIES, generate_device

WORLD = 8  # the reference tests' ranks


def main() -> int:
    device, argv = device_arg(sys.argv)
    sf = float(argv[1]) if len(argv) > 1 else 0.01
    ctx = CylonContext(device=device, world=WORLD)

    t0 = time.perf_counter()
    dts = generate_device(ctx, sf, seed=42)
    glog.info("generated + ingested SF=%g (%d lineitems) in %.1f [ms]", sf,
              dts["lineitem"].num_rows, (time.perf_counter() - t0) * 1e3)

    for name, q in QUERIES.items():
        t0 = time.perf_counter()
        out = q(ctx, dts)
        glog.info("%s: %d rows in %.1f [ms]", name, out.num_rows,
                  (time.perf_counter() - t0) * 1e3)
        out.show(0, 5)
    ctx.finalize()
    return 0


if __name__ == "__main__":
    sys.exit(main())
