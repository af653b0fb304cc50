#!/usr/bin/env python
"""TPC-H end to end on the port: generate SF-0.01 data on the host, ingest
it at world 8, run every query.

As the JAX package's example does, the tables are the host generator's
pandas frames (``tpch.generate``), ingested with ``DTable.from_pandas``
on the context's device.  Usage:

    python tpch_example.py [scale_factor] [--device D]
"""
import sys
import time

from example_utils import device_arg

from cylon_tpu_torch import CylonContext
from cylon_tpu_torch import logging as glog
from cylon_tpu_torch.parallel import DTable
from cylon_tpu_torch.tpch import QUERIES, generate

WORLD = 8  # the reference tests' ranks


def main() -> int:
    device, argv = device_arg(sys.argv)
    sf = float(argv[1]) if len(argv) > 1 else 0.01
    ctx = CylonContext(device=device, world=WORLD)

    t0 = time.perf_counter()
    data = generate(sf, seed=42)
    dts = {name: DTable.from_pandas(ctx, df) for name, df in data.items()}
    glog.info("generated + ingested SF=%g (%d lineitems) in %.1f [ms]", sf,
              len(data["lineitem"]), (time.perf_counter() - t0) * 1e3)

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
