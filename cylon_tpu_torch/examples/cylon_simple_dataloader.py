#!/usr/bin/env python
"""pycylon table -> numpy -> torch minibatches, on the port's pycylon.

Mirrors the reference's python/examples/cylon_simple_dataloader.py: load a
CSV through pycylon, convert to numpy via pandas, and feed a torch model's
forward pass in minibatches via pycylon.util.data.MiniBatcher.  The model
runs on the context's device.  Usage:

    python cylon_simple_dataloader.py [a.csv b.csv] [--device D]
"""
import sys

import torch
from example_utils import device_arg, input_csvs

from cylon_tpu_torch import logging as glog
from cylon_tpu_torch.pycylon import CylonContext, csv_reader
from cylon_tpu_torch.pycylon.util.data import MiniBatcher


def main() -> int:
    device, argv = device_arg(sys.argv)
    path, _ = input_csvs(argv, rows=512)
    ctx = CylonContext("mpi", device=device)
    tb = csv_reader.read(ctx, path, ",")
    glog.info("loaded %d rows x %d cols", tb.rows, tb.columns)

    data = tb.to_pandas().to_numpy(dtype="float32")
    batches = MiniBatcher.generate_minibatches(data, 64)
    glog.info("minibatches: %s", str(batches.shape))

    torch.manual_seed(0)
    model = torch.nn.Sequential(
        torch.nn.Linear(data.shape[1], 8), torch.nn.ReLU(),
        torch.nn.Linear(8, 1)).to(ctx.device)
    total = 0.0
    with torch.no_grad():
        for b in batches:
            total += float(model(torch.from_numpy(b).to(ctx.device)).sum())
    glog.info("forward pass over %d batches ok (sum=%.4f)",
              len(batches), total)
    ctx.finalize()
    return 0


if __name__ == "__main__":
    sys.exit(main())
