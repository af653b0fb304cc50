#!/usr/bin/env python
"""MNIST-shaped sequential training through the port's pycylon data path.

Mirrors the reference's python/examples/cylon_sequential_mnist.py flow —
CSV → pycylon Table → numpy → minibatches → a torch sequential net — with
two deviations (both as in the JAX package's example): the dataset is
generated on the fly (the reference expects the Kaggle CSV under
~/data/mnist/), and training runs a couple of quick epochs so the example
doubles as a test.  The net trains on the context's device.  Usage:

    python cylon_mnist_example.py [--device D]
"""
from __future__ import annotations

import os
import sys

import numpy as np
import torch
from example_utils import device_arg, temp_dir

from cylon_tpu_torch import logging as glog
from cylon_tpu_torch.pycylon import CylonContext, csv_reader
from cylon_tpu_torch.pycylon.util.FileUtils import files_exist
from cylon_tpu_torch.pycylon.util.data import MiniBatcher

IMG = 28
PIXELS = IMG * IMG


def generate_mnist_csv(path: str, rows: int, seed: int) -> str:
    """label + 784 pixel columns, digits drawn as class-dependent blobs so
    a linear model can actually learn (pure noise would train to chance)."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, rows)
    # each class lights up a distinct 78-pixel band plus noise
    pix = rng.random((rows, PIXELS)).astype(np.float32) * 0.3
    band = PIXELS // 10
    for c in range(10):
        sel = labels == c
        pix[np.ix_(sel, range(c * band, (c + 1) * band))] += 0.7
    data = np.column_stack([labels[:, None], np.round(pix, 4)])
    with open(path, "w") as f:
        f.write(",".join(["label"] + [f"p{i}" for i in range(PIXELS)])
                + "\n")
        for row in data:
            f.write(str(int(row[0])) + ","
                    + ",".join(f"{v:.4f}" for v in row[1:]) + "\n")
    return path


def main() -> int:
    device, _ = device_arg(sys.argv)
    d = temp_dir("cylon_mnist_")
    train_path = generate_mnist_csv(os.path.join(d, "mnist_train.csv"),
                                    rows=512, seed=3)
    test_path = generate_mnist_csv(os.path.join(d, "mnist_test.csv"),
                                   rows=128, seed=4)
    files_exist(d, [os.path.basename(train_path),
                    os.path.basename(test_path)])

    ctx = CylonContext("mpi", device=device)
    dev = ctx.device
    tb_train = csv_reader.read(ctx, train_path, ",")
    tb_test = csv_reader.read(ctx, test_path, ",")
    glog.info("train %d x %d, test %d x %d", tb_train.rows,
              tb_train.columns, tb_test.rows, tb_test.columns)

    train_npy = tb_train.to_pandas().to_numpy(dtype="float32")
    test_npy = tb_test.to_pandas().to_numpy(dtype="float32")

    train_x = MiniBatcher.generate_minibatches(train_npy[:, 1:], 64)
    train_y = MiniBatcher.generate_minibatches(train_npy[:, :1], 64)

    torch.manual_seed(0)
    model = torch.nn.Sequential(
        torch.nn.Linear(PIXELS, 32), torch.nn.ReLU(),
        torch.nn.Linear(32, 10)).to(dev)
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    loss_fn = torch.nn.CrossEntropyLoss()

    first = last = None
    for epoch in range(3):
        total = 0.0
        for xb, yb in zip(train_x, train_y):
            x = torch.from_numpy(np.ascontiguousarray(xb)).to(dev)
            y = torch.from_numpy(np.ascontiguousarray(yb[:, 0])).long().to(dev)
            opt.zero_grad()
            loss = loss_fn(model(x), y)
            loss.backward()
            opt.step()
            total += float(loss)
        mean = total / max(len(train_x), 1)
        first = mean if first is None else first
        last = mean
        glog.info("epoch %d loss %.4f", epoch, mean)

    with torch.no_grad():
        x = torch.from_numpy(test_npy[:, 1:]).to(dev)
        pred = model(x).argmax(dim=1).cpu().numpy()  # graftlint: ok[implicit-host-sync]
        acc = float((pred == test_npy[:, 0].astype(np.int64)).mean())
    glog.info("test accuracy %.3f", acc)
    assert last < first, "loss did not decrease"
    assert acc > 0.5, f"model failed to learn (acc={acc})"
    print(f"OK mnist: loss {first:.3f} -> {last:.3f}, acc {acc:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
