"""Shared bits for the port's example scripts.

Mirrors the reference examples' setup (reference:
cpp/src/examples/test_utils.hpp, experiments/generate_csv.py) and the JAX
package's ``examples/example_utils.py``: a small seeded CSV generator with
the scaling-run column shape (int key with ~1% duplicates + value
columns), an arg helper that generates inputs on the fly when the caller
doesn't pass CSV paths — so every example runs with no arguments — and
``--device`` (the card unless the caller names another).
"""
from __future__ import annotations

import argparse
import atexit
import os
import shutil
import sys
import tempfile

import numpy as np

# the repository root, so ``cylon_tpu_torch`` imports from a checkout
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def device_arg(argv):
    """(device, argv without ``--device D``): the device the example runs
    on — None, the card, unless ``--device`` names another."""
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--device", default=None)
    ns, rest = ap.parse_known_args(argv[1:])
    return ns.device, [argv[0]] + rest


def temp_dir(prefix: str) -> str:
    """A fresh temporary directory, removed when the example exits."""
    d = tempfile.mkdtemp(prefix=prefix)
    atexit.register(shutil.rmtree, d, ignore_errors=True)
    return d


def generate_csv(path: str, rows: int, seed: int, dup_ratio: float = 0.99,
                 cols: int = 4) -> str:
    """4-column CSV in the scaling protocol's shape (reference:
    cpp/src/experiments/generate_csv.py, generate_files.py:30,49)."""
    rng = np.random.default_rng(seed)
    krange = max(int(rows * dup_ratio), 1)
    data = {"0": rng.integers(0, krange, rows)}
    for i in range(1, cols):
        data[str(i)] = np.round(rng.random(rows), 6)
    header = ",".join(data)
    body = np.column_stack([v.astype(str) for v in data.values()])
    with open(path, "w") as f:
        f.write(header + "\n")
        for row in body:
            f.write(",".join(row) + "\n")
    return path


def input_csvs(argv, rows: int = 5000):
    """(left_path, right_path) from argv, generating temp files if absent."""
    if len(argv) >= 3:
        return argv[1], argv[2]
    d = temp_dir("cylon_example_")
    return (generate_csv(os.path.join(d, "csv1_0.csv"), rows, seed=1),
            generate_csv(os.path.join(d, "csv2_0.csv"), rows, seed=2))
