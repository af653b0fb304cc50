"""pycylon.util.data.DataManager over the port — DL data-feeding
utilities.

reference: python/pycylon/util/data/DataManager.py:32-169 — CSV→arrow
loaders plus minibatching helpers for feeding PyTorch from tables.  The
distributed loader here reads one file per rank and yields the port's
sharded DTable (the reference's per-rank-file convention,
examples/bench/table_join_dist_test.cpp:87-91).  Device tables live on
the loader's context's device: the card unless that context names
another.
"""
from __future__ import annotations

import math
import os
from typing import List, Optional, Sequence

import numpy as np


class Partition:
    """A view of ``data`` restricted to ``index`` (torch Dataset-shaped)."""

    def __init__(self, data, index: Sequence[int]):
        self.data = data
        self.index = list(index)

    def __len__(self) -> int:
        return len(self.index)

    def __getitem__(self, i: int):
        return self.data[self.index[i]]


class DataLoader:
    """Base loader: a directory of CSV files → a list of tables."""

    def __init__(self, source_dir: Optional[str] = None,
                 source_files: Optional[List[str]] = None,
                 file_type: str = "csv", loader_type: str = "arrow",
                 delimiter: str = ","):
        if source_dir is not None and not os.path.isdir(source_dir):
            raise FileNotFoundError(source_dir)
        self.source_dir = source_dir
        self.source_files = source_files or []
        self.file_type = file_type
        self.loader_type = loader_type
        self.delimiter = delimiter
        self._dataset: Optional[List] = None

    @property
    def dataset(self) -> List:
        if self._dataset is None:
            raise RuntimeError("load() not called")
        return self._dataset

    def _paths(self) -> List[str]:
        if self.source_dir is None:
            return list(self.source_files)
        return [os.path.join(self.source_dir, f) for f in self.source_files]

    def load(self):
        raise NotImplementedError


class LocalDataLoader(DataLoader):
    """Loads each file into a host pyarrow table (``loader_type='arrow'``)
    or a device Table (``loader_type='table'``, on ``ctx``: a local
    context on the card by default)."""

    def __init__(self, ctx=None, **kw):
        super().__init__(**kw)
        self.ctx = ctx

    def load(self):
        if self.loader_type == "arrow":
            from pyarrow import csv as pacsv

            self._dataset = [pacsv.read_csv(p) for p in self._paths()]
        elif self.loader_type == "table":
            from ....io import CSVReadOptions, read_csv_many
            from ...ctx.context import CylonContext

            ctx = self.ctx or CylonContext(None)
            opts = CSVReadOptions().WithDelimiter(self.delimiter)
            self._dataset = read_csv_many(ctx, self._paths(), opts)
        else:
            raise NotImplementedError(
                f"loader_type {self.loader_type!r} not supported")
        return self._dataset


class DistributedDataLoader(DataLoader):
    """One file per rank → a sharded DTable.

    The reference's DistributedDataLoader is an empty stub
    (DataManager.py:127); this one does what the C++ benchmarks do by hand
    (read ``csv1_<rank>.csv`` per rank).
    """

    def __init__(self, ctx=None, **kw):
        super().__init__(**kw)
        self.ctx = ctx

    def load(self):
        from ....io import CSVReadOptions, read_csv_many
        from ....parallel import DTable
        from ...ctx.context import CylonContext

        ctx = self.ctx or CylonContext("tpu")
        paths = self._paths()
        if len(paths) != ctx.get_world_size():
            raise ValueError(f"{len(paths)} files for a "
                             f"{ctx.get_world_size()}-rank world")
        opts = CSVReadOptions().WithDelimiter(self.delimiter)
        parts = read_csv_many(ctx, paths, opts)
        self._dataset = [DTable.from_partitions(ctx, parts)]
        return self._dataset


class MiniBatcher:
    """Static minibatch reshaper (reference DataManager.py:130-169): pads
    the ragged tail batch by re-using rows from the head so every batch has
    exactly ``minibatch_size`` rows."""

    @staticmethod
    def generate_minibatches(data: np.ndarray, minibatch_size: int = 1
                             ) -> np.ndarray:
        n, width = data.shape
        if n == 0:
            return data.reshape(0, minibatch_size, width)
        num_batches = math.ceil(n / float(minibatch_size))
        full = (num_batches - 1) * minibatch_size
        rem = n - full
        if rem == minibatch_size:  # exactly divisible: zero-copy reshape
            return data.reshape(num_batches, minibatch_size, width)
        body = data[:full].reshape(num_batches - 1, minibatch_size, width)
        # head rows fill the short tail, cycling when n < fill size
        fill = np.resize(data, (minibatch_size - rem, width))
        tail = np.concatenate([data[full:], fill])[None]
        return np.concatenate([body, tail], axis=0)
