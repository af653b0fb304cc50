"""The join microbench's generator: the port's ``bench_join_cols`` and
``DATA_VERSION`` against the JAX package's, bit for bit.  Both packages'
numpy forms are equal, and the port's torch form equals them, for the
same seed, index and key range: contiguous global indices (the bench's
``np.arange``) and a strided window of them (one shard's rows)."""
import numpy as np
import pytest
import torch

from cylon_tpu.tpch import datagen_device as jdd

from cylon_tpu_torch.tpch import datagen_device as tdd

ROWS = 200_003
KRANGE = int(ROWS * 0.99)
SEEDS = [3, 3 + 7919, 2**31 + 5]
INDICES = {
    "contiguous": np.arange(ROWS, dtype=np.int32),
    "strided": np.arange(11, 7 * ROWS, 7, dtype=np.int32),
}
COLUMNS = ("k", "v0", "v1", "v2")
DTYPES = {"k": np.int32, "v0": np.float32, "v1": np.float32,
          "v2": np.float32}


def _bits(x):
    x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return x.view(np.uint32)


@pytest.mark.parametrize("idx", list(INDICES))
@pytest.mark.parametrize("seed", SEEDS)
def test_bench_join_cols_bit_equal(seed, idx):
    i = INDICES[idx]
    want = jdd.bench_join_cols(np, seed, i, KRANGE)
    got_np = tdd.bench_join_cols(np, seed, i, KRANGE)
    got_t = tdd.bench_join_cols(torch, seed, torch.from_numpy(i), KRANGE)
    assert tuple(want) == tuple(got_np) == tuple(got_t) == COLUMNS
    for c in COLUMNS:
        assert want[c].dtype == got_np[c].dtype == DTYPES[c]
        assert got_t[c].dtype == torch.from_numpy(want[c]).dtype
        np.testing.assert_array_equal(_bits(got_np[c]), _bits(want[c]), c)
        np.testing.assert_array_equal(_bits(got_t[c]), _bits(want[c]), c)
    k = got_np["k"]
    assert k.min() >= 0 and k.max() < KRANGE
    for c in ("v0", "v1", "v2"):
        assert got_np[c].min() >= 0.0 and got_np[c].max() < 1.0


def test_data_version_and_draw_tags_equal_jax():
    assert tdd.DATA_VERSION == jdd.DATA_VERSION == 1
    assert (tdd._T.BENCH_K, tdd._T.BENCH_V) == (jdd._T.BENCH_K,
                                                jdd._T.BENCH_V) == (60, 61)
    # every draw-site tag of the JAX package is the port's
    tags = {n: v for n, v in vars(jdd._T).items() if not n.startswith("_")}
    assert {n: getattr(tdd._T, n) for n in tags} == tags
