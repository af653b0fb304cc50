"""Partition hash parity: the port's plain murmur3 chain (ops/hash.py) and
its kernel wrapper (ops/hash_cuda.py) against the JAX package's jnp chain
and its Pallas kernel (run in interpret mode).  Hashes and partition ids
must be equal exactly.  The CUDA kernel itself is held to the plain
version on a card by tests/test_torch_gpu.py."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cylon_tpu.ops import hash as jh
from cylon_tpu.ops.hash_pallas import partition_ids_fused as jax_fused

from cylon_tpu_torch import CylonError
from cylon_tpu_torch.ops import hash as th
from cylon_tpu_torch.ops import hash_cuda

N = 4096 + 17  # off-block tail, as the JAX package's Pallas tests use

DTYPES = ["int8", "int16", "int32", "int64", "uint8", "uint16", "uint32",
          "uint64", "bool", "float16", "float32", "float64"]


def _column(rng, dtype: str, n: int = N) -> np.ndarray:
    dt = np.dtype(dtype)
    if dt == np.bool_:
        return rng.random(n) < 0.5
    if dt.kind in "iu":
        info = np.iinfo(dt)
        return rng.integers(info.min, info.max, n, dtype=dt, endpoint=True)
    x = (rng.standard_normal(n) * 1e3).astype(dt)
    x[:8] = np.array([np.nan, -0.0, 0.0, np.inf, -np.inf, 1.0, -1.0,
                      np.finfo(dt).tiny / 4], dtype=dt)  # incl. a subnormal
    return x


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("dtype", DTYPES)
def test_murmur3_matches_jax(dtype):
    x = _column(np.random.default_rng(1), dtype)
    want = np.asarray(jh.murmur3_32(jnp.asarray(x)))
    got = th.murmur3_32(_t(x)).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("nparts", [1, 7, 16])
def test_partition_ids_match_jax_and_pallas(dtype, nparts):
    """Two key columns (the second nullable) → row hash → % P, through the
    port's plain chain and its wrapper on CPU tensors, against the jnp
    chain and the Pallas kernel in interpret mode."""
    rng = np.random.default_rng(2)
    k1 = _column(rng, dtype)
    k2 = rng.integers(-2**62, 2**62, N, dtype=np.int64)
    v2 = rng.random(N) < 0.8
    jcols = (jnp.asarray(k1), jnp.asarray(k2))
    jval = (None, jnp.asarray(v2))
    want_h = np.asarray(jh.row_hash(jcols, jval))
    want = np.asarray(jh.partition_ids(jh.row_hash(jcols, jval), nparts))
    pallas = np.asarray(jax_fused(jcols, jval, nparts, interpret=True))
    np.testing.assert_array_equal(pallas, want)

    tcols = (_t(k1), _t(k2))
    tval = (None, _t(v2))
    np.testing.assert_array_equal(th.row_hash(tcols, tval).numpy(),
                                  want_h.astype(np.int64))
    plain = th.partition_ids(th.row_hash(tcols, tval), nparts)
    assert plain.dtype == torch.int32
    np.testing.assert_array_equal(plain.numpy(), want)
    before = hash_cuda.launches
    np.testing.assert_array_equal(
        hash_cuda.partition_ids_fused(tcols, tval, nparts).numpy(), want)
    assert hash_cuda.launches == before  # CPU tensors never launch


def test_nulls_hash_to_zero_and_multicolumn_combine():
    rng = np.random.default_rng(3)
    cols = [rng.integers(0, 50, N).astype(np.int32),
            rng.random(N).astype(np.float64),
            rng.integers(-5, 5, N).astype(np.int16)]
    valids = [rng.random(N) < 0.7, None, rng.random(N) < 0.5]
    jv = [None if v is None else jnp.asarray(v) for v in valids]
    tv = [None if v is None else _t(v) for v in valids]
    want = np.asarray(jh.row_hash([jnp.asarray(c) for c in cols], jv))
    got = th.row_hash([_t(c) for c in cols], tv).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))
    ch = th.column_hash(_t(cols[0]), tv[0]).numpy()
    assert (ch[~valids[0]] == 0).all()


def test_wrapper_rejects_bad_inputs():
    a = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(CylonError):
        hash_cuda.partition_ids_fused((a, torch.zeros(7, dtype=torch.int32)),
                                      (None, None), 4)
    # more than 16 key columns is no bad input: the plain path takes any k
    wide = (torch.arange(8, dtype=torch.int32),) * 17
    assert torch.equal(hash_cuda.partition_ids_fused(wide, (None,) * 17, 4),
                       th.partition_ids(th.row_hash(wide, (None,) * 17), 4))
    with pytest.raises(CylonError):
        hash_cuda.partition_ids_fused((a,), (torch.ones(8, dtype=torch.int8),), 4)
    with pytest.raises(CylonError):
        hash_cuda.partition_ids_fused((a,), (None,), 0)
