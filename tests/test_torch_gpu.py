"""The PyTorch port on the card: the CUDA partition-hash kernel against its
plain version, and the distributed join (HASH and SORT), sort and set ops
on CUDA tensors against the same calls on the CPU.  Every test here needs a CUDA device (``gpu`` marker) and
skips itself without one.  This file imports no JAX, so it also runs where
JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

import cylon_tpu_torch as pt
from cylon_tpu_torch.ops import hash as plain_hash
from cylon_tpu_torch.ops import hash_cuda
from cylon_tpu_torch.parallel import (DTable, dist_intersect, dist_join,
                                      dist_sort, dist_subtract, dist_union)

from test_torch_common import port_rows

DTYPES = [torch.int8, torch.int16, torch.int32, torch.int64, torch.uint8,
          torch.uint16, torch.uint32, torch.uint64, torch.bool,
          torch.float16, torch.float32, torch.float64]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _column(rng, dtype, n):
    if dtype == torch.bool:
        return torch.from_numpy(rng.random(n) < 0.5)
    if dtype.is_floating_point:
        x = torch.from_numpy(rng.standard_normal(n) * 1e3).to(dtype)
        x[:5] = torch.tensor([float("nan"), -0.0, 0.0, float("inf"), 1e-40])
        return x
    return torch.from_numpy(rng.integers(-2**63, 2**63 - 1, n, dtype=np.int64,
                                         endpoint=True)).to(dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_kernel_matches_plain_on_card(card, dtype):
    """Bit for bit, with a nullable second column, nparts 1/7/16, on an
    odd row count."""
    rng = np.random.default_rng(40)
    n = (1 << 20) + 17
    k1 = _column(rng, dtype, n).to(card)
    k2 = torch.from_numpy(rng.integers(-2**62, 2**62, n)).to(card)
    v2 = torch.from_numpy(rng.random(n) < 0.8).to(card)
    for nparts in (1, 7, 16):
        want = plain_hash.partition_ids(plain_hash.row_hash((k1, k2), (None, v2)),
                                        nparts)
        before = hash_cuda.launches
        got = hash_cuda.partition_ids_fused((k1, k2), (None, v2), nparts)
        torch.cuda.synchronize()
        assert hash_cuda.launches == before + 1
        assert torch.equal(got, want)


@pytest.mark.gpu
def test_kernel_rejects_non_contiguous(card):
    x = torch.zeros(16, dtype=torch.int32, device=card)[::2]
    with pytest.raises(pt.CylonError):
        hash_cuda.partition_ids_fused((x,), (None,), 4)


@pytest.mark.gpu
@pytest.mark.parametrize("how", ["inner", "left", "right", "full_outer"])
def test_dist_join_on_card_matches_cpu(card, how):
    """World 4 on the card (kernel partitioning) vs world 4 on the CPU
    (plain partitioning): the same rows on the same shards, in order."""
    rng = np.random.default_rng(41)
    data_l = {"k": rng.integers(0, 500, 3000).astype(np.int64),
              "v": rng.random(3000).astype(np.float32)}
    data_r = {"k": rng.integers(0, 500, 2000).astype(np.int64),
              "w": rng.integers(-9, 9, 2000).astype(np.int32)}
    cfg = pt.JoinConfig(pt.JoinType(how), pt.JoinAlgorithm.HASH, 0, 0)
    outs = []
    for device in ("cpu", "cuda"):
        ctx = pt.CylonContext(device=device, world=4)
        lt = DTable.from_table(ctx, pt.Table.from_columns(ctx, data_l))
        rt = DTable.from_table(ctx, pt.Table.from_columns(ctx, data_r))
        before = hash_cuda.launches
        outs.append(dist_join(lt, rt, cfg))
        assert hash_cuda.launches - before == (2 if device == "cuda" else 0)
    cpu, gpu = outs
    assert gpu.cap == cpu.cap
    assert port_rows(gpu, ordered=True) == port_rows(cpu, ordered=True)


def _sides(rng):
    data_l = {"k": rng.integers(0, 500, 3000).astype(np.int64),
              "v": rng.random(3000).astype(np.float32)}
    data_r = {"k": rng.integers(0, 500, 2000).astype(np.int64),
              "w": rng.integers(-9, 9, 2000).astype(np.int32)}
    return data_l, data_r


@pytest.mark.gpu
@pytest.mark.parametrize("how", ["inner", "left", "right", "full_outer"])
def test_dist_join_sort_on_card_matches_cpu(card, how):
    """SORT (range partitioning, no kernel launch) at world 4: the same
    rows on the same shards, in order, on the card as on the CPU."""
    data_l, data_r = _sides(np.random.default_rng(42))
    cfg = pt.JoinConfig(pt.JoinType(how), pt.JoinAlgorithm.SORT, 0, 0)
    outs = []
    for device in ("cpu", "cuda"):
        ctx = pt.CylonContext(device=device, world=4)
        lt = DTable.from_table(ctx, pt.Table.from_columns(ctx, data_l))
        rt = DTable.from_table(ctx, pt.Table.from_columns(ctx, data_r))
        before = hash_cuda.launches
        outs.append(dist_join(lt, rt, cfg))
        assert hash_cuda.launches == before
    cpu, gpu = outs
    assert gpu.cap == cpu.cap
    assert port_rows(gpu, ordered=True) == port_rows(cpu, ordered=True)


@pytest.mark.gpu
@pytest.mark.parametrize("ascending", [True, False])
def test_dist_sort_on_card_matches_cpu(card, ascending):
    rng = np.random.default_rng(43)
    k = rng.standard_normal(5000)
    k[rng.random(5000) < 0.3] = np.nan
    data = {"k": k, "v": np.arange(5000, dtype=np.int32)}
    outs = []
    for device in ("cpu", "cuda"):
        ctx = pt.CylonContext(device=device, world=4)
        t = DTable.from_table(ctx, pt.Table.from_columns(ctx, data))
        outs.append(dist_sort(t, "k", ascending))
    cpu, gpu = outs
    assert gpu.cap == cpu.cap
    assert port_rows(gpu, ordered=True) == port_rows(cpu, ordered=True)


@pytest.mark.gpu
@pytest.mark.parametrize("op", [dist_union, dist_intersect, dist_subtract])
def test_dist_set_op_on_card_matches_cpu(card, op):
    """World 4: the kernel partitions every column of both tables (two
    launches), and the result equals the CPU's shard for shard."""
    rng = np.random.default_rng(44)
    a = {"k": rng.integers(0, 50, 3000).astype(np.int64),
         "f": rng.integers(0, 4, 3000).astype(np.float32)}
    b = {"k": np.concatenate([a["k"][:1000], rng.integers(0, 80, 1500)]),
         "f": np.concatenate([a["f"][:1000],
                              rng.integers(0, 4, 1500).astype(np.float32)])}
    outs = []
    for device in ("cpu", "cuda"):
        ctx = pt.CylonContext(device=device, world=4)
        ta = DTable.from_table(ctx, pt.Table.from_columns(ctx, a))
        tb = DTable.from_table(ctx, pt.Table.from_columns(ctx, b))
        before = hash_cuda.launches
        outs.append(op(ta, tb))
        assert hash_cuda.launches - before == (2 if device == "cuda" else 0)
    cpu, gpu = outs
    assert gpu.cap == cpu.cap
    assert port_rows(gpu, ordered=True) == port_rows(cpu, ordered=True)
