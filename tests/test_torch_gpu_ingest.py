"""Ingest and the wide-key partition hash on the card: the chained
partition-hash kernel (more than 16 key columns) against its plain
version, the page-locked staging arena of ``StagedIngest`` (a copy queued
behind busy stream work, the arena reset only after the copies' event, a
concurrent ingest on page-locked one-off blocks), and ``append`` and the
Arrow / partition ingest on CUDA tensors against the same calls on the
CPU.  Every test here needs a CUDA device (``gpu`` marker) and skips
itself without one.  This file imports no JAX, so it also runs where JAX
is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu_ingest.py
"""
import threading

import numpy as np
import pyarrow as pa
import pytest
import torch

import cylon_tpu_torch as pt
from cylon_tpu_torch import strings as tstr
from cylon_tpu_torch.native import runtime as truntime
from cylon_tpu_torch.ops import hash as plain_hash
from cylon_tpu_torch.ops import hash_cuda
from cylon_tpu_torch.parallel import DTable, dist_join, dist_union
from cylon_tpu_torch.parallel import dtable as tdtable

from test_torch_common import port_rows


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _wide(rng, n, width, device):
    dts = (torch.int32, torch.float32, torch.int64)
    cols, vals = [], []
    for j in range(width):
        x = torch.from_numpy(rng.standard_normal(n) * 1e6)
        x = x.to(dts[j % 3]) if j % 3 != 1 else x.float()
        if j % 3 == 1:
            x[:3] = torch.tensor([float("nan"), -0.0, 0.0])
        cols.append(x.to(device))
        vals.append(torch.from_numpy(rng.random(n) < 0.9).to(device)
                    if j % 2 else None)
    return cols, vals


@pytest.mark.gpu
@pytest.mark.parametrize("width", [17, 24, 40])
def test_chained_kernel_matches_plain_on_card(card, width):
    rng = np.random.default_rng(width)
    cols, vals = _wide(rng, (1 << 18) + 17, width, card)
    groups = -(-width // hash_cuda.MAX_KEY_COLS)
    for nparts in (1, 3, 4, 16):
        before, chained = hash_cuda.launches, hash_cuda.launches_chained
        got = hash_cuda.partition_ids_fused(cols, vals, nparts)
        torch.cuda.synchronize()
        want = plain_hash.partition_ids(plain_hash.row_hash(cols, vals),
                                        nparts)
        assert got.dtype == torch.int32
        assert torch.equal(got, want)
        assert hash_cuda.launches - before == groups
        assert hash_cuda.launches_chained - chained == groups
    # 16 columns stay one launch of the single-pass entry
    before, chained = hash_cuda.launches, hash_cuda.launches_chained
    got = hash_cuda.partition_ids_fused(cols[:16], vals[:16], 4)
    assert torch.equal(got, plain_hash.partition_ids(
        plain_hash.row_hash(cols[:16], vals[:16]), 4))
    assert (hash_cuda.launches - before,
            hash_cuda.launches_chained - chained) == (1, 0)


def _arrow(seed, n):
    rng = np.random.default_rng(seed)
    return pa.table({
        "k": pa.array(rng.integers(0, n // 2 + 1, n, dtype=np.int32)),
        "v": pa.array(rng.random(n, dtype=np.float32),
                      mask=rng.random(n) < 0.1),
        "w": pa.array(rng.integers(-2**60, 2**60, n)),
        "s": pa.array(rng.choice(["ab", "cd", "é", "xyz"], n),
                      mask=rng.random(n) < 0.2),
    })


def _layout(dt):
    return (dt.cap, [int(x) for x in dt.counts_host()],
            [(c.name, c.data.cpu().numpy().tobytes(),
              None if c.validity is None else c.validity.cpu().numpy().tobytes(),
              None if c.dictionary is None else list(c.dictionary))
             for c in dt.columns])


@pytest.mark.gpu
def test_pinned_arena_ingest_behind_busy_stream(card, monkeypatch):
    """The copies run on the copy stream while the compute stream is busy
    for about 0.1 s; the consumer's stream waits on their event, the
    table reads back bit for bit, and the arena resets only once the
    event has completed."""
    seen = []
    real_reset = truntime.StagingArena.reset

    def reset(arena):
        seen.append(current["staged"].done is not None
                    and current["staged"].done.query())
        real_reset(arena)

    current = {}
    real_init = tdtable.StagedIngest.__init__

    def init(self, ctx, force_arena=False):
        real_init(self, ctx, force_arena)
        current["staged"] = self

    monkeypatch.setattr(truntime.StagingArena, "reset", reset)
    monkeypatch.setattr(tdtable.StagedIngest, "__init__", init)
    at = _arrow(1, 300_000)
    ctx = pt.CylonContext(device="cuda", world=4)
    torch.cuda._sleep(200_000_000)  # ~0.1 s of work on the current stream
    dt = DTable.from_arrow(ctx, at)
    assert current["staged"].one_off_blocks == 0
    assert tdtable._arena.pinned and tdtable._arena.bytes_in_use == 0
    assert seen == [True]
    want = DTable.from_arrow(pt.CylonContext(device="cpu", world=4), at)
    assert _layout(dt) == _layout(want)
    assert dt.to_table().to_arrow().equals(want.to_table().to_arrow())


@pytest.mark.gpu
def test_concurrent_ingest_gets_pinned_one_off_blocks(card):
    ctx = pt.CylonContext(device="cuda", world=2)
    first = tdtable.StagedIngest(ctx)
    got = {}

    def other():
        s = tdtable.StagedIngest(ctx)
        try:
            got["arena"] = s._arena
            got["t"] = s.put(np.arange(10, dtype=np.int64),
                             np.array([5, 5], np.int32),
                             np.array([0, 5, 10]), 8)
            got["pinned"] = [b.is_pinned() for b in s._sources]
        finally:
            s.finish()
        got["one_off"] = s.one_off_blocks

    try:
        assert first._arena is not None
        th = threading.Thread(target=other)
        th.start()
        th.join()
    finally:
        first.finish()
    assert got["arena"] is None and got["one_off"] == 1
    assert got["pinned"] == [True]
    assert got["t"].cpu().tolist() == [0, 1, 2, 3, 4, 0, 0, 0,
                                       5, 6, 7, 8, 9, 0, 0, 0]


@pytest.mark.gpu
def test_ingest_paths_and_append_on_card_match_cpu(card):
    """from_arrow, from_partitions and from_table on the card equal the
    CPU's layout; append on the card equals the CPU's append, keeps the
    handle and bumps the epoch; the HASH join of the grown table too."""
    gctx = pt.CylonContext(device="cuda", world=4)
    cctx = pt.CylonContext(device="cpu", world=4)
    at, delta = _arrow(2, 50_000), _arrow(3, 7_001)
    g, c = DTable.from_arrow(gctx, at), DTable.from_arrow(cctx, at)
    assert _layout(g) == _layout(c)
    parts = [at.slice(i * 9000, 9000 + i) for i in range(4)]
    assert _layout(DTable.from_partitions(gctx, [
        pt.Table.from_arrow(gctx, p) for p in parts])) == \
        _layout(DTable.from_partitions(cctx, [
            pt.Table.from_arrow(cctx, p) for p in parts]))
    assert _layout(DTable.from_table(gctx, pt.Table.from_arrow(gctx, at))) \
        == _layout(c)
    handle = g
    g.append(DTable.from_arrow(gctx, delta))
    c.append(DTable.from_arrow(cctx, delta))
    assert g is handle and g.content_epoch == 1
    assert g.delta_for(1).num_rows == 7_001
    assert _layout(g) == _layout(c)
    g.spill()
    g.append(DTable.from_arrow(gctx, delta))
    c.append(DTable.from_arrow(cctx, delta))
    assert not g.is_spilled and _layout(g) == _layout(c)
    cfg = pt.JoinConfig(pt.JoinType.INNER, pt.JoinAlgorithm.HASH, 0, 0)
    got = dist_join(g, DTable.from_arrow(gctx, delta), cfg)
    want = dist_join(c, DTable.from_arrow(cctx, delta), cfg)
    assert port_rows(got) == port_rows(want)


@pytest.mark.gpu
def test_hash64_lanes_and_wide_union_on_card_match_cpu(card):
    """A 17-key-column union (15 numeric columns + a hashed string's two
    lanes) launches the chained kernel and equals the CPU's rows."""
    rng = np.random.default_rng(4)
    cols = {f"c{j}": rng.integers(0, 3, 5000).astype(np.int32)
            for j in range(15)}
    import pandas as pd
    df = pd.DataFrame(cols)
    df["name"] = rng.choice(np.array(["ann", "bob", "cyd"], object), 5000)
    enc, _ = tstr.encode_frame(df, ["name"])
    outs = []
    for dev in ("cuda", "cpu"):
        ctx = pt.CylonContext(device=dev, world=4)
        a = DTable.from_pandas(ctx, enc)
        b = DTable.from_pandas(ctx, enc.iloc[::3].reset_index(drop=True))
        before = hash_cuda.launches_chained
        outs.append(dist_union(a, b))
        if dev == "cuda":
            assert hash_cuda.launches_chained - before == 4  # 2 per side
    assert port_rows(outs[0]) == port_rows(outs[1])
    assert outs[0].num_rows == len(df.drop_duplicates())
