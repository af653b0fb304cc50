"""The port's ``pycylon.net`` and ``pycylon.util`` against the JAX
package's on the same seeded inputs: the raw AllToAll (``Communication``)
at world 1 and world 8 (the same inserts give the same ``received``
lists on every rank), its refusal across processes, ``TxRequest``'s
header cap, ``dist_init`` / ``dist_finalize``, ``MiniBatcher``, the local
and distributed data loaders and ``benchmark_with_repitions``."""
import types

import numpy as np
import pandas as pd
import pytest
import torch

import cylon_tpu_torch.pycylon as tpc
from cylon_tpu_torch.pycylon.net import Communication, TxRequest
from cylon_tpu_torch.pycylon.net import dist as tdist
from cylon_tpu_torch.pycylon.util import benchmark_with_repitions
from cylon_tpu_torch.pycylon.util.data import (DistributedDataLoader,
                                               LocalDataLoader, MiniBatcher)
from cylon_tpu_torch.status import Code as TCode
from cylon_tpu_torch.status import CylonError as TCylonError

from test_torch_common import (assert_rows_close, float_rtols, jax_rows,
                               jax_trace_shim, port_rows, schema)  # noqa: F401


def jax_dctx(world):
    from pycylon import CylonContext
    from tests.conftest import CPU_DEVICES

    return CylonContext({"backend": "mpi", "devices": CPU_DEVICES[:world]})


def port_dctx(world):
    return tpc.CylonContext("mpi", device="cpu", world=world)


# ---------------------------------------------------------------------------
# Communication: the raw AllToAll
# ---------------------------------------------------------------------------

def _inserts(pattern: str, world: int):
    """(worker_id, [(buffer, length, target, header, header_length)])."""
    if pattern == "reference":  # tests/test_io_compat.py::test_alltoall_bytes
        hdr = np.array([1, 2, 3, 4], np.int32)
        return 0, [(np.array([3.14, 2.71]), 2, 1 % world, hdr, 4),
                   (np.array([7.0]), 1, 0, hdr, 4)]
    if pattern == "empty":
        return world - 1, []
    rng = np.random.default_rng(world)
    dtypes = [np.float64, np.float32, np.int32, np.int64, np.uint8, np.int16]
    out = []
    for i in range(12):
        dt = dtypes[i % len(dtypes)]
        n = int(rng.integers(0, 40))
        buf = (rng.random(n) * 1000).astype(dt)
        length = int(rng.integers(0, n + 1))
        hdr, hlen = None, -1
        if i % 3:
            hdr = rng.integers(-9, 9, int(rng.integers(1, 7))).astype(np.int32)
            hlen = int(rng.integers(0, len(hdr) + 1)) if i % 2 else -1
        out.append((buf, length, int(rng.integers(0, world)), hdr, hlen))
    return int(rng.integers(0, world)), out


def _exchange(comm_cls, ctx, world, pattern):
    worker, inserts = _inserts(pattern, world)
    comm = comm_cls(worker, list(range(world)), list(range(world)), 1,
                    ctx=ctx)
    took = [comm.insert(*ins) for ins in inserts]
    # a target outside the list is refused, as the reference's is
    took.append(comm.insert(np.arange(3), 3, world + 5))
    comm.wait()
    comm.finish()
    took.append(comm.insert(np.arange(3), 3, 0))  # after finish: refused
    comm.finish()  # idempotent
    return took, [comm.received(r) for r in range(world)], comm.received()


def _same_inbox(got, want):
    assert len(got) == len(want)
    for (gs, gb, gh), (ws, wb, wh) in zip(got, want):
        assert gs == ws
        assert gb.dtype == wb.dtype and np.array_equal(gb, wb)
        assert (gh is None) == (wh is None)
        if gh is not None:
            assert gh.dtype == wh.dtype and np.array_equal(gh, wh)


@pytest.mark.parametrize("pattern", ["reference", "seeded", "empty"])
@pytest.mark.parametrize("world", [1, 8])
def test_communication_equals_jax(jax_trace_shim, world, pattern):
    from pycylon.net import Communication as JComm

    g_took, g_boxes, g_mine = _exchange(Communication, port_dctx(world),
                                        world, pattern)
    w_took, w_boxes, w_mine = _exchange(JComm, jax_dctx(world), world,
                                        pattern)
    assert g_took == w_took and g_took[-2:] == [False, False]
    for got, want in zip(g_boxes, w_boxes):
        _same_inbox(got, want)
    _same_inbox(g_mine, w_mine)
    if pattern != "empty":
        assert sum(len(b) for b in g_boxes) == len(_inserts(pattern,
                                                            world)[1])


def test_communication_refuses_across_processes():
    """The raw AllToAll runs in one process only: across processes the
    JAX package cannot read its exchanged array back to the host, and the
    port refuses with a typed NotImplemented before any collective."""
    ctx = types.SimpleNamespace(get_process_count=lambda: 2)
    comm = Communication(0, [0, 1], [0, 1], 1, ctx=ctx)
    assert comm.insert(np.arange(4.0), 4, 1)
    with pytest.raises(TCylonError) as e:
        comm.finish()
    assert e.value.status.code == TCode.NotImplemented
    assert "Communication" in str(e.value)


def test_txrequest_header_cap():
    from pycylon.net import TxRequest as JTx

    for mk in (TxRequest, JTx):
        with pytest.raises(ValueError):
            mk(0, np.arange(3), 3, np.arange(8, dtype=np.int32))
    args = (2, np.arange(5), -1, np.arange(6, dtype=np.int32), 4)
    got, want = TxRequest(*args), JTx(*args)
    assert repr(got) == repr(want) and got.to_string() == want.to_string()
    assert repr(got).startswith("TxRequest(target=2, length=5, header=[")
    assert np.array_equal(got.header, np.arange(4)) and \
        got.header.dtype == want.header.dtype == np.int32


def test_dist_init_pins_one_context(monkeypatch):
    """``dist_init`` pins one module-global distributed context (the
    default world, 8 as the JAX package's virtual devices) until
    ``dist_finalize``; it runs on the card, so without one it raises."""
    from pycylon.net import dist as jdist

    monkeypatch.setattr(tdist, "_ctx", None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(TCylonError):
        tdist.dist_init()
    monkeypatch.setattr(tdist, "CylonContext",
                        lambda cfg: tpc.CylonContext(cfg, device="cpu"))
    a = tdist.dist_init()
    assert tdist.get_ctx() is a and tdist.dist_init() is a
    assert a.get_config() == "mpi" and a.is_distributed()
    monkeypatch.setattr(jdist, "_ctx", None)
    assert (tdist.rank(), tdist.size()) == (jdist.rank(), jdist.size()) \
        == (0, 8)
    tdist.dist_finalize()
    jdist.dist_finalize()
    assert tdist._ctx is None and tdist.dist_init() is not a
    tdist.dist_finalize()


# ---------------------------------------------------------------------------
# util: MiniBatcher, the loaders, benchutils
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,batch", [(150, 32), (128, 32), (0, 32), (2, 32)])
def test_minibatcher_equals_jax(n, batch):
    from pycylon.util.data import MiniBatcher as JMB

    data = np.random.default_rng(n).random((n, 4))
    got = MiniBatcher.generate_minibatches(data, batch)
    want = JMB.generate_minibatches(data, batch)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.array_equal(got, want)


def _csvs(tmp_path, sizes, seed):
    rng = np.random.default_rng(seed)
    files = []
    for i, n in enumerate(sizes):
        pd.DataFrame({"x": rng.integers(0, 9, n),
                      "y": np.round(rng.random(n), 4)}).to_csv(
            tmp_path / f"p{i}.csv", index=False)
        files.append(f"p{i}.csv")
    return files


@pytest.mark.parametrize("loader_type", ["arrow", "table"])
def test_local_loader_equals_jax(tmp_path, loader_type):
    from pycylon.util.data import LocalDataLoader as JLoader

    files = _csvs(tmp_path, [10, 7], seed=1)
    got = LocalDataLoader(ctx=tpc.CylonContext(None, device="cpu"),
                          source_dir=str(tmp_path), source_files=files,
                          loader_type=loader_type).load()
    want = JLoader(source_dir=str(tmp_path), source_files=files,
                   loader_type=loader_type).load()
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        if loader_type == "arrow":
            assert g.equals(w)
        else:
            assert schema(g) == schema(w)
            assert_rows_close(port_rows(g, True), jax_rows(w, True),
                              float_rtols(g))
    absolute = LocalDataLoader(source_files=[str(tmp_path / files[0])]).load()
    assert absolute[0].num_rows == 10
    with pytest.raises(FileNotFoundError):
        LocalDataLoader(source_dir=str(tmp_path / "missing"))


@pytest.mark.parametrize("world", [1, 8])
def test_distributed_loader_equals_jax(tmp_path, jax_trace_shim, world):
    """One file per rank → a DTable whose shards equal the JAX loader's,
    rows in order."""
    from pycylon.util.data import DistributedDataLoader as JLoader

    files = _csvs(tmp_path, [int(n) for n in np.random.default_rng(
        world).integers(1, 20, world)], seed=world)
    (got,) = DistributedDataLoader(ctx=port_dctx(world),
                                   source_dir=str(tmp_path),
                                   source_files=files).load()
    (want,) = JLoader(ctx=jax_dctx(world), source_dir=str(tmp_path),
                      source_files=files).load()
    assert got.num_rows == want.num_rows
    assert schema(got) == schema(want)
    assert_rows_close(port_rows(got, True), jax_rows(want, True),
                      float_rtols(got))
    with pytest.raises(ValueError):
        DistributedDataLoader(ctx=port_dctx(world + 1),
                              source_dir=str(tmp_path),
                              source_files=files).load()


@pytest.mark.parametrize("time_type", ["ns", "us", "ms", "s"])
def test_benchutils_equals_jax(time_type):
    from pycylon.util.benchutils import benchmark_with_repitions as jbench

    calls = []

    def f(x):
        calls.append(x)
        return x + 1

    got = benchmark_with_repitions(repititions=3, time_type=time_type)(f)(1)
    want = jbench(repititions=3, time_type=time_type)(f)(1)
    assert got[1] == want[1] == 2 and len(calls) == 6
    assert got[0] >= 0 and want[0] >= 0
