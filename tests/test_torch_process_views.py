"""One process's view of a world that spans processes, without the other
process: the pieces of the TPC-H and planner slice that must not touch
the communicator, checked in a single process.

A *process view* is a ``CylonContext`` whose communicator describes
process ``p`` of a 2 × 4 world (global ranks ``4p … 4p + 3``) but fails
any call that would reach another process.  On it:

* ``generate_device`` builds exactly the single-process world 8's
  shards ``4p … 4p + 3`` with no collective;
* the meta view (``with_device("meta")``) keeps the process split and
  its :class:`AbstractCommunicator` returns meta tensors of the shapes
  ``ProcessCommunicator``'s collectives return, never calling
  ``torch.distributed``, so ``plan_check`` checks a TPC-H query with no
  call at all and reports what the single-process world 8 reports;
* the plan cache keys on the process split, ``plan_check``'s table
  check reads the local shard count, and the psum groupby's rows belong
  to global rank 0 only;
* a planned query that fails with an error this process alone may have
  seen tears the group down (``comm.abort``), one that fails alike in
  every process (a ``CylonError``) or inside an abstract run does not.

The real two-process runs are ``tests/test_torch_multiprocess_tpch.py``.
"""
from __future__ import annotations

import pytest
import torch

import cylon_tpu_torch as pt
from cylon_tpu_torch import CylonError
from cylon_tpu_torch.analysis import plan_check
from cylon_tpu_torch.context import AbstractCommunicator, LocalCommunicator
from cylon_tpu_torch.plan import executor
from cylon_tpu_torch.tpch import datagen_device as dd
from cylon_tpu_torch.tpch import queries
from cylon_tpu_torch.tpch.datagen import TABLE_NAMES

import torch_multiprocess_worker as W

NPROC, L = 2, 4
P = NPROC * L


class _NoPeers:
    """Process ``proc``'s communicator of a 2 × 4 world with no other
    process behind it: the split and ranks of a ``ProcessCommunicator``;
    a call that would reach another process fails the test.
    ``all_reduce`` sums the local ranks only (as if the other process
    added zeros)."""

    backend = "none"

    def __init__(self, proc: int):
        self.nproc, self.proc, self.local, self.world = NPROC, proc, L, P
        self.first_rank = proc * L
        self.device = torch.device("cpu")
        self.calls = 0
        self.aborted = False

    @property
    def group_key(self):
        return ("no-peers", self.proc)

    def _reach(self, *args, **kwargs):
        raise AssertionError("a collective reached for another process")

    all_to_all = all_gather = ppermute = all_gather_object = _reach
    barrier = _reach

    def abort(self):
        self.aborted = True

    def all_reduce(self, x):
        return x.sum(0)


def _view(proc: int) -> pt.CylonContext:
    ctx = pt.CylonContext(device="cpu", world=L)
    ctx._comm = _NoPeers(proc)
    ctx._distributed = True
    return ctx


def views_at(proc: int):
    """A fresh process view and its TPC-H tables (its communicator's
    abort flag unset)."""
    ctx = _view(proc)
    return ctx, dd.generate_device(ctx, W.TPCH_SCALE, seed=W.TPCH_SEED)


@pytest.fixture(scope="module")
def world8():
    ctx = pt.CylonContext(device="cpu", world=P)
    return ctx, dd.generate_device(ctx, W.TPCH_SCALE, seed=W.TPCH_SEED)


@pytest.fixture(scope="module")
def views():
    return [views_at(proc) for proc in range(NPROC)]


# ---------------------------------------------------------------------------
# the generator
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", TABLE_NAMES)
def test_generator_builds_the_process_shards(world8, views, name):
    """Each process builds only its own ranks' blocks, from their global
    row ids: process ``p``'s shards equal the single-process world 8's
    shards ``4p … 4p + 3`` (counts and every column's bytes), with the
    same ``cap`` and the global counts, and no collective runs."""
    _, want = world8
    whole = W.shard_digests(want[name])
    for proc, (ctx, tables) in enumerate(views):
        got = tables[name]
        assert W.shard_digests(got) == whole[proc * L:(proc + 1) * L]
        assert got.cap == want[name].cap
        assert list(got.counts_host()) == list(want[name].counts_host())
        assert tuple(got.counts.shape) == (L,)


# ---------------------------------------------------------------------------
# the meta view's communicator
# ---------------------------------------------------------------------------

def _block(shape, dtype=torch.int64):
    return torch.arange(int(torch.tensor(shape).prod()),
                        dtype=dtype).reshape(shape)


COLLECTIVES = {
    # name: (call, input shape, what the real collective returns)
    "all_to_all": (lambda c, x: c.all_to_all(x), (L, P, 3), (L, P, 3)),
    "all_gather": (lambda c, x: c.all_gather(x), (L, 3), (P, 3)),
    "all_reduce": (lambda c, x: c.all_reduce(x), (L, 3), (3,)),
    "ppermute": (lambda c, x: c.ppermute(x, 3), (L, 5), (L, 5)),
    "all_to_all_slow": (lambda c, x: c.all_to_all(
        x, split=(NPROC, L), axis="slow"), (L, NPROC, 2), (L, NPROC, 2)),
    "all_to_all_fast": (lambda c, x: c.all_to_all(
        x, split=(NPROC, L), axis="fast"), (L, L, 2), (L, L, 2)),
    "all_gather_slow": (lambda c, x: c.all_gather(
        x, split=(NPROC, L), axis="slow"), (L, 3), (L, NPROC, 3)),
    "all_gather_fast": (lambda c, x: c.all_gather(
        x, split=(NPROC, L), axis="fast"), (L, 3), (L, L, 3)),
}


@pytest.mark.parametrize("name", list(COLLECTIVES))
def test_abstract_collective_shapes(name):
    """Each collective of the meta view's communicator returns a meta
    tensor of the shape and dtype ``ProcessCommunicator`` returns for
    this process's ``[L, …]`` block (the same shape as
    ``LocalCommunicator``'s per-rank result on the world's block, cut to
    L ranks where per-rank), without calling anything."""
    call, shape, want = COLLECTIVES[name]
    comm = AbstractCommunicator(_NoPeers(1), torch.device("meta"))
    x = _block(shape).to("meta")
    out = call(comm, x)
    assert out.device.type == "meta" and out.dtype == x.dtype
    assert tuple(out.shape) == want
    if name in ("all_to_all", "all_gather", "all_reduce", "ppermute"):
        # the single-process contract on the world's block, per rank
        local = LocalCommunicator(P, torch.device("cpu"))
        whole = _block((P,) + shape[1:])
        ref = call(local, whole)
        per_rank = name in ("all_to_all", "ppermute")
        assert tuple(ref.shape[1:] if per_rank else ref.shape) == \
            (want[1:] if per_rank else want)


def test_abstract_collectives_refuse_like_the_real_ones():
    """A split other than the process split is refused ``NotImplemented``
    and a block without the L local ranks leading is ``Invalid``, as the
    process communicator refuses them."""
    comm = AbstractCommunicator(_NoPeers(0), torch.device("meta"))
    x = torch.empty((L, 2, 3), device="meta")
    with pytest.raises(CylonError) as e:
        comm.all_to_all(x, split=(P // 2, 2), axis="fast")
    assert e.value.status.code.name == "NotImplemented"
    with pytest.raises(CylonError) as e:
        comm.all_gather(torch.empty((P, 3), device="meta"))
    assert e.value.status.code.name == "Invalid"
    with pytest.raises(CylonError) as e:
        comm.all_reduce(torch.empty((P, 3), device="meta"))
    assert e.value.status.code.name == "Invalid"


def test_abstract_communicator_agrees_on_nothing():
    """Host objects of other processes are unknown to an abstract run
    (``all_gather_object`` raises a typed ``ExecutionError``); a barrier
    is a no-op; the view keeps the real communicator's ranks."""
    real = _NoPeers(1)
    comm = AbstractCommunicator(real, torch.device("meta"))
    with pytest.raises(CylonError) as e:
        comm.all_gather_object({"x": 1})
    assert e.value.status.code.name == "ExecutionError"
    assert comm.barrier() is None
    assert (comm.nproc, comm.proc, comm.local, comm.world,
            comm.first_rank) == (NPROC, 1, L, P, L)
    assert comm.group_key == ("abstract", "no-peers", 1)


def test_meta_view_keeps_the_process_split():
    """``with_device("meta")`` of a process view keeps the world, the
    local ranks, the process count and the global rank, over an
    :class:`AbstractCommunicator`; any other device view across
    processes is refused ``NotImplemented``; one process's view is a
    plain context as before."""
    ctx = _view(1)
    meta = ctx.with_device("meta")
    assert isinstance(meta.comm, AbstractCommunicator)
    assert (meta.get_world_size(), meta.get_local_world_size(),
            meta.get_process_count(), meta.get_rank()) == (P, L, NPROC, L)
    assert meta.device.type == "meta" and meta.is_distributed()
    with pytest.raises(CylonError) as e:
        ctx.with_device("cpu")
    assert e.value.status.code.name == "NotImplemented"
    one = pt.CylonContext(device="cpu", world=P).with_device("meta")
    assert isinstance(one.comm, LocalCommunicator)
    assert one.get_world_size() == P


# ---------------------------------------------------------------------------
# the plan check, the plan cache, the table check, the psum owner
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("q", ["q1", "q3", "q6", "q12"])
def test_plan_check_on_a_process_view(world8, views, q):
    """``plan_check.validate`` of a TPC-H query on process 1's view: the
    verdict, operator list, boundary and result schema of the
    single-process world 8's report, with no call into the communicator
    (any would fail the test), no host read and no launch."""
    from cylon_tpu_torch import trace
    from cylon_tpu_torch.ops import hash_cuda
    kwargs = W.tpch_kwargs()
    wctx, wtables = world8
    want = plan_check.validate(
        lambda t: W.tpch_call(queries, wctx, t, q, kwargs), wtables)
    ctx, tables = views[1]
    trace.enable_counters()
    try:
        trace.reset()
        l0 = hash_cuda.launches
        got = plan_check.validate(
            lambda t: W.tpch_call(queries, ctx, t, q, kwargs), tables)
        assert trace.counters().get("host.read", 0) == 0
        assert hash_cuda.launches == l0
    finally:
        trace.disable_counters()
        trace.reset()
    assert got.ok and want.ok
    assert [n.op for n in got.nodes] == [n.op for n in want.nodes]
    assert (got.result, got.boundary) == (want.result, want.boundary)


def test_plan_cache_keys_on_the_process_split():
    """A 2 × 4 process world and a single-process world of 8 on one
    device are different configurations to the plan cache."""
    a = executor._config_fingerprint(_view(0))
    b = executor._config_fingerprint(pt.CylonContext(device="cpu", world=P))
    assert a != b
    assert a == executor._config_fingerprint(_view(1))


def test_table_check_reads_the_local_shard_count(views):
    """``plan_check``'s table check holds a process's table to its L
    local shards (``[L]`` counts, ``[L · cap]`` leaves) and rejects one
    laid out for all P."""
    ctx, tables = views[0]
    li = tables["lineitem"]
    plan_check._check_table("t", li)
    bad = pt.parallel.DTable(ctx, li.columns, li.cap,
                             torch.zeros(P, dtype=torch.int32))
    with pytest.raises(CylonError, match="counts shape"):
        plan_check._check_table("t", bad)


def test_psum_rows_belong_to_global_rank_zero(views):
    """The psum groupby's decoded groups sit on global rank 0 alone: in
    process 0's view its first local shard holds them, in process 1's
    view every shard is empty (the groups are identical everywhere)."""
    from cylon_tpu_torch.parallel import dist_ops
    counts = []
    for ctx, tables in views:
        out = dist_ops.dist_groupby_fused(
            tables["lineitem"], ["l_returnflag", "l_linestatus"],
            W.PSUM_AGGS, mode="psum")
        counts.append([int(c) for c in out.counts])
    assert counts[0][0] > 0 and counts[0][1:] == [0] * (L - 1)
    assert counts[1] == [0] * L


def _failing(kind: str):
    def fn(env):
        if kind == "runtime":
            raise RuntimeError("a failure only this process sees")
        raise CylonError(pt.Status(pt.Code.Invalid, "a plan bug"))
    return fn


@pytest.mark.parametrize("kind, aborts", [("runtime", True),
                                          ("cylon", False)])
def test_planned_failure_across_processes(kind, aborts):
    """Across processes the planner engages no recovery rung: the error
    raises as it is; a non-``CylonError`` (which only this process may
    have seen) tears the process group down first, so the peers'
    collectives fail at once, while a ``CylonError`` (the same in every
    process) leaves it up."""
    from cylon_tpu_torch.dtypes import Type
    from cylon_tpu_torch.parallel import dist_with_column
    ctx, tables = views_at(0)
    fn = _failing(kind)
    with pytest.raises(RuntimeError if aborts else CylonError):
        ctx.optimize(lambda t: dist_with_column(t["region"], "x", fn,
                                                Type.INT32).num_rows,
                     tables)
    assert ctx.comm.aborted is aborts


def test_abstract_planned_failure_leaves_the_group_up():
    """A planned form that fails inside ``plan_check``'s abstract run
    reports the error and tears nothing down: no collective ran, so no
    peer waits on it."""
    from cylon_tpu_torch import plan as planner
    from cylon_tpu_torch.dtypes import Type
    from cylon_tpu_torch.parallel import dist_with_column
    ctx, tables = views_at(1)
    fn = _failing("runtime")
    rep = plan_check.explain(lambda t: planner.run(
        ctx, lambda tt: dist_with_column(tt["region"], "x", fn,
                                         Type.INT32).num_rows, t), tables)
    assert not rep.ok and isinstance(rep.error, RuntimeError)
    assert ctx.comm.aborted is False
