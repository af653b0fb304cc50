"""Boundaries of the PyTorch port: it loads neither JAX nor ``cylon_tpu``,
its context never falls back from the card to the CPU, and the chip smoke
script refuses to run without a card."""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import cylon_tpu_torch as pt

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "cylon_tpu_torch"
SMOKE = ROOT / "chip_smoke.py"
FORBIDDEN = ("jax", "jaxlib", "cylon_tpu")


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in FORBIDDEN


def test_import_loads_no_jax_or_reference_package():
    code = (
        "import json, sys\n"
        "before = set(sys.modules)\n"
        "import cylon_tpu_torch, cylon_tpu_torch.compute, "
        "cylon_tpu_torch.parallel, cylon_tpu_torch.ops.hash_cuda, "
        "cylon_tpu_torch.ops.sort, cylon_tpu_torch.ops.setops, "
        "cylon_tpu_torch.ops.groupby, cylon_tpu_torch.parallel.broadcast, "
        "cylon_tpu_torch.ops.sketch, cylon_tpu_torch.parallel.streaming, "
        "cylon_tpu_torch.tpch, cylon_tpu_torch.plan, cylon_tpu_torch.trace, "
        "cylon_tpu_torch.analysis.plan_check, cylon_tpu_torch.logging, "
        "cylon_tpu_torch.observe, cylon_tpu_torch.observe.locks, "
        "cylon_tpu_torch.observe.histogram, cylon_tpu_torch.observe.metrics, "
        "cylon_tpu_torch.observe.export, cylon_tpu_torch.observe.devmem, "
        "cylon_tpu_torch.observe.compile, cylon_tpu_torch.observe.flightrec, "
        "cylon_tpu_torch.observe.doctor, cylon_tpu_torch.observe.stats, "
        "cylon_tpu_torch.observe.analyze, cylon_tpu_torch.spill, "
        "cylon_tpu_torch.spill.pool, cylon_tpu_torch.spill.morsel, "
        "cylon_tpu_torch.parallel.remesh, cylon_tpu_torch.topology, "
        "cylon_tpu_torch.resilience, cylon_tpu_torch.faults, "
        "cylon_tpu_torch.plan.executor, cylon_tpu_torch.row, "
        "cylon_tpu_torch.strings, cylon_tpu_torch.io, "
        "cylon_tpu_torch.io.csv, cylon_tpu_torch.native.runtime, "
        "cylon_tpu_torch.serve, cylon_tpu_torch.serve.session, "
        "cylon_tpu_torch.serve.admission, cylon_tpu_torch.serve.matview, "
        "cylon_tpu_torch.serve.router, cylon_tpu_torch.observe.exporter, "
        "cylon_tpu_torch.observe.timeseries\n"
        "print(json.dumps(sorted(set(sys.modules) - before)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert "cylon_tpu_torch" in loaded
    assert [m for m in loaded if _forbidden(m)] == []


@pytest.mark.parametrize("path", sorted(str(p.relative_to(ROOT)) for p in
                                        list(PKG.rglob("*.py")) + [SMOKE]))
def test_no_jax_or_reference_import_in_source(path):
    tree = ast.parse((ROOT / path).read_text())
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module and _forbidden(node.module):
                bad.append(node.module)
    assert bad == []


def test_context_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(pt.CylonError):
        pt.CylonContext()
    with pytest.raises(pt.CylonError):
        pt.CylonContext(device="cuda", world=4)
    assert pt.CylonContext(device="cpu", world=4).get_world_size() == 4


def test_context_rejects_bad_world_and_config():
    with pytest.raises(pt.CylonError):
        pt.CylonContext(device="cpu", world=0)
    with pytest.raises(pt.CylonError):
        pt.CylonContext("mpi", device="cpu")


def test_init_multihost_without_a_card_raises(monkeypatch, tmp_path):
    """``InitMultiHost`` never falls back to the CPU: with no card and no
    ``device="cpu"`` it raises before it joins any process group."""
    import torch.distributed as dist
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(pt.CylonError):
        pt.CylonContext.InitMultiHost(f"file://{tmp_path}/store", 1, 0,
                                      world=2)
    assert not dist.is_initialized()


def test_local_communicator_is_one_process():
    """A single-process context: ``local == world``, ``first_rank == 0``,
    one process, every rank its own."""
    ctx = pt.CylonContext(device="cpu", world=4)
    comm = ctx.comm
    assert (comm.local, comm.world, comm.first_rank, comm.nproc) == \
        (4, 4, 0, 1)
    assert ctx.get_rank() == 0 and ctx.get_local_world_size() == 4
    assert ctx.local_ranks() == [0, 1, 2, 3]
    assert ctx.get_neighbours() == []
    assert ctx.get_neighbours(include_self=True) == [0, 1, 2, 3]
    assert ctx.get_process_count() == 1


def test_local_communicator_transposes_and_gathers():
    comm = pt.CylonContext(device="cpu", world=3).comm
    x = torch.arange(3 * 3 * 2).view(3, 3, 2)
    y = comm.all_to_all(x)
    for s in range(3):
        for d in range(3):
            assert torch.equal(y[d, s], x[s, d])
    assert torch.equal(comm.all_gather(torch.arange(3)), torch.arange(3))
    with pytest.raises(pt.CylonError):
        comm.all_to_all(torch.zeros(2, 3))


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the script would run for real")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, str(SMOKE)], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout

