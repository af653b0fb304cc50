"""The port's concurrency discipline against the JAX package's: each
threaded module's ``GUARDED_STATE`` catalogue (its AST view = its runtime
value, its keys = the JAX module's), every catalogued lock an
``OrderedLock``, the tree clean under the two concurrency rules and the
lockcheck CLI's contract, the torch meaning of ``blocking-call-under-lock``,
sanitize turning lock-order enforcement on, the ``warn_once`` hammer and
a served window under enforcement."""
import importlib
import os
import threading

import numpy as np
import pandas as pd
import pytest

from cylon_tpu.analysis import lockcheck as jlockcheck

from cylon_tpu_torch import config
from cylon_tpu_torch.analysis import graftlint, lockcheck
from cylon_tpu_torch.observe.locks import (LockOrderViolation, OrderedLock,
                                           clear_graph, known_locks)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# every port module that declares a catalogue (the JAX package's list,
# plus the modules the port catalogues that the JAX test leaves out)
CATALOGUED = (
    "logging", "observe.stats", "observe.timeseries", "observe.exporter",
    "observe.compile", "serve.session", "serve.admission", "serve.matview",
    "serve.router", "spill.pool", "parallel.shuffle", "parallel.broadcast",
    "parallel.streaming", "analysis.lockcheck", "analysis.graftlint",
)

# Where the port's keys differ from the JAX module's, and why: the port
# holds state the reference does not.
PORT_ONLY_KEYS = {
    "spill.pool": {"_streams": "the per-device CUDA copy stream of the "
                   "staging transfers (the JAX pool stages through "
                   "jax.device_get / device_put, with no stream)"},
    "parallel.shuffle": {"_warned": "the warn-once keys the shuffle used "
                         "(skew, budget floor), which clear_chunk_state "
                         "forgets; the JAX shuffle keeps no such set"},
}

# graftlint's cache lock stays a plain threading.Lock in both packages:
# the linter needs the standard library alone
PLAIN_LOCK_MODULES = ("analysis.graftlint",)


def _path(pkg: str, mod: str) -> str:
    return os.path.join(REPO, pkg, *mod.split(".")) + ".py"


def _rules(src, path="fixture.py"):
    return sorted({f.rule for f in graftlint.lint_source(src, path)})


@pytest.fixture(autouse=True)
def _isolate():
    """Every test starts with an empty lock-order DAG and default
    enforcement, and leaves them that way."""
    clear_graph()
    prev = config.set_lockcheck(None)
    try:
        yield
    finally:
        config.set_lockcheck(prev)
        clear_graph()


@pytest.mark.parametrize("mod", CATALOGUED)
def test_guarded_state_parse_matches_runtime(mod):
    """The AST-parsed catalogue (what lint checks against) equals the
    imported module's GUARDED_STATE (what the code does)."""
    m = importlib.import_module(f"cylon_tpu_torch.{mod}")
    assert lockcheck.guarded_state(m.__file__) == m.GUARDED_STATE


@pytest.mark.parametrize("mod", CATALOGUED)
def test_guarded_state_keys_match_reference(mod):
    """Each catalogue's entries equal the JAX module's, save the listed
    port-only state (each with its reason)."""
    want = jlockcheck.guarded_state(_path("cylon_tpu", mod))
    got = lockcheck.guarded_state(_path("cylon_tpu_torch", mod))
    extra = PORT_ONLY_KEYS.get(mod, {})
    assert want is not None and got is not None
    assert {k: v for k, v in got.items() if k not in extra} == want
    assert set(extra) <= set(got)


def test_every_catalogued_lock_is_an_ordered_lock():
    """A catalogued module-level lock must be the instrumented kind, or the
    lock-order detector cannot see it; instance locks are checked on a
    live instance (the streaming pipeline below)."""
    for mod in CATALOGUED:
        if mod in PLAIN_LOCK_MODULES:
            continue
        m = importlib.import_module(f"cylon_tpu_torch.{mod}")
        for name in set(m.GUARDED_STATE.values()):
            if hasattr(m, name):
                assert isinstance(getattr(m, name), OrderedLock), (mod, name)


def test_streaming_pipeline_lock_is_ordered():
    """The HostPipeline's submit / close lock is the reference's
    ``OrderedLock("streaming.pipeline")``: the order detector sees it (a
    plain ``threading.Lock`` there was invisible to it)."""
    from cylon_tpu_torch.parallel.streaming import HostPipeline
    config.set_lockcheck(True)
    p = HostPipeline(workers=1, depth=2)
    try:
        assert isinstance(p._lock, OrderedLock)
        assert p._lock.name == "streaming.pipeline"
        assert p.submit(lambda: 7).wait(30) == 7
        assert known_locks()["streaming.pipeline"] is p._lock
        # an inversion against the pipeline lock raises under enforcement
        other = OrderedLock("t.pipeline_other")
        with p._lock:
            with other:
                pass
        with pytest.raises(LockOrderViolation):
            with other:
                with p._lock:
                    pass
    finally:
        p.close()


def test_tree_is_clean_under_concurrency_rules():
    """The burn-down gate: zero findings for the two concurrency rules
    over the package and the chip smoke script (the CLI's exit 0)."""
    assert lockcheck.main([os.path.join(REPO, "cylon_tpu_torch"),
                           os.path.join(REPO, "chip_smoke.py")]) == 0


def test_lockcheck_cli_contract(tmp_path, capsys):
    assert lockcheck.main([]) == 2
    assert lockcheck.main(["/no/such/path"]) == 2
    bad = tmp_path / "seeded.py"
    bad.write_text("import threading, time\n"
                   "_lock = threading.Lock()\n"
                   "def f():\n"
                   "    with _lock:\n"
                   "        time.sleep(1)\n")
    assert lockcheck.main([str(bad)]) == 1
    assert "blocking-call-under-lock" in capsys.readouterr().out
    broken = tmp_path / "broken.py"
    broken.write_text("def f(:\n")
    assert lockcheck.main([str(broken)]) == 2


def test_blocking_call_under_lock_torch_meanings():
    """The torch meanings of a call that blocks under a lock: the device
    barrier, a stream or event wait, a host read, a collective and its
    work handle, a future and a thread; waiting on the HELD condition is
    exempt."""
    src = ("import threading, torch\n"
           "import torch.distributed as dist\n"
           "from .ops.compact import read_host\n"
           "_lock = threading.Lock()\n"
           "def f(x, ev, work, fut, th, cv):\n"
           "    with _lock:\n"
           "        torch.cuda.synchronize()\n"
           "        ev.synchronize()\n"
           "        v = x.item()\n"
           "        h = x.cpu()\n"
           "        c = read_host(x)\n"
           "        dist.all_reduce(x)\n"
           "        work.wait()\n"
           "        fut.result()\n"
           "        th.join()\n")
    found = [f.line for f in graftlint.lint_source(src, "fixture.py")
             if f.rule == "blocking-call-under-lock"]
    assert found == list(range(7, 16))
    clean = ("import threading, torch\n"
             "_cv = threading.Condition(threading.Lock())\n"
             "_lock = threading.Lock()\n"
             "def f(x, strs):\n"
             "    with _cv:\n"
             "        _cv.wait(1.0)\n"
             "    with _lock:\n"
             "        s = ', '.join(strs)\n"
             "        y = x.to('cuda', non_blocking=True)\n"
             "    torch.cuda.synchronize()\n")
    assert "blocking-call-under-lock" not in _rules(clean)


def test_shared_state_rule_on_fixtures():
    base = ("import threading\n"
            "GUARDED_STATE = {'_items': '_lock'}\n"
            "_items: list = []\n"
            "_lock = threading.Lock()\n")
    assert "shared-state-unguarded" in _rules(
        base + "def f(x):\n    _items.append(x)\n")
    assert "shared-state-unguarded" not in _rules(
        base + "def f(x):\n    with _lock:\n        _items.append(x)\n")
    assert "shared-state-unguarded" not in _rules(
        base + "def _add_locked(x):\n    _items.append(x)\n")
    # an uncatalogued module-level mutable in a thread-spawning module
    spawn = ("import threading\n_cache: dict = {}\n"
             "def go():\n    threading.Thread(target=print).start()\n")
    assert "shared-state-unguarded" in _rules(spawn)
    assert "shared-state-unguarded" not in _rules(
        spawn.replace("_cache", "_TABLE"))


def test_sanitize_enables_enforcement():
    """Sanitizing turns lock-order enforcement on: an AB/BA inversion then
    raises ``LockOrderViolation`` at the acquire, naming both chains."""
    assert not config.lockcheck_enabled()
    a, b = OrderedLock("t.san_a"), OrderedLock("t.san_b")
    caught = []
    with config.sanitize():
        assert config.lockcheck_enabled()
        with a:
            with b:
                pass

        def inverter():
            try:
                with b:
                    with a:
                        pass
            except LockOrderViolation as e:
                caught.append(e)

        th = threading.Thread(target=inverter)
        th.start()
        th.join(30)
    assert not config.lockcheck_enabled()
    assert len(caught) == 1
    assert "t.san_a -> t.san_b" in str(caught[0])


def test_warn_once_hammer_exactly_one_winner():
    """N racing threads with one key: exactly one emits.  The check-then-
    add pair is atomic under the catalogued lock."""
    from cylon_tpu_torch import logging as glog
    glog.reset_warn_once()
    results = []
    start = threading.Barrier(8)

    def racer():
        start.wait()
        for i in range(50):
            results.append(glog.warn_once(("t.hammer", i), "m"))

    threads = [threading.Thread(target=racer) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert sum(results) == 50
    assert len(results) == 8 * 50
    glog.reset_warn_once()


def _plan_groupby(t):
    from cylon_tpu_torch.parallel import dist_groupby, shuffle_table
    s = shuffle_table(t["fact"], ["k"])
    return dist_groupby(s, ["k"], [("v", "sum")])


def test_serve_window_under_enforcement():
    """A concurrent serve window with enforcement on: every OrderedLock
    of the engine order-checked (queue condition, breaker, session, the
    export lane's pipeline lock, warn_once) while queries flow."""
    import cylon_tpu_torch as pt
    from cylon_tpu_torch.parallel import DTable
    from cylon_tpu_torch.serve import ServeSession

    config.set_lockcheck(True)
    rng = np.random.default_rng(3)
    n = 256
    ctx = pt.CylonContext(device="cpu", world=4)
    dts = {"fact": DTable.from_pandas(ctx, pd.DataFrame({
        "k": rng.integers(0, 16, n).astype(np.int32),
        "v": rng.random(n).astype(np.float64)}))}
    with ServeSession(ctx, tables=dts, batch_window_ms=10.0) as s:
        handles = []

        def client(i):
            handles.append(s.submit(_plan_groupby, label=f"h{i}"))

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        outs = [h.result(timeout=600) for h in handles]
        stats = s.stats()
    assert len(outs) == 8
    assert stats["failed"] == 0 and stats["completed"] == 8
    assert "serve.session" in known_locks()
