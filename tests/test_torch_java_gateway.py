"""The Java binding's gateway over the port against the JAX package's: the
JAX gateway started as ``tests/test_java_gateway.py`` starts it (with
``jax_trace_shim``'s attribute set in that process, so its distributed
ops run on this JAX version), the
port's launcher started with the Java binding's own argv
(``CylonContext.java``: ``<python> -m pycylon.java_gateway <backend>``)
plus ``--device cpu``, the same request sequence sent to both over their
pipes.  Every reply must be equal with table ids masked out, and every
table a reply names must hold the same rows (read back through
``column_json``; the CSVs ``to_csv`` writes are compared as row
multisets).  Each pair runs once local (world 1) and once distributed
(``mpi``: the JAX package's 8 virtual CPU devices, the port's default
world of 8)."""
import json
import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

REPO = Path(__file__).resolve().parent.parent
LAUNCHER = REPO / "cylon_tpu_torch" / "pycylon" / "java_launcher.py"
JAVA_ARGV = ["-m", "pycylon.java_gateway"]  # CylonContext.java:48-50


def _port_env():
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.pop("PYTHONPATH", None)  # the launcher finds its package itself
    return env


# ``python -m pycylon.java_gateway <backend>``, after setting what
# test_torch_common.jax_trace_shim sets: JAX keeps trace_state_clean under
# jax._src.core only, and the JAX package's distributed path reads it
# from jax.core
JAX_GATEWAY = (
    "import sys, jax\n"
    "from jax._src import core\n"
    "if not hasattr(jax.core, 'trace_state_clean'):\n"
    "    jax.core.trace_state_clean = core.trace_state_clean\n"
    "from pycylon.java_gateway import serve\n"
    "serve(backend=sys.argv[1])\n")


def _popen(argv, env, cwd):
    """A gateway on pipes for stdin and stdout; its stderr goes to a file
    (an unread stderr pipe fills with the gateway's log lines and blocks
    it mid-reply)."""
    err = tempfile.TemporaryFile(mode="w+")
    p = subprocess.Popen(argv, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                         stderr=err, text=True, env=env, cwd=cwd)
    p.err = err
    return p


def _stderr(p) -> str:
    p.err.seek(0)
    return p.err.read()[-2000:]


def _start_jax(backend):
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = str(REPO)
    # the repo's persistent compile cache, as tests/test_examples.py uses
    env["JAX_COMPILATION_CACHE_DIR"] = str(REPO / ".jax_cache")
    env["JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS"] = "0.5"
    return _popen([sys.executable, "-c", JAX_GATEWAY, backend], env, REPO)


def _start_port(backend, *extra):
    # run as Java runs it: the launcher itself is the executable
    return _popen([str(LAUNCHER), *JAVA_ARGV, backend, "--device", "cpu",
                   *extra], _port_env(), "/")


def _stop(p):
    if p.poll() is None:
        p.kill()
    p.wait(timeout=30)
    p.err.close()


def _rpc(p, req):
    p.stdin.write(json.dumps(req) + "\n")
    p.stdin.flush()
    line = p.stdout.readline()
    assert line, _stderr(p)
    return json.loads(line)


class Pair:
    """The two gateways, driven in lockstep: each request goes to both,
    ids map port → JAX so a later request names the same table in each."""

    def __init__(self, jax_proc, port_proc):
        self.j, self.p = jax_proc, port_proc
        self.ids = {}

    def _jreq(self, req):
        out = {}
        for k, v in req.items():
            if k in ("id", "left", "right"):
                v = self.ids.get(v, v)
            elif k == "ids":
                v = [self.ids.get(i, i) for i in v]
            out[k] = v
        return out

    def both(self, **req):
        """(port reply, JAX reply), equal once ids are masked."""
        got, want = _rpc(self.p, req), _rpc(self.j, self._jreq(req))
        if "id" in got and "id" in want:
            self.ids[got["id"]] = want["id"]
        for a, b in zip(got.get("ids", []), want.get("ids", [])):
            self.ids[a] = b
        assert _masked(got) == _masked(want), (req, got, want)
        return got, want

    def rows(self, tid):
        """A table's rows, read through the protocol, from both gateways:
        equal as multisets; the port's returned."""
        got = self._rows(self.p, tid)
        want = self._rows(self.j, self.ids[tid])
        assert sorted(got, key=repr) == sorted(want, key=repr)
        return got

    @staticmethod
    def _rows(proc, tid):
        ncol = _rpc(proc, {"op": "columns", "id": tid})["value"]
        cols = [_rpc(proc, {"op": "column_json", "id": tid, "column": c})
                ["value"] for c in range(ncol)]
        return list(zip(*cols))


UUID = re.compile(r"[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{4}-"
                  r"[0-9a-f]{12}")


def _masked(reply):
    """The reply with every table id (in ``id``, ``ids`` and error
    messages) replaced by a placeholder."""
    r = dict(reply)
    if "id" in r:
        r["id"] = "<id>"
    if "ids" in r:
        r["ids"] = ["<id>"] * len(r["ids"])
    if "error" in r:
        r["error"] = UUID.sub("<id>", r["error"])
    return r


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    d = tmp_path_factory.mktemp("gateway")
    rng = np.random.default_rng(11)
    ldf = pd.DataFrame({"k": rng.integers(0, 40, 80),
                        "v": np.round(rng.random(80), 6)})
    rdf = pd.DataFrame({"k": rng.integers(0, 40, 60),
                        "w": np.round(rng.random(60), 6)})
    # a second table with the left schema, half of it shared (set ops)
    sdf = pd.concat([ldf.iloc[:40], pd.DataFrame({
        "k": rng.integers(0, 40, 30), "v": np.round(rng.random(30), 6)})])
    paths = {}
    for name, df in (("l", ldf), ("r", rdf), ("s", sdf)):
        paths[name] = str(d / f"{name}.csv")
        df.to_csv(paths[name], index=False)
    return d, paths, {"l": ldf, "r": rdf, "s": sdf}


@pytest.fixture(scope="module", params=["local", "mpi"])
def pair(request, frames):
    j, p = _start_jax(request.param), _start_port(request.param)
    gw = Pair(j, p)
    _, paths, _ = frames
    gw.t = {name: gw.both(op="from_csv", path=path)[0]["id"]
            for name, path in paths.items()}
    yield gw
    try:  # the last request: both answer shutdown alike and exit 0
        got, _ = gw.both(op="shutdown")
        assert got == {"ok": True, "shutdown": True}
        assert j.wait(timeout=60) == 0 and p.wait(timeout=60) == 0
    finally:
        _stop(j)
        _stop(p)


def test_metadata_and_ping(pair, frames):
    _, _, dfs = frames
    assert pair.both(op="ping")[0] == {"ok": True}
    for name, df in dfs.items():
        tid = pair.t[name]
        assert pair.both(op="rows", id=tid)[0]["value"] == len(df)
        assert pair.both(op="columns", id=tid)[0]["value"] == 2
        assert pair.both(op="column_names", id=tid)[0]["value"] == \
            list(df.columns)
        assert pair.rows(tid) == list(df.itertuples(index=False, name=None))


@pytest.mark.parametrize("how", [("inner", "hash"), ("left", "sort"),
                                 ("outer", "hash"), ("right", "sort")])
def test_join(pair, frames, how):
    _, _, dfs = frames
    jt, alg = how
    want = len(dfs["l"].merge(dfs["r"], on="k", how=jt))
    for distributed in (False, True):
        got, _ = pair.both(op="join", left=pair.t["l"], right=pair.t["r"],
                           join_type=jt, algorithm=alg, left_col=0,
                           right_col=0, distributed=distributed)
        assert pair.both(op="rows", id=got["id"])[0]["value"] == want
        pair.both(op="column_names", id=got["id"])
        pair.rows(got["id"])


@pytest.mark.parametrize("op", ["union", "intersect", "subtract"])
def test_set_ops(pair, op):
    for distributed in (False, True):
        got, _ = pair.both(op=op, left=pair.t["l"], right=pair.t["s"],
                           distributed=distributed)
        pair.both(op="rows", id=got["id"])
        pair.rows(got["id"])


def test_sort_show_and_to_csv(pair, frames):
    d, _, dfs = frames
    srt, _ = pair.both(op="sort", id=pair.t["l"], column=0)
    rows = pair.rows(srt["id"])
    assert [r[0] for r in rows] == sorted(dfs["l"]["k"])
    pair.both(op="show", id=pair.t["l"])
    pair.both(op="show", id=srt["id"])
    outs = [str(d / f"out_{pair.ids[srt['id']]}_{s}.csv")
            for s in ("port", "jax")]
    assert _rpc(pair.p, {"op": "to_csv", "id": srt["id"],
                         "path": outs[0]}) == \
        _rpc(pair.j, {"op": "to_csv", "id": pair.ids[srt["id"]],
                      "path": outs[1]}) == {"ok": True}
    a, b = (pd.read_csv(o) for o in outs)
    assert a["k"].is_monotonic_increasing
    assert sorted(a.itertuples(index=False)) == \
        sorted(b.itertuples(index=False))


def test_column_json_and_selects(pair, frames):
    _, _, dfs = frames
    tid = pair.t["l"]
    vals = pair.both(op="column_json", id=tid, column=0)[0]["value"]
    assert vals == dfs["l"]["k"].tolist()
    assert pair.both(op="column_json", id=tid, column=1)[0]["value"] == \
        dfs["l"]["v"].tolist()
    mask = [bool(v == 3) for v in vals]
    sid, _ = pair.both(op="select_mask", id=tid, mask=mask)
    assert len(pair.rows(sid["id"])) == sum(mask)
    for expr in ("k > 4", "(k % 2 == 0) & (v > 0.5)", "v <= 0.25"):
        eid, _ = pair.both(op="select_expr", id=tid, expr=expr)
        assert len(pair.rows(eid["id"])) == len(dfs["l"].query(
            expr.replace("&", "and")))


def test_select_expr_names_torch_not_jnp(pair):
    """The one reference-side difference: the port evaluates with
    ``torch`` in scope, the JAX gateway with ``jnp``.  An expression that
    names ``jnp`` is answered ``ok: false`` by the port, and one that
    names ``torch`` by the JAX gateway; under the same empty builtins."""
    tid = pair.t["l"]
    jid = pair.ids[tid]
    got = _rpc(pair.p, {"op": "select_expr", "id": tid,
                        "expr": "jnp.abs(k) > 4"})
    want = _rpc(pair.j, {"op": "select_expr", "id": jid,
                         "expr": "jnp.abs(k) > 4"})
    assert want["ok"] and not got["ok"] and "jnp" in got["error"]
    tor = _rpc(pair.p, {"op": "select_expr", "id": tid,
                        "expr": "torch.abs(k) > 4"})
    pair.ids[tor["id"]] = want["id"]
    assert tor["ok"] and len(pair.rows(tor["id"])) == \
        len(pair._rows(pair.j, want["id"]))
    for p in (pair.p, pair.j):
        bad = _rpc(p, {"op": "select_expr", "id": tid if p is pair.p
                       else jid, "expr": "len(k) > 0"})
        assert not bad["ok"] and "NameError" in bad["error"]


def test_replace_column_and_from_columns(pair):
    tid = pair.t["l"]
    vals = pair.both(op="column_json", id=tid, column=0)[0]["value"]
    doubled = [v * 2 for v in vals]
    mid, _ = pair.both(op="replace_column", id=tid, column=0,
                       values=doubled, name="k2")
    assert pair.both(op="column_names", id=mid["id"])[0]["value"] == \
        ["k2", "v"]
    assert pair.both(op="column_json", id=mid["id"], column=0)[0][
        "value"] == doubled
    fid, _ = pair.both(op="table_from_columns",
                       columns=[{"name": "a", "values": [1, 2, 3]},
                                {"name": "b", "values": [0.5, 1.5, 2.5]}])
    assert pair.rows(fid["id"]) == [(1, 0.5), (2, 1.5), (3, 2.5)]


@pytest.mark.parametrize("n", [1, 3])
def test_partitions_and_merge(pair, frames, n):
    _, _, dfs = frames
    hp, _ = pair.both(op="hash_partition", id=pair.t["l"], columns=[0], n=n)
    assert len(hp["ids"]) == n
    for i in hp["ids"]:  # the same murmur3 placement in each part
        pair.rows(i)
    rr, _ = pair.both(op="round_robin_partition", id=pair.t["l"], n=n + 1)
    sizes = [pair.both(op="rows", id=i)[0]["value"] for i in rr["ids"]]
    assert sum(sizes) == len(dfs["l"]) and max(sizes) - min(sizes) <= 1
    mg, _ = pair.both(op="merge", ids=hp["ids"])
    assert sorted(pair.rows(mg["id"])) == sorted(
        dfs["l"].itertuples(index=False, name=None))


def test_free_and_protocol_errors(pair):
    fid, _ = pair.both(op="table_from_columns",
                       columns=[{"name": "a", "values": [1]}])
    assert pair.both(op="free", id=fid["id"])[0] == {"ok": True}
    err, _ = pair.both(op="rows", id=fid["id"])
    assert not err["ok"] and "unknown table id" in err["error"]
    assert pair.both(op="bogus")[0] == {"ok": False,
                                        "error": "unknown op 'bogus'"}
    got = _rpc(pair.p, {"op": "rows"})
    want = _rpc(pair.j, {"op": "rows"})
    assert got == want and not got["ok"]


def test_launcher_refuses_foreign_targets():
    """Only Java's ``-m pycylon.java_gateway`` runs; any other ``-m``
    target (or none) exits 2 with a message, before any engine import."""
    for argv in (["-m", "pycylon.other", "mpi"], ["-c", "print(1)"], []):
        r = subprocess.run([str(LAUNCHER), *argv], capture_output=True,
                           text=True, timeout=60, env=_port_env(), cwd="/")
        assert r.returncode == 2, r
        assert "pycylon.java_gateway" in r.stderr and r.stdout == ""


def test_launcher_shutdown_and_world(tmp_path):
    """Java's argv with ``--world 3``: the gateway runs at that world,
    answers, and exits 0 on shutdown; with no card and no ``--device`` it
    exits non-zero (no CPU fallback)."""
    p = _start_port("mpi", "--world", "3")
    try:
        t = _rpc(p, {"op": "table_from_columns",
                     "columns": [{"name": "k", "values": [3, 1, 2, 1]}]})
        u = _rpc(p, {"op": "union", "left": t["id"], "right": t["id"],
                     "distributed": True})
        assert _rpc(p, {"op": "rows", "id": u["id"]})["value"] == 3
        assert _rpc(p, {"op": "shutdown"}) == {"ok": True, "shutdown": True}
        assert p.wait(timeout=60) == 0
    finally:
        _stop(p)
    env = dict(_port_env(), CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([str(LAUNCHER), *JAVA_ARGV, "mpi"], input="",
                       capture_output=True, text=True, timeout=120, env=env,
                       cwd="/")
    assert r.returncode != 0 and "CylonError" in r.stderr
