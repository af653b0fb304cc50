"""The port's graftlint against the JAX package's: each ported rule on a
seeded violation and its clean spelling, suppressions, the CLI's exit
contract, each catalogue's AST parse against its runtime value, the same
``(rule, line)`` findings as the JAX linter on the same snippets for the
rules that mean the same, ``implicit-host-sync`` on translated jnp / torch
pairs, and the tier-1 gate: the port and ``chip_smoke.py`` lint clean."""
import os
import subprocess
import sys

import pytest

from cylon_tpu.analysis import graftlint as jlint

from cylon_tpu_torch.analysis import graftlint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TPATH = os.path.join(REPO, "cylon_tpu_torch", "parallel", "zz_fixture.py")
JPATH = os.path.join(REPO, "cylon_tpu", "parallel", "zz_fixture.py")


def _rules(src, path="fixture.py"):
    return sorted({f.rule for f in graftlint.lint_source(src, path)})


def _found(lint, src, path):
    return sorted((f.rule, f.line) for f in lint.lint_source(src, path))


# ---------------------------------------------------------------------------
# each rule: a seeded violation, and its clean spelling
# ---------------------------------------------------------------------------

HOST_SYNC = [
    ("x = v.item()\n", ["implicit-host-sync"]),
    ("import torch\nn = int(torch.sum(dt.counts))\n",
     ["implicit-host-sync"]),
    ("r = dt.counts.tolist()\nb = bool(m.validity.any())\n",
     ["implicit-host-sync"]),
    ("import numpy as np\nh = np.asarray(torch.cumsum(a, 0))\n",
     ["implicit-host-sync"]),
    ("h = c.data.cpu()\ng = c.data.to('cpu')\n", ["implicit-host-sync"]),
    # host values, static metadata and a bare .numpy() are clean
    ("import numpy as np\nn = int(per_shard.max(initial=0))\n"
     "m = int(col.data.shape[0]) + int(col.data.numel())\n"
     "e = int(c.data.element_size())\nh = np.asarray(host_rows)\n"
     "t = host.tolist()\nv = c.data.numpy()\n", []),
    ("import torch\ni = int(torch.iinfo(torch.int32).max)\n", []),
]


@pytest.mark.parametrize("src,want", HOST_SYNC)
def test_implicit_host_sync(src, want):
    assert _rules(src) == want


def test_host_copy_is_sanctioned_in_the_boundary_modules():
    src = "h = dt.counts.cpu()\n"
    assert _rules(src, "cylon_tpu_torch/parallel/dist_ops.py") \
        == ["implicit-host-sync"]
    for ok in ("cylon_tpu_torch/ops/compact.py", "cylon_tpu_torch/table.py",
               "cylon_tpu_torch/trace.py", "cylon_tpu_torch/io/csv.py"):
        assert _rules(src, ok) == []


def test_kernel_factory_unkeyed():
    pos = ("import torch\n"
           "def _compiled(fn):\n"
           "    return torch.compile(fn)\n")
    assert _rules(pos) == ["kernel-factory-unkeyed"]
    so = ("import ctypes\n"
          "def _lib(path):\n"
          "    return ctypes.CDLL(path)\n")
    assert _rules(so) == ["kernel-factory-unkeyed"]
    clean = ("import functools, torch\n"
             "@functools.lru_cache(maxsize=None)\n"
             "def _compiled(cap):\n"
             "    def kernel(x):\n"
             "        return x + cap\n"
             "    return torch.compile(kernel)\n")
    assert _rules(clean) == []
    keyed = clean.replace("@functools.lru_cache(maxsize=None)",
                          "@kernel_factory")
    assert _rules(keyed) == []
    sup = pos.replace("def _compiled(fn):",
                      "def _compiled(fn):  # graftlint: ok[kernel-factory-unkeyed]")
    assert _rules(sup) == []


def test_jit_in_loop():
    pos = ("import torch\n"
           "for i in range(3):\n"
           "    f = torch.compile(lambda x: x + i)\n")
    assert "jit-in-loop" in _rules(pos)
    pos2 = ("from torch.utils import cpp_extension\n"
            "while True:\n"
            "    m = cpp_extension.load('k', ['k.cu'])\n")
    assert "jit-in-loop" in _rules(pos2)
    clean = ("import torch\n"
             "f = torch.compile(lambda x: x + 1)\n"
             "for i in range(3):\n"
             "    y = f(i)\n")
    assert _rules(clean) == []


def test_catalogue_rules():
    """counter / fault-point / dist-op: a name outside the port's
    catalogue fires, a catalogued or dynamic one does not."""
    path = "cylon_tpu_torch/parallel/fixture.py"
    assert _rules("from .. import trace\ntrace.count('nope.metric')\n",
                  path) == ["counter-not-in-catalogue"]
    assert _rules("from .. import trace\ntrace.count('shuffle.exchanges')\n"
                  "trace.count(name)\n", path) == []
    assert _rules("from .. import faults\nfaults.check('nope.point')\n",
                  path) == ["fault-point-not-in-catalogue"]
    assert _rules("from .. import faults\nfaults.check('exec.stage')\n",
                  path) == []
    op = ("from ..analysis import plan_check\n"
          "@plan_check.instrument\n"
          "def dist_frobnicate(dt):\n"
          "    return dt\n")
    assert _rules(op, TPATH) == ["dist-op-unlowered"]
    assert _rules(op.replace("dist_frobnicate", "dist_join"), TPATH) == []
    assert _rules(op, "fixture.py") == []


def test_host_array_unpooled_and_warn_once_key():
    src = "import numpy as np\nh = np.asarray(c.data)\n"
    assert _rules(src, TPATH) == ["host-array-unpooled",
                                  "implicit-host-sync"]
    assert _rules(src.replace("np.asarray(c.data)", "c.data.cpu()"),
                  TPATH) == ["host-array-unpooled", "implicit-host-sync"]
    # the pool's boundary list sanctions the ingest / export modules
    assert _rules("h = c.data.cpu()\n",
                  os.path.join(REPO, "cylon_tpu_torch", "tpch", "x.py")) \
        == ["implicit-host-sync"]
    bad = ("from cylon_tpu_torch import logging as glog\n"
           "def f(key):\n    glog.warn_once(key, 'm')\n")
    assert _rules(bad) == ["warn-once-key-literal"]
    assert _rules(bad.replace("warn_once(key", "warn_once(('k.x', key)")) \
        == []


def test_suppressions_on_one_line_and_across_an_expression():
    assert _rules("x = v.item()  # graftlint: ok[implicit-host-sync]\n") \
        == []
    assert _rules("x = v.item()  # graftlint: ok\n") == []
    assert _rules("x = v.item()  # graftlint: ok[broad-except]\n") \
        == ["implicit-host-sync"]
    multi = ("import torch\n"
             "n = int(\n"
             "    torch.sum(dt.counts))  # graftlint: ok[implicit-host-sync]\n")
    assert _rules(multi) == []
    # a suppression in a handler's body does not waive its except line
    buried = ("try:\n    x()\nexcept Exception:\n"
              "    y = 1  # graftlint: ok[broad-except]\n")
    assert _rules(buried) == ["broad-except"]


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case,rc", [("clean", 0), ("seeded", 1),
                                     ("usage", 2)])
def test_cli_exit_codes(tmp_path, case, rc):
    f = tmp_path / "m.py"
    f.write_text({"clean": "x = 1\n",
                  "seeded": "import torch\nn = int(torch.sum(dt.counts))\n",
                  "usage": "def f(:\n"}[case])
    args = [str(f)]
    if case == "usage":   # a parse error and a missing path alike
        assert graftlint.main([]) == 2
        assert graftlint.main(["/no/such/path"]) == 2
    proc = subprocess.run(
        [sys.executable, "-m", "cylon_tpu_torch.analysis.graftlint", *args],
        capture_output=True, text=True, cwd=REPO, timeout=300)
    assert proc.returncode == rc, proc.stdout + proc.stderr
    if case == "seeded":
        assert "implicit-host-sync" in proc.stdout


# ---------------------------------------------------------------------------
# the catalogues: AST parse = runtime value
# ---------------------------------------------------------------------------

def _runtime(name):
    if name == "METRICS":
        from cylon_tpu_torch.observe.metrics import METRICS
        return set(METRICS)
    if name == "POINTS":
        from cylon_tpu_torch.faults import POINTS
        return set(POINTS)
    if name == "LOWERING":
        from cylon_tpu_torch.plan.executor import LOWERING
        return set(LOWERING)
    from cylon_tpu_torch.spill.pool import SANCTIONED_HOST_BOUNDARIES
    return set(SANCTIONED_HOST_BOUNDARIES)


@pytest.mark.parametrize("name,parse", [
    ("METRICS", graftlint._metric_names),
    ("POINTS", graftlint._fault_point_names),
    ("LOWERING", graftlint._lowering_keys),
    ("SANCTIONED_HOST_BOUNDARIES", graftlint._host_boundary_names),
])
def test_catalogue_parse_matches_runtime(name, parse):
    names = parse(TPATH)
    assert names is not None and set(names) == _runtime(name)


# ---------------------------------------------------------------------------
# parity with the JAX linter
# ---------------------------------------------------------------------------

SAME_MEANING = {
    "broad_except": "try:\n    x()\nexcept Exception:\n    pass\n"
                    "try:\n    y()\nexcept (ValueError, BaseException):\n"
                    "    out = None\n"
                    "try:\n    z()\nexcept Exception as e:\n    raise\n",
    "warn_once": "from cylon_tpu import logging as glog\n"
                 "def f(key, q):\n    glog.warn_once(key, 'm')\n"
                 "    glog.warn_once(f'slo.{q}', 'm')\n"
                 "    glog.warn_once(('shuffle.skew', q), 'm')\n",
    "catalogues": "from .. import trace, faults\n"
                  "def f(v):\n    trace.count('nope.metric')\n"
                  "    trace.count('shuffle.exchanges')\n"
                  "    faults.check('nope.point')\n"
                  "    return faults.perturb('resilience.budget', v)\n",
    "dist_op": "from ..analysis import plan_check\n"
               "@plan_check.instrument\n"
               "def dist_frobnicate(dt):\n    return dt\n"
               "@plan_check.instrument\n"
               "def dist_join(dt):\n    return dt\n",
    "shared_state": "import threading\n"
                    "GUARDED_STATE = {'_items': '_lock'}\n"
                    "_items: list = []\n_lock = threading.Lock()\n"
                    "_other: dict = {}\n"
                    "def f(x):\n    _items.append(x)\n"
                    "    with _lock:\n        _items.append(x)\n",
    "blocking": "import threading, time\n_lock = threading.Lock()\n"
                "def f(fut, th, strs):\n    with _lock:\n"
                "        time.sleep(0.1)\n        fut.result(5)\n"
                "        th.join(2.0)\n        s = ', '.join(strs)\n",
    "unpooled": "import numpy as np\nh = np.asarray(c.data)\n"
                "g = np.array(leaves[0])\n",
}


@pytest.mark.parametrize("case", list(SAME_MEANING))
def test_same_findings_as_jax(case):
    src = SAME_MEANING[case]
    got = _found(graftlint, src, TPATH)
    assert got and got == _found(jlint, src, JPATH)


# (JAX snippet, torch snippet): each the other's translation
TRANSLATED = [
    ("import jax.numpy as jnp\nn = int(jnp.sum(dt.counts))\n",
     "import torch\nn = int(torch.sum(dt.counts))\n"),
    ("import jax.numpy as jnp\nimport numpy as np\n"
     "h = np.asarray(jnp.cumsum(c.data))\n",
     "import torch\nimport numpy as np\n"
     "h = np.asarray(torch.cumsum(c.data, 0))\n"),
    ("import jax\nv = jax.device_get(dt.counts)\n",
     "import torch\nv = dt.counts.cpu()\n"),
    ("import jax.numpy as jnp\nok = bool(jnp.any(m.validity))\n"
     "s = float(jnp.max(c.data))\nn = int(c.data.shape[0])\n",
     "import torch\nok = bool(torch.any(m.validity))\n"
     "s = float(torch.max(c.data))\nn = int(c.data.shape[0])\n"),
    ("x = v.item()\ny = int(host.max())\n",
     "x = v.item()\ny = int(host.max())\n"),
]


@pytest.mark.parametrize("jsrc,tsrc", TRANSLATED)
def test_implicit_host_sync_translated_pairs(jsrc, tsrc):
    """A jnp snippet and its torch translation give implicit-host-sync at
    the same lines, inside and outside the sanctioned modules."""
    for jp, tp in (("cylon_tpu/parallel/dist_ops.py",
                    "cylon_tpu_torch/parallel/dist_ops.py"),
                   ("cylon_tpu/ops/compact.py",
                    "cylon_tpu_torch/ops/compact.py")):
        want = [ln for r, ln in _found(jlint, jsrc, jp)
                if r == "implicit-host-sync"]
        got = [ln for r, ln in _found(graftlint, tsrc, tp)
               if r == "implicit-host-sync"]
        assert got == want


def test_rules_ported_and_not_ported():
    """Every JAX rule is either ported or listed as not ported, with the
    reason, in the module docstring too."""
    assert set(graftlint.RULES) | set(graftlint.NOT_PORTED) \
        == set(jlint.RULES)
    assert not set(graftlint.RULES) & set(graftlint.NOT_PORTED)
    for rule in graftlint.NOT_PORTED:
        assert rule in graftlint.__doc__


def test_port_lints_clean():
    """The tier-1 gate: the port and the chip smoke script carry zero
    unsuppressed findings."""
    findings = graftlint.lint_paths([os.path.join(REPO, "cylon_tpu_torch"),
                                     os.path.join(REPO, "chip_smoke.py")])
    assert findings == [], "\n".join(str(f) for f in findings)
