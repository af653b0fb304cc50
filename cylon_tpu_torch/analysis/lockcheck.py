"""lockcheck — the static half of the concurrency discipline.

The port of ``cylon_tpu/analysis/lockcheck.py``.  Threaded modules
declare a ``GUARDED_STATE`` catalogue: a module-level dict literal
mapping each shared mutable attribute (module global or instance
attribute, by leaf name) to the lock that guards it::

    GUARDED_STATE = {
        "_warned_keys": "_warn_lock",   # module global
        "_entries": "_lock",            # instance attr, any class here
    }

The catalogue is the lint contract (the same pattern that keeps the
metric, fault-point and LOWERING catalogues honest): graftlint's
``shared-state-unguarded`` rule flags any write to a catalogued name
outside a ``with <lock>`` block, and any *uncatalogued* module-level
mutable literal in a threaded module; ``blocking-call-under-lock``
flags a call that can block indefinitely lexically inside a
``with <lock>`` body: a device sync, a host read of a device tensor, a
``torch.distributed`` collective or the ``wait()`` on its work handle,
a sleep, a future's ``.result()`` or a thread's ``.join()``.  A thread
that blocks on device work or on a peer while it holds a lock another
thread needs to make that work progress is a deadlock.  The runtime
half (``observe/locks.py``) enforces what no lexical rule can see: the
global lock acquisition ORDER.

This module holds the pure-AST helpers both rules share (graftlint
imports them), the mtime-cached *path* parser used by the
AST-vs-runtime catalogue-equality tests, and a CLI that lints a tree
with ONLY the two concurrency rules active::

    python -m cylon_tpu_torch.analysis.lockcheck cylon_tpu_torch chip_smoke.py

Exit codes follow the shared analysis contract: 0 clean, 1 findings,
2 usage/parse error.
"""
from __future__ import annotations

import ast
import os
import re
import sys
from typing import Dict, Optional, Sequence, Tuple

from ..observe.locks import OrderedLock

__all__ = ["CONCURRENCY_RULES", "BLOCKING_CALLS", "BLOCKING_METHODS",
           "DIST_COLLECTIVES", "MUTATING_METHODS",
           "guarded_state_from_tree", "guarded_state", "spawns_threads",
           "is_constant_name", "is_mutable_literal", "main"]

CONCURRENCY_RULES = ("shared-state-unguarded", "blocking-call-under-lock")

# Dotted call targets that can block indefinitely — forbidden lexically
# inside a ``with <lock>`` body: the device barrier, the engine's
# sanctioned host reads (each waits for the device work behind its
# tensor) and sleeps.
BLOCKING_CALLS = frozenset({
    "torch.cuda.synchronize", "cuda.synchronize",
    "time.sleep",
    "read_host", "compact.read_host", "ops_compact.read_host",
    "read_counts", "compact.read_counts", "ops_compact.read_counts",
    "host_batch", "table.host_batch",
    "hard_sync", "trace.hard_sync", "_trace.hard_sync",
})

# Method calls that block whatever their receiver: a stream or event
# barrier, a tensor's host read.  ``.result()``, thread ``.join()`` and
# work-handle ``.wait()`` are recognized structurally in graftlint (a
# dotted-name set cannot express their receivers).
BLOCKING_METHODS = frozenset({"synchronize", "item", "cpu"})

# ``torch.distributed`` calls that rendezvous with every peer of the
# group (``dist.<name>`` or ``torch.distributed.<name>``).
DIST_COLLECTIVES = frozenset({
    "all_to_all_single", "all_to_all", "all_gather", "all_gather_object",
    "all_gather_into_tensor", "all_reduce", "reduce", "broadcast",
    "broadcast_object_list", "barrier", "batch_isend_irecv", "send",
    "recv", "reduce_scatter_tensor", "reduce_scatter", "gather",
    "scatter", "monitored_barrier",
})

# Container method calls that mutate the receiver — a write for the
# purposes of shared-state-unguarded.
MUTATING_METHODS = frozenset({
    "append", "appendleft", "add", "pop", "popleft", "popitem", "clear",
    "update", "setdefault", "extend", "extendleft", "discard", "remove",
    "insert",
})

_CONSTANT_NAME_RE = re.compile(r"^_{0,2}[A-Z][A-Z0-9_]*$")

# constructors whose result is a mutable container
_MUTABLE_CTORS = frozenset({
    "dict", "list", "set", "deque", "defaultdict", "OrderedDict",
    "Counter", "bytearray", "WeakSet", "WeakValueDictionary",
    "WeakKeyDictionary",
})


def _dotted_leaf(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def guarded_state_from_tree(tree: ast.Module) -> Optional[Dict[str, str]]:
    """The module's ``GUARDED_STATE`` dict literal (attr leaf name →
    guarding lock leaf name), or None when the module declares none.
    Non-literal entries are ignored — the catalogue is a contract and
    must be statically readable."""
    for node in tree.body:
        if isinstance(node, ast.AnnAssign):
            targets, value = [node.target], node.value
        elif isinstance(node, ast.Assign):
            targets, value = node.targets, node.value
        else:
            continue
        if not any(isinstance(t, ast.Name) and t.id == "GUARDED_STATE"
                   for t in targets):
            continue
        if not isinstance(value, ast.Dict):
            return None
        out: Dict[str, str] = {}
        for k, v in zip(value.keys, value.values):
            if (isinstance(k, ast.Constant) and isinstance(k.value, str)
                    and isinstance(v, ast.Constant)
                    and isinstance(v.value, str)):
                out[k.value] = v.value
        return out
    return None


def spawns_threads(tree: ast.Module) -> bool:
    """Does this module start threads (``threading.Thread(...)``)?
    Thread-spawning modules owe a GUARDED_STATE catalogue for their
    module-level mutables even before any is shared — the next edit is
    one ``self``-capture away from sharing them."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and _dotted_leaf(node.func) == "Thread":
            return True
    return False


def is_constant_name(name: str) -> bool:
    """CONSTANT_CASE names are immutable-by-convention tables (METRICS,
    POINTS, LOWERING…) — exempt from the uncatalogued-mutable arm."""
    return bool(_CONSTANT_NAME_RE.match(name))


def is_mutable_literal(value: ast.AST) -> bool:
    """Is this assigned value a mutable container (display,
    comprehension, or bare mutable-constructor call)?"""
    if isinstance(value, (ast.Dict, ast.List, ast.Set, ast.ListComp,
                          ast.SetComp, ast.DictComp)):
        return True
    if isinstance(value, ast.Call):
        return _dotted_leaf(value.func) in _MUTABLE_CTORS
    return False


# ---------------------------------------------------------------------------
# mtime-cached path parser — the runtime-equality half.
#
# graftlint reads GUARDED_STATE straight from the tree it is linting (so
# synthetic fixtures fire without any file I/O); this parser reads it from
# a FILE, mtime-cached, for the tests that pin the AST view to the
# imported module's runtime dict.  The cache mutation is atomic under a
# catalogued OrderedLock — this module practices the discipline it checks.
# ---------------------------------------------------------------------------

_cache_lock = OrderedLock("lockcheck.catalogue_cache")
_guarded_cache: Dict[str, Tuple[float, Optional[Dict[str, str]]]] = {}

GUARDED_STATE = {"_guarded_cache": "_cache_lock"}


def guarded_state(path: str) -> Optional[Dict[str, str]]:
    """``GUARDED_STATE`` of the module at ``path`` (mtime-cached parse),
    or None when the file is missing/unparseable/uncatalogued."""
    try:
        mtime = os.path.getmtime(path)
    except OSError:
        return None
    with _cache_lock:
        hit = _guarded_cache.get(path)
        if hit is not None and hit[0] == mtime:
            return None if hit[1] is None else dict(hit[1])
        try:
            with open(path, "r", encoding="utf-8") as fh:
                tree = ast.parse(fh.read(), filename=path)
            names = guarded_state_from_tree(tree)
        except (OSError, SyntaxError):
            names = None
        _guarded_cache[path] = (mtime, names)
    return None if names is None else dict(names)


def clear_cache() -> None:
    """Forget every cached parse (test isolation)."""
    with _cache_lock:
        _guarded_cache.clear()


# ---------------------------------------------------------------------------
# CLI: the two concurrency rules alone
# ---------------------------------------------------------------------------

def main(argv: Optional[Sequence[str]] = None) -> int:
    from . import graftlint

    argv = list(sys.argv[1:] if argv is None else argv)
    paths = [a for a in argv if not a.startswith("-")]
    if not paths:
        print("usage: python -m cylon_tpu_torch.analysis.lockcheck "
              "PATH [PATH ...]", file=sys.stderr)
        return 2
    missing = [p for p in paths if not os.path.exists(p)]
    if missing:
        print(f"lockcheck: no such path: {', '.join(missing)}",
              file=sys.stderr)
        return 2
    findings = graftlint.lint_paths(paths)
    if any(f.rule == "parse-error" for f in findings):
        for f in findings:
            if f.rule == "parse-error":
                print(f)
        print("lockcheck: parse error", file=sys.stderr)
        return 2
    findings = [f for f in findings if f.rule in CONCURRENCY_RULES]
    for f in findings:
        print(f)
    if findings:
        print(f"lockcheck: {len(findings)} finding(s)", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
