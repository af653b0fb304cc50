"""graftlint — AST linter for the hazard classes torch cannot type-check.

The port of ``cylon_tpu/analysis/graftlint.py``.  The engine's
performance contract rests on invariants invisible to the Python type
system: no implicit device→host transfer inside hot spans, kernels and
compiled callables built once per key, and every metric, fault point and
distributed entry point in its catalogue.  Each rule encodes one of
those invariants as a static check, with its torch meaning:

  implicit-host-sync      ``.item()``; ``.tolist()``, ``int()`` /
                          ``float()`` / ``bool()`` and ``np.asarray()`` /
                          ``np.array()`` applied to a tensor-valued
                          expression (a ``torch.*`` call result or the
                          table types' device attributes ``data`` /
                          ``counts`` / ``validity`` / ``pending_mask``,
                          with method and index chains hanging off
                          either; ``shape``, ``dtype``, ``device``,
                          ``numel()``, ``element_size()`` and the like
                          are static and exempt); ``.cpu()`` /
                          ``.to("cpu")`` outside the modules where the
                          sanctioned reads live (``DEVICE_GET_ALLOWED``:
                          ``ops/compact.read_host`` / ``read_counts``,
                          ``table.host_batch``, ``trace.hard_sync``, the
                          ingest / export and spill boundaries).  A bare
                          ``.numpy()`` is not flagged: on a card tensor it
                          raises, so it only ever reads a host copy.
  kernel-factory-unkeyed  a function that builds a kernel or a compiled
                          callable (``torch.compile``, ``torch.jit.script``
                          / ``trace``, ``torch.utils.cpp_extension.load`` /
                          ``load_inline``, ``ctypes.CDLL`` of a built
                          ``.so``, the ``ops/hash_cuda.py`` build) without
                          an ``observe.compile.kernel_factory`` /
                          ``lru_cache`` decorator (every call rebuilds),
                          or whose nested kernel closes over a name that
                          is not part of its cache key.
  jit-in-loop             one of those build calls inside a ``for`` /
                          ``while`` body.
  broad-except            a bare ``except:`` / ``except Exception:`` /
                          ``except BaseException:`` handler that never
                          re-raises — it can swallow ``ReplayNeeded``
                          (breaking deferred-pipeline replay) or a typed
                          ``CylonError``.
  dist-op-unlowered       an ``@plan_check.instrument`` ``dist_*`` /
                          ``shuffle_*`` entry point in
                          cylon_tpu_torch/parallel/ with no case in the
                          plan executor's ``LOWERING`` table
                          (cylon_tpu_torch/plan/executor.py).
  counter-not-in-catalogue  a string-literal metric name bumped via
                          ``trace.count`` / ``count_max`` / ``gauge`` /
                          ``hist`` with no row in the observe catalogue
                          (cylon_tpu_torch/observe/metrics.py
                          ``METRICS``).  Dynamic names are skipped.
  fault-point-not-in-catalogue  a string-literal point name consulted via
                          ``faults.check`` / ``faults.perturb`` with no
                          row in the fault-point catalogue
                          (cylon_tpu_torch/faults.py ``POINTS``).
  host-array-unpooled     a ``.cpu()`` / ``np.asarray()`` / ``np.array()``
                          materialization whose argument is LEAF-SIZED
                          (mentions ``.data`` / ``.validity`` /
                          ``.pending_mask`` or a ``leaves``-named
                          collection) outside the spill pool and the
                          sanctioned device↔host boundaries
                          (cylon_tpu_torch/spill/pool.py
                          ``SANCTIONED_HOST_BOUNDARIES``) — route it
                          through ``spill.pool.stage_out_arrays``.
  warn-once-key-literal   a ``glog.warn_once`` whose key is neither a
                          string literal nor a tuple opening with one.
  shared-state-unguarded  a write to a name the module's
                          ``GUARDED_STATE`` catalogue maps to a lock,
                          outside a ``with <that lock>`` block — or an
                          uncatalogued module-level mutable literal in a
                          threaded module.  Module top level,
                          ``__init__`` / ``__new__`` bodies and
                          ``*_locked`` functions are exempt.
  blocking-call-under-lock  a call that can block indefinitely
                          (``analysis.lockcheck.BLOCKING_CALLS``:
                          ``torch.cuda.synchronize``, a stream's or
                          event's ``.synchronize()``, ``.item()``,
                          ``.cpu()``, ``read_host`` / ``read_counts`` /
                          ``host_batch`` / ``hard_sync``, a
                          ``torch.distributed`` collective or the
                          ``.wait()`` on its work handle, ``time.sleep``,
                          ``.result()``, a thread's ``.join()``)
                          lexically inside a ``with <lock>`` body.
                          ``Condition.wait`` on the held condition is
                          exempt (it releases the lock while waiting).

Not ported, because torch has no such hazard:

  raw-float64-literal     torch's 64-bit types exist unconditionally:
                          there is no x64 switch that narrows them.
  shard-map-axis-literal  the port's collectives take a communicator and
                          a process group, never a mesh-axis name.

Findings carry ``file:line:col``; suppress a deliberate site with a
``# graftlint: ok[rule]`` (or bare ``# graftlint: ok``) comment on any
line the flagged expression spans.

CLI::

    python -m cylon_tpu_torch.analysis.graftlint cylon_tpu_torch chip_smoke.py

exits 0 when clean, 1 with findings, 2 on usage/parse errors.
"""
from __future__ import annotations

import ast
import os
import re
import symtable
import sys
import threading
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

__all__ = ["Finding", "RULES", "NOT_PORTED", "lint_source", "lint_paths",
           "main"]

RULES = (
    "implicit-host-sync",
    "kernel-factory-unkeyed",
    "jit-in-loop",
    "fault-point-not-in-catalogue",
    "broad-except",
    "dist-op-unlowered",
    "counter-not-in-catalogue",
    "warn-once-key-literal",
    "host-array-unpooled",
    "shared-state-unguarded",
    "blocking-call-under-lock",
)

# The reference's rules with no torch meaning, and why.
NOT_PORTED = {
    "raw-float64-literal":
        "torch's 64-bit types exist with no x64 switch to narrow them",
    "shard-map-axis-literal":
        "the port's collectives take a communicator and a process group, "
        "never a mesh-axis name",
}

_PKG = "cylon_tpu_torch/"

# Modules whose job IS the device↔host boundary: ingest, export, the
# batched count protocol (ops/compact.read_host / read_counts), the
# tracing sync (trace.hard_sync), per-cell accessors.  A ``.cpu()`` there
# is the sanctioned spelling; anywhere else it must be suppressed with a
# comment saying why.
DEVICE_GET_ALLOWED = (
    _PKG + "trace.py",
    _PKG + "table.py",
    _PKG + "row.py",
    _PKG + "parallel/dtable.py",
    _PKG + "ops/compact.py",
    _PKG + "io/",
    # the spill pool IS the sanctioned host-tier staging boundary; its
    # batched stage-out is the route host-array-unpooled points everyone
    # else at
    _PKG + "spill/pool.py",
    # the EXPLAIN ANALYZE measurement boundary: its row peeks are
    # deliberate, explicit, per-operator host reads
    _PKG + "observe/analyze.py",
)

# Attribute names that hold device tensors throughout this codebase
# (Column/DTable fields).  ``host_data``/``_counts_host`` are the
# host-side mirrors and intentionally absent.
_DEVICE_ATTRS = {"data", "counts", "validity", "pending_mask"}

# static metadata reads on a tensor — no transfer involved
_STATIC_ATTRS = {"shape", "dtype", "ndim", "device", "is_cuda", "layout",
                 "itemsize", "nbytes", "is_meta", "requires_grad"}
_STATIC_METHODS = {"numel", "nelement", "element_size", "dim", "size",
                   "stride", "data_ptr", "is_contiguous", "get_device",
                   "is_floating_point", "is_complex", "storage_offset",
                   "untyped_storage"}

# ``torch.<name>`` calls that return host values, not tensors
_TORCH_HOST_FNS = {"iinfo", "finfo", "device", "dtype", "is_tensor",
                   "is_floating_point", "is_complex", "numel",
                   "get_default_dtype", "is_grad_enabled", "Size",
                   "result_type", "promote_types", "can_cast"}
# ``torch.<sub>.*`` namespaces whose calls return tensors
_TORCH_TENSOR_NS = {"nn", "special", "linalg", "fft"}

# Calls that build a kernel or a compiled callable.
_BUILD_CALLS = {
    "torch.compile", "torch.jit.script", "torch.jit.trace", "jit.script",
    "jit.trace", "torch.utils.cpp_extension.load",
    "torch.utils.cpp_extension.load_inline", "cpp_extension.load",
    "cpp_extension.load_inline", "load_inline", "ctypes.CDLL", "CDLL",
    "ctypes.cdll.LoadLibrary", "cdll.LoadLibrary", "hash_cuda.build",
}

_CACHE_DECORATORS = {"lru_cache", "cache", "kernel_factory"}

_SUPPRESS_RE = re.compile(
    r"#\s*graftlint:\s*ok(?:\[([A-Za-z0-9_,\- ]+)\])?")


@dataclass(frozen=True)
class Finding:
    path: str
    line: int
    col: int
    rule: str
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule}: {self.message}"


def _suppressions(source: str) -> Dict[int, Optional[Set[str]]]:
    """line → None (all rules) or the set of rule names waived there."""
    out: Dict[int, Optional[Set[str]]] = {}
    for i, text in enumerate(source.splitlines(), start=1):
        m = _SUPPRESS_RE.search(text)
        if not m:
            continue
        if m.group(1) is None:
            out[i] = None
        else:
            out[i] = {r.strip() for r in m.group(1).split(",") if r.strip()}
    return out


def _dotted(node: ast.AST) -> Optional[str]:
    """'torch.cuda.synchronize' for a Name/Attribute chain, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _is_torch_tensor_call(target: str) -> bool:
    parts = target.split(".")
    if parts[0] != "torch" or len(parts) < 2:
        return False
    if len(parts) == 2:
        return parts[1] not in _TORCH_HOST_FNS
    return parts[1] in _TORCH_TENSOR_NS


def _is_tensorish(node: ast.AST) -> bool:
    """Syntactic heuristic: does this expression produce a DEVICE tensor?

    Tuned for precision over recall (a silent miss beats a noisy false
    positive): ``torch.*`` call results, the device attributes of the
    table types, and method/index chains hanging off either.
    """
    if isinstance(node, ast.Attribute):
        if node.attr in _STATIC_ATTRS:
            return False  # static metadata of a tensor, not data
        if node.attr in _DEVICE_ATTRS:
            return True
        return _is_tensorish(node.value)
    if isinstance(node, ast.Subscript):
        return _is_tensorish(node.value)
    if isinstance(node, ast.Call):
        target = _dotted(node.func)
        if target is not None and _is_torch_tensor_call(target):
            return True
        if isinstance(node.func, ast.Attribute):  # method chain: x.sum()
            if node.func.attr in _STATIC_METHODS:
                return False
            return _is_tensorish(node.func.value)
    if isinstance(node, ast.BinOp):
        return _is_tensorish(node.left) or _is_tensorish(node.right)
    return False


def _is_host_copy_call(node: ast.Call) -> bool:
    """``x.cpu()`` or ``x.to("cpu"...)`` / ``x.to(device="cpu")``: the
    explicit device→host copy (the torch spelling of ``jax.device_get``)."""
    if not isinstance(node.func, ast.Attribute):
        return False
    if node.func.attr == "cpu" and not node.args:
        return True
    if node.func.attr != "to":
        return False
    args = list(node.args[:1]) + [kw.value for kw in node.keywords
                                  if kw.arg == "device"]
    return any(isinstance(a, ast.Constant) and a.value == "cpu"
               for a in args)


class _Linter(ast.NodeVisitor):
    def __init__(self, path: str, source: str):
        self.path = path
        self.norm = path.replace(os.sep, "/")
        self.source = source
        self.findings: List[Finding] = []
        self.module_names: Set[str] = set()
        self.loop_depth = 0
        self._suppress = _suppressions(source)
        self._finding_lines: Dict[Tuple[int, int, str], Tuple[int, int]] = {}
        # concurrency-rule state: the module's GUARDED_STATE catalogue,
        # the lock names it references, and the lexical with/function
        # context maintained during traversal
        self.guarded: Optional[Dict[str, str]] = None
        self.lock_names: Set[str] = set()
        self._with_stack: List[str] = []
        self._func_stack: List[str] = []
        self._lc = None          # the lockcheck helper module (run())

    # -- plumbing -----------------------------------------------------------

    def run(self, tree: ast.Module) -> List[Finding]:
        from . import lockcheck as _lockcheck
        self._lc = _lockcheck
        self.module_names = _module_bindings(tree)
        self.guarded = _lockcheck.guarded_state_from_tree(tree)
        self.lock_names = set(self.guarded.values()) if self.guarded \
            else set()
        if self.guarded is not None or _lockcheck.spawns_threads(tree):
            self._check_module_mutables(tree, _lockcheck)
        self.visit(tree)
        self._check_factories(tree)
        self._check_unlowered(tree)
        return [f for f in self.findings if not self._suppressed(f)]

    def _suppressed(self, f: Finding) -> bool:
        node_lines = self._finding_lines.get((f.line, f.col, f.rule),
                                             (f.line, f.line))
        for line in range(node_lines[0], node_lines[1] + 1):
            rules = self._suppress.get(line, "missing")
            if rules is None or (rules != "missing" and f.rule in rules):
                return True
        return False

    def _emit(self, node: ast.AST, rule: str, message: str,
              def_line_only: bool = False) -> None:
        """``def_line_only`` narrows the suppression span to the node's
        first line — used for function-level findings, where the full
        span would let an unrelated suppression deep in the body waive
        the finding by accident."""
        f = Finding(self.path, node.lineno, node.col_offset, rule, message)
        end = node.lineno if def_line_only else (
            getattr(node, "end_lineno", node.lineno) or node.lineno)
        self._finding_lines[(f.line, f.col, rule)] = (node.lineno, end)
        self.findings.append(f)

    # -- traversal ----------------------------------------------------------

    def visit_For(self, node: ast.For) -> None:
        self._loop(node)

    def visit_AsyncFor(self, node: ast.AsyncFor) -> None:
        self._loop(node)

    def visit_While(self, node: ast.While) -> None:
        self._loop(node)

    def _loop(self, node) -> None:
        self.loop_depth += 1
        self.generic_visit(node)
        self.loop_depth -= 1

    def visit_Call(self, node: ast.Call) -> None:
        target = _dotted(node.func)
        self._check_host_sync(node, target)
        self._check_jit_in_loop(node, target)
        self._check_counter_catalogue(node, target)
        self._check_warn_once_key(node, target)
        self._check_fault_catalogue(node, target)
        self._check_host_unpooled(node, target)
        self._check_blocking_under_lock(node, target)
        self._check_mutating_call(node)
        self.generic_visit(node)

    def visit_ExceptHandler(self, node: ast.ExceptHandler) -> None:
        self._check_broad_except(node)
        self.generic_visit(node)

    def visit_With(self, node: ast.With) -> None:
        self._with(node)

    def visit_AsyncWith(self, node: ast.AsyncWith) -> None:
        self._with(node)

    def _with(self, node) -> None:
        leaves = []
        for item in node.items:
            d = _dotted(item.context_expr)
            if d:
                leaves.append(d.rsplit(".", 1)[-1])
        self._with_stack.extend(leaves)
        self.generic_visit(node)
        if leaves:
            del self._with_stack[-len(leaves):]

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self._function(node)

    def visit_AsyncFunctionDef(self, node: ast.AsyncFunctionDef) -> None:
        self._function(node)

    def visit_Lambda(self, node: ast.Lambda) -> None:
        self._function(node, name="<lambda>")

    def _function(self, node, name: Optional[str] = None) -> None:
        # a function DEFINED inside a `with lock:` body runs later, not
        # under the lock — the lexical with-context must not leak into
        # its body (and vice versa for the function-name exemptions)
        saved = self._with_stack
        self._with_stack = []
        self._func_stack.append(name or node.name)
        self.generic_visit(node)
        self._func_stack.pop()
        self._with_stack = saved

    def visit_Assign(self, node: ast.Assign) -> None:
        for t in node.targets:
            self._check_guarded_write(t, t)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self._check_guarded_write(node.target, node)
        self.generic_visit(node)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        if node.value is not None:
            self._check_guarded_write(node.target, node)
        self.generic_visit(node)

    def visit_Delete(self, node: ast.Delete) -> None:
        for t in node.targets:
            self._check_guarded_write(t, node)
        self.generic_visit(node)

    # -- shared-state-unguarded ----------------------------------------------

    @staticmethod
    def _write_leaf(target: ast.AST) -> Optional[str]:
        """The catalogued leaf name a write target touches:
        ``self._entries[k] = v`` and ``._entries.pop(k)`` both touch
        ``_entries``; ``self._n += 1`` touches ``_n``."""
        while isinstance(target, (ast.Subscript, ast.Starred)):
            target = target.value
        if isinstance(target, ast.Attribute):
            return target.attr
        if isinstance(target, ast.Name):
            return target.id
        return None

    def _exempt_context(self) -> bool:
        """Writes at module top level and in ``__init__``/``__new__``
        bodies initialize not-yet-shared objects; ``*_locked``
        functions hold the lock by contract (their callers own the
        ``with``)."""
        if not self._func_stack:
            return True
        fn = self._func_stack[-1]
        return fn in ("__init__", "__new__") or fn.endswith("_locked")

    def _check_guarded_write(self, target: ast.AST,
                             node: ast.AST) -> None:
        if not self.guarded:
            return
        if isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self._check_guarded_write(elt, node)
            return
        leaf = self._write_leaf(target)
        if leaf is None or leaf not in self.guarded:
            return
        if self._exempt_context():
            return
        need = self.guarded[leaf]
        if need in self._with_stack:
            return
        self._emit(node, "shared-state-unguarded",
                   f"write to {leaf!r} outside `with {need}:` — the "
                   "GUARDED_STATE catalogue maps it to that lock "
                   "(hold the lock, move the write into a *_locked "
                   "helper, or fix the catalogue)")

    def _check_mutating_call(self, node: ast.Call) -> None:
        """``x.append(…)`` / ``.pop`` / ``.update`` … on a catalogued
        container is a write like any other."""
        if not self.guarded or not isinstance(node.func, ast.Attribute):
            return
        if node.func.attr not in self._lc.MUTATING_METHODS:
            return
        self._check_guarded_write(node.func.value, node)

    def _check_module_mutables(self, tree: ast.Module,
                               _lockcheck) -> None:
        """In a threaded module (declares GUARDED_STATE or spawns
        threads), every module-level mutable literal must be catalogued
        — an uncatalogued one is shared state the lint cannot protect.
        CONSTANT_CASE names are immutable-by-convention tables
        (METRICS, POINTS, LOWERING…) and exempt."""
        for node in tree.body:
            if isinstance(node, ast.Assign):
                targets, value = node.targets, node.value
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                targets, value = [node.target], node.value
            else:
                continue
            for t in targets:
                if not isinstance(t, ast.Name):
                    continue
                name = t.id
                if (name == "GUARDED_STATE" or name.startswith("__")
                        or _lockcheck.is_constant_name(name)):
                    continue
                if self.guarded and (name in self.guarded
                                     or name in self.lock_names):
                    continue
                if not _lockcheck.is_mutable_literal(value):
                    continue
                self._emit(node, "shared-state-unguarded",
                           f"module-level mutable {name!r} in a "
                           "threaded module is not in the GUARDED_STATE "
                           "catalogue — map it to its guarding lock, or "
                           "rename to CONSTANT_CASE if it is an "
                           "immutable table")

    # -- blocking-call-under-lock --------------------------------------------

    def _innermost_lock(self) -> Optional[str]:
        for name in reversed(self._with_stack):
            if "lock" in name.lower() or name in self.lock_names:
                return name
        return None

    def _check_blocking_under_lock(self, node: ast.Call,
                                   target: Optional[str]) -> None:
        """A device sync, a host read of a device tensor, a collective or
        a thread rendezvous lexically inside a ``with <lock>`` body: the
        blocked work may need a thread that needs this lock.  Waiting on
        the HELD condition is exempt — ``Condition.wait`` releases the
        lock while waiting, the sanctioned way to block under one."""
        lock = self._innermost_lock()
        if lock is None:
            return
        lc = self._lc
        head, _, leaf = (target or "").rpartition(".")
        if target in lc.BLOCKING_CALLS or (
                head in ("dist", "torch.distributed", "_dist")
                and leaf in lc.DIST_COLLECTIVES):
            self._emit(node, "blocking-call-under-lock",
                       f"{target}() can block indefinitely while `with "
                       f"{lock}:` is held — move the blocking work outside "
                       "the lock (capture state under it, block after "
                       "release)")
            return
        if not isinstance(node.func, ast.Attribute):
            return
        attr = node.func.attr
        if attr in lc.BLOCKING_METHODS and target not in lc.BLOCKING_CALLS:
            if attr in ("item", "cpu") and node.args:
                return
            self._emit(node, "blocking-call-under-lock",
                       f".{attr}() waits for the device while `with "
                       f"{lock}:` is held — read after release")
            return
        if attr == "result":
            self._emit(node, "blocking-call-under-lock",
                       f".result() joins a future while `with {lock}:` "
                       "is held — the worker completing it may need "
                       "this lock; collect futures under the lock, "
                       "join them after release")
            return
        if attr == "wait":
            recv = _dotted(node.func.value) or ""
            rleaf = recv.rsplit(".", 1)[-1]
            if rleaf in self._with_stack or "cv" in rleaf.lower() \
                    or "cond" in rleaf.lower():
                return  # Condition.wait: releases the lock it waits on
            self._emit(node, "blocking-call-under-lock",
                       f".wait() blocks on a work handle or event while "
                       f"`with {lock}:` is held — wait after release")
            return
        if attr == "join":
            # thread-join shapes only: t.join() / t.join(5.0) /
            # t.join(timeout=…).  str.join/os.path.join take non-
            # numeric positional args and are skipped.
            joinish = (not node.args
                       and not any(kw.arg != "timeout"
                                   for kw in node.keywords)) \
                or (len(node.args) == 1
                    and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, (int, float))
                    and not isinstance(node.args[0].value, bool))
            if joinish and not isinstance(node.func.value, ast.Constant):
                self._emit(node, "blocking-call-under-lock",
                           f".join() rendezvouses with a thread while "
                           f"`with {lock}:` is held — if that thread "
                           "ever takes this lock, this is a deadlock; "
                           "join after release")

    # -- broad-except --------------------------------------------------------

    def _check_broad_except(self, node: ast.ExceptHandler) -> None:
        """A handler catching Exception/BaseException (or everything)
        that never re-raises swallows ``ReplayNeeded`` — the deferred
        pipeline's replay signal, which inherits Exception by design —
        and typed ``CylonError``s alike.  Handlers containing ANY
        ``raise`` are exempt (convert-and-reraise is the sanctioned
        shape); deliberate best-effort catches carry a suppression
        comment saying why."""
        broad_names = ("Exception", "BaseException",
                       "builtins.Exception", "builtins.BaseException")
        t = node.type
        if t is None:
            broad = True
        elif isinstance(t, ast.Tuple):
            broad = any(_dotted(e) in broad_names for e in t.elts)
        else:
            broad = _dotted(t) in broad_names
        if not broad:
            return
        if _has_handler_raise(node.body):
            return
        what = "bare `except:`" if t is None else \
            f"`except {_dotted(t) if not isinstance(t, ast.Tuple) else 'Exception'}:`"
        self._emit(node, "broad-except",
                   f"{what} with no re-raise can swallow ReplayNeeded / "
                   "CylonError — catch the specific exceptions, re-raise, "
                   "or suppress with a comment saying why the swallow is "
                   "safe", def_line_only=True)

    # -- implicit-host-sync --------------------------------------------------

    def _check_host_sync(self, node: ast.Call, target: Optional[str]) -> None:
        func = node.func
        if (isinstance(func, ast.Attribute) and func.attr == "item"
                and not node.args and not node.keywords):
            self._emit(node, "implicit-host-sync",
                       ".item() blocks on a device→host transfer")
            return
        if (isinstance(func, ast.Attribute) and func.attr == "tolist"
                and not node.args and _is_tensorish(func.value)):
            self._emit(node, "implicit-host-sync",
                       ".tolist() of a tensor blocks on a device→host "
                       "transfer")
            return
        if target in ("int", "float", "bool") and len(node.args) == 1 \
                and _is_tensorish(node.args[0]):
            self._emit(node, "implicit-host-sync",
                       f"{target}() on a tensor forces a host sync; keep "
                       "the value on the device or read it through "
                       "ops/compact.read_host")
            return
        if target in ("np.asarray", "np.array", "numpy.asarray",
                      "numpy.array") and node.args \
                and _is_tensorish(node.args[0]):
            self._emit(node, "implicit-host-sync",
                       f"{target}() on a tensor is a hidden "
                       "device→host transfer")
            return
        if _is_host_copy_call(node):
            if not any(a in self.norm for a in DEVICE_GET_ALLOWED):
                self._emit(node, "implicit-host-sync",
                           "a .cpu() copy outside the ingest/export "
                           "allow-list (route host reads through "
                           "ops/compact.read_host / read_counts or "
                           "table.host_batch)")

    # -- jit-in-loop ---------------------------------------------------------

    def _is_build_call(self, target: Optional[str]) -> bool:
        if target in _BUILD_CALLS:
            return True
        # the kernel build's own module spells it bare
        return target == "build" and self.norm.endswith(
            _PKG + "ops/hash_cuda.py")

    def _check_jit_in_loop(self, node: ast.Call,
                           target: Optional[str]) -> None:
        if self.loop_depth > 0 and self._is_build_call(target):
            self._emit(node, "jit-in-loop",
                       f"{target}() inside a loop builds a fresh kernel "
                       "per iteration — hoist it (or a cached factory) "
                       "out of the loop")

    # -- counter-not-in-catalogue --------------------------------------------

    def _check_counter_catalogue(self, node: ast.Call,
                                 target: Optional[str]) -> None:
        """Every string-literal metric name bumped through the trace
        API must have a row in the observe catalogue.  Dynamic names
        (``cost.strategy_counter(...)``) are skipped: the runtime
        compliance sweep covers them."""
        if target is None:
            return
        head, _, leaf = target.rpartition(".")
        if leaf not in _COUNTER_FNS:
            return
        if head not in ("trace", "_trace"):
            # bare count()/count_max()/gauge() are the trace module's
            # OWN internal spellings; anywhere else a bare name is some
            # unrelated local function, not a metric bump
            if head or not self.norm.endswith(_PKG + "trace.py"):
                return
        if not node.args:
            return
        arg = node.args[0]
        if not (isinstance(arg, ast.Constant)
                and isinstance(arg.value, str)):
            return  # dynamic name — runtime compliance covers it
        names = _metric_names(self.path)
        if names is None or arg.value in names:
            return
        self._emit(node, "counter-not-in-catalogue",
                   f"metric {arg.value!r} is not in the observe "
                   "catalogue (cylon_tpu_torch/observe/metrics.py "
                   "METRICS) — add a row documenting its kind/unit/"
                   "meaning, or derive the name from a catalogued family")

    # -- host-array-unpooled -------------------------------------------------

    def _check_host_unpooled(self, node: ast.Call,
                             target: Optional[str]) -> None:
        """Leaf-sized device→host materializations go through the spill
        pool: a ``.cpu()`` or ``np.asarray`` / ``np.array`` whose
        argument mentions a table leaf attribute or a ``leaves``
        collection, outside the boundary list the pool itself publishes
        (``SANCTIONED_HOST_BOUNDARIES``), bypasses the host budget, the
        LRU and the ``spill.stage_*`` fault points."""
        if target in ("np.asarray", "np.array", "numpy.asarray",
                      "numpy.array"):
            if not node.args:
                return
            arg = node.args[0]
        elif _is_host_copy_call(node):
            arg = node.func.value
        else:
            return
        if not _is_leafish_host(arg):
            return
        allowed = _host_boundary_names(self.path)
        if allowed is None:
            return  # no pool module to check against (partial tree)
        if any(a in self.norm for a in allowed):
            return
        self._emit(node, "host-array-unpooled",
                   f"{target or '.cpu'}() materializes leaf-sized data "
                   "outside the spill pool / sanctioned boundaries — "
                   "route it through spill.pool.stage_out_arrays so the "
                   "host budget, LRU and staging fault points apply")

    # -- warn-once-key-literal -----------------------------------------------

    def _check_warn_once_key(self, node: ast.Call,
                             target: Optional[str]) -> None:
        """``glog.warn_once`` keys must open with a string literal: the
        literal head is what makes the once-per-signature rate limit a
        rate limit (a fully dynamic key is unique per call → the alert
        spams) and what makes the alert family greppable."""
        if target is None or not node.args:
            return
        head, _, leaf = target.rpartition(".")
        if leaf != "warn_once":
            return
        if head not in ("glog", "logging") and not (
                head == "" and self.norm.endswith(_PKG + "logging.py")):
            return
        key = node.args[0]
        if isinstance(key, ast.Constant) and isinstance(key.value, str):
            return
        if (isinstance(key, ast.Tuple) and key.elts
                and isinstance(key.elts[0], ast.Constant)
                and isinstance(key.elts[0].value, str)):
            return
        self._emit(key, "warn-once-key-literal",
                   "warn_once key must be a string literal or a tuple "
                   "opening with one — a fully dynamic key defeats the "
                   "once-per-signature rate limit and makes the alert "
                   "family ungreppable")

    # -- fault-point-not-in-catalogue ----------------------------------------

    def _check_fault_catalogue(self, node: ast.Call,
                               target: Optional[str]) -> None:
        """Every string-literal point name consulted through
        ``faults.check``/``faults.perturb`` must have a row in the
        fault-point catalogue; dynamic names are skipped."""
        if target is None or not node.args:
            return
        head, _, leaf = target.rpartition(".")
        if leaf not in ("check", "perturb"):
            return
        if head not in ("faults", "_faults"):
            # bare check()/perturb() are the faults module's own
            # internal spellings; anywhere else a bare name is some
            # unrelated local function, not a fault-point consult
            if head or not self.norm.endswith(_PKG + "faults.py"):
                return
        arg = node.args[0]
        if not (isinstance(arg, ast.Constant)
                and isinstance(arg.value, str)):
            return  # dynamic point name — runtime coverage owns it
        names = _fault_point_names(self.path)
        if names is None or arg.value in names:
            return
        self._emit(node, "fault-point-not-in-catalogue",
                   f"fault point {arg.value!r} is not in the faults "
                   "catalogue (cylon_tpu_torch/faults.py POINTS) — add a "
                   "row documenting what a fault there simulates")

    # -- dist-op-unlowered ---------------------------------------------------

    def _check_unlowered(self, tree: ast.Module) -> None:
        """Every instrumented ``dist_*``/``shuffle_*`` entry point in the
        parallel layer must have a case in the plan executor's LOWERING
        table, or the optimizer surface silently loses it."""
        keys = _lowering_keys(self.path)
        if keys is None:
            return  # not a parallel-layer file, or no executor to check
        for node in tree.body:
            if not isinstance(node, ast.FunctionDef):
                continue
            if not _DIST_OP_RE.match(node.name):
                continue
            deco_exprs = [d.func if isinstance(d, ast.Call) else d
                          for d in node.decorator_list]
            instrumented = any(_dotted(d) in _INSTRUMENT_DECOS
                               for d in deco_exprs)
            if not instrumented:
                continue
            if node.name not in keys:
                self._emit(node, "dist-op-unlowered",
                           f"distributed op {node.name!r} has no lowering "
                           "case in cylon_tpu_torch/plan/executor.py "
                           "LOWERING — add one (plus a CAPTURED_OPS spec "
                           "in plan/ir.py) so optimized plans keep "
                           "covering the whole op surface",
                           def_line_only=True)

    # -- kernel-factory-unkeyed ----------------------------------------------

    def _check_factories(self, tree: ast.Module) -> None:
        blocks = {}
        try:
            table = symtable.symtable(self.source, self.path, "exec")
            _index_symtable(table, blocks)
        except Exception:  # graftlint: ok[broad-except]
            # symtable alone is best-effort: without it the closure-
            # capture arm degrades (blocks stay empty), but the uncached-
            # factory arm below must keep firing — a blanket except here
            # would silently turn the whole rule off
            pass
        for node in ast.walk(tree):
            if not isinstance(node, ast.FunctionDef):
                continue
            builds = [n for n in ast.walk(node) if isinstance(n, ast.Call)
                      and self._is_build_call(_dotted(n.func))]
            if not builds:
                continue
            deco_exprs = [d.func if isinstance(d, ast.Call) else d
                          for d in node.decorator_list]
            cached = any(
                (_dotted(d) or "").rsplit(".", 1)[-1] in _CACHE_DECORATORS
                for d in deco_exprs)
            if not cached:
                self._emit(node, "kernel-factory-unkeyed",
                           f"{node.name!r} builds a kernel or compiled "
                           "callable but has no cache decorator — every "
                           "call rebuilds (decorate with "
                           "observe.compile.kernel_factory or "
                           "functools.lru_cache keyed on the static "
                           "arguments)", def_line_only=True)
                continue
            params = {a.arg for a in (node.args.posonlyargs + node.args.args
                                      + node.args.kwonlyargs)}
            if node.args.vararg:
                params.add(node.args.vararg.arg)
            if node.args.kwarg:
                params.add(node.args.kwarg.arg)
            fblock = blocks.get((node.name, node.lineno))
            if fblock is None:
                continue
            flocals = set(fblock.get_locals()) | params
            for child, enclosing in _nested_function_blocks(fblock, flocals):
                for free in child.get_frees():
                    if free in enclosing or free in self.module_names:
                        continue
                    self._emit(node, "kernel-factory-unkeyed",
                               f"kernel {child.get_name()!r} inside "
                               f"{node.name!r} closes over {free!r}, which "
                               "is not part of the factory's cache key — "
                               "thread it through the (hashable) factory "
                               "arguments", def_line_only=True)


_INSTRUMENT_DECOS = ("plan_check.instrument", "instrument")
_DIST_OP_RE = re.compile(r"^(dist|shuffle)_[a-z0-9_]+$")

_COUNTER_FNS = {"count", "count_max", "gauge", "hist"}

# One shared mtime-cached "parse a catalogue literal out of a sibling
# file" helper behind the catalogue-backed rules.  Cache entries are keyed
# by the catalogue file's path + mtime, so an edit during a long-lived
# process invalidates the parse.  Every arm is best-effort: an
# unlocatable/unparseable catalogue returns None and the rule stays
# silent.
#
# The whole check-then-parse-then-store sequence holds _catalogue_lock.  A
# plain threading.Lock (not OrderedLock) on purpose: the linter needs the
# standard library alone, and the lock is leaf-level by construction.
_catalogue_lock = threading.Lock()
_catalogue_cache: Dict[Tuple[str, str],
                       Tuple[float, Optional[frozenset]]] = {}

GUARDED_STATE = {"_catalogue_cache": "_catalogue_lock"}


def _sibling_names(linted_path: str, anchor: str, rel_file: str,
                   var_name: str, extract) -> Optional[frozenset]:
    """String names extracted from the ``var_name = <literal>``
    assignment in ``rel_file`` (located relative to ``linted_path`` via
    its last ``anchor`` component); ``extract(value_node)`` maps the
    assigned AST literal to a set of names or None."""
    norm = linted_path.replace(os.sep, "/")
    idx = norm.rfind(anchor)
    if idx < 0:
        return None
    cat_path = norm[:idx] + rel_file
    try:
        mtime = os.path.getmtime(cat_path)
    except OSError:
        return None
    with _catalogue_lock:
        hit = _catalogue_cache.get((cat_path, var_name))
        if hit is not None and hit[0] == mtime:
            return hit[1]
        names: Optional[frozenset] = None
        try:
            with open(cat_path, "r", encoding="utf-8") as fh:
                tree = ast.parse(fh.read(), filename=cat_path)
            for node in tree.body:
                if isinstance(node, ast.AnnAssign):
                    targets = [node.target]
                    value = node.value
                elif isinstance(node, ast.Assign):
                    targets = node.targets
                    value = node.value
                else:
                    continue
                if not any(isinstance(t, ast.Name) and t.id == var_name
                           for t in targets):
                    continue
                names = extract(value)
        except (OSError, SyntaxError):
            names = None
        _catalogue_cache[(cat_path, var_name)] = (mtime, names)
    return names


def _dict_str_keys(value: ast.AST) -> Optional[frozenset]:
    if not isinstance(value, ast.Dict):
        return None
    return frozenset(k.value for k in value.keys
                     if isinstance(k, ast.Constant)
                     and isinstance(k.value, str))


def _metric_names(linted_path: str) -> Optional[frozenset]:
    """Metric names of the observe catalogue, parsed from the
    ``METRICS ... = _specs((name, kind, unit, doc), ...)`` literal in
    cylon_tpu_torch/observe/metrics.py (located relative to the linted
    file)."""
    def rows(value: ast.AST) -> Optional[frozenset]:
        if not isinstance(value, ast.Call):
            return None
        return frozenset(
            row.elts[0].value for row in value.args
            if isinstance(row, ast.Tuple) and row.elts
            and isinstance(row.elts[0], ast.Constant)
            and isinstance(row.elts[0].value, str))
    return _sibling_names(linted_path, _PKG, _PKG + "observe/metrics.py",
                          "METRICS", rows)


_LEAF_ATTRS = {"data", "validity", "pending_mask"}


def _is_leafish_host(node: ast.AST) -> bool:
    """Does this expression plausibly reference table-leaf-sized
    tensors?  Tuned for precision like ``_is_tensorish``: leaf
    attributes of the table types, or a ``leaves``-named collection."""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Attribute) and sub.attr in _LEAF_ATTRS:
            return True
        if isinstance(sub, ast.Name) and ("leaves" in sub.id
                                          or sub.id == "leaf"):
            return True
    return False


def _host_boundary_names(linted_path: str) -> Optional[frozenset]:
    """The sanctioned device↔host boundary paths, parsed from the
    ``SANCTIONED_HOST_BOUNDARIES = (...)`` literal in
    cylon_tpu_torch/spill/pool.py (located relative to the linted
    file)."""
    def rows(value: ast.AST) -> Optional[frozenset]:
        if not isinstance(value, (ast.Tuple, ast.List)):
            return None
        return frozenset(e.value for e in value.elts
                         if isinstance(e, ast.Constant)
                         and isinstance(e.value, str))
    return _sibling_names(linted_path, _PKG, _PKG + "spill/pool.py",
                          "SANCTIONED_HOST_BOUNDARIES", rows)


def _fault_point_names(linted_path: str) -> Optional[frozenset]:
    """Fault-point names of the catalogue, parsed from the
    ``POINTS: Dict[str, str] = {...}`` literal in
    cylon_tpu_torch/faults.py (located relative to the linted file)."""
    return _sibling_names(linted_path, _PKG, _PKG + "faults.py", "POINTS",
                          _dict_str_keys)


def _lowering_keys(linted_path: str) -> Optional[frozenset]:
    """String keys of the plan executor's LOWERING dict, located
    relative to the linted file (…/cylon_tpu_torch/parallel/X.py →
    …/cylon_tpu_torch/plan/executor.py) — only parallel-layer files are
    checked, so the anchor is the parallel/ component."""
    return _sibling_names(linted_path, _PKG + "parallel/",
                          _PKG + "plan/executor.py", "LOWERING",
                          _dict_str_keys)


def _has_handler_raise(body) -> bool:
    """A ``raise`` that can actually execute as part of the handler:
    raises inside a nested function/lambda/class defined in the handler
    body do NOT run when the handler does, so they must not exempt it."""
    stack = list(body)
    while stack:
        n = stack.pop()
        if isinstance(n, ast.Raise):
            return True
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.Lambda, ast.ClassDef)):
            continue
        stack.extend(ast.iter_child_nodes(n))
    return False


def _nested_function_blocks(block, enclosing: Set[str]) -> Iterable:
    """(function block, names bound in any enclosing scope) pairs — a
    genexpr inside the kernel legitimately closes over kernel locals."""
    for child in block.get_children():
        if child.get_type() == "function":
            yield child, enclosing
            yield from _nested_function_blocks(
                child, enclosing | set(child.get_locals()))


def _index_symtable(table, out: Dict[Tuple[str, int], object]) -> None:
    for child in table.get_children():
        if child.get_type() == "function":
            out[(child.get_name(), child.get_lineno())] = child
        _index_symtable(child, out)


def _module_bindings(tree: ast.Module) -> Set[str]:
    names: Set[str] = set()
    for node in tree.body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            for a in node.names:
                names.add((a.asname or a.name).split(".")[0])
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                for n in ast.walk(t):
                    if isinstance(n, ast.Name):
                        names.add(n.id)
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            names.add(node.target.id)
    return names


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def lint_source(source: str, path: str = "<string>") -> List[Finding]:
    """Lint one module's source; returns unsuppressed findings."""
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return [Finding(path, e.lineno or 0, e.offset or 0,
                        "parse-error", str(e))]
    return _Linter(path, source).run(tree)


def _iter_py_files(paths: Sequence[str]) -> Iterable[str]:
    for p in paths:
        if os.path.isdir(p):
            for root, dirs, files in os.walk(p):
                dirs[:] = sorted(d for d in dirs
                                 if d not in ("__pycache__", ".git"))
                for f in sorted(files):
                    if f.endswith(".py"):
                        yield os.path.join(root, f)
        else:
            yield p


def lint_paths(paths: Sequence[str]) -> List[Finding]:
    findings: List[Finding] = []
    for path in _iter_py_files(paths):
        with open(path, "r", encoding="utf-8") as fh:
            findings.extend(lint_source(fh.read(), path))
    return findings


def count_files(paths: Sequence[str]) -> int:
    """How many ``.py`` files ``lint_paths(paths)`` reads."""
    return sum(1 for _ in _iter_py_files(paths))


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--list-rules" in argv:
        for r in RULES:
            print(r)
        return 0
    paths = [a for a in argv if not a.startswith("-")]
    if not paths:
        print("usage: python -m cylon_tpu_torch.analysis.graftlint "
              "[--list-rules] PATH [PATH ...]", file=sys.stderr)
        return 2
    missing = [p for p in paths if not os.path.exists(p)]
    if missing:
        print(f"graftlint: no such path: {', '.join(missing)}",
              file=sys.stderr)
        return 2
    findings = lint_paths(paths)
    for f in findings:
        print(f)
    if any(f.rule == "parse-error" for f in findings):
        # a syntactically broken tree is a tooling failure, not lint
        # findings — the documented exit-code contract separates them
        print("graftlint: parse error", file=sys.stderr)
        return 2
    if findings:
        print(f"graftlint: {len(findings)} finding(s)", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
