"""Runtime context: device, world size, rank, config map, barrier.

Mirrors the reference's ``CylonContext`` (reference:
cpp/src/cylon/ctx/cylon_context.hpp:29-138, net/mpi/mpi_communicator.cpp:
23-62).  Where the reference wraps an MPI communicator and the JAX package
a device mesh, this context owns one torch device and a communicator over
a world of ``P = nproc × L`` ranks: ``nproc`` processes, each driving
``L`` local ranks on its own device.  Process ``p`` drives the global
ranks ``p·L … p·L + L − 1``.

Per-rank tensors carry a leading axis of the L LOCAL ranks; destination
axes keep P.  Every operator reaches the other ranks only through the
communicator:

``LocalCommunicator``    one process (``nproc = 1``, ``L = P``): all P
                         ranks' row shards on one device (the counterpart
                         of the JAX tests' 8 virtual CPU devices); a
                         collective is a tensor operation over the leading
                         rank axis.
``ProcessCommunicator``  a ``torch.distributed`` process group (NCCL on a
                         card, gloo on the CPU): the in-process part of a
                         collective is a block transpose or roll, the
                         cross-process part one ``all_to_all_single`` /
                         ``all_gather`` / ``all_reduce`` or a batch of
                         point-to-point sends (``CylonContext.
                         InitMultiHost``).

Host reads that decide a size, a lowering or a replay read REPLICATED
values (all-gathered counts), so every process makes the same decision
and the next collective finds every process there.
"""
from __future__ import annotations

import datetime
import itertools
import weakref
from typing import Dict, List, Optional, Tuple, Union

import torch

from .status import Code, CylonError, Status


class LocalCommunicator:
    """``world`` ranks simulated on one device.

    Per-rank values travel as tensors whose leading axis is the rank.
    ``all_to_all``, ``all_gather`` and ``ppermute`` also run GROUP-LOCAL
    over one axis of a ``(slow, fast)`` split of the world (``split``,
    ``axis`` "slow" or "fast"; rank ``p`` sits at slow coordinate
    ``p // fast`` and fast coordinate ``p % fast``): a group is the
    ranks that share the other coordinate, and its size ``G`` is that
    axis's extent.  On one device a group-local collective is a reshape
    to ``[slow, fast, ...]`` and a transpose or roll inside each group.
    """

    nproc = 1
    proc = 0
    first_rank = 0
    backend = "local"

    def __init__(self, world: int, device: torch.device):
        self.world = world
        self.local = world
        self.device = device

    @property
    def group_key(self) -> Tuple:
        """What tells this communicator's ranks apart from another's in a
        process-wide cache key (one process: nothing)."""
        return ()

    def all_gather_object(self, obj) -> list:
        """Host objects, one per process, in process order."""
        return [obj]

    def _split(self, split, axis) -> Tuple[int, int]:
        slow, fast = int(split[0]), int(split[1])
        if slow * fast != self.world or axis not in ("slow", "fast"):
            raise CylonError(Status(Code.Invalid,
                f"a group-local collective wants a (slow, fast) split of "
                f"world {self.world} and axis 'slow' or 'fast', got "
                f"{tuple(split)!r}, {axis!r}"))
        return slow, fast

    def _want(self, what: str, x: torch.Tensor, lead) -> None:
        if tuple(x.shape[:len(lead)]) != tuple(lead):
            raise CylonError(Status(Code.Invalid,
                f"{what} wants {list(lead) + ['...']}, got "
                f"{tuple(x.shape)}"))

    def all_to_all(self, x: torch.Tensor, split=None,
                   axis: Optional[str] = None) -> torch.Tensor:
        """``x[src, dst, ...]`` is what rank ``src`` sends to ``dst``;
        returns ``y[dst, src, ...]``, what each rank received from each.
        Group-local (``split``): ``x[p, g]`` goes to the ``g``-th rank of
        ``p``'s group, and ``y[p, g]`` came from the ``g``-th."""
        if split is None:
            self._want("all_to_all", x, (self.world, self.world))
            return x.transpose(0, 1).contiguous()
        slow, fast = self._split(split, axis)
        tail = tuple(x.shape[2:])
        if axis == "fast":
            self._want("all_to_all", x, (self.world, fast))
            return (x.reshape((slow, fast, fast) + tail).transpose(1, 2)
                    .reshape((self.world, fast) + tail))
        self._want("all_to_all", x, (self.world, slow))
        return (x.reshape((slow, fast, slow) + tail).transpose(0, 2)
                .reshape((self.world, slow) + tail))

    def all_gather(self, x: torch.Tensor, split=None,
                   axis: Optional[str] = None) -> torch.Tensor:
        """``x[rank, ...]`` one value block per rank → the same blocks,
        visible to every rank (here: one tensor all ranks share).
        Group-local (``split``): ``y[p, g]`` is the block of the
        ``g``-th rank of ``p``'s group."""
        self._want("all_gather", x, (self.world,))
        if split is None:
            return x
        slow, fast = self._split(split, axis)
        tail = tuple(x.shape[1:])
        xv = x.reshape((slow, fast) + tail)
        if axis == "fast":
            y = xv.unsqueeze(1).expand((slow, fast, fast) + tail)
            return y.reshape((self.world, fast) + tail)
        y = xv.transpose(0, 1).unsqueeze(0).expand((slow, fast, slow) + tail)
        return y.reshape((self.world, slow) + tail)

    def ppermute(self, x: torch.Tensor, shift: int, split=None,
                 axis: Optional[str] = None) -> torch.Tensor:
        """Rank ``i``'s block ``x[i]`` goes to rank ``(i + shift) % P``;
        returns what each rank received.  Group-local (``split``): the
        shift runs along ``axis`` inside each group."""
        self._want("ppermute", x, (self.world,))
        if split is None:
            return torch.roll(x, int(shift), 0)
        slow, fast = self._split(split, axis)
        tail = tuple(x.shape[1:])
        dim = 0 if axis == "slow" else 1
        return torch.roll(x.reshape((slow, fast) + tail), int(shift),
                          dim).reshape(x.shape)

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """``x[rank, ...]`` one block per rank → their sum over the ranks,
        visible to every rank (``psum``); shape ``x.shape[1:]``."""
        if x.dim() == 0 or x.shape[0] != self.world:
            raise CylonError(Status(Code.Invalid,
                f"all_reduce wants [{self.world}, ...], got {tuple(x.shape)}"))
        return x.sum(0)

    def barrier(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def _bytes(x: torch.Tensor) -> torch.Tensor:
    """``x``'s contents as a flat uint8 tensor (every collective moves
    bytes, so every dtype, bool included, rides every backend)."""
    return x.contiguous().reshape(-1).view(torch.uint8)


def _unbytes(b: torch.Tensor, dtype: torch.dtype, shape) -> torch.Tensor:
    return b.view(dtype).reshape(shape)


class ProcessCommunicator:
    """``L`` local ranks of a ``P = nproc × L`` world whose other ranks
    live in the other processes of the default ``torch.distributed``
    process group (one process per group rank).

    Per-rank tensors lead with the L local ranks; the contract of each
    collective is ``LocalCommunicator``'s with that leading axis:

    * ``all_to_all(x[L, P, …]) → y[L, P, …]``, ``y[l, s]`` what global
      rank ``s`` sent to local rank ``l``: one ``all_to_all_single`` over
      the processes;
    * ``all_gather(x[L, …]) → [P, …]``, the same in every process;
    * ``all_reduce(x[L, …]) → x.shape[1:]``, the sum over all P ranks;
    * ``ppermute(x[L, …], shift)`` by global rank: the in-process part is
      a roll, blocks that cross a process go by ``batch_isend_irecv``.

    The group-local forms run under the split ``(nproc, L)``, the process
    grouping: the fast axis is in-process (a block transpose or roll, no
    wire), the slow axis one exchange across processes that carries the
    L axis along, so no subgroup is needed.  With one process any split
    is in-process.  Any other split under several processes raises a
    typed ``NotImplemented``: it never runs a wrong exchange.

    Every collective moves bytes (``_bytes``) and runs synchronously on
    the caller's stream: ``torch.distributed`` makes the current stream
    wait for the backend's stream before the call returns.
    """

    def __init__(self, local: int, device: torch.device):
        import torch.distributed as dist
        self._dist = dist
        self.nproc = int(dist.get_world_size())
        self.proc = int(dist.get_rank())
        self.local = int(local)
        self.world = self.nproc * self.local
        self.first_rank = self.proc * self.local
        self.device = device
        self.backend = str(dist.get_backend())
        self._local = LocalCommunicator(self.local, device)
        # calls into torch.distributed so far (collectives, point-to-point
        # batches, barriers): what shows that an abstract plan run moved
        # nothing between processes
        self.calls = 0

    @property
    def group_key(self) -> Tuple:
        return (id(self), self.nproc, self.proc)

    # -- helpers -------------------------------------------------------------

    def _want(self, what: str, x: torch.Tensor, lead) -> None:
        LocalCommunicator._want(self, what, x, lead)

    def _split(self, split, axis) -> Tuple[int, int]:
        slow, fast = int(split[0]), int(split[1])
        if slow * fast != self.world or axis not in ("slow", "fast"):
            raise CylonError(Status(Code.Invalid,
                f"a group-local collective wants a (slow, fast) split of "
                f"world {self.world} and axis 'slow' or 'fast', got "
                f"{tuple(split)!r}, {axis!r}"))
        if self.nproc > 1 and (slow, fast) != (self.nproc, self.local):
            raise CylonError(Status(Code.NotImplemented,
                f"the process communicator runs group-local collectives "
                f"under its process split ({self.nproc}, {self.local}) "
                f"only, not {(slow, fast)!r} (set CYLON_MESH_SHAPE="
                f"{self.nproc}x{self.local} or leave it unset)"))
        return slow, fast

    def _a2a_procs(self, send: torch.Tensor) -> torch.Tensor:
        """``send[q, …]`` goes to process ``q``; returns ``recv[q, …]``,
        what process ``q`` sent here."""
        b = _bytes(send)
        out = torch.empty_like(b)
        self.calls += 1
        self._dist.all_to_all_single(out, b)
        return _unbytes(out, send.dtype, send.shape)

    def _gather_procs(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` from every process, stacked: ``[nproc, …x.shape]``."""
        b = _bytes(x)
        out = torch.empty(self.nproc * b.numel(), dtype=torch.uint8,
                          device=b.device)
        fn = getattr(self._dist, "all_gather_single", None) or \
            self._dist.all_gather_into_tensor
        self.calls += 1
        fn(out, b)
        return _unbytes(out, x.dtype, (self.nproc,) + tuple(x.shape))

    def _p2p(self, sends, recvs) -> None:
        """``sends`` {process: tensor}, ``recvs`` {process: buffer}: one
        batch of point-to-point transfers, waited on."""
        ops = []
        for q, t in sends.items():
            ops.append(self._dist.P2POp(self._dist.isend, _bytes(t), q))
        bufs = {q: torch.empty(t.numel() * t.element_size(),
                               dtype=torch.uint8, device=t.device)
                for q, t in recvs.items()}
        for q, b in bufs.items():
            ops.append(self._dist.P2POp(self._dist.irecv, b, q))
        if ops:
            self.calls += 1
            for w in self._dist.batch_isend_irecv(ops):
                w.wait()
        for q, t in recvs.items():
            t.copy_(_unbytes(bufs[q], t.dtype, t.shape))

    # -- collectives -----------------------------------------------------------

    def all_to_all(self, x: torch.Tensor, split=None,
                   axis: Optional[str] = None) -> torch.Tensor:
        L, n = self.local, self.nproc
        if split is None:
            self._want("all_to_all", x, (L, self.world))
            tail = tuple(x.shape[2:])
            rest = tuple(range(3, 3 + len(tail)))
            # [L_src, nproc, L_dst, …] → [nproc, L_src, L_dst, …]
            send = x.reshape((L, n, L) + tail).permute((1, 0, 2) + rest)
            recv = self._a2a_procs(send.contiguous())
            # recv[q, l_src, l_dst] came from rank q·L + l_src
            return recv.permute((2, 0, 1) + rest).reshape(
                (L, self.world) + tail).contiguous()
        if n == 1:
            self._split(split, axis)
            return self._local.all_to_all(x, split, axis)
        self._split(split, axis)
        tail = tuple(x.shape[2:])
        if axis == "fast":
            # x[l, g] goes to local rank g; y[l, g] came from local rank g
            self._want("all_to_all", x, (L, L))
            return x.transpose(0, 1).contiguous()
        # x[l, g] goes to rank (g, l); y[l, q] came from rank (q, l)
        self._want("all_to_all", x, (L, n))
        recv = self._a2a_procs(x.transpose(0, 1).contiguous())
        return recv.transpose(0, 1).contiguous()

    def all_gather(self, x: torch.Tensor, split=None,
                   axis: Optional[str] = None) -> torch.Tensor:
        L = self.local
        self._want("all_gather", x, (L,))
        tail = tuple(x.shape[1:])
        if split is None:
            return self._gather_procs(x).reshape((self.world,) + tail)
        if self.nproc == 1:
            self._split(split, axis)
            return self._local.all_gather(x, split, axis)
        self._split(split, axis)
        if axis == "fast":
            return x.unsqueeze(0).expand((L, L) + tail)
        return self._gather_procs(x).transpose(0, 1).contiguous()

    def ppermute(self, x: torch.Tensor, shift: int, split=None,
                 axis: Optional[str] = None) -> torch.Tensor:
        L, n, P = self.local, self.nproc, self.world
        self._want("ppermute", x, (L,))
        if split is not None:
            if n == 1:
                self._split(split, axis)
                return self._local.ppermute(x, shift, split, axis)
            self._split(split, axis)
            if axis == "fast":
                return torch.roll(x, int(shift), 0)
            k = int(shift) % n
            if k == 0:
                return x.clone()
            out = torch.empty_like(x)
            self._p2p({(self.proc + k) % n: x}, {(self.proc - k) % n: out})
            return out
        shift = int(shift) % P
        out = torch.empty_like(x)
        first = self.first_rank
        sends: Dict[int, List[Tuple[int, int]]] = {}
        recvs: Dict[int, List[Tuple[int, int]]] = {}
        for ll in range(L):
            dst = (first + ll + shift) % P
            src = (first + ll - shift) % P
            if dst // L == self.proc:
                out[dst - first] = x[ll]
            else:
                sends.setdefault(dst // L, []).append((dst, ll))
            if src // L != self.proc:
                recvs.setdefault(src // L, []).append((ll, ll))
        # one message per peer: blocks in destination-rank order on both
        # ends (a receiver lists its own ranks in order)
        send_t = {q: x[[ll for _, ll in sorted(v)]] for q, v in sends.items()}
        recv_t = {q: torch.empty((len(v),) + tuple(x.shape[1:]),
                                 dtype=x.dtype, device=x.device)
                  for q, v in recvs.items()}
        self._p2p(send_t, recv_t)
        for q, v in recvs.items():
            out[[ll for ll, _ in sorted(v)]] = recv_t[q]
        return out

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() == 0 or x.shape[0] != self.local:
            raise CylonError(Status(Code.Invalid,
                f"all_reduce wants [{self.local}, ...], got "
                f"{tuple(x.shape)}"))
        s = x.sum(0)
        self.calls += 1
        self._dist.all_reduce(s)
        return s

    def all_gather_object(self, obj) -> list:
        out = [None] * self.nproc
        self.calls += 1
        self._dist.all_gather_object(out, obj)
        return out

    def abort(self) -> None:
        """Tear the process group down after a failure that this process
        alone may have seen: every peer's pending or next collective then
        fails at once (a closed connection, C5's TOPOLOGY) instead of
        waiting for the group's timeout.  No collective runs here
        afterwards."""
        if self._dist.is_initialized():
            self._dist.destroy_process_group()

    def barrier(self) -> None:
        self.calls += 1
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            self._dist.barrier(device_ids=[self.device.index])
        else:
            self._dist.barrier()


class AbstractCommunicator:
    """The communicator of the meta view of a world that spans processes
    (``CylonContext.with_device("meta")``, the abstract plan run of
    ``analysis/plan_check``): the process split ``(nproc, L)`` and the
    global ranks of the real communicator, and collectives that return
    meta tensors of the shapes :class:`ProcessCommunicator`'s return.
    It never calls ``torch.distributed``: an abstract run in one process
    neither waits on nor moves anything to another."""

    backend = "abstract"

    def __init__(self, comm, device: torch.device):
        self.nproc, self.proc = comm.nproc, comm.proc
        self.local, self.world = comm.local, comm.world
        self.first_rank = comm.first_rank
        self.device = device
        self._key = ("abstract",) + tuple(comm.group_key)

    @property
    def group_key(self) -> Tuple:
        return self._key

    def _want(self, what: str, x: torch.Tensor, lead) -> None:
        LocalCommunicator._want(self, what, x, lead)

    def _split(self, split, axis) -> Tuple[int, int]:
        return ProcessCommunicator._split(self, split, axis)

    @staticmethod
    def _meta(shape, x: torch.Tensor) -> torch.Tensor:
        return torch.empty(tuple(shape), dtype=x.dtype, device="meta")

    def all_to_all(self, x: torch.Tensor, split=None,
                   axis: Optional[str] = None) -> torch.Tensor:
        if split is None:
            self._want("all_to_all", x, (self.local, self.world))
        else:
            slow, fast = self._split(split, axis)
            self._want("all_to_all", x,
                       (self.local, fast if axis == "fast" else slow))
        return self._meta(x.shape, x)

    def all_gather(self, x: torch.Tensor, split=None,
                   axis: Optional[str] = None) -> torch.Tensor:
        self._want("all_gather", x, (self.local,))
        tail = tuple(x.shape[1:])
        if split is None:
            return self._meta((self.world,) + tail, x)
        slow, fast = self._split(split, axis)
        return self._meta((self.local, fast if axis == "fast" else slow)
                          + tail, x)

    def ppermute(self, x: torch.Tensor, shift: int, split=None,
                 axis: Optional[str] = None) -> torch.Tensor:
        self._want("ppermute", x, (self.local,))
        if split is not None:
            self._split(split, axis)
        return self._meta(x.shape, x)

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() == 0 or x.shape[0] != self.local:
            raise CylonError(Status(Code.Invalid,
                f"all_reduce wants [{self.local}, ...], got "
                f"{tuple(x.shape)}"))
        return self._meta(x.shape[1:], x)

    def all_gather_object(self, obj) -> list:
        raise CylonError(Status(Code.ExecutionError,
            "plan_check: host objects of the other processes are not "
            "known to an abstract plan run (it makes no collective)"))

    def barrier(self) -> None:
        return None


def _resolve_device(device) -> torch.device:
    """The context's device: the card unless the caller names another;
    never a silent CPU fallback."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise CylonError(Status(Code.ExecutionError,
            "no CUDA device is available; pass device='cpu' to run "
            "on the CPU"))
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


# the live multi-process contexts of this process (an entry point that
# takes no context — the serving fleet's router — refuses while one is
# live)
_process_contexts: "weakref.WeakSet" = weakref.WeakSet()


def _live_nproc() -> int:
    return max((c.get_process_count() for c in list(_process_contexts)
                if not c._finalized), default=1)


def refuse_multiprocess(what: str, ctx=None) -> None:
    """Raise a typed ``NotImplemented`` naming ``what`` when ``ctx`` (or,
    without one, any live context of this process) spans several
    processes: the parts of the engine that do not run across processes
    yet refuse rather than hang or answer wrong."""
    n = ctx.get_process_count() if ctx is not None else _live_nproc()
    if n > 1:
        raise CylonError(Status(Code.NotImplemented,
            f"{what} does not run over the process communicator yet "
            f"(a world of {n} processes); run it in a single-process "
            "context"))


class CylonContext:
    """Entry point to the runtime.

    ``CylonContext()`` runs on the CUDA card and raises when there is none:
    it never falls back to the CPU.  ``device="cpu"`` asks for the CPU
    explicitly (the tests do).  ``world=P`` keeps P row shards on that
    device.  ``config`` is an optional dict seeding the string config map.

    ``first_slot=s`` places the context's shards on the slots ``s ..
    s + P − 1`` of its device (``topology.slots``): the counterpart of
    the JAX package's ``CylonContext({"devices": subset})``, so two
    contexts over disjoint slot ranges are disjoint replicas of one
    card (a serving fleet, ``serve.FleetRouter``).  They share the
    card's memory.

    ``CylonContext.InitMultiHost(...)`` joins a world that spans
    processes (the ``mpirun`` launch of the reference): the context then
    drives its process's L local ranks of the P-rank world through a
    :class:`ProcessCommunicator`.
    """

    def __init__(self, config: Optional[Dict[str, str]] = None,
                 device: Union[str, torch.device, None] = None,
                 world: int = 1, first_slot: int = 0):
        if config is not None and not isinstance(config, dict):
            raise CylonError(Status(Code.Invalid,
                                    f"unknown config {config!r}"))
        if int(world) < 1:
            raise CylonError(Status(Code.Invalid,
                                    f"world size must be >= 1, got {world}"))
        dev = _resolve_device(device)
        if int(first_slot) < 0:
            raise CylonError(Status(Code.Invalid,
                f"first_slot must be >= 0, got {first_slot}"))
        self._device = dev
        self._first_slot = int(first_slot)
        self._comm = LocalCommunicator(int(world), dev)
        self._config: Dict[str, str] = dict(config or {})
        self._sequence = itertools.count()
        self._distributed = False
        self._owns_group = False
        self._finalized = False

    # -- reference API parity (ctx/cylon_context.hpp) -------------------------

    @staticmethod
    def Init(device: Union[str, torch.device, None] = None
             ) -> "CylonContext":
        """A local context: one rank on ``device`` (the card by
        default)."""
        return CylonContext(None, device)

    @staticmethod
    def InitDistributed(config: Optional[Dict[str, str]] = None,
                        device: Union[str, torch.device, None] = None,
                        world: int = 1) -> "CylonContext":
        """A distributed context of ``world`` ranks on one device
        (``is_distributed()`` true whatever the world); ``config`` seeds
        the config map."""
        ctx = CylonContext(config, device, world)
        ctx._distributed = True
        return ctx

    @staticmethod
    def InitMultiHost(coordinator_address: Optional[str] = None,
                      num_processes: Optional[int] = None,
                      process_id: Optional[int] = None, *, world: int = 1,
                      device: Union[str, torch.device, None] = None,
                      backend: Optional[str] = None,
                      timeout: Optional[float] = None
                      ) -> "CylonContext":
        """Join a world that spans ``num_processes`` processes, each
        driving ``world`` local ranks on its ``device``: process
        ``process_id`` drives the global ranks ``process_id·world …``.
        Every process calls it with the same ``world`` (reference:
        net/mpi/mpi_communicator.cpp:23-62, MPI_Init).

        ``coordinator_address`` is the rendezvous: ``host:port`` (TCP),
        a ``tcp://`` or ``file://`` URL; None reads the
        ``torch.distributed`` environment (``MASTER_ADDR`` /
        ``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK``), as the JAX
        package reads its coordination environment.  ``backend``:
        ``"nccl"`` on a card and ``"gloo"`` on the CPU by default; an
        explicit choice is honoured, with no fallback from one to the
        other.  ``timeout`` (seconds) bounds every collective of the
        group.  A process group already initialized in this process is
        joined as it is.  Like ``CylonContext()``, it never falls back
        to the CPU: with no card, pass ``device="cpu"``."""
        import torch.distributed as dist
        if int(world) < 1:
            raise CylonError(Status(Code.Invalid,
                                    f"world size must be >= 1, got {world}"))
        dev = _resolve_device(device)
        if not dist.is_available():
            raise CylonError(Status(Code.NotImplemented,
                "this torch build has no torch.distributed"))
        owns = False
        if not dist.is_initialized():
            be = backend or ("nccl" if dev.type == "cuda" else "gloo")
            if dev.type == "cuda":
                torch.cuda.set_device(dev)
            if coordinator_address is None:
                init = "env://"
            elif "://" in coordinator_address:
                init = coordinator_address
            else:
                init = f"tcp://{coordinator_address}"
            kw = {}
            if num_processes is not None:
                kw["world_size"] = int(num_processes)
            if process_id is not None:
                kw["rank"] = int(process_id)
            if timeout is not None:
                kw["timeout"] = datetime.timedelta(seconds=float(timeout))
            dist.init_process_group(be, init_method=init, **kw)
            owns = True
        elif backend is not None and dist.get_backend() != backend:
            raise CylonError(Status(Code.Invalid,
                f"a {dist.get_backend()} process group is already "
                f"initialized; backend={backend!r} asked for another"))
        ctx = CylonContext(None, dev, int(world))
        ctx._comm = ProcessCommunicator(int(world), dev)
        ctx._distributed = True
        ctx._owns_group = owns
        _process_contexts.add(ctx)
        return ctx

    def with_world(self, world: int) -> "CylonContext":
        """A context on the same device with ``world`` shards and a copy
        of this one's config map, starting at the same slot: the
        survivor (or grown) context of an elastic re-mesh
        (``topology.mark_lost`` / ``mark_joined``).  One process only."""
        refuse_multiprocess("a re-mesh (with_world)", self)
        return CylonContext(dict(self._config), self._device, world,
                            self._first_slot)

    def with_device(self, device: Union[str, torch.device]
                    ) -> "CylonContext":
        """A context with this one's world, first slot and a copy of its
        config map on ``device``: the ``meta`` view over which an
        abstract plan run (``analysis/plan_check``) rebuilds its tables,
        so every allocation the plan makes lands on the meta device.

        Across processes only the meta view exists: it keeps the process
        split ``(nproc, L)`` and the global rank, and its
        :class:`AbstractCommunicator` returns meta tensors of the shapes
        the real collectives return without calling
        ``torch.distributed``."""
        if self._comm.nproc == 1:
            return CylonContext(dict(self._config), device,
                                self.get_world_size(), self._first_slot)
        dev = torch.device(device)
        if dev.type != "meta":
            raise CylonError(Status(Code.NotImplemented,
                f"a device view (with_device({str(dev)!r})) does not run "
                f"over the process communicator (a world of "
                f"{self._comm.nproc} processes); only the meta view does"))
        view = CylonContext(dict(self._config), dev, self._comm.local,
                            self._first_slot)
        view._comm = AbstractCommunicator(self._comm, dev)
        view._distributed = True
        return view

    def get_rank(self) -> int:
        """Lowest rank this process drives: ``process_id · L`` (0 in a
        single-process world).  reference: ctx/cylon_context.cpp
        (GetRank)."""
        return self._comm.first_rank

    def get_world_size(self) -> int:
        """P, the ranks of the whole world (every process's)."""
        return self._comm.world

    def get_local_world_size(self) -> int:
        """L, the ranks this process drives (P with one process)."""
        return self._comm.local

    def get_process_count(self) -> int:
        """The processes of the world (1 unless ``InitMultiHost``)."""
        return self._comm.nproc

    def local_ranks(self) -> List[int]:
        """The global ranks this process drives."""
        r0 = self._comm.first_rank
        return list(range(r0, r0 + self._comm.local))

    def get_neighbours(self, include_self: bool = False) -> List[int]:
        """Ranks driven by OTHER processes (empty with one process);
        ``include_self`` adds this process's own.  reference:
        ctx/cylon_context.cpp (GetNeighbours)."""
        mine = set(self.local_ranks())
        return [i for i in range(self.get_world_size())
                if include_self or i not in mine]

    def get_next_sequence(self) -> int:
        """Monotone op id (the reference's edge / tag ids,
        ctx/cylon_context.cpp:99-101); kept for API parity and span
        labels: collectives are ordered by program order."""
        return next(self._sequence)

    def is_distributed(self) -> bool:
        return self._distributed or self.get_world_size() > 1

    def finalize(self) -> None:
        """End the context; destroys the process group this context
        created (``InitMultiHost``).  Idempotent."""
        if self._finalized:
            return
        self._finalized = True
        if self._owns_group:
            import torch.distributed as dist
            if dist.is_initialized():
                dist.destroy_process_group()
            self._owns_group = False

    def add_config(self, key: str, value: str) -> None:
        self._config[key] = value

    def get_config(self, key: str, default: str = "") -> str:
        return self._config.get(key, default)

    def barrier(self) -> None:
        """Block the host until the device has drained queued work."""
        self._comm.barrier()

    def optimize(self, op, tables=None):
        """Run ``op(tables)`` (or ``op()`` when ``tables`` is None) through
        the logical query planner: the plan is captured lazily, rewritten
        and executed via the compiled-plan cache, so a repeated query
        skips the rewrite.  Returns the query's concrete result.
        ``CYLON_OPTIMIZER=0`` (or ``config.set_optimizer_enabled(False)``)
        makes this a plain eager call.  Across processes every process
        calls it with the same plan (SPMD): the rules read global counts,
        so every process rewrites the plan alike."""
        from . import plan
        return plan.optimize(self, op, tables)

    def analyze(self, op, tables=None):
        """EXPLAIN ANALYZE a plan: run ``op(tables)`` (or ``op()`` when
        ``tables`` is None) for real, once, with every distributed
        operator instrumented; returns the runtime-annotated
        ``PlanReport`` (``report.output`` is the result).  The
        context-level spelling of ``DTable.explain(op, tables=...,
        analyze=True)``.  Across processes every process runs it (SPMD);
        node rows are global, node bytes this process's senders'."""
        from . import observe
        if tables is None:
            return observe.analyze(op)
        return observe.analyze(op, tables)

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def comm(self) -> Union[LocalCommunicator, ProcessCommunicator]:
        return self._comm

    @property
    def first_slot(self) -> int:
        """The first of this context's shard slots on its device (one
        process only: across processes a rank is a global rank,
        ``get_rank``)."""
        refuse_multiprocess("slot placement (first_slot)", self)
        return self._first_slot

    def __repr__(self) -> str:
        slot = (f", first_slot={self._first_slot}" if self._first_slot
                else "")
        procs = ""
        if self._comm.nproc > 1:
            procs = (f", process={self._comm.proc}/{self._comm.nproc}, "
                     f"local={self._comm.local}")
        return (f"CylonContext(world={self.get_world_size()}, "
                f"device={self._device}{slot}{procs})")
