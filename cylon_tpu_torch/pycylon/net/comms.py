"""pycylon.net.comms over the port — raw AllToAll through the context's
communicator.

reference: python/pycylon/net/comms.pyx (Communication → CAll_to_all_wrap →
cylon::AllToAll insert/wait/finish over MPI point-to-point).  Here the
byte exchange is ONE ``all_to_all`` of the context's communicator:
inserted buffers are byte-serialized (``_pack``), padded to the per-pair
maximum in a ``[source, target, block]`` uint8 tensor with an int32
``[source, target]`` length tensor beside it, exchanged, and unpadded on
receive (``_unpack``) — the JAX package's plan, with its one
``lax.all_to_all`` over the device mesh replaced by the communicator's
(``LocalCommunicator``: a block transpose of the ranks on the context's
device).  ``wait`` is a no-op: the exchange runs in ``finish``.

One process only: across processes ``finish`` raises a typed
``NotImplemented`` (``context.refuse_multiprocess``).  The JAX package
cannot run it there either: its exchange reads the whole ``[target,
source, block]`` array back to the host with ``jax.device_get``, which
JAX refuses for an array that spans another process's devices.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ...context import refuse_multiprocess
from ...table import host_batch
from .dist import get_ctx
from .txrequest import TxRequest


class Communication:
    def __init__(self, worker_id: int, sources: Sequence[int],
                 targets: Sequence[int], edge_id: int, ctx=None):
        self.ctx = ctx or get_ctx()
        self.worker_id = int(worker_id)
        self.sources = list(sources)
        self.targets = list(targets)
        self.edge_id = int(edge_id)
        self._pending: List[TxRequest] = []
        self._received: Dict[int, List[Tuple[int, np.ndarray, Optional[np.ndarray]]]] = {}
        self._done = False

    def insert(self, buffer: np.ndarray, length: int, target: int,
               header: Optional[np.ndarray] = None,
               header_length: int = -1) -> bool:
        if self._done:
            return False
        if target not in self.targets:
            return False
        self._pending.append(TxRequest(target, buffer[:length], length,
                                       header, header_length))
        return True

    def wait(self) -> None:
        """Nothing to progress: the exchange runs in ``finish`` (the
        reference's MPI_Test polling loops have no equivalent)."""

    def finish(self) -> None:
        """Run the exchange: one padded uint8 all_to_all (and one int32
        all_to_all of the lengths) through the context's communicator."""
        if self._done:
            return
        refuse_multiprocess("pycylon.net.Communication (the raw AllToAll)",
                            self.ctx)
        Pn = self.ctx.get_world_size()
        dev = self.ctx.device

        # serialize sends per (source = worker_id, target)
        per_target: Dict[int, List[TxRequest]] = {t: [] for t in range(Pn)}
        for req in self._pending:
            per_target[req.target].append(req)
        blobs = {t: _pack(reqs) for t, reqs in per_target.items()}
        block = max(max((len(b) for b in blobs.values()), default=1), 1)

        send = np.zeros((Pn, Pn, block), np.uint8)   # [source, target, block]
        lens = np.zeros((Pn, Pn), np.int32)
        for t, b in blobs.items():
            send[self.worker_id, t, :len(b)] = np.frombuffer(b, np.uint8)
            lens[self.worker_id, t] = len(b)

        comm = self.ctx.comm
        recv_d = comm.all_to_all(torch.from_numpy(send).to(dev))
        rlens_d = comm.all_to_all(torch.from_numpy(lens).to(dev))
        recv, rlens = host_batch([recv_d, rlens_d])  # [target, source, …]
        for tgt in range(Pn):
            inbox = []
            for src in range(Pn):
                n = int(rlens[tgt, src])
                if n:
                    inbox.extend((src, buf, hdr) for buf, hdr in
                                 _unpack(recv[tgt, src, :n].tobytes()))
            self._received[tgt] = inbox
        self._done = True

    def received(self, rank: Optional[int] = None):
        """Buffers received by ``rank`` (default: this worker) as a list of
        (source, buffer ndarray, header ndarray|None)."""
        return self._received.get(
            self.worker_id if rank is None else rank, [])


def _pack(reqs: List[TxRequest]) -> bytes:
    """Per request: int64 [buffer bytes, header ints], int64 dtype-name
    length, the dtype name, the int32 header, the buffer's bytes."""
    out = bytearray()
    for r in reqs:
        buf = np.ascontiguousarray(r.buf)
        hdr = (np.empty(0, np.int32) if r.header is None
               else np.asarray(r.header, np.int32))
        meta = np.array([len(buf.tobytes()), len(hdr)], np.int64).tobytes()
        dt = str(buf.dtype).encode()
        out += meta + np.array([len(dt)], np.int64).tobytes() + dt
        out += hdr.tobytes() + buf.tobytes()
    return bytes(out)


def _unpack(blob: bytes):
    out = []
    off = 0
    while off < len(blob):
        blen, hlen = np.frombuffer(blob, np.int64, 2, off)
        off += 16
        (dlen,) = np.frombuffer(blob, np.int64, 1, off)
        off += 8
        dt = np.dtype(blob[off:off + dlen].decode())
        off += int(dlen)
        hdr = (np.frombuffer(blob, np.int32, int(hlen), off)
               if hlen else None)
        off += int(hlen) * 4
        buf = np.frombuffer(blob[off:off + int(blen)], dt).copy()
        off += int(blen)
        out.append((buf, hdr))
    return out
