"""pycylon.net.txrequest over the port — reference:
python/pycylon/net/txrequest.pyx and cpp/src/cylon/net/TxRequest.hpp: a
send descriptor (target, buffer, length, ≤6-int user header)."""
from __future__ import annotations

from typing import Optional

import numpy as np

MAX_HEADER = 6  # reference: net/TxRequest.hpp (headerLength <= 6)


class TxRequest:
    def __init__(self, target: int, buf: Optional[np.ndarray] = None,
                 length: int = -1, header: Optional[np.ndarray] = None,
                 header_length: int = -1):
        if header is not None:
            header = np.asarray(header, dtype=np.int32)
            n = header.shape[0] if header_length < 0 else header_length
            if n > MAX_HEADER:
                raise ValueError(f"header length {n} > {MAX_HEADER}")
            header = header[:n]
        self.target = int(target)
        self.buf = None if buf is None else np.asarray(buf)
        self.length = (len(self.buf) if (length < 0 and self.buf is not None)
                       else length)
        self.header = header

    def to_string(self, data_type: str = "", depth: int = 0) -> str:
        hdr = [] if self.header is None else list(self.header)
        return (f"TxRequest(target={self.target}, length={self.length}, "
                f"header={hdr})")

    def __repr__(self) -> str:
        return self.to_string()
