"""pycylon.common.status over the port — reference:
python/pycylon/common/status.pyx.

The reference ctor is ``Status(code, msg: bytes, _)``; both that shape and
the port's ``Status(code, msg)`` shape are accepted.  ``is_ok``,
``get_code`` and ``get_msg`` come from the backing class.
"""
from __future__ import annotations

from ...status import Code, Status as _Status


class Status(_Status):
    def __init__(self, code=Code.OK, msg="", _ignored: int = -1):
        if isinstance(msg, bytes):
            msg = msg.decode()
        super().__init__(code, msg)


__all__ = ["Status", "Code"]
