"""pycylon.net over the port — the raw AllToAll, send descriptors and the
distributed-context pin.

reference: python/pycylon/net/ (Cython wrappers over cylon::net AllToAll /
TxRequest / dist).  The progress-engine machinery has no equivalent here:
``Communication.finish()`` makes ONE exchange through the context's
communicator (a block transpose of the ranks' byte blocks on one device).
"""
from . import dist
from .comms import Communication
from .txrequest import TxRequest

__all__ = ["dist", "Communication", "TxRequest"]
