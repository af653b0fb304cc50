"""pycylon.ctx.context over the port — reference:
python/pycylon/ctx/context.pyx:24-75.

``CylonContext('mpi')`` in reference scripts meant "join the MPI world";
here, as in the JAX package's pycylon, it means "distribute": ``world``
row shards (default ``DEFAULT_WORLD``, the reference tests' 8 ranks) on
the context's device.  ``CylonContext()`` / ``CylonContext(None)`` /
``CylonContext('local')`` is the single-rank local mode.  The backend
names are the JAX package's (``'tpu'``, ``'mpi'``, ``'dist'`` and
``'cpu'`` distribute; ``'cpu'`` names a backend there and here, it does
not choose the CPU device); any other raises ``CylonError`` (Invalid).
A dict config (``{'backend': 'mpi', 'k': 'v'}``) names its backend under
``'backend'`` and seeds the config map with the rest; its JAX-package
``'devices'`` key is refused, ``world=`` takes its place.

``device`` is the card unless the caller names another
(``device='cpu'``); without a card the default raises, never falling
back to the CPU.
"""
from __future__ import annotations

from typing import Any, Optional

from ...context import CylonContext as _Ctx
from ...status import Code, CylonError, Status

LOCAL_BACKENDS = (None, "local")
DIST_BACKENDS = ("tpu", "mpi", "dist", "cpu")
DEFAULT_WORLD = 8


class CylonContext(_Ctx):
    def __init__(self, config: Optional[Any] = None, *, device=None,
                 world: Optional[int] = None):
        # a dict config names its backend as the JAX package's does; its
        # other keys seed the config map.  ``world=`` takes the place of
        # the JAX package's ``devices`` list, which is refused here.
        seed = None
        if isinstance(config, dict):
            if "devices" in config:
                raise CylonError(Status(Code.Invalid,
                    "a 'devices' list has no meaning over the port; pass "
                    "world= (and device=) instead"))
            backend = config.get("backend", "tpu")
            seed = {k: v for k, v in config.items() if k != "backend"}
        else:
            backend = config
        if backend in LOCAL_BACKENDS:
            if world not in (None, 1):
                raise CylonError(Status(Code.Invalid,
                    f"a local context has world 1, got world={world}"))
            world, distributed = 1, False
        elif backend in DIST_BACKENDS:
            world = DEFAULT_WORLD if world is None else int(world)
            distributed = True
        else:
            raise CylonError(Status(Code.Invalid,
                                    f"unknown backend config {config!r}"))
        super().__init__(seed, device, world)
        self._distributed = distributed
        self._config_str = config if isinstance(config, str) else None

    def get_config(self, key: Optional[str] = None, default: str = ""):
        """No key: the config string the context was built with (the
        reference's ``get_config()``); a key: the config map's value."""
        if key is None:
            return self._config_str
        return super().get_config(key, default)
