from .context import CylonContext

__all__ = ["CylonContext"]
