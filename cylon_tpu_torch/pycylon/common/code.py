"""pycylon.common.code over the port — reference:
python/pycylon/common/code.pyx:23-40."""
from ...status import Code

__all__ = ["Code"]
