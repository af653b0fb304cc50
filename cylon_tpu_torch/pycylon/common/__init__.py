from .code import Code
from .status import Status
from .join_config import JoinAlgorithm, JoinConfig, JoinType, \
    PJoinAlgorithm, PJoinType

__all__ = ["Code", "Status", "JoinConfig", "JoinType", "JoinAlgorithm",
           "PJoinType", "PJoinAlgorithm"]
