"""pycylon.common.join_config over the port — reference:
python/pycylon/common/join_config.pyx:23-60.

String enums (``PJoinType`` / ``PJoinAlgorithm``) plus a ``JoinConfig``
built from the same strings.  ``'outer'`` / ``'fullouter'`` /
``'full_outer'`` all mean FULL OUTER (the reference docs use 'outer', the
enum value is 'fullouter'); no algorithm (``None``) means HASH.
"""
from __future__ import annotations

from enum import Enum

from ...config import (JoinAlgorithm as JoinAlgorithm,
                       JoinConfig as _JoinConfig,
                       JoinType as JoinType)


class PJoinAlgorithm(Enum):
    SORT = "sort"
    HASH = "hash"


class PJoinType(Enum):
    INNER = "inner"
    LEFT = "left"
    RIGHT = "right"
    OUTER = "fullouter"


_TYPE_MAP = {
    "inner": JoinType.INNER,
    "left": JoinType.LEFT,
    "right": JoinType.RIGHT,
    "outer": JoinType.FULL_OUTER,
    "fullouter": JoinType.FULL_OUTER,
    "full_outer": JoinType.FULL_OUTER,
}
_ALG_MAP = {"sort": JoinAlgorithm.SORT, "hash": JoinAlgorithm.HASH,
            None: JoinAlgorithm.HASH}


def resolve(join_type: str, join_algorithm, left_column_index: int,
            right_column_index: int) -> _JoinConfig:
    if left_column_index is None or right_column_index is None:
        raise ValueError("Join Column index not provided")
    if join_type not in _TYPE_MAP:
        raise ValueError(f"Unsupported Join Type {join_type}")
    if join_algorithm not in _ALG_MAP:
        raise ValueError(f"Unsupported Join Algorithm {join_algorithm}")
    return _JoinConfig(_TYPE_MAP[join_type], _ALG_MAP[join_algorithm],
                       left_column_index, right_column_index)


class JoinConfig(_JoinConfig):
    """reference signature: JoinConfig(join_type, join_algorithm, left, right)."""

    def __new__(cls, join_type: str, join_algorithm: str,
                left_column_index: int, right_column_index: int):
        cfg = resolve(join_type, join_algorithm, left_column_index,
                      right_column_index)
        self = object.__new__(cls)
        object.__setattr__(self, "join_type", cfg.join_type)
        object.__setattr__(self, "algorithm", cfg.algorithm)
        object.__setattr__(self, "left_column_idx", cfg.left_column_idx)
        object.__setattr__(self, "right_column_idx", cfg.right_column_idx)
        return self

    def __init__(self, *a, **k):  # state set in __new__
        pass


__all__ = ["JoinConfig", "JoinType", "JoinAlgorithm", "PJoinType",
           "PJoinAlgorithm", "resolve"]
