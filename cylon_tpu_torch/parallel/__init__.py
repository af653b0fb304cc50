"""Distributed tables and operators over the context's P row shards."""
from .dist_ops import (dist_head, dist_intersect, dist_join, dist_sort,
                       dist_sort_multi, dist_subtract, dist_union,
                       shuffle_table)
from .dtable import DColumn, DTable

__all__ = ["DTable", "DColumn", "dist_join", "shuffle_table",
           "dist_union", "dist_intersect", "dist_subtract",
           "dist_sort", "dist_sort_multi", "dist_head"]
