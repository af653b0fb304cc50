"""Distributed tables and operators over the context's P row shards."""
from ..ops.compact import run_pipeline
from .broadcast import clear_replica_cache, replicate_table
from .dist_ops import (dist_aggregate, dist_anti_join, dist_groupby,
                       dist_groupby_fused, dist_groupby_sketch, dist_head,
                       dist_intersect, dist_join, dist_multiway_join,
                       dist_project, dist_select, dist_semi_join, dist_sort,
                       dist_sort_multi, dist_subtract, dist_union,
                       dist_with_column, shuffle_table)
from .dtable import DColumn, DTable
from .streaming import HostPipeline, HostTask, dist_join_streaming

__all__ = ["DTable", "DColumn", "dist_join", "dist_join_streaming",
           "dist_multiway_join", "shuffle_table",
           "dist_semi_join", "dist_anti_join",
           "dist_union", "dist_intersect", "dist_subtract",
           "dist_sort", "dist_sort_multi", "dist_head",
           "dist_select", "dist_project", "dist_with_column",
           "dist_groupby", "dist_groupby_fused", "dist_groupby_sketch",
           "dist_aggregate", "replicate_table", "clear_replica_cache",
           "HostPipeline", "HostTask", "run_pipeline"]
