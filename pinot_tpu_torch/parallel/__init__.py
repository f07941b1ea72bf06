from pinot_tpu_torch.parallel.sharded import (NotShardable,
                                              ShardedQueryExecutor,
                                              StackedSegments, make_mesh)

__all__ = ["NotShardable", "ShardedQueryExecutor", "StackedSegments",
           "make_mesh"]
