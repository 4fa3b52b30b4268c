from .mesh import (all_reduce_sum, barrier, launch, make_world_for_batch, rank,
                   shard_rows, world_size)

__all__ = ["all_reduce_sum", "barrier", "launch", "make_world_for_batch", "rank",
           "shard_rows", "world_size"]
