"""FedNL's clients sharded across ranks over ``torch.distributed`` (port of
``repro.distributed``): the sharded round (:mod:`.fednl_shard`) and the
process groups it runs in (:mod:`.world`)."""

from repro_torch.distributed.fednl_shard import (
    ShardRunner,
    make_sharded_fednl_round,
    make_sharded_fednl_step,
    shard_problem,
    sharded_fednl_init,
)
from repro_torch.distributed.world import ShardedWorld, world_of_one, world_size_for

__all__ = [
    "ShardRunner",
    "ShardedWorld",
    "make_sharded_fednl_round",
    "make_sharded_fednl_step",
    "shard_problem",
    "sharded_fednl_init",
    "world_of_one",
    "world_size_for",
]
