"""Sharded forms of the solver over ``torch.distributed`` (port of
``poroelasticity_dealii_tpu/parallel/``): the production z-slab path
(:mod:`.rows`) over a :class:`.sharding.SlabGroup`."""

from .rows import (ShardedRowOps, make_row_ops_sharded,  # noqa: F401
                   shard_production_discretization, slab_layers)
from .sharding import SlabGroup, init_from_env, make_slab_group  # noqa: F401
