"""Sharded forms of the solver over ``torch.distributed`` (port of
``poroelasticity_dealii_tpu/parallel/``): psum and gspmd
(:mod:`.sharding`), which keep every solver vector whole, the production
slab kits (:mod:`.rows`: z-slab rows in 3D, y-slab parity in 2D), and
ghost (:mod:`.ghost`: every vector sharded, halo windows), over a
:class:`.sharding.SlabGroup`."""

from .ghost import (GhostShardedDiscretization,  # noqa: F401
                    renumber_discretization, shard_discretization_ghost)
from .rows import (ShardedKit, ShardedParityOps,  # noqa: F401
                   ShardedRowOps, make_parity_ops_sharded,
                   make_row_ops_sharded, shard_production_discretization,
                   slab_layers)
from .sharding import (ShardedDiscretization, SlabGroup,  # noqa: F401
                       SlabStencil, init_from_env, make_slab_group,
                       shard_discretization, shard_grid_discretization)
