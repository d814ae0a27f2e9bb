"""Sharded forms of the solver over ``torch.distributed`` (port of
``poroelasticity_dealii_tpu/parallel/``, ghost excepted): psum and gspmd
(:mod:`.sharding`), which keep every solver vector whole, and the
production slab kits (:mod:`.rows`: z-slab rows in 3D, y-slab parity in
2D), over a :class:`.sharding.SlabGroup`."""

from .rows import (ShardedKit, ShardedParityOps,  # noqa: F401
                   ShardedRowOps, make_parity_ops_sharded,
                   make_row_ops_sharded, shard_production_discretization,
                   slab_layers)
from .sharding import (ShardedDiscretization, SlabGroup,  # noqa: F401
                       SlabStencil, init_from_env, make_slab_group,
                       shard_discretization, shard_grid_discretization)
