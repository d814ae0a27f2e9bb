"""Launch plan of the cell product pass of ``csrc/comp_major.cu``
(``rows_products_kernel``), which the elasticity apply in the row layout
(:func:`.comp_major.elasticity_rows_apply`) and on flat vectors
(:func:`.elasticity.elasticity_grid_apply`) and the projection right-hand
side (:func:`.comp_major.projection_rows`) share: tiles of cells gathered
into shared memory and multiplied by the element matrix into an
(``rows``, ``stride``) scratch, cell fastest.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

# The tile shapes of the pass (ProductTile<T, ROWS> in the source), by output
# rows per cell: cells per tile, resident blocks per SM (its
# __launch_bounds__), and the shared-memory shapes of the element matrix and
# of the tile's operand matrix X_E.  ELASTICITY_ROWS: K (81 x 81) of the
# apply, in either layout; PROJECTION_ROWS: pe (8 * 6 x 81) of the
# projection.
ELASTICITY_ROWS, N_VOIGT = 81, 6
PROJECTION_ROWS = 8 * N_VOIGT
PRODUCT_TILE = {
    torch.float32: {"cells": 256, "blocks_per_sm": 2, "k": (81, 84),
                    "x": (81, 256)},
    torch.float64: {"cells": 64, "blocks_per_sm": 2, "k": (88, 92),
                    "x": (88, 68)},
}
PROJECTION_TILE = {
    torch.float32: {"cells": 256, "blocks_per_sm": 2, "k": (81, 48),
                    "x": (81, 256)},
    torch.float64: {"cells": 64, "blocks_per_sm": 2, "k": (48, 92),
                    "x": (88, 68)},
}
_TILES = {ELASTICITY_ROWS: PRODUCT_TILE, PROJECTION_ROWS: PROJECTION_TILE}


@dataclasses.dataclass(frozen=True)
class RowsApplyPlan:
    """Launch plan of a cell product pass: ``tiles`` tiles of
    ``cells_per_tile`` cells over a persistent grid of ``grid`` blocks with
    ``smem_bytes`` of dynamic shared memory, writing the (``rows``,
    ``stride``) product scratch (cell fastest)."""
    rows: int
    cells_per_tile: int
    tiles: int
    stride: int
    grid: int
    smem_bytes: int

    @property
    def scratch_numel(self) -> int:
        return self.rows * self.stride


@functools.lru_cache(maxsize=64)
def rows_apply_plan(n: int, dtype: torch.dtype, sms: int,
                    rows: int = ELASTICITY_ROWS,
                    nz: int = None) -> RowsApplyPlan:
    """The product pass's plan at grid size ``n`` on a card with ``sms``
    multiprocessors, for ``rows`` output rows per cell (the elasticity
    apply's 81 or the projection's 48) over ``nz`` layers of n x n cells
    (default n; the apply's slab form passes its slab depth): at most one
    resident wave of blocks, each loading the element matrix once and
    walking tiles."""
    t = _TILES[rows][dtype]
    item = torch.tensor([], dtype=dtype).element_size()
    smem = ((t["k"][0] * t["k"][1] + t["x"][0] * t["x"][1]) * item
            + (t["cells"] + 81) * 4)        # + cell bases, node offsets
    tiles = -(-(n if nz is None else nz) * n * n // t["cells"])
    return RowsApplyPlan(
        rows=rows, cells_per_tile=t["cells"], tiles=tiles,
        stride=tiles * t["cells"], grid=min(tiles, sms * t["blocks_per_sm"]),
        smem_bytes=smem)


@functools.cache
def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count
