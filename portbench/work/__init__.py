"""The least work of a kernel's function, whatever implements it, and the
card's published peaks: the yardstick of every ``<kernel>_roofline``.

A call's bound is the larger of its bytes over the memory rate and its
operations over the peak rate.  Each input and output value is counted
once, at its unpadded size; no layout of an implementation (padded rows,
a dof-major plan, a connectivity per component) is counted.  Both
elasticity applies count the Q2 element's products sum-factorised, one
axis at a time, where that takes fewer operations than the dense element
matrix:

* The structured elasticity apply (``elasticity_rows_apply``): the Q2
  vector in and out and the Dirichlet mask where the mode reads one; the
  cells are equal cubes, so the map is a constant folded into the
  material constants: the gradients and their transpose, the stress at
  each point, the weights and the scatter's additions, or 2 flop per
  nonzero of the element matrix, whichever is fewer.
* The generic elasticity apply (``generic_elasticity_apply``), on a mesh
  whose cells differ: the vector in and out, the 27 node ids of each
  cell, each cell's corner offsets and the element's tables; the
  sum-factorised products, the map rebuilt at each point from the corner
  offsets (as ``tools/apply_bench.py::generic_work`` counts it with
  ``geometry="offsets"``, frozen here), the pointwise algebra and the
  scatter's additions.
"""

from __future__ import annotations

import numpy as np

# NVIDIA H100 SXM data sheet, dense, at the full 700 W power limit: f32
# outside the tensor cores (TF32 is another precision), f64 on its tensor
# cores (DMMA), the card's fastest f64
PEAK_BYTES = 3.35e12                 # HBM3, bytes/s
PEAK_FLOPS = {"float32": 67e12, "float64": 67e12}
ITEM = {"float32": 4, "float64": 8}

# the rows apply's modes (``ops/comp_major.py``: UNMASKED, FREE,
# CONSTRAINED) and whether each reads the Dirichlet mask
ROWS_MODE_MASK = {0: False, 1: True, 2: True}

# frozen from tools/apply_bench.py: flop of the Q1 map rebuilt at one
# quadrature point from the corner offsets (3D), and multiply-adds of the
# sum-factorised gradients for one component of a cell (3D)
MAP_FLOP_3D = 2 * 7 * 9 + 9 * 3 + 5 + 1 + 9 + 1
SUMFAC_FMA_3D = 648


def bound_ms(nbytes: float, flop: float, dtype: str) -> float:
    """The least milliseconds of ``nbytes`` and ``flop`` on the card."""
    return max(nbytes / PEAK_BYTES, flop / PEAK_FLOPS[dtype]) * 1e3


def element_stiffness(h: float, lam: float, mu: float) -> np.ndarray:
    """The Q2 elasticity matrix (81 x 81, dof ``node * 3 + comp``) of a
    cube of side ``h``, by the 3-point Gauss rule."""
    from ..reference.fem import gauss, tables
    pts, wts = gauss(3)
    _, grad = tables(2, pts)
    g = grad / h                                     # (Q, 27, 3)
    w = wts * h ** 3
    ke = np.zeros((27, 3, 27, 3))
    for q in range(len(w)):
        gq = g[q]
        ke += w[q] * (lam * np.einsum("ni,mj->nimj", gq, gq)
                      + mu * np.einsum("nj,mi->nimj", gq, gq)
                      + mu * np.einsum("nk,mk,ij->nimj", gq, gq,
                                       np.eye(3)))
    return ke.reshape(81, 81)


def nonzeros(ke: np.ndarray) -> int:
    """Entries above 1e-12 of the largest (the rest is quadrature
    roundoff)."""
    return int((np.abs(ke) > 1e-12 * np.abs(ke).max()).sum())


def _pointwise_flop(cells: int) -> int:
    """The sum-factorised Q2 elasticity products of ``cells`` cells, with
    no map: the three components' gradients and their transpose, the
    stress at each of the 27 points, the weights and the scatter's
    additions."""
    Qu, Nu, dim = 27, 27, 3
    return (2 * 2 * dim * SUMFAC_FMA_3D + (dim - 1) * Qu
            + 6 * Qu * dim * dim + Qu + Nu * dim) * cells


def rows_elasticity_ms(n: int, dtype: str, mode: int, ke_nonzeros: int
                       ) -> float:
    """One structured elasticity apply on an n^3 grid."""
    n_udofs = 3 * (2 * n + 1) ** 3
    nbytes = (2 + ROWS_MODE_MASK[mode]) * n_udofs * ITEM[dtype]
    flop = min(2 * ke_nonzeros * n ** 3, _pointwise_flop(n ** 3))
    return bound_ms(nbytes, flop, dtype)


def generic_elasticity_ms(cells: int, n_udofs: int, dtype: str) -> float:
    """One generic Q2 elasticity apply on a hex mesh of ``cells`` cells
    (27 nodes, 27 Gauss points)."""
    item = ITEM[dtype]
    E, Qu, Nu, dim = cells, 27, 27, 3
    tables = Qu * Nu * (1 + dim) * item
    nbytes = (2 * n_udofs * item + Nu * E * 4 + tables
              + (2 ** dim - 1) * dim * E * item)
    flop = (_pointwise_flop(E) + 2 * Qu * dim * dim * (2 * dim - 1) * E
            + MAP_FLOP_3D * Qu * E)
    return bound_ms(nbytes, flop, dtype)
