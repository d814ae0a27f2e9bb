"""Gauss-Legendre quadrature on [-1, 1]^d.

The reference integrates everything with ``QGauss<dim>(fe.degree + 1)``
(reference ``PoroElasticDisplacementSolver.h:159-160``,
``PoroElasticPressureSolver.h:97-101``, ``StrainProjector.h:126``), i.e.
(degree+1)-point tensor-product Gauss rules, which integrate the element
integrands exactly for affine cells.  Tables are plain numpy; they are baked
into jitted computations as compile-time constants.
"""

from __future__ import annotations

import numpy as np


def gauss_1d(n: int):
    """n-point Gauss-Legendre rule on [-1, 1]; exact for degree 2n-1."""
    pts, wts = np.polynomial.legendre.leggauss(n)
    return pts.astype(np.float64), wts.astype(np.float64)


def gauss_tensor(n: int, dim: int):
    """Tensor-product Gauss rule on [-1,1]^dim.

    Returns ``(points (n^dim, dim), weights (n^dim,))`` ordered
    lexicographically with the x coordinate fastest (matching the node
    ordering used by :mod:`..ops.shape`).
    """
    p1, w1 = gauss_1d(n)
    # np.indices flattens C-order (last axis fastest); coordinate k = x,y,z
    # must vary fastest for k=0, so coordinate k reads idx[dim-1-k].
    idx = np.indices([n] * dim).reshape(dim, -1)
    pts = np.stack([p1[idx[dim - 1 - k]] for k in range(dim)], axis=-1)
    wts = np.ones(n ** dim, dtype=np.float64)
    for k in range(dim):
        wts *= w1[idx[dim - 1 - k]]
    return pts, wts
