"""Scalar Q1 operators on uniform grids as shifted-slice products (port of
``poroelasticity_dealii_tpu/ops/stencil.py:151-189``, ``_make_q1_slices_apply``).

Carries the pressure mass, Laplace and fused-Jacobian applies and the
pressure multigrid level operators."""

from __future__ import annotations

import numpy as np
import torch


def make_q1_slices_apply(element_matrix: np.ndarray, dim: int, ns, dtype,
                         device) -> callable:
    """``apply(x)`` for a scalar Q1 -> Q1 operator with the uniform cell
    matrix ``element_matrix`` (2^dim x 2^dim, x-fastest local nodes) on a
    grid of ``ns`` cells per axis ((x, y[, z]) order).

    Each cell-local node is a shifted full-grid slice: the 2^dim slices are
    stacked, multiplied by the element matrix in one product, and each
    output slice is added back at its shift.  ``x`` may carry leading batch
    dimensions (the batched projection solves)."""
    K = torch.as_tensor(np.asarray(element_matrix, np.float64), dtype=dtype,
                        device=device)
    n_loc = 2 ** dim
    offsets = [tuple((a >> d) & 1 for d in range(dim)) for a in range(n_loc)]
    rev = tuple(reversed(tuple(ns)))                  # grid is (z, y, x)
    grid = tuple(r + 1 for r in rev)

    def cell_slice(off):
        # tensor axes are (z, y, x); the offset tuple is (x, y, z)
        return tuple(slice(off[dim - 1 - a], off[dim - 1 - a] + rev[a])
                     for a in range(dim))

    slices = [cell_slice(off) for off in offsets]

    def apply(x):
        batch = x.shape[:-1]
        X = x.reshape(batch + grid)
        ell = (Ellipsis,)
        U = torch.stack([X[ell + s] for s in slices], dim=-1)
        V = U @ K.T                                    # (..., cells, n_loc)
        Y = torch.zeros_like(X)
        for ao, s in enumerate(slices):
            Y[ell + s] += V[..., ao]
        return Y.reshape(x.shape)

    return apply
