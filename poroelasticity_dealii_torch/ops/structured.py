"""Uniform-grid geometry (port of
``poroelasticity_dealii_tpu/ops/structured.py:91-109``)."""

from __future__ import annotations

import numpy as np

from .geometry import geometry_factors


def uniform_geometry_factors(mesh_vertices: np.ndarray, cells_per_axis,
                             quad_points, quad_weights):
    """Geometry factors of ONE cell of a uniform grid, cells-broadcast:
    ``jinv (Q, dim, dim, 1)``, ``jxw (Q, 1)``."""
    lo = mesh_vertices.min(axis=0)
    hi = mesh_vertices.max(axis=0)
    dim = lo.shape[0]
    h = (hi - lo) / np.asarray(cells_per_axis, np.float64)
    corners = np.array(np.indices([2] * dim).reshape(dim, -1).T[:, ::-1],
                       dtype=np.float64) * h
    jinv, jxw = geometry_factors(corners[None], quad_points, quad_weights)
    return np.transpose(jinv, (1, 2, 3, 0)), jxw.T
