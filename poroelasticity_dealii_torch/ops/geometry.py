"""Isoparametric Q1 geometry factors, host numpy (port of
``poroelasticity_dealii_tpu/ops/geometry.py``, numpy branch)."""

from __future__ import annotations

import numpy as np

from .shape import shape_tables


def geometry_factors(corner_xyz: np.ndarray, quad_points, quad_weights):
    """Jacobian factors of the Q1 cell map at quadrature points.

    ``corner_xyz``: (E, 2**dim, dim) cell corners; ``quad_points`` (Q, dim)
    in [-1, 1]^dim; ``quad_weights`` (Q,).  Returns ``jinv (E, Q, dim, dim)``
    with ``grad_x phi[d] = sum_m jinv[m, d] * grad_ref phi[m]`` and
    ``jxw (E, Q)``."""
    corner_xyz = np.asarray(corner_xyz)
    dim = corner_xyz.shape[-1]
    dtype = corner_xyz.dtype
    _, dn1 = shape_tables(1, dim, np.asarray(quad_points))
    dn1 = np.asarray(dn1, dtype=dtype)                 # (Q, 2**dim, dim)
    w = np.asarray(quad_weights, dtype=dtype)
    jac = np.einsum("evi,qvj->eqij", corner_xyz, dn1)  # J[e,q,i,j]
    if dim == 1:
        det = jac[..., 0, 0]
        jinv = (1.0 / det)[..., None, None]
    elif dim == 2:
        a, b = jac[..., 0, 0], jac[..., 0, 1]
        c, d = jac[..., 1, 0], jac[..., 1, 1]
        det = a * d - b * c
        inv_det = 1.0 / det
        jinv = np.stack([
            np.stack([d * inv_det, -b * inv_det], axis=-1),
            np.stack([-c * inv_det, a * inv_det], axis=-1),
        ], axis=-2)
    else:
        a = jac
        c00 = a[..., 1, 1] * a[..., 2, 2] - a[..., 1, 2] * a[..., 2, 1]
        c01 = a[..., 1, 2] * a[..., 2, 0] - a[..., 1, 0] * a[..., 2, 2]
        c02 = a[..., 1, 0] * a[..., 2, 1] - a[..., 1, 1] * a[..., 2, 0]
        c10 = a[..., 0, 2] * a[..., 2, 1] - a[..., 0, 1] * a[..., 2, 2]
        c11 = a[..., 0, 0] * a[..., 2, 2] - a[..., 0, 2] * a[..., 2, 0]
        c12 = a[..., 0, 1] * a[..., 2, 0] - a[..., 0, 0] * a[..., 2, 1]
        c20 = a[..., 0, 1] * a[..., 1, 2] - a[..., 0, 2] * a[..., 1, 1]
        c21 = a[..., 0, 2] * a[..., 1, 0] - a[..., 0, 0] * a[..., 1, 2]
        c22 = a[..., 0, 0] * a[..., 1, 1] - a[..., 0, 1] * a[..., 1, 0]
        det = a[..., 0, 0] * c00 + a[..., 0, 1] * c01 + a[..., 0, 2] * c02
        inv_det = 1.0 / det
        jinv = np.stack([
            np.stack([c00, c10, c20], axis=-1),
            np.stack([c01, c11, c21], axis=-1),
            np.stack([c02, c12, c22], axis=-1),
        ], axis=-2) * inv_det[..., None, None]
    jxw = det * w[None, :]
    return jinv, jxw
