"""Isoparametric Q1 geometry: the stored factors, host numpy (port of
``poroelasticity_dealii_tpu/ops/geometry.py``, numpy branch), and the
operand the generic kernels rebuild them from, each cell's corner
offsets, with the plain forms of those rebuilds (:func:`map_factors`,
the elasticity kernel's; :func:`q1_tensor_map`, the Q1 kernel's)."""

from __future__ import annotations

import numpy as np
import torch

from .quadrature import gauss_tensor
from .shape import node_lattice, shape_tables


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


def corner_offsets(corner_xyz: np.ndarray) -> np.ndarray:
    """Each cell's corner offsets ``X_n - X_0`` for the corners n = 1 ..
    2**dim - 1, float64, cells last: ``(2**dim - 1, dim, E)``.  Built in
    float64 and cast to a run's dtype only afterwards: the Q1 map's
    gradients sum to zero over the corners, so J is the offsets' sum and
    no large coordinate is subtracted in the working precision."""
    c = np.asarray(corner_xyz, np.float64)
    return np.ascontiguousarray(np.transpose(c[:, 1:] - c[:, :1], (1, 2, 0)))


def reference_offsets(dim: int) -> np.ndarray:
    """The offsets ``(2**dim - 1, dim)`` of the unit reference cube: the
    finite geometry of AMR bucketing's phantom cells."""
    return node_lattice(1, dim)[1:].astype(np.float64)


def map_tables(dim: int, points_1d: int):
    """(``dn1`` (Q, 2**dim, dim), ``weights`` (Q,)), float64: the Q1 map's
    shape gradients and the weights at the tensor Gauss rule of
    ``points_1d`` points per axis (the rule of the apply that rebuilds its
    geometry)."""
    pts, wts = gauss_tensor(points_1d, dim)
    return np.asarray(shape_tables(1, dim, pts)[1], np.float64), wts


def _cofactors(a: torch.Tensor):
    """(C, det J) of the maps ``a`` (Q, dim, dim, E): ``C[:, i, j]`` the
    cofactor of ``a[:, i, j]`` (:func:`geometry_factors`' formulas), det
    along the first row."""
    if a.shape[1] == 2:
        c = [[a[:, 1, 1], -a[:, 1, 0]], [-a[:, 0, 1], a[:, 0, 0]]]
        det = a[:, 0, 0] * a[:, 1, 1] - a[:, 0, 1] * a[:, 1, 0]
    else:
        def m(i, j):
            return a[:, i, j]
        c = [[m(1, 1) * m(2, 2) - m(1, 2) * m(2, 1),
              m(1, 2) * m(2, 0) - m(1, 0) * m(2, 2),
              m(1, 0) * m(2, 1) - m(1, 1) * m(2, 0)],
             [m(0, 2) * m(2, 1) - m(0, 1) * m(2, 2),
              m(0, 0) * m(2, 2) - m(0, 2) * m(2, 0),
              m(0, 1) * m(2, 0) - m(0, 0) * m(2, 1)],
             [m(0, 1) * m(1, 2) - m(0, 2) * m(1, 1),
              m(0, 2) * m(1, 0) - m(0, 0) * m(1, 2),
              m(0, 0) * m(1, 1) - m(0, 1) * m(1, 0)]]
        det = m(0, 0) * c[0][0] + m(0, 1) * c[0][1] + m(0, 2) * c[0][2]
    return torch.stack([torch.stack(row, dim=1) for row in c], dim=1), det


def map_factors(offsets: torch.Tensor, dn1: torch.Tensor,
                weights: torch.Tensor):
    """The Q1 cell map at the quadrature points, rebuilt from the corner
    offsets ``(2**dim - 1, dim, E)`` as the generic elasticity kernel
    rebuilds it, in the offsets' dtype: ``J[q, i, j, e] = sum_n
    off[n - 1, i, e] * dn1[q, n, j]`` over n = 1 .. 2**dim - 1 ascending,
    ``det J``, ``J^-1`` by cofactors (:func:`geometry_factors`' formulas)
    and ``JxW = det J * w``.  Returns ``(jac, det, jinv, jxw)``, cells
    last: (Q, dim, dim, E), (Q, E), (Q, dim, dim, E), (Q, E).  The plain
    form of that kernel's arithmetic (it fuses the multiply-adds); the Q1
    kernel's is :func:`q1_tensor_map`."""
    dim = offsets.shape[1]
    dn1 = dn1.to(offsets.dtype)
    jac = offsets[0][None, :, None, :] * dn1[:, 1, None, :, None]
    for n in range(2, 2 ** dim):
        jac = jac + offsets[n - 1][None, :, None, :] * \
            dn1[:, n, None, :, None]
    cof, det = _cofactors(jac)
    jinv = cof.transpose(1, 2) * (1.0 / det)[:, None, None]
    jxw = det * weights.to(offsets.dtype)[:, None]
    return jac, det, jinv, jxw


def q1_tensor_map(offsets: torch.Tensor):
    """The Q1 cell map at the 2-point Gauss points (2**dim of them, in
    :func:`.quadrature.gauss_tensor`'s order, weights 1), rebuilt from the
    corner offsets ``(2**dim - 1, dim, E)`` as the generic Q1 kernel
    rebuilds it, in the offsets' dtype: J in tensor-product form, one
    reference axis contracted at a time (xi0 first) with the 1D Q1 values
    ``(1 +- 1/sqrt 3) / 2`` at the two points, or their derivatives
    ``+-1/2`` along J's own axis; the cofactors C, ``det J`` (= JxW) and
    ``K = C^T C / det J`` (= JxW J^-1 J^-T, the Laplacian's weight).
    Returns ``(det, K)``, cells last: (2**dim, E), (2**dim, dim, dim, E).
    The plain form of that kernel's arithmetic (it fuses the
    multiply-adds and keeps K's symmetric half)."""
    dim, E = offsets.shape[1], offsets.shape[-1]
    r = 1.0 / np.sqrt(3.0)
    val = torch.tensor([[(1 + r) / 2, (1 - r) / 2], [(1 - r) / 2,
                                                     (1 + r) / 2]],
                       dtype=offsets.dtype)         # [point s, node i]
    der = torch.tensor([[-0.5, 0.5], [-0.5, 0.5]], dtype=offsets.dtype)
    v = torch.cat([offsets.new_zeros((1, dim, E)), offsets])
    v = v.reshape((2,) * dim + (dim, E))   # [i_{dim-1}, .., i0, comp, e]
    cols = []
    for m in range(dim):
        x = v
        for axis in range(dim):
            k = dim - 1 - axis
            x = torch.movedim(torch.tensordot(der if axis == m else val,
                                              x, dims=([1], [k])), 0, k)
        cols.append(x.reshape(2 ** dim, dim, E))
    cof, det = _cofactors(torch.stack(cols, dim=2))
    K = torch.einsum("qimE,qinE->qmnE", cof, cof) * (1.0 / det)[:, None,
                                                                None]
    return det, K
