"""Tensor-product Lagrange (Q_k) shape functions on [-1, 1]^d quads/hexes.

Replaces deal.II's ``FE_Q`` shape machinery for the two spaces the reference
uses: scalar Q1 pressure (``PoroElasticPressureSolver.h:20``) and vector Q2
displacement (``PoroElasticDisplacementSolver.h:67``).  Any degree k >= 1 is
supported.

Conventions (uniform everywhere in this framework):

* Reference cell is ``[-1, 1]^d``.
* Local nodes are the k+1 per-axis equispaced lattice points, ordered
  lexicographically with x fastest: ``flat = ix + (k+1)*iy + (k+1)^2*iz``.
* Vector-valued spaces interleave components: local dof = ``node*dim + comp``
  (the analogue of deal.II's ``system_to_component_index``).

All tables are numpy float64; they become compile-time constants inside jit.
"""

from __future__ import annotations

import numpy as np


def lagrange_nodes_1d(degree: int) -> np.ndarray:
    """Equispaced Lagrange nodes on [-1, 1] (k+1 points)."""
    return np.linspace(-1.0, 1.0, degree + 1)


def _lagrange_basis_1d(nodes: np.ndarray, x: np.ndarray):
    """Values and derivatives of the 1D Lagrange basis at points x.

    Returns ``(vals (len(x), n_nodes), grads (len(x), n_nodes))``.
    """
    n = len(nodes)
    x = np.asarray(x, dtype=np.float64)
    vals = np.ones((len(x), n))
    grads = np.zeros((len(x), n))
    for i in range(n):
        # L_i(x) = prod_{j!=i} (x - x_j) / (x_i - x_j)
        for j in range(n):
            if j == i:
                continue
            vals[:, i] *= (x - nodes[j]) / (nodes[i] - nodes[j])
        # dL_i(x) = sum_m [1/(x_i-x_m)] prod_{j!=i,m} (x-x_j)/(x_i-x_j)
        for m in range(n):
            if m == i:
                continue
            term = np.ones(len(x)) / (nodes[i] - nodes[m])
            for j in range(n):
                if j in (i, m):
                    continue
                term *= (x - nodes[j]) / (nodes[i] - nodes[j])
            grads[:, i] += term
    return vals, grads


def node_lattice(degree: int, dim: int) -> np.ndarray:
    """Integer lattice coordinates of local nodes, lexicographic x-fastest.

    Shape ``(n_nodes, dim)`` with entries in ``0..degree``.
    """
    n1 = degree + 1
    idx = np.indices([n1] * dim).reshape(dim, -1)
    return np.stack([idx[dim - 1 - k] for k in range(dim)], axis=-1)


def shape_tables(degree: int, dim: int, points: np.ndarray):
    """Evaluate all Q_degree scalar shape functions at reference points.

    Args:
      degree: polynomial degree k.
      dim: spatial dimension.
      points: ``(n_pts, dim)`` reference coordinates in [-1, 1]^d.

    Returns:
      ``(phi (n_pts, n_nodes), dphi (n_pts, n_nodes, dim))`` where
      ``n_nodes = (degree+1)**dim``.
    """
    points = np.asarray(points, dtype=np.float64)
    if points.ndim == 1:
        points = points[:, None]
    nodes1 = lagrange_nodes_1d(degree)
    lat = node_lattice(degree, dim)  # (n_nodes, dim)
    n_pts = points.shape[0]
    n_nodes = lat.shape[0]
    vals_d, grads_d = [], []
    for d in range(dim):
        v, g = _lagrange_basis_1d(nodes1, points[:, d])
        vals_d.append(v)   # (n_pts, degree+1)
        grads_d.append(g)
    phi = np.ones((n_pts, n_nodes))
    dphi = np.zeros((n_pts, n_nodes, dim))
    for a in range(n_nodes):
        for d in range(dim):
            phi[:, a] *= vals_d[d][:, lat[a, d]]
        for gd in range(dim):
            term = np.ones(n_pts)
            for d in range(dim):
                t = grads_d[d] if d == gd else vals_d[d]
                term = term * t[:, lat[a, d]]
            dphi[:, a, gd] = term
    return phi, dphi


def face_lattice_indices(degree: int, dim: int):
    """Local node indices lying on each of the 2*dim axis-aligned faces.

    Face numbering follows deal.II colorize convention used by the reference
    deck (``input.data`` comments; ``PoroelasticityFSS.h:419-435``):
    face ``2*d`` is the x_d = -1 face, ``2*d + 1`` the x_d = +1 face
    (boundary ids 0/1 for x, 2/3 for y, 4/5 for z).

    Returns a list of int arrays, each of length ``(degree+1)**(dim-1)``.
    """
    lat = node_lattice(degree, dim)
    faces = []
    for d in range(dim):
        for side, val in ((0, 0), (1, degree)):
            faces.append(np.nonzero(lat[:, d] == val)[0].astype(np.int32))
    return faces
