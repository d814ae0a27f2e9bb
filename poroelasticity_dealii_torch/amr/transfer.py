"""Nodal solution transfer across remeshing.

The deal.II ``SolutionTransfer`` analogue (``PoroelasticityFSS.h:474-497``):
{p, eps_v, eps_v0} move from the old mesh to the new one by evaluating the
old (continuous, constraint-distributed) Q1 field at the new node locations
— exact injection where the meshes coincide, parent-cell interpolation under
refinement, child-corner injection under coarsening.
"""

from __future__ import annotations

import numpy as np

from .forest import QuadForest


def _morton(f: np.ndarray, n_bits: int, dim: int) -> np.ndarray:
    """Interleave the low ``n_bits`` of ``f``'s (..., dim) integer
    coordinates into one Morton (z-order) code, x in the least-significant
    interleave slot (matching the leaf child layout)."""
    code = np.zeros(f.shape[:-1], np.int64)
    for b in range(n_bits):
        for d in range(dim):
            code |= ((f[..., d] >> b) & 1) << (b * dim + d)
    return code


def transfer_nodal(forest_old: QuadForest, mesh_old, values: np.ndarray,
                   new_points: np.ndarray) -> np.ndarray:
    """Evaluate the old Q1 field(s) at ``new_points``.

    Args:
      values: ``(..., n_old_vertices)`` nodal values (hanging entries must
        already be distributed — they are, the solver keeps them consistent).
      new_points: ``(P, 2)`` physical coordinates.
    Returns ``(..., P)``.
    """
    dim = new_points.shape[1]
    leaves = forest_old.sorted_leaves()
    Lmax = forest_old.max_level
    R = 2 ** Lmax
    lo = forest_old.lower
    sz = forest_old.upper - forest_old.lower
    u = np.clip((new_points - lo) / sz, 0.0, 1.0)      # (P, dim) in [0,1]

    was_1d = values.ndim == 1
    values = np.atleast_2d(values)
    cellv = values[..., mesh_old.cells]                # (..., E, 2^dim)

    # Morton-order lookup: a leaf (l, idx) covers exactly the CONTIGUOUS
    # Morton-code range [morton(idx << (Lmax-l)), + 2^(dim(Lmax-l))) of
    # finest cells, and leaves partition the domain, so the covering leaf
    # of a point is searchsorted(starts, code, 'right') - 1 on the
    # Morton-sorted leaf starts.  O(E log E + P) time, O(E) memory — no
    # dense R^dim grid (a level-10 3D forest would need GiBs of one).
    lv = np.array([leaf[0] for leaf in leaves], dtype=np.int64)
    li = np.array([leaf[1:] for leaf in leaves], dtype=np.int64)  # (E, dim)
    starts = _morton(li << (Lmax - lv)[:, None], Lmax, dim)
    order = np.argsort(starts)

    f = np.minimum((u * R).astype(np.int64), R - 1)     # (P, dim)
    c = order[np.searchsorted(starts[order], _morton(f, Lmax, dim),
                              side="right") - 1]        # (P,)
    levels = lv
    n = (1 << levels[c]).astype(np.float64)             # (P,)
    idx = np.minimum((u * n[:, None]).astype(np.int64),
                     (n[:, None] - 1).astype(np.int64))
    xi = u * n[:, None] - idx                           # (P, dim) in [0,1]

    # multilinear corner weights in lex corner order (x fastest): corner
    # j = sum_d bit_d 2^d, weight = prod_d (bit_d ? xi_d : 1-xi_d)
    w = np.ones((len(u), 1))
    for d in range(dim):
        wd = np.stack([1.0 - xi[:, d], xi[:, d]], axis=1)   # (P, 2)
        w = (wd[:, :, None] * w[:, None, :]).reshape(len(u), -1)
    out = np.einsum("...pv,pv->...p", cellv[..., c, :], w)
    return out[0] if was_1d else out
