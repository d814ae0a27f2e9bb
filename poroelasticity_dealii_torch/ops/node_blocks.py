"""The per-node (3, 3) diagonal blocks of the constrained Q2 elasticity
operator on the 3D structured grid, which the node-block Jacobi
preconditioner inverts (a copy of ``elasticity_node_blocks`` from
``poroelasticity_dealii_tpu/ops/pallas_comp_major.py:174-211``, held
source-equal by ``tests/test_torch_vendored.py``).  Host numpy, built once
at set-up."""

from __future__ import annotations

import numpy as np

from .shape import node_lattice


def elasticity_node_blocks(element_matrix: np.ndarray, n: int,
                           free_mask_u) -> np.ndarray:
    """Per-node (3, 3) diagonal blocks of the CONSTRAINED elasticity
    operator on the structured Q2 grid: B[node][c, c'] = sum over cells
    touching the node of the element matrix's local diagonal node block,
    with Dirichlet-constrained (node, comp) rows/cols replaced by the
    identity (the constrained operator acts as identity there).

    Feeds the node-block Jacobi preconditioner (the 3x3 coupling between
    a node's displacement components that scalar Jacobi ignores — the
    lam/mu cross terms of ``PoroElasticDisplacementSolver.h:237-242``).
    Host numpy, setup-time.  Returns (g^3, 3, 3), g = 2n+1.

    Measured caveat (docs/VALIDATION.md "node-block Jacobi ablation"): on
    the uniform grids this path runs on, the assembled INTERIOR blocks
    are exactly diagonal — the per-element cross terms (up to 37% of the
    diagonal at corner nodes) cancel by parity across the 8 surrounding
    cells — and off-diagonals survive only at boundary nodes free in
    several components, which the golden decks' Dirichlet masks zero.
    Hence 'block' == scalar Jacobi numerically on those decks, and the
    knob defaults to 'jacobi'."""
    g = 2 * n + 1
    Ke = np.asarray(element_matrix, np.float64)
    lat = node_lattice(2, 3)                             # (27, 3) x-first
    B = np.zeros((g ** 3, 3, 3))
    idx = np.arange(n)
    cz, cy, cx = np.meshgrid(idx, idx, idx, indexing="ij")
    for a in range(27):
        ox, oy, oz = int(lat[a, 0]), int(lat[a, 1]), int(lat[a, 2])
        nodes = (((2 * cz + oz) * g + (2 * cy + oy)) * g
                 + (2 * cx + ox)).ravel()                # unique per a
        B[nodes] += Ke[a * 3:a * 3 + 3, a * 3:a * 3 + 3]
    f = np.asarray(free_mask_u, np.float64).reshape(g ** 3, 3) > 0
    B *= f[:, :, None] & f[:, None, :]                   # zero constrained
    for c in range(3):
        B[~f[:, c], c, c] = 1.0                          # identity rows
    return B

