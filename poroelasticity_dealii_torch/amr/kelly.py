"""Kelly error estimator + fixed-error-fraction marking (2D).

Replicates the reference's AMR driver pair
(``KellyErrorEstimator::estimate`` on the pressure solution +
``GridRefinement::refine_and_coarsen_fixed_fraction(0.6, 0.4)``,
``PoroelasticityFSS.h:452-462``): per-cell indicators

    eta_K^2 = sum_{F in dK} (h_F / 24) * int_F [d p / d n]^2 ds

with the normal-derivative jump of the Q1 pressure field across every
(possibly coarse-fine) interior face, 2-point Gauss per fine face segment.
"""

from __future__ import annotations

from typing import Set, Tuple

import numpy as np

from .forest import QuadForest


def _grads_batched(pts, x0, h, pv):
    """Bilinear gradients for a batch: pts (F, Q, 2) in cells with origins
    x0 (F, 2), sizes h (F, 2) and corner values pv (F, 4, lex order).
    Returns (F, Q, 2)."""
    xi = (pts - x0[:, None, :]) / h[:, None, :]
    dpdx = ((pv[:, 1] - pv[:, 0])[:, None] * (1 - xi[..., 1])
            + (pv[:, 3] - pv[:, 2])[:, None] * xi[..., 1]) / h[:, None, 0]
    dpdy = ((pv[:, 2] - pv[:, 0])[:, None] * (1 - xi[..., 0])
            + (pv[:, 3] - pv[:, 1])[:, None] * xi[..., 0]) / h[:, None, 1]
    return np.stack([dpdx, dpdy], axis=-1)


def kelly_estimate(forest: QuadForest, mesh, p: np.ndarray) -> np.ndarray:
    """Per-cell eta_K (NOT squared), cells in ``forest.sorted_leaves`` ==
    ``mesh`` ordering.  ``p``: Q1 nodal pressure (vertex values).

    Fully vectorized over face records (the per-record python loop was a
    measured remesh hotspot)."""
    records, leaves = forest.interior_faces()
    eta2 = np.zeros(len(leaves))
    if not records:
        return eta2
    R = 2 ** forest.max_level
    lower = forest.lower
    sz = forest.upper - forest.lower
    # 2-point Gauss on [0,1]
    gp = np.array([0.5 - 0.5 / np.sqrt(3), 0.5 + 0.5 / np.sqrt(3)])
    gw = np.array([0.5, 0.5])
    cellv = p[mesh.cells]                        # (E, 4) corner values

    rec = np.asarray(records, dtype=np.int64)    # (F, 6)
    a, b, axis, line, lo, span = rec.T
    t_axis = 1 - axis
    length = sz[t_axis] * span / R               # (F,)
    line_phys = lower[axis] + sz[axis] * line / R
    lo_phys = lower[t_axis] + sz[t_axis] * lo / R
    tang = lo_phys[:, None] + gp[None, :] * length[:, None]    # (F, 2)
    norm = np.broadcast_to(line_phys[:, None], tang.shape)
    on_x = (axis == 0)[:, None]
    pts = np.stack([np.where(on_x, norm, tang),
                    np.where(on_x, tang, norm)], axis=-1)      # (F, 2, 2)

    lv = np.asarray(leaves, dtype=np.int64)      # (E, 3): l, ix, iy
    s = (R >> lv[:, 0]).astype(np.float64)
    x0 = lower + sz * lv[:, 1:] * s[:, None] / R
    h = sz * s[:, None] / R

    ga = _grads_batched(pts, x0[a], h[a], cellv[a])
    gb = _grads_batched(pts, x0[b], h[b], cellv[b])
    jump = np.take_along_axis(ga - gb, axis[:, None, None], axis=-1)[..., 0]
    integral = length * (gw[None, :] * jump ** 2).sum(axis=1)
    # deal.II: each adjacent cell receives the face term with its own
    # face diameter factor h_F/24
    contrib = (length / 24.0) * integral
    np.add.at(eta2, a, contrib)
    np.add.at(eta2, b, contrib)
    return np.sqrt(eta2)


def _grads_trilinear_batched(pts, x0, h, pv):
    """Trilinear gradients for a batch: pts (F, Q, 3) in cells with origins
    x0 (F, 3), sizes h (F, 3), corner values pv (F, 8, lex order x fastest).
    Returns (F, Q, 3)."""
    F, Q, _ = pts.shape
    xi = (pts - x0[:, None, :]) / h[:, None, :]           # (F, Q, 3)
    V = pv.reshape(F, 2, 2, 2)                            # (F, z, y, x)
    w = [np.stack([1 - xi[..., d], xi[..., d]], axis=-1)  # (F, Q, 2)
         for d in range(3)]
    g = np.empty((F, Q, 3))
    # derivative along physical axis d = difference along numpy axis 3-d,
    # blended bilinearly over the other two axes
    for d in range(3):
        dV = (np.take(V, 1, axis=3 - d)
              - np.take(V, 0, axis=3 - d))                # (F, 2, 2)
        rem = [a for a in (2, 1, 0) if a != d]            # physical labels
        g[:, :, d] = np.einsum("fab,fqa,fqb->fq",
                               dV, w[rem[0]], w[rem[1]]) / h[:, None, d]
    return g


def kelly_estimate_3d(forest, mesh, p: np.ndarray) -> np.ndarray:
    """3D Kelly indicator: face-jump integrals of the normal derivative of
    the Q1 pressure over all interior quad faces, 2x2 Gauss per fine face
    square; eta_K^2 accumulates (h_F / 24) * integral per adjacent cell
    (h_F = face diameter), matching the 2D convention and deal.II's
    ``KellyErrorEstimator`` (PoroelasticityFSS.h:452-458).  Vectorized over
    face records like the 2D estimator."""
    records, leaves = forest.interior_faces()
    eta2 = np.zeros(len(leaves))
    if not records:
        return eta2
    R = 2 ** forest.max_level
    lower = forest.lower
    sz = forest.upper - forest.lower
    gp = np.array([0.5 - 0.5 / np.sqrt(3), 0.5 + 0.5 / np.sqrt(3)])
    cellv = p[mesh.cells]                        # (E, 8)

    rec = np.asarray(records, dtype=np.int64)    # (F, 7)
    a, b, axis, plane, lo1, lo2, span = rec.T
    tang = np.array([[1, 2], [0, 2], [0, 1]])[axis]       # (F, 2)
    t1, t2 = tang[:, 0], tang[:, 1]
    a1 = sz[t1] * span / R                       # physical side lengths
    a2 = sz[t2] * span / R
    area = a1 * a2
    diam = np.hypot(a1, a2)
    plane_phys = lower[axis] + sz[axis] * plane / R
    c1 = (lower[t1] + sz[t1] * lo1 / R)[:, None] \
        + np.repeat(gp, 2)[None, :] * a1[:, None]         # (F, 4)
    c2 = (lower[t2] + sz[t2] * lo2 / R)[:, None] \
        + np.tile(gp, 2)[None, :] * a2[:, None]
    pts = np.empty((len(rec), 4, 3))
    for k in range(3):
        pts[:, :, k] = np.where(
            (axis == k)[:, None], plane_phys[:, None],
            np.where((t1 == k)[:, None], c1, c2))

    lv = np.asarray(leaves, dtype=np.int64)      # (E, 4): l, ix, iy, iz
    s = (R >> lv[:, 0]).astype(np.float64)
    x0 = lower + sz * lv[:, 1:] * s[:, None] / R
    h = sz * s[:, None] / R

    ga = _grads_trilinear_batched(pts, x0[a], h[a], cellv[a])
    gb = _grads_trilinear_batched(pts, x0[b], h[b], cellv[b])
    jump = np.take_along_axis(ga - gb, axis[:, None, None], axis=-1)[..., 0]
    integral = area * np.mean(jump ** 2, axis=1)   # 4 equal Gauss weights
    contrib = (diam / 24.0) * integral
    np.add.at(eta2, a, contrib)
    np.add.at(eta2, b, contrib)
    return np.sqrt(eta2)


def fixed_fraction_marks(forest: QuadForest, eta: np.ndarray,
                         top_fraction: float = 0.6,
                         bottom_fraction: float = 0.4,
                         min_level: int = 0,
                         max_level: int = 30) -> Tuple[Set, Set]:
    """deal.II ``refine_and_coarsen_fixed_fraction`` semantics: refine the
    smallest cell set carrying ``top_fraction`` of the total error, coarsen
    the largest bottom set carrying at most ``bottom_fraction``; then apply
    the reference's level clamps (``PoroelasticityFSS.h:463-472``)."""
    leaves = forest.sorted_leaves()
    order = np.argsort(eta)[::-1]
    total = eta.sum()
    refine, coarsen = set(), set()
    if total > 0:
        csum = np.cumsum(eta[order])
        n_ref = int(np.searchsorted(csum, top_fraction * total) + 1)
        n_ref = min(n_ref, len(leaves))
        refine = {leaves[i] for i in order[:n_ref]}
        rev = order[::-1]
        csum_low = np.cumsum(eta[rev])
        n_coar = int(np.searchsorted(csum_low, bottom_fraction * total,
                                     side="right"))
        coarsen = {leaves[i] for i in rev[:n_coar]}
    # level clamps
    refine = {c for c in refine if c[0] < max_level}
    coarsen = {c for c in coarsen if c[0] > min_level}
    return refine, coarsen
