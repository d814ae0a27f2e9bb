"""The reference's remesh: the Kelly indicator, the fixed-fraction marks
and the solution transfer of deal.II's ``refine_mesh``
(``PoroelasticityFSS.h:448-498``), on octree meshes of a box, from the
mesh arrays and the constrained Q1 fields alone (:mod:`.hanging`).

* Kelly (``KellyErrorEstimator``, ``:452-458``): for every interior face
  F, ``(h_F / 24) int_F [dp/dn]^2`` with ``h_F`` the face's diameter,
  added to both cells beside it; a coarse cell's face that finer cells
  share is taken face by face on the finer side (deal.II's subfaces); a
  cell's indicator is the square root of its sum.  2 x 2 Gauss points a
  face.
* Marks (``refine_and_coarsen_fixed_fraction(0.6, 0.4)``, ``:460-472``):
  refine the fewest largest indicators that sum to 60% of the total,
  coarsen the most smallest ones that sum to at most 40%, then the level
  clamps (refine below the max level, coarsen above the initial one).  A
  refined cell refines its coarser face neighbours (one hanging level);
  a family of eight coarsens only when all eight are marked, none is
  refined, and no face neighbour of a child would be finer than it.
* Transfer (``SolutionTransfer``, ``:474-497``): each new node's value is
  the old constrained Q1 field where the node lies.
"""

from __future__ import annotations

import numpy as np

# indicators this close (relative) to a fraction's threshold are not
# counted: ties (cells of the same shape around the well) and rounding
# decide them, not the rule
TIE = 1e-9
GAUSS = (0.5 - 0.5 / np.sqrt(3.0), 0.5 + 0.5 / np.sqrt(3.0))


class Boxes:
    """The cells of an octree mesh as boxes ``lo``, ``h`` (E, 3), their
    levels, and a grid of the smallest cell's size that locates points."""

    def __init__(self, X: np.ndarray):
        lo, hi = X.min(1), X.max(1)
        corner = np.array([[(c >> a) & 1 for a in range(3)]
                           for c in range(8)], np.float64)
        if not np.allclose(X, lo[:, None] + corner * (hi - lo)[:, None],
                           atol=1e-9 * float(np.ptp(X))):
            raise ValueError("the reference's remesh takes axis-aligned "
                             "boxes only")
        self.lo, self.h = lo, hi - lo
        self.dlo, self.dhi = lo.min(0), hi.max(0)
        self.hmin = float(self.h[:, 0].min())
        size = (self.dhi - self.dlo) / self.hmin
        self.n = np.round(size).astype(np.int64)
        self.level = np.round(np.log2((self.dhi - self.dlo)[0]
                                      / self.h[:, 0])).astype(np.int64)
        self.grid = np.full(tuple(self.n[::-1]), -1, np.int64)   # (z, y, x)
        i0 = np.round((lo - self.dlo) / self.hmin).astype(np.int64)
        s = np.round(self.h[:, 0] / self.hmin).astype(np.int64)
        for size in np.unique(s):
            sel = np.nonzero(s == size)[0]
            r = np.arange(size)
            oz, oy, ox = (a.reshape(-1) for a in np.meshgrid(r, r, r,
                                                             indexing="ij"))
            b = i0[sel]
            self.grid[b[:, None, 2] + oz, b[:, None, 1] + oy,
                      b[:, None, 0] + ox] = sel[:, None]
        if np.any(self.grid < 0):
            raise ValueError("the cells do not tile the box")

    def locate(self, x) -> np.ndarray:
        """The cell holding each point (on a face: either side)."""
        i = np.floor((np.asarray(x) - self.dlo) / self.hmin).astype(np.int64)
        i = np.clip(i, 0, self.n - 1)
        return self.grid[i[..., 2], i[..., 1], i[..., 0]]

    def q1(self, values, cells, x, at) -> np.ndarray:
        """Q1 field(s) ``values (..., n)`` (``cells (E, 8)`` its nodes) at
        points ``x (P, 3)`` in cells ``at (P,)``: (..., P)."""
        xi = (x - self.lo[at]) / self.h[at]
        w = np.ones((len(at), 1))
        for d in range(3):
            wd = np.stack([1.0 - xi[:, d], xi[:, d]], 1)
            w = (wd[:, :, None] * w[:, None, :]).reshape(len(at), -1)
        return np.einsum("...pv,pv->...p", values[..., cells[at]], w)

    def gradient(self, values, cells, x, at) -> np.ndarray:
        """The gradient of a Q1 field at points ``x (P, 3)`` in cells
        ``at``: (P, 3)."""
        xi = (x - self.lo[at]) / self.h[at]
        v = values[cells[at]]                                 # (P, 8)
        g = np.zeros((len(at), 3))
        for c in range(8):
            bits = [(c >> a) & 1 for a in range(3)]
            f = [xi[:, a] if bits[a] else 1.0 - xi[:, a] for a in range(3)]
            df = [1.0 if bits[a] else -1.0 for a in range(3)]
            for d in range(3):
                o = [a for a in range(3) if a != d]
                g[:, d] += v[:, c] * df[d] * f[o[0]] * f[o[1]] / \
                    self.h[at, d]
        return g


def faces(B: Boxes):
    """Each interior face once, taken on its finer (or, between equals,
    lower-numbered) side: (cell a, neighbour b, normal axis, side)."""
    out = []
    for axis in range(3):
        for side in (0, 1):
            plane = B.lo[:, axis] + side * B.h[:, axis]
            inner = (np.abs(plane - B.dlo[axis]) > 0.25 * B.hmin) & \
                (np.abs(plane - B.dhi[axis]) > 0.25 * B.hmin)
            a = np.nonzero(inner)[0]
            probe = B.lo[a] + 0.25 * B.h[a]
            probe[:, axis] = plane[a] + (0.25 if side else -0.25) * B.hmin
            b = B.locate(probe)
            ha, hb = B.h[a, 0], B.h[b, 0]
            keep = (hb > 1.5 * ha) | ((np.abs(hb - ha) < 0.5 * ha) & (a < b))
            out.append(np.stack([a[keep], b[keep],
                                 np.full(keep.sum(), axis),
                                 np.full(keep.sum(), side)], 1))
    return np.concatenate(out)


def kelly(B: Boxes, cells, p) -> np.ndarray:
    """The Kelly indicator of each cell of the Q1 pressure ``p``."""
    F = faces(B)
    a, b, axis, side = F.T
    eta2 = np.zeros(len(B.lo))
    for ax in range(3):
        sel = axis == ax
        fa, fb, fs = a[sel], b[sel], side[sel]
        t1, t2 = [d for d in range(3) if d != ax]
        h1, h2 = B.h[fa, t1], B.h[fa, t2]
        jump2 = np.zeros(len(fa))
        for g1 in GAUSS:
            for g2 in GAUSS:
                x = B.lo[fa].copy()
                x[:, ax] += fs * B.h[fa, ax]
                x[:, t1] += g1 * h1
                x[:, t2] += g2 * h2
                d = B.gradient(p, cells, x, fa)[:, ax] \
                    - B.gradient(p, cells, x, fb)[:, ax]
                jump2 += 0.25 * d * d
        term = np.hypot(h1, h2) / 24.0 * (h1 * h2) * jump2
        np.add.at(eta2, fa, term)
        np.add.at(eta2, fb, term)
    return np.sqrt(eta2)


def _count(sorted_eta, share: float, top: bool) -> int:
    """Cells taken from the front of ``sorted_eta``: the fewest reaching
    ``share`` of the total (``top``) or the most staying within it."""
    csum = np.cumsum(sorted_eta)
    target = share * csum[-1]
    if top:
        return int(np.searchsorted(csum, target, "left")) + 1
    return int(np.searchsorted(csum, target, "right"))


def _band(eta, order, share, top):
    """Cells whose side of the threshold rounding could move: those
    within :data:`TIE` of the last cell taken, under the share moved by
    :data:`TIE` either way."""
    s = eta[order]
    last = [n - 1 for n in {_count(s, share * (1 + f), top)
                            for f in (-TIE, 0.0, TIE)} if 1 <= n <= len(s)]
    if not last:
        return np.zeros(len(eta), bool)
    lo, hi = s[last].min(), s[last].max()
    return (eta >= lo * (1 - TIE)) & (eta <= hi * (1 + TIE))


def expected_fate(B: Boxes, eta, min_level: int, max_level: int,
                  top=0.6, bottom=0.4):
    """Each old cell's fate under the marks (+1 refined, 0 kept, -1
    coarsened) and whether it is counted."""
    E = len(eta)
    desc = np.argsort(-eta, kind="stable")
    asc = desc[::-1]
    refine = np.zeros(E, bool)
    refine[desc[:_count(eta[desc], top, True)]] = True
    coarsen = np.zeros(E, bool)
    coarsen[asc[:_count(eta[asc], bottom, False)]] = True
    unsure = _band(eta, desc, top, True) | _band(eta, asc, bottom, False)
    refine &= B.level < max_level
    coarsen &= B.level > min_level
    F = faces(B)
    finer = B.h[F[:, 1], 0] > 1.5 * B.h[F[:, 0], 0]
    fine, coarse = F[finer, 0], F[finer, 1]
    while True:                                    # one hanging level
        grow = refine[fine] & ~refine[coarse]
        if not grow.any():
            break
        refine[coarse[grow]] = True
        unsure[coarse[grow]] |= unsure[fine[grow]]
    coarsen &= ~refine
    # families: the cells of one parent box
    i0 = np.round((B.lo - B.dlo) / B.h).astype(np.int64) // 2
    _, fid, fcount = np.unique(np.column_stack([B.level, i0]), axis=0,
                               return_inverse=True, return_counts=True)
    fid = fid.reshape(-1)
    nf = fid.max() + 1
    ok = np.ones(nf, bool)
    np.logical_and.at(ok, fid, coarsen)
    ok &= fcount == 8
    # a family whose coarsening the rounding could decide
    maybe = np.ones(nf, bool)
    np.logical_and.at(maybe, fid, coarsen | unsure)
    maybe &= fcount == 8
    doubt = np.zeros(nf, bool)
    np.logical_or.at(doubt, fid, unsure)
    # a face neighbour finer than the children, or refined beside them,
    # keeps a family; one that may itself coarsen first leaves it unsure
    sure = np.zeros(nf, bool)
    same = np.abs(B.h[F[:, 1], 0] - B.h[F[:, 0], 0]) < 0.5 * B.h[F[:, 0], 0]
    for c, n, finer_n in ((coarse, fine, True),
                          (F[same, 0], F[same, 1], False),
                          (F[same, 1], F[same, 0], False)):
        other = fid[c] != fid[n]
        block = other & (finer_n | refine[n])
        shaky = other & (unsure[n] | (finer_n & coarsen[n]))
        np.logical_and.at(ok, fid[c], ~block)
        np.logical_or.at(sure, fid[c], block & ~shaky)
        np.logical_or.at(doubt, fid[c], shaky)
    fam_unsure = maybe & ~sure & doubt
    fate = np.where(refine, 1, np.where(ok[fid], -1, 0))
    counted = ~(unsure | fam_unsure[fid])
    return fate, counted


def marks_mismatch(B_old: Boxes, cells_old, p, B_new: Boxes,
                   min_level: int, max_level: int) -> float:
    """The share of the counted old cells whose fate in the new mesh is
    not what the marks of ``p`` give."""
    eta = kelly(B_old, cells_old, p)
    fate, counted = expected_fate(B_old, eta, min_level, max_level)
    at = B_new.locate(B_old.lo + 0.5 * B_old.h)
    ratio = B_new.h[at, 0] / B_old.h[:, 0]
    got = np.where(ratio < 0.75, 1, np.where(ratio > 1.5, -1, 0))
    if not counted.any():
        return 0.0
    return float(np.mean(got[counted] != fate[counted]))


def transfer_gap(B_old: Boxes, cells_old, old: np.ndarray, x_new,
                 new: np.ndarray) -> float:
    """The largest distance of the transferred fields ``new (k, P)`` at
    ``x_new (P, 3)`` from the old fields ``old (k, n)`` there, over the
    largest old value of each field."""
    at = B_old.locate(x_new)
    want = B_old.q1(old, cells_old, x_new, at)
    scale = np.abs(old).max(-1)
    return float(np.max(np.abs(new - want).max(-1)
                        / np.where(scale > 0, scale, 1.0)))
