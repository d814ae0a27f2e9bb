"""2D quadtree forest over a rectangular domain.

Host-side (numpy) replacement for deal.II's ``Triangulation`` refinement
machinery used by the reference (``PoroelasticityFSS.h:448-498``):
refine/coarsen with 1-irregularity (neighbor levels differ by at most one),
deal.II-colorize boundary ids, and extraction of a conforming-with-hanging-
nodes :class:`~..mesh.core.Mesh`.

A leaf is ``(level, ix, iy)`` with ``0 <= ix, iy < 2**level`` over the unit
square, mapped affinely onto ``[lower, upper]``.  Integer corner coordinates
at a common resolution ``R = 2**max_level`` make all dedup exact.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Set, Tuple

import numpy as np

from ..mesh.core import Mesh

Leaf = Tuple[int, int, int]


class FaceRec(Tuple):
    """(cell_a, cell_b, axis, line, lo, span) — one fine face segment."""
    __slots__ = ()

    def __new__(cls, a, b, axis, line, lo, span):
        return tuple.__new__(cls, (a, b, axis, line, lo, span))

    cell_a = property(lambda s: s[0])
    cell_b = property(lambda s: s[1])
    axis = property(lambda s: s[2])
    line = property(lambda s: s[3])
    lo = property(lambda s: s[4])
    span = property(lambda s: s[5])


@dataclasses.dataclass
class QuadForest:
    lower: np.ndarray
    upper: np.ndarray
    leaves: Set[Leaf]

    # ------------------------------------------------------------------
    @classmethod
    def uniform(cls, lower, upper, level: int) -> "QuadForest":
        n = 2 ** level
        leaves = {(level, ix, iy) for ix in range(n) for iy in range(n)}
        return cls(lower=np.asarray(lower, float),
                   upper=np.asarray(upper, float), leaves=leaves)

    @property
    def max_level(self) -> int:
        return max(l for l, _, _ in self.leaves)

    def sorted_leaves(self) -> List[Leaf]:
        """Deterministic cell ordering: by (level, iy, ix)? No — spatial
        lexicographic (y-major then x) at mixed levels, keyed by the integer
        coordinates of the cell's lower-left corner, finest-first on ties
        (ties cannot happen between leaves)."""
        R = 2 ** self.max_level
        def key(leaf):
            l, ix, iy = leaf
            s = R // (2 ** l)
            return (iy * s, ix * s)
        return sorted(self.leaves, key=key)

    # ------------------------------------------------------------------
    def neighbors_coarser(self, leaf: Leaf) -> List[Leaf]:
        """Existing leaves that are edge-neighbors of ``leaf`` at a coarser
        level."""
        l, ix, iy = leaf
        out = []
        for dx, dy in ((1, 0), (-1, 0), (0, 1), (0, -1)):
            nx, ny = ix + dx, iy + dy
            if not (0 <= nx < 2 ** l and 0 <= ny < 2 ** l):
                continue
            for lc in range(l - 1, -1, -1):
                cand = (lc, nx >> (l - lc), ny >> (l - lc))
                if cand in self.leaves:
                    out.append(cand)
                    break
        return out

    def _enforce_one_irregular_refine(self, marked: Set[Leaf]) -> Set[Leaf]:
        """Refining ``marked`` may require refining coarser neighbors too."""
        marked = set(marked)
        changed = True
        while changed:
            changed = False
            for leaf in list(marked):
                l = leaf[0]
                for nb in self.neighbors_coarser(leaf):
                    if l - nb[0] >= 1 and nb not in marked:
                        # after refining `leaf` its children are at l+1;
                        # neighbor at l-1 would differ by 2
                        marked.add(nb)
                        changed = True
        return marked

    # ------------------------------------------------------------------
    def refine_and_coarsen(self, refine: Set[Leaf], coarsen: Set[Leaf]):
        """Apply marks (deal.II-like semantics): refinement wins over
        coarsening; coarsening requires all four siblings marked and must
        not break 1-irregularity."""
        refine = self._enforce_one_irregular_refine(set(refine) & self.leaves)
        coarsen = set(coarsen) & self.leaves - refine

        new_leaves = set(self.leaves)
        for leaf in refine:
            l, ix, iy = leaf
            new_leaves.discard(leaf)
            for dx in (0, 1):
                for dy in (0, 1):
                    new_leaves.add((l + 1, 2 * ix + dx, 2 * iy + dy))

        # group coarsen candidates by parent; require all 4 siblings
        by_parent: Dict[Leaf, int] = {}
        for leaf in coarsen:
            l, ix, iy = leaf
            if l == 0:
                continue
            by_parent[(l - 1, ix // 2, iy // 2)] = \
                by_parent.get((l - 1, ix // 2, iy // 2), 0) + 1
        tmp = QuadForest(self.lower, self.upper, new_leaves)
        for parent, count in sorted(by_parent.items()):
            if count != 4:
                continue
            l, ix, iy = parent
            children = [(l + 1, 2 * ix + dx, 2 * iy + dy)
                        for dx in (0, 1) for dy in (0, 1)]
            if not all(c in tmp.leaves for c in children):
                continue
            # 1-irregularity: the parent's neighbors may not have leaves
            # finer than level l+1
            ok = True
            R = None
            for c in children:
                cl, cx, cy = c
                for dx, dy in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                    nx, ny = cx + dx, cy + dy
                    if not (0 <= nx < 2 ** cl and 0 <= ny < 2 ** cl):
                        continue
                    if (cx // 2, cy // 2) == (nx // 2, ny // 2):
                        continue  # sibling
                    # any leaf strictly finer than cl adjacent?
                    if _has_descendant_leaf(tmp.leaves, (cl, nx, ny)):
                        ok = False
                        break
                if not ok:
                    break
            if ok:
                for c in children:
                    tmp.leaves.discard(c)
                tmp.leaves.add(parent)
        self.leaves = tmp.leaves

    # ------------------------------------------------------------------
    def to_mesh(self) -> Mesh:
        """Flat SoA mesh of the current leaves (with hanging vertices)."""
        L = self.max_level
        R = 2 ** L
        leaves = self.sorted_leaves()
        vert_ids: Dict[Tuple[int, int], int] = {}
        verts: List[Tuple[int, int]] = []

        def vid(p):
            if p not in vert_ids:
                vert_ids[p] = len(verts)
                verts.append(p)
            return vert_ids[p]

        cells = np.zeros((len(leaves), 4), dtype=np.int32)
        for c, (l, ix, iy) in enumerate(leaves):
            s = R // (2 ** l)
            x0, y0 = ix * s, iy * s
            cells[c] = [vid((x0, y0)), vid((x0 + s, y0)),
                        vid((x0, y0 + s)), vid((x0 + s, y0 + s))]

        iv = np.array(verts, dtype=np.float64)
        coords = self.lower + (self.upper - self.lower) * iv / R

        face_cells, face_local, face_ids = [], [], []
        for c, (l, ix, iy) in enumerate(leaves):
            n = 2 ** l
            if ix == 0:
                face_cells.append(c); face_local.append(0); face_ids.append(0)
            if ix == n - 1:
                face_cells.append(c); face_local.append(1); face_ids.append(1)
            if iy == 0:
                face_cells.append(c); face_local.append(2); face_ids.append(2)
            if iy == n - 1:
                face_cells.append(c); face_local.append(3); face_ids.append(3)

        return Mesh(dim=2, vertices=coords, cells=cells,
                    face_cells=np.asarray(face_cells, np.int32),
                    face_local=np.asarray(face_local, np.int32),
                    face_ids=np.asarray(face_ids, np.int32))

    # ------------------------------------------------------------------
    def interior_faces(self):
        """All interior face pairings as ``FaceRec`` records.

        Each record covers one *fine-resolution* face segment: for a
        coarse-fine interface the coarse edge contributes two records, one
        per fine half.  ``cell_a``/``cell_b`` index :meth:`sorted_leaves`;
        integer geometry (``line`` = face coordinate along ``axis``,
        segment = ``[lo, lo+span]`` along the other axis) is at resolution
        ``R = 2**max_level``.  Returns ``(records, leaves)``.
        """
        L = self.max_level
        R = 2 ** L
        leaves = self.sorted_leaves()
        # edge registry: (axis, line, lo, span, side_of_cell) -> cell index
        reg: Dict[Tuple[int, int, int, int, int], int] = {}
        for i, (l, ix, iy) in enumerate(leaves):
            s = R // (2 ** l)
            x0, y0 = ix * s, iy * s
            for axis, line, lo, side in (
                    (0, x0 + s, y0, 0),   # right edge: cell on low side
                    (0, x0, y0, 1),       # left edge: cell on high side
                    (1, y0 + s, x0, 0),   # top edge
                    (1, y0, x0, 1)):      # bottom edge
                reg[(axis, line, lo, s, side)] = i

        records = []
        for (axis, line, lo, s, side), i in sorted(reg.items()):
            if side != 0:
                continue
            j = reg.get((axis, line, lo, s, 1))
            if j is not None:             # conforming, same level
                records.append(FaceRec(i, j, axis, line, lo, s))
                continue
            h = s // 2
            if h:                          # i coarse, fine pair on high side
                j0 = reg.get((axis, line, lo, h, 1))
                j1 = reg.get((axis, line, lo + h, h, 1))
                if j0 is not None and j1 is not None:
                    records.append(FaceRec(i, j0, axis, line, lo, h))
                    records.append(FaceRec(i, j1, axis, line, lo + h, h))
                    continue
            s2, lo2 = s * 2, lo - (lo % (s * 2))  # i fine, coarse on high
            j = reg.get((axis, line, lo2, s2, 1))
            if j is not None:
                records.append(FaceRec(i, j, axis, line, lo, s))
        return records, leaves


def _has_descendant_leaf(leaves: Set[Leaf], cell: Leaf) -> bool:
    """True if any leaf strictly finer than ``cell`` lies inside it."""
    l, ix, iy = cell
    for dl in (1, 2):          # 1-irregular forests never need more
        f = 2 ** dl
        for dx in range(f):
            for dy in range(f):
                if (l + dl, ix * f + dx, iy * f + dy) in leaves:
                    return True
    return False
