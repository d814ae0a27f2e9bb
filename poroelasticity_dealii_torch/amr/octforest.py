"""3D octree forest over a box domain.

The 3D counterpart of :mod:`.forest` (the reference's ``refine_mesh`` is
dim-templated, ``PoroelasticityFSS.h:448-498``): refine/coarsen with
1-irregularity, deal.II-colorize boundary ids (0/1 x-low/high, 2/3 y, 4/5
z), and extraction of a conforming-with-hanging-nodes
:class:`~..mesh.core.Mesh` of hexahedra.

A leaf is ``(level, ix, iy, iz)`` with ``0 <= i* < 2**level`` over the unit
cube, mapped affinely onto ``[lower, upper]``.  Integer corner coordinates
at a common resolution ``R = 2**max_level`` make all dedup exact.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Set, Tuple

import numpy as np

from ..mesh.core import Mesh

Leaf = Tuple[int, int, int, int]        # (level, ix, iy, iz)

_FACE_DIRS = ((1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0),
              (0, 0, 1), (0, 0, -1))


class FaceRec3(NamedTuple):
    """One fine face square between two leaves.

    ``axis``: the face-normal axis; ``plane``: integer coordinate along it;
    the square spans ``[lo1, lo1+span] x [lo2, lo2+span]`` along the two
    tangential axes (sorted ascending).  Coordinates at resolution R.
    """
    cell_a: int      # cell on the low side of the plane
    cell_b: int      # cell on the high side
    axis: int
    plane: int
    lo1: int
    lo2: int
    span: int


@dataclasses.dataclass
class OctForest:
    lower: np.ndarray
    upper: np.ndarray
    leaves: Set[Leaf]
    dim = 3

    # ------------------------------------------------------------------
    @classmethod
    def uniform(cls, lower, upper, level: int) -> "OctForest":
        n = 2 ** level
        leaves = {(level, ix, iy, iz)
                  for ix in range(n) for iy in range(n) for iz in range(n)}
        return cls(lower=np.asarray(lower, float),
                   upper=np.asarray(upper, float), leaves=leaves)

    @property
    def max_level(self) -> int:
        return max(leaf[0] for leaf in self.leaves)

    def sorted_leaves(self) -> List[Leaf]:
        """Deterministic spatial ordering by the integer coordinates of the
        cell's low corner (z-major, then y, then x)."""
        R = 2 ** self.max_level

        def key(leaf):
            l = leaf[0]
            s = R // (2 ** l)
            return (leaf[3] * s, leaf[2] * s, leaf[1] * s)

        return sorted(self.leaves, key=key)

    # ------------------------------------------------------------------
    def neighbors_coarser(self, leaf: Leaf) -> List[Leaf]:
        """Existing coarser leaves sharing a face with ``leaf``."""
        l = leaf[0]
        idx = leaf[1:]
        n = 2 ** l
        out = []
        for d in _FACE_DIRS:
            nb = tuple(idx[a] + d[a] for a in range(3))
            if not all(0 <= nb[a] < n for a in range(3)):
                continue
            for lc in range(l - 1, -1, -1):
                sh = l - lc
                cand = (lc,) + tuple(v >> sh for v in nb)
                if cand in self.leaves:
                    out.append(cand)
                    break
        return out

    def _enforce_one_irregular_refine(self, marked: Set[Leaf]) -> Set[Leaf]:
        marked = set(marked)
        changed = True
        while changed:
            changed = False
            for leaf in list(marked):
                for nb in self.neighbors_coarser(leaf):
                    if leaf[0] - nb[0] >= 1 and nb not in marked:
                        marked.add(nb)
                        changed = True
        return marked

    # ------------------------------------------------------------------
    def refine_and_coarsen(self, refine: Set[Leaf], coarsen: Set[Leaf]):
        """deal.II-like mark application: refinement wins; coarsening needs
        all 8 siblings marked and must not break 1-irregularity."""
        refine = self._enforce_one_irregular_refine(set(refine) & self.leaves)
        coarsen = set(coarsen) & self.leaves - refine

        new_leaves = set(self.leaves)
        for leaf in refine:
            l, ix, iy, iz = leaf
            new_leaves.discard(leaf)
            for dx in (0, 1):
                for dy in (0, 1):
                    for dz in (0, 1):
                        new_leaves.add((l + 1, 2 * ix + dx, 2 * iy + dy,
                                        2 * iz + dz))

        by_parent: Dict[Leaf, int] = {}
        for leaf in coarsen:
            l, ix, iy, iz = leaf
            if l == 0:
                continue
            p = (l - 1, ix // 2, iy // 2, iz // 2)
            by_parent[p] = by_parent.get(p, 0) + 1
        tmp = set(new_leaves)
        for parent, count in sorted(by_parent.items()):
            if count != 8:
                continue
            l, ix, iy, iz = parent
            children = [(l + 1, 2 * ix + dx, 2 * iy + dy, 2 * iz + dz)
                        for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)]
            if not all(c in tmp for c in children):
                continue
            # 1-irregularity: no face-neighbor leaf finer than l+1 may abut
            ok = True
            for c in children:
                cl = c[0]
                cidx = c[1:]
                nmax = 2 ** cl
                for d in _FACE_DIRS:
                    nb = tuple(cidx[a] + d[a] for a in range(3))
                    if not all(0 <= nb[a] < nmax for a in range(3)):
                        continue
                    if tuple(v // 2 for v in nb) == tuple(v // 2
                                                          for v in cidx):
                        continue          # sibling
                    if _has_descendant_leaf(tmp, (cl,) + nb):
                        ok = False
                        break
                if not ok:
                    break
            if ok:
                for c in children:
                    tmp.discard(c)
                tmp.add(parent)
        self.leaves = tmp

    # ------------------------------------------------------------------
    def to_mesh(self) -> Mesh:
        """Flat SoA hex mesh of the current leaves (with hanging vertices).

        Cell vertex order: the deal.II/framework lexicographic corner order
        (x fastest, then y, then z — matches ``hyper_rectangle``)."""
        R = 2 ** self.max_level
        leaves = self.sorted_leaves()
        vert_ids: Dict[Tuple[int, int, int], int] = {}
        verts: List[Tuple[int, int, int]] = []

        def vid(p):
            if p not in vert_ids:
                vert_ids[p] = len(verts)
                verts.append(p)
            return vert_ids[p]

        cells = np.zeros((len(leaves), 8), dtype=np.int32)
        for c, (l, ix, iy, iz) in enumerate(leaves):
            s = R // (2 ** l)
            x0, y0, z0 = ix * s, iy * s, iz * s
            k = 0
            for dz in (0, 1):
                for dy in (0, 1):
                    for dx in (0, 1):
                        cells[c, k] = vid((x0 + dx * s, y0 + dy * s,
                                           z0 + dz * s))
                        k += 1

        iv = np.array(verts, dtype=np.float64)
        coords = self.lower + (self.upper - self.lower) * iv / R

        face_cells, face_local, face_ids = [], [], []
        for c, (l, ix, iy, iz) in enumerate(leaves):
            n = 2 ** l
            for axis, i in ((0, ix), (1, iy), (2, iz)):
                if i == 0:
                    face_cells.append(c)
                    face_local.append(2 * axis)
                    face_ids.append(2 * axis)
                if i == n - 1:
                    face_cells.append(c)
                    face_local.append(2 * axis + 1)
                    face_ids.append(2 * axis + 1)

        return Mesh(dim=3, vertices=coords, cells=cells,
                    face_cells=np.asarray(face_cells, np.int32),
                    face_local=np.asarray(face_local, np.int32),
                    face_ids=np.asarray(face_ids, np.int32))

    # ------------------------------------------------------------------
    def interior_faces(self) -> Tuple[List[FaceRec3], List[Leaf]]:
        """All interior face pairings as fine face squares: a coarse-fine
        interface contributes FOUR records (one per fine quarter)."""
        R = 2 ** self.max_level
        leaves = self.sorted_leaves()
        # (axis, plane, lo1, lo2, span, side) -> cell index; side 0 = cell
        # on the low side of the plane (its high face), 1 = high side
        reg: Dict[Tuple[int, int, int, int, int, int], int] = {}
        for i, leaf in enumerate(leaves):
            l = leaf[0]
            s = R // (2 ** l)
            lo = tuple(v * s for v in leaf[1:])
            for axis in range(3):
                t1, t2 = [a for a in range(3) if a != axis]
                reg[(axis, lo[axis] + s, lo[t1], lo[t2], s, 0)] = i
                reg[(axis, lo[axis], lo[t1], lo[t2], s, 1)] = i

        records: List[FaceRec3] = []
        for (axis, plane, lo1, lo2, s, side), i in sorted(reg.items()):
            if side != 0:
                continue
            j = reg.get((axis, plane, lo1, lo2, s, 1))
            if j is not None:                     # conforming, same level
                records.append(FaceRec3(i, j, axis, plane, lo1, lo2, s))
                continue
            h = s // 2
            if h:                                  # i coarse, 4 fine squares
                quads = [(lo1 + a * h, lo2 + b * h)
                         for a in (0, 1) for b in (0, 1)]
                fine = [reg.get((axis, plane, q1, q2, h, 1))
                        for (q1, q2) in quads]
                if all(f is not None for f in fine):
                    for (q1, q2), f in zip(quads, fine):
                        records.append(FaceRec3(i, f, axis, plane, q1, q2, h))
                    continue
            s2 = s * 2                             # i fine, coarse high side
            j = reg.get((axis, plane, lo1 - (lo1 % s2), lo2 - (lo2 % s2),
                         s2, 1))
            if j is not None:
                records.append(FaceRec3(i, j, axis, plane, lo1, lo2, s))
        return records, leaves


def _has_descendant_leaf(leaves: Set[Leaf], cell: Leaf) -> bool:
    """True if any strictly finer leaf lies inside ``cell`` (1-irregular
    forests never need to look more than 2 levels down)."""
    l = cell[0]
    idx = cell[1:]
    for dl in (1, 2):
        f = 2 ** dl
        for dx in range(f):
            for dy in range(f):
                for dz in range(f):
                    if (l + dl, idx[0] * f + dx, idx[1] * f + dy,
                            idx[2] * f + dz) in leaves:
                        return True
    return False
