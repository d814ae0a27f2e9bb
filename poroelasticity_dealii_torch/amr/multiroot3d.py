"""Forest-of-roots AMR over an arbitrary coarse hex mesh (3D).

The 3D member of the forest family: the reference's ``refine_mesh`` is
dim-templated over any ``Triangulation`` — including one read from gmsh
(``PoroelasticityFSS.h:439-445`` feeding
``refine_mesh`` at ``:448-498``) — so 3D AMR over an imported ``.msh`` is
in-scope parity.  This module generalizes :class:`.octforest.OctForest`
(one axis-aligned box root) exactly the way :mod:`.multiroot` generalizes
:class:`.forest.QuadForest` in 2D: each coarse hex is a root carrying a
TRILINEAR map from the unit cube onto its (possibly distorted) physical
cell, and all refinement bookkeeping runs in exact per-root integer
coordinates.

A leaf is ``(level, ix, iy, iz, root)`` — level first so the shared
``fixed_fraction_marks`` level clamps (``kelly.py``) apply unchanged.

Key geometric facts this module relies on:

* a trilinear map restricted to an axis-aligned sub-box of the unit cube
  is again trilinear in the sub-box's local coordinates, so every fine
  cell is exactly the trilinear hex of its corner images — the extracted
  :class:`~..mesh.core.Mesh` is self-contained and the existing
  isoparametric discretization applies as-is;
* restricted to an axis-aligned PLANE the map is bilinear in the two
  in-plane parameters, and restricted to an axis-aligned LINE it is
  affine — so shared-face points computed from either incident root
  coincide, root faces are bilinear patches with a consistent two-sided
  parameterization, and hanging-node interpolation weights written in the
  face/edge PARAMETER (tensor-product Lagrange traces) are exact on
  distorted parents too.

Cross-root face orientation: unlike 2D (one flip bit), two roots may see
a shared quad face under any of the 8 dihedral transforms.  Every
``(root, local face)`` incidence stores an integer affine map onto the
face's CANONICAL frame (anchored at its smallest corner vertex id, the
same convention ``mesh/qk.py`` uses for 3D face-interior node dedup), and
all cross-root traffic composes through that frame.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from ..mesh.core import Mesh

# leaf = (level, ix, iy, iz, root)
MR3Leaf = Tuple[int, int, int, int, int]

# local face id = 2*axis + side (deal.II colorize order), corners of the
# face in FACE-LEX order (s = lower tangent axis, t = higher; corner bit
# order (s, t)); hex corners are lex (x fastest): id = ix + 2 iy + 4 iz
_FACE_AXES = [(1, 2), (1, 2), (0, 2), (0, 2), (0, 1), (0, 1)]


def _face_corners(face: int) -> Tuple[int, int, int, int]:
    axis, side = face // 2, face % 2
    t1, t2 = _FACE_AXES[face]
    out = []
    for bt in (0, 1):
        for bs in (0, 1):
            bits = [0, 0, 0]
            bits[axis] = side
            bits[t1] = bs
            bits[t2] = bt
            out.append(bits[0] + 2 * bits[1] + 4 * bits[2])
    return tuple(out)                       # (s0t0, s1t0, s0t1, s1t1)


_FACE_CORNERS = [_face_corners(f) for f in range(6)]

# the 12 hex edges as (corner, corner) pairs (lex ids)
_HEX_EDGES = [(a, b) for a in range(8) for b in range(a + 1, 8)
              if bin(a ^ b).count("1") == 1]


class _F2:
    """Integer affine transform of a face frame at node resolution ``n``:
    ``p' = M p + o * n`` with ``M`` a signed permutation (dihedral D4).
    Exact on integer coordinates for any n."""

    __slots__ = ("M", "o")

    def __init__(self, M, o):
        self.M = np.asarray(M, np.int64)    # (2, 2), entries in {-1, 0, 1}
        self.o = np.asarray(o, np.int64)    # (2,), entries in {0, 1}

    def __call__(self, p, n):
        return tuple(self.M @ np.asarray(p, np.int64) + self.o * n)

    def compose(self, other):               # self o other
        return _F2(self.M @ other.M, self.M @ other.o + self.o)

    def inv(self):
        Mi = np.linalg.inv(self.M).astype(np.int64)
        return _F2(Mi, -Mi @ self.o)

    def cell(self, q, n):
        """Transform a CELL index pair (boxes [q, q+1]): map both corners,
        take the elementwise min."""
        a = self(q, n)
        b = self((q[0] + 1, q[1] + 1), n)
        return (min(a[0], b[0]), min(a[1], b[1]))


def _frame_transform(corners_from, corners_to) -> _F2:
    """The integer transform between two face-lex corner orderings
    ``[c00, c10, c01, c11]`` of the SAME four vertices (p in from-frame
    node coords [0, n]^2 -> to-frame)."""
    pos = {v: np.array(p, np.int64) for v, p in
           zip(corners_to, ((0, 0), (1, 0), (0, 1), (1, 1)))}
    P00, P10, P01 = (pos[corners_from[0]], pos[corners_from[1]],
                     pos[corners_from[2]])
    M = np.stack([P10 - P00, P01 - P00], axis=1)
    return _F2(M, P00)


@dataclasses.dataclass
class MultiRootOctForest:
    """3D octree forest whose roots are the cells of a coarse hex mesh."""

    root_cells: np.ndarray       # (C, 8) int coarse corner vertex ids (lex)
    root_coords: np.ndarray      # (V, 3) float coarse vertex coordinates
    # (root, face) -> boundary id for coarse boundary faces
    boundary_ids: Dict[Tuple[int, int], int]
    leaves: Set[MR3Leaf]
    dim = 3

    def __post_init__(self):
        self.root_cells = np.asarray(self.root_cells, np.int64)
        self.root_coords = np.asarray(self.root_coords, float)
        # face registry: sorted 4-vid key -> [(root, face, to_canonical)]
        reg: Dict[tuple, List[Tuple[int, int, _F2]]] = {}
        self._canon: Dict[tuple, tuple] = {}   # key -> canonical corner ids
        for r in range(self.n_roots):
            for f in range(6):
                quad = tuple(int(self.root_cells[r, c])
                             for c in _FACE_CORNERS[f])
                key = tuple(sorted(quad))
                canon = self._canon.get(key)
                if canon is None:
                    canon = _canonical_quad(quad)
                    self._canon[key] = canon
                reg.setdefault(key, []).append(
                    (r, f, _frame_transform(quad, canon)))
        for key, inc in reg.items():
            if len(inc) > 2:
                raise ValueError(f"non-manifold coarse face {key}")
        self._faces = reg
        # (root, face) -> (nbr root, nbr face, A-frame -> B-frame) | None
        self._nbr: Dict[Tuple[int, int],
                        Optional[Tuple[int, int, _F2]]] = {}
        for inc in reg.values():
            if len(inc) == 1:
                self._nbr[inc[0][:2]] = None
            else:
                (ra, fa, Ta), (rb, fb, Tb) = inc
                self._nbr[(ra, fa)] = (rb, fb, Tb.inv().compose(Ta))
                self._nbr[(rb, fb)] = (ra, fa, Ta.inv().compose(Tb))
        # edge registry for vertex dedup: canonical (vmin, vmax)
        self._edges: Set[Tuple[int, int]] = set()
        for r in range(self.n_roots):
            for (a, b) in _HEX_EDGES:
                va = int(self.root_cells[r, a])
                vb = int(self.root_cells[r, b])
                self._edges.add((min(va, vb), max(va, vb)))
        self._vid: Dict[tuple, int] = {}

    # ------------------------------------------------------------------
    @classmethod
    def from_mesh(cls, coarse: Mesh, level: int = 0) -> "MultiRootOctForest":
        """Root the forest on ``coarse``'s hexes, each uniformly refined
        ``level`` times (the ``initial refinement level`` semantics of the
        reference's ``create_mesh``, applied to an imported mesh)."""
        if coarse.dim != 3:
            raise ValueError("MultiRootOctForest needs a 3D (hex) mesh")
        bids = {(int(c), int(s)): int(i)
                for c, s, i in zip(coarse.face_cells, coarse.face_local,
                                   coarse.face_ids)}
        n = 2 ** level
        leaves = {(level, ix, iy, iz, r)
                  for r in range(coarse.n_cells)
                  for ix in range(n) for iy in range(n) for iz in range(n)}
        return cls(root_cells=coarse.cells, root_coords=coarse.vertices,
                   boundary_ids=bids, leaves=leaves)

    def copy(self) -> "MultiRootOctForest":
        return MultiRootOctForest(self.root_cells, self.root_coords,
                                  dict(self.boundary_ids), set(self.leaves))

    @property
    def n_roots(self) -> int:
        return self.root_cells.shape[0]

    @property
    def max_level(self) -> int:
        return max(leaf[0] for leaf in self.leaves)

    def sorted_leaves(self) -> List[MR3Leaf]:
        """Deterministic cell order: by root, then spatially within the
        root (z-major, y, x fastest) at the common resolution."""
        R = 2 ** self.max_level

        def key(leaf):
            l, ix, iy, iz, r = leaf
            s = R >> l
            return (r, iz * s, iy * s, ix * s)
        return sorted(self.leaves, key=key)

    # ------------------------------------------------------------------
    # integer-geometry traversal (root frame, resolution n = 2**level)
    # ------------------------------------------------------------------
    def _cross(self, l: int, idx, r: int, face: int):
        """Map the OUT-OF-ROOT virtual cell position ``idx`` that lies just
        across local ``face`` of root ``r`` into the neighboring root's
        frame; None at a domain boundary."""
        nbr = self._nbr.get((r, face))
        if nbr is None:
            return None
        rn, fn, T = nbr
        n = 1 << l
        axis = face // 2
        t1, t2 = _FACE_AXES[face]
        q1, q2 = T.cell((idx[t1], idx[t2]), n)
        an, sn = fn // 2, fn % 2
        nt1, nt2 = _FACE_AXES[fn]
        out = [0, 0, 0]
        out[an] = 0 if sn == 0 else n - 1
        out[nt1] = q1
        out[nt2] = q2
        return (l, out[0], out[1], out[2], rn)

    def _face_neighbor_cell(self, l, ix, iy, iz, r, d):
        """The same-level cell position across one face (may live in a
        neighboring root); None outside the domain."""
        n = 1 << l
        nb = (ix + d[0], iy + d[1], iz + d[2])
        if all(0 <= nb[a] < n for a in range(3)):
            return (l, nb[0], nb[1], nb[2], r)
        axis = next(a for a in range(3) if d[a] != 0)
        face = 2 * axis + (0 if d[axis] < 0 else 1)
        return self._cross(l, nb, r, face)

    _FACE_DIRS = ((1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0),
                  (0, 0, 1), (0, 0, -1))

    def neighbors_coarser(self, leaf: MR3Leaf) -> List[MR3Leaf]:
        """Existing leaves face-adjacent to ``leaf`` at a coarser level
        (including across root boundaries)."""
        l, ix, iy, iz, r = leaf
        out = []
        for d in self._FACE_DIRS:
            pos = self._face_neighbor_cell(l, ix, iy, iz, r, d)
            if pos is None:
                continue
            pl, px, py, pz, pr = pos
            for lc in range(pl - 1, -1, -1):
                sh = pl - lc
                cand = (lc, px >> sh, py >> sh, pz >> sh, pr)
                if cand in self.leaves:
                    out.append(cand)
                    break
        return out

    def _has_descendant_leaf(self, cell: MR3Leaf) -> bool:
        l, ix, iy, iz, r = cell
        for dl in (1, 2):           # 1-irregular forests never need more
            f = 1 << dl
            for dx in range(f):
                for dy in range(f):
                    for dz in range(f):
                        if (l + dl, ix * f + dx, iy * f + dy,
                                iz * f + dz, r) in self.leaves:
                            return True
        return False

    def _enforce_one_irregular_refine(self, marked: Set[MR3Leaf]):
        marked = set(marked)
        changed = True
        while changed:
            changed = False
            for leaf in list(marked):
                l = leaf[0]
                for nb in self.neighbors_coarser(leaf):
                    if l - nb[0] >= 1 and nb not in marked:
                        marked.add(nb)
                        changed = True
        return marked

    # ------------------------------------------------------------------
    def refine_and_coarsen(self, refine: Set[MR3Leaf],
                           coarsen: Set[MR3Leaf]):
        """deal.II-like mark application (mirrors ``OctForest``):
        refinement wins; coarsening needs all eight siblings and must not
        break 1-irregularity (checked across root boundaries too)."""
        refine = self._enforce_one_irregular_refine(
            set(refine) & self.leaves)
        coarsen = set(coarsen) & self.leaves - refine

        new_leaves = set(self.leaves)
        for (l, ix, iy, iz, r) in refine:
            new_leaves.discard((l, ix, iy, iz, r))
            for dx in (0, 1):
                for dy in (0, 1):
                    for dz in (0, 1):
                        new_leaves.add((l + 1, 2 * ix + dx, 2 * iy + dy,
                                        2 * iz + dz, r))

        by_parent: Dict[MR3Leaf, int] = {}
        for (l, ix, iy, iz, r) in coarsen:
            if l == 0:
                continue
            p = (l - 1, ix // 2, iy // 2, iz // 2, r)
            by_parent[p] = by_parent.get(p, 0) + 1
        tmp = self.copy()
        tmp.leaves = new_leaves
        for parent, count in sorted(by_parent.items()):
            if count != 8:
                continue
            l, ix, iy, iz, r = parent
            children = [(l + 1, 2 * ix + dx, 2 * iy + dy, 2 * iz + dz, r)
                        for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)]
            if not all(c in tmp.leaves for c in children):
                continue
            ok = True
            for (cl, cx, cy, cz, cr) in children:
                for d in self._FACE_DIRS:
                    pos = tmp._face_neighbor_cell(cl, cx, cy, cz, cr, d)
                    if pos is None:
                        continue
                    if pos[4] == cr and (pos[1] // 2, pos[2] // 2,
                                         pos[3] // 2) == (cx // 2, cy // 2,
                                                          cz // 2):
                        continue            # sibling
                    if tmp._has_descendant_leaf(pos):
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
    # point classification + mesh extraction
    # ------------------------------------------------------------------
    def _classify(self, r: int, x: int, y: int, z: int, R: int) -> tuple:
        """Exact cross-root dedup key of the integer point (x, y, z) in
        root ``r``'s frame at resolution ``R``: coarse-vertex key at
        corners, canonical (vmin, vmax, param) key on root edges,
        canonical face-frame key on root faces, per-root key inside."""
        p = (x, y, z)
        on = [(0 if p[a] == 0 else (1 if p[a] == R else None))
              for a in range(3)]
        nb = sum(o is not None for o in on)
        if nb == 3:
            corner = sum((on[a] << a) for a in range(3))
            return ("v", int(self.root_cells[r, corner]))
        if nb == 2:
            axis = next(a for a in range(3) if on[a] is None)
            bits = [on[a] or 0 for a in range(3)]
            bits[axis] = 0
            c0 = bits[0] + 2 * bits[1] + 4 * bits[2]
            bits[axis] = 1
            c1 = bits[0] + 2 * bits[1] + 4 * bits[2]
            va = int(self.root_cells[r, c0])
            vb = int(self.root_cells[r, c1])
            t = p[axis]
            if va < vb:
                return ("e", va, vb, t)
            return ("e", vb, va, R - t)
        if nb == 1:
            axis = next(a for a in range(3) if on[a] is not None)
            face = 2 * axis + on[axis]
            quad = tuple(int(self.root_cells[r, c])
                         for c in _FACE_CORNERS[face])
            key = tuple(sorted(quad))
            T = _frame_transform(quad, self._canon[key])
            t1, t2 = _FACE_AXES[face]
            q1, q2 = T((p[t1], p[t2]), R)
            return ("f", key, q1, q2)
        return ("i", r, x, y, z)

    def _trilinear(self, r: int, xi: np.ndarray) -> np.ndarray:
        """Physical position(s) of reference point(s) ``xi`` (.., 3) in
        root ``r``."""
        c = self.root_coords[self.root_cells[r]]          # (8, 3) lex
        u, v, w = xi[..., :1], xi[..., 1:2], xi[..., 2:]
        wu = np.concatenate([1 - u, u], axis=-1)[..., :, None, None]
        wv = np.concatenate([1 - v, v], axis=-1)[..., None, :, None]
        ww = np.concatenate([1 - w, w], axis=-1)[..., None, None, :]
        W = (wu * wv * ww).reshape(xi.shape[:-1] + (8,))
        # weight index = ix*4 + iy*2 + iz from the reshape above; corner
        # lex id = ix + 2 iy + 4 iz -> permute
        perm = [ix + 2 * iy + 4 * iz
                for ix in range(2) for iy in range(2) for iz in range(2)]
        return np.einsum("...a,ad->...d", W, c[perm])

    def to_mesh(self) -> Mesh:
        R = 2 ** self.max_level
        leaves = self.sorted_leaves()
        vid: Dict[tuple, int] = {}
        coords: List[np.ndarray] = []

        def get_vid(r, x, y, z):
            key = self._classify(r, x, y, z, R)
            i = vid.get(key)
            if i is None:
                i = len(coords)
                vid[key] = i
                coords.append(self._trilinear(
                    r, np.array([x / R, y / R, z / R])))
            return i

        cells = np.zeros((len(leaves), 8), np.int32)
        face_cells, face_local, face_ids = [], [], []
        for c, (l, ix, iy, iz, r) in enumerate(leaves):
            s = R >> l
            x0, y0, z0 = ix * s, iy * s, iz * s
            k = 0
            for dz in (0, 1):
                for dy in (0, 1):
                    for dx in (0, 1):
                        cells[c, k] = get_vid(r, x0 + dx * s, y0 + dy * s,
                                              z0 + dz * s)
                        k += 1
            n = 1 << l
            for face, at_bdry in ((0, ix == 0), (1, ix == n - 1),
                                  (2, iy == 0), (3, iy == n - 1),
                                  (4, iz == 0), (5, iz == n - 1)):
                if at_bdry and self._nbr.get((r, face)) is None:
                    face_cells.append(c)
                    face_local.append(face)
                    face_ids.append(self.boundary_ids.get((r, face), 0))
        self._vid = vid
        return Mesh(dim=3, vertices=np.asarray(coords, float),
                    cells=cells,
                    face_cells=np.asarray(face_cells, np.int32),
                    face_local=np.asarray(face_local, np.int32),
                    face_ids=np.asarray(face_ids, np.int32))

    # ------------------------------------------------------------------
    # interior faces (conforming + coarse-fine), in SURFACE coordinates
    # ------------------------------------------------------------------
    def _leaf_face_records(self):
        """Per leaf face: (surface, lo1, lo2, span, side_flag, cell_index).

        ``surface`` identifies the plane the face lies on:
        ``('i', root, axis, plane)`` for intra-root planes (lo1/lo2 along
        the tangent axes ascending) or ``('f', sorted-4-vid key)`` for
        coarse-mesh faces (lo1/lo2 in the canonical face frame).
        ``side_flag`` is 0/1 and differs for the two cells incident to a
        surface."""
        R = 2 ** self.max_level
        leaves = self.sorted_leaves()
        recs = []
        for i, (l, ix, iy, iz, r) in enumerate(leaves):
            s = R >> l
            lo3 = (ix * s, iy * s, iz * s)
            n = 1 << l
            idx = (ix, iy, iz)
            for face in range(6):
                axis, side = face // 2, face % 2
                t1, t2 = _FACE_AXES[face]
                plane = lo3[axis] + side * s
                at_root_face = idx[axis] == (n - 1 if side else 0)
                if at_root_face:
                    nbr = self._nbr.get((r, face))
                    if nbr is None:
                        continue                      # domain boundary
                    quad = tuple(int(self.root_cells[r, c])
                                 for c in _FACE_CORNERS[face])
                    key = tuple(sorted(quad))
                    T = _frame_transform(quad, self._canon[key])
                    # canonical low corner of the face square [lo, lo+s]^2
                    a = T((lo3[t1], lo3[t2]), R)
                    b = T((lo3[t1] + s, lo3[t2] + s), R)
                    q1, q2 = min(a[0], b[0]), min(a[1], b[1])
                    inc = self._faces[key]
                    flag = [t[:2] for t in inc].index((r, face))
                    recs.append((("f", key), q1, q2, s, flag, i))
                else:
                    surface = ("i", r, axis, plane)
                    flag = side                      # 0: face below cell
                    recs.append((surface, lo3[t1], lo3[t2], s, 1 - flag, i))
        return recs

    def interior_face_records(self):
        """Fine face squares as (cell_a, cell_b, surface, lo1, lo2, span)
        with cell_a the coarse cell at coarse-fine interfaces.  One record
        per conforming face, four per hanging coarse face (one per fine
        quarter)."""
        by_surface: Dict[tuple, List[tuple]] = {}
        for surface, lo1, lo2, s, flag, i in self._leaf_face_records():
            by_surface.setdefault(surface, []).append((lo1, lo2, s, flag, i))
        out = []
        for surface, segs in sorted(by_surface.items()):
            sides = ({}, {})
            for lo1, lo2, s, flag, i in segs:
                sides[flag][(lo1, lo2, s)] = i
            for flag in (0, 1):
                other = 1 - flag
                for (lo1, lo2, s), i in sorted(sides[flag].items()):
                    j = sides[other].get((lo1, lo2, s))
                    if j is not None:
                        if flag == 0:       # emit each conforming pair once
                            out.append((i, j, surface, lo1, lo2, s))
                        continue
                    h = s // 2
                    if not h:
                        continue
                    quads = [(lo1 + a * h, lo2 + b * h)
                             for b in (0, 1) for a in (0, 1)]
                    fine = [sides[other].get((p, q, h)) for (p, q) in quads]
                    if all(f is not None for f in fine):
                        # i coarse, 4 fine quarters on the other side
                        for (p, q), f in zip(quads, fine):
                            out.append((i, f, surface, p, q, h))
        return out, self.sorted_leaves()

    def _surface_point(self, leaf: MR3Leaf, surface, q1: int, q2: int,
                       R: int):
        """Integer root-frame coordinates (x, y, z) of surface parameter
        (q1, q2) as seen from ``leaf``'s root."""
        l, ix, iy, iz, r = leaf
        if surface[0] == "i":
            _, sr, axis, plane = surface
            assert sr == r
            t1, t2 = [a for a in range(3) if a != axis]
            out = [0, 0, 0]
            out[axis] = plane
            out[t1], out[t2] = q1, q2
            return tuple(out)
        _, key = surface
        for face in range(6):
            quad = tuple(int(self.root_cells[r, c])
                         for c in _FACE_CORNERS[face])
            if tuple(sorted(quad)) == key:
                T = _frame_transform(quad, self._canon[key])
                p1, p2 = T.inv()((q1, q2), R)
                axis, side = face // 2, face % 2
                t1, t2 = _FACE_AXES[face]
                out = [0, 0, 0]
                out[axis] = side * R
                out[t1], out[t2] = p1, p2
                return tuple(out)
        raise AssertionError("leaf's root not incident to surface")

    def _ref_quad(self, leaf: MR3Leaf, surface, lo1: int, lo2: int,
                  span: int, R: int):
        """Face-square corners in ``leaf``'s unit reference cube, ordered
        face-lex by increasing surface parameters: [(q1,q2), (q1+s,q2),
        (q1,q2+s), (q1+s,q2+s)].  Returns (4, 3)."""
        l, ix, iy, iz, r = leaf
        s = R >> l
        lo3 = np.array([ix * s, iy * s, iz * s], float)
        pts = []
        for dq2 in (0, 1):
            for dq1 in (0, 1):
                xyz = self._surface_point(
                    leaf, surface, lo1 + dq1 * span, lo2 + dq2 * span, R)
                pts.append((np.asarray(xyz, float) - lo3) / s)
        return np.asarray(pts, float)       # (4, 3)

    # ------------------------------------------------------------------
    # hanging entity enumeration (for constraints.py)
    # ------------------------------------------------------------------
    def hanging_faces(self):
        """Hanging coarse faces as corner-vertex-id quadruples with their
        face-frame midpoint ids: one record per coarse face split 2x2 on
        the refined side, as a dict of fine-mesh vertex ids on the 3x3
        node grid of the coarse face::

            {(a, b): vid  for a, b in {0, 1, 2}^2}

        (a, b) indexes the coarse face frame at half-steps — (0,0) etc.
        the corners, (1,1) the face center VERTEX of the refined side.
        Requires a prior :meth:`to_mesh` call (uses its vertex ids)."""
        if not self._vid:
            raise RuntimeError("call to_mesh() before hanging_faces()")
        R = 2 ** self.max_level
        records, leaves = self.interior_face_records()
        out = []
        seen = set()
        for (a, b, surface, lo1, lo2, span) in records:
            if leaves[a][0] == leaves[b][0]:
                continue                        # conforming
            span2 = 2 * span
            LO1, LO2 = lo1 - (lo1 % span2), lo2 - (lo2 % span2)
            skey = (surface, LO1, LO2)
            if skey in seen:
                continue
            seen.add(skey)
            coarse = a if leaves[a][0] < leaves[b][0] else b
            grid = {}
            for bb in range(3):
                for aa in range(3):
                    xyz = self._surface_point(
                        leaves[coarse], surface,
                        LO1 + aa * span, LO2 + bb * span, R)
                    grid[(aa, bb)] = self._vid[self._classify(
                        leaves[coarse][4], *xyz, R)]
            out.append(grid)
        return out

    def hanging_edges(self) -> List[Tuple[int, int, int]]:
        """Hanging coarse edges as (v0, v1, h) fine-mesh vertex-id triples
        (v0/v1 = coarse edge endpoints, h = hanging midpoint vertex),
        including edges interior to hanging faces (their constraints are
        consistent restrictions of the face trace — the builder
        deduplicates).  Requires a prior :meth:`to_mesh` call."""
        if not self._vid:
            raise RuntimeError("call to_mesh() before hanging_edges()")
        R = 2 ** self.max_level
        leaves = self.sorted_leaves()
        # line registry: linekey -> {(lo, span): (leaf, p0, axis)} with lo
        # the canonical line parameter of the segment's low end
        by_line: Dict[tuple, Dict[Tuple[int, int], tuple]] = {}
        for leaf in leaves:
            l, ix, iy, iz, r = leaf
            s = R >> l
            lo3 = (ix * s, iy * s, iz * s)
            for axis in range(3):
                t1, t2 = [a for a in range(3) if a != axis]
                for d1 in (0, 1):
                    for d2 in (0, 1):
                        p0 = [0, 0, 0]
                        p0[axis] = lo3[axis]
                        p0[t1] = lo3[t1] + d1 * s
                        p0[t2] = lo3[t2] + d2 * s
                        p1 = list(p0)
                        p1[axis] += s
                        linekey, lo = self._line_seg_key(
                            r, tuple(p0), tuple(p1), R)
                        by_line.setdefault(linekey, {})[
                            (lo, s)] = (leaf, tuple(p0), axis)
        triples = []
        # line keys are heterogeneous tuples (("e", v, v) root-edge keys vs
        # (("f", ...), ...) face keys) — sort by repr for determinism
        for linekey, segs in sorted(by_line.items(), key=repr):
            for (lo, s), (leaf, p0, axis) in sorted(segs.items()):
                h = s // 2
                if not h:
                    continue
                if (lo, h) in segs and (lo + h, h) in segs:
                    ids = []
                    for t in (0, h, s):
                        p = list(p0)
                        p[axis] += t
                        ids.append(self._vid[self._classify(
                            leaf[4], *p, R)])
                    v0, hd, v1 = ids
                    triples.append((v0, v1, hd))
        return triples

    def _line_seg_key(self, r: int, p0, p1, R: int):
        """Canonical key of the axis-parallel line SEGMENT [p0, p1] in root
        ``r``'s frame, plus the canonical parameter of its low end: two
        roots seeing the same physical segment agree on both.  Root-edge
        lines get the cross-root ('e', vmin, vmax) key, root-face lines
        the canonical face-frame line, interior lines a per-root key."""
        axis = next(a for a in range(3) if p0[a] != p1[a])
        t1, t2 = [a for a in range(3) if a != axis]
        c1, c2 = p0[t1], p0[t2]
        on1 = c1 in (0, R)
        on2 = c2 in (0, R)
        if on1 and on2:                       # root edge
            bits = [0, 0, 0]
            bits[t1] = 1 if c1 else 0
            bits[t2] = 1 if c2 else 0
            bits[axis] = 0
            a0 = bits[0] + 2 * bits[1] + 4 * bits[2]
            bits[axis] = 1
            a1 = bits[0] + 2 * bits[1] + 4 * bits[2]
            va = int(self.root_cells[r, a0])
            vb = int(self.root_cells[r, a1])
            ta, tb = p0[axis], p1[axis]
            if va < vb:
                return ("e", va, vb), min(ta, tb)
            return ("e", vb, va), min(R - ta, R - tb)
        if on1 or on2:                        # root face
            if on1:
                faxis, fside = t1, (1 if c1 else 0)
            else:
                faxis, fside = t2, (1 if c2 else 0)
            face = 2 * faxis + fside
            quad = tuple(int(self.root_cells[r, c])
                         for c in _FACE_CORNERS[face])
            key = tuple(sorted(quad))
            T = _frame_transform(quad, self._canon[key])
            f1, f2 = _FACE_AXES[face]
            q0 = T((p0[f1], p0[f2]), R)
            q1 = T((p1[f1], p1[f2]), R)
            if q0[0] != q1[0]:                # line along canonical axis 0
                return (("f", key), 0, q0[1]), min(q0[0], q1[0])
            return (("f", key), 1, q0[0]), min(q0[1], q1[1])
        return (("i", r), axis, c1, c2), min(p0[axis], p1[axis])


def _canonical_quad(quad) -> tuple:
    """Canonical face-lex corner ordering of a quad given ONE face-lex
    ordering ``(c00, c10, c01, c11)``: anchor at the smallest vertex id,
    s axis toward its smaller edge-neighbor (the same
    smallest-corner-anchored convention as mesh/qk.py 3D face nodes)."""
    c00, c10, c01, c11 = quad
    # edge graph: neighbors of each corner
    nbrs = {c00: (c10, c01), c10: (c00, c11),
            c01: (c00, c11), c11: (c10, c01)}
    diag = {c00: c11, c11: c00, c10: c01, c01: c10}
    a = min(quad)
    n1, n2 = sorted(nbrs[a])
    return (a, n1, n2, diag[a])


# ---------------------------------------------------------------------------
# Kelly estimator on multi-root (distorted trilinear) hex meshes
# ---------------------------------------------------------------------------

def _trilinear_grads_phys(corners, values, ref):
    """Physical gradient of the Q1 field with corner ``values`` (F, 8) on
    trilinear cells with ``corners`` (F, 8, 3) (lex order), at reference
    points ``ref`` (F, Q, 3).  Returns (F, Q, 3)."""
    u = ref[..., 0]
    v = ref[..., 1]
    w = ref[..., 2]
    # lex corner a = bits (x, y, z): weight prod over axes
    sh = []
    dsh = [[], [], []]
    for a in range(8):
        bx, by, bz = a & 1, (a >> 1) & 1, (a >> 2) & 1
        fx = u if bx else 1 - u
        fy = v if by else 1 - v
        fz = w if bz else 1 - w
        gx = 1.0 if bx else -1.0
        gy = 1.0 if by else -1.0
        gz = 1.0 if bz else -1.0
        sh.append(fx * fy * fz)
        dsh[0].append(gx * fy * fz)
        dsh[1].append(fx * gy * fz)
        dsh[2].append(fx * fy * gz)
    D = np.stack([np.stack(d, axis=-1) for d in dsh], axis=-2)  # (F,Q,3,8)
    g_ref = np.einsum("fqda,fa->fqd", D, values)                # (F,Q,3)
    J = np.einsum("fqda,fax->fqxd", D, corners)                 # (F,Q,3x,3d)
    return np.linalg.solve(np.swapaxes(J, -1, -2), g_ref[..., None])[..., 0]


def kelly_estimate_multiroot3d(forest: MultiRootOctForest, mesh,
                               p: np.ndarray) -> np.ndarray:
    """Per-cell Kelly indicator eta_K on a 3D multi-root forest: face-jump
    integrals of the normal pressure derivative over all interior fine
    face squares (2x2 Gauss), geometry-exact on distorted trilinear cells;
    same (h_F / 24) convention as :func:`.kelly.kelly_estimate_3d`."""
    records, leaves = forest.interior_face_records()
    eta2 = np.zeros(len(leaves))
    if not records:
        return eta2
    R = 2 ** forest.max_level
    gp = np.array([0.5 - 0.5 / np.sqrt(3), 0.5 + 0.5 / np.sqrt(3)])

    A = np.array([r[0] for r in records])
    B = np.array([r[1] for r in records])
    refA = np.stack([forest._ref_quad(leaves[r[0]], r[2], r[3], r[4], r[5],
                                      R) for r in records])     # (F, 4, 3)
    refB = np.stack([forest._ref_quad(leaves[r[1]], r[2], r[3], r[4], r[5],
                                      R) for r in records])
    corners = mesh.vertices[mesh.cells]                   # (E, 8, 3)
    cellv = p[mesh.cells]                                 # (E, 8)

    # 2x2 Gauss points in the face parameter square (s, t)
    S = np.repeat(gp, 2)                                  # (4,)
    T = np.tile(gp, 2)

    def face_ref(ref, s, t):
        """Bilinear interp of the 4 ref-cube corners at face params."""
        w = np.stack([(1 - s) * (1 - t), s * (1 - t),
                      (1 - s) * t, s * t], axis=-1)       # (Q, 4)
        return np.einsum("qa,fad->fqd", w, ref)

    qA = face_ref(refA, S, T)                             # (F, 4, 3)
    qB = face_ref(refB, S, T)

    # physical geometry from cell A's trilinear map: corners + tangents
    def at_ref(c, ref):
        u, v, w = ref[..., 0], ref[..., 1], ref[..., 2]
        ws = []
        for a in range(8):
            bx, by, bz = a & 1, (a >> 1) & 1, (a >> 2) & 1
            ws.append((u if bx else 1 - u) * (v if by else 1 - v)
                      * (w if bz else 1 - w))
        W = np.stack(ws, axis=-1)                         # (F, .., 8)
        return np.einsum("f...a,fad->f...d", W, c)

    pc = at_ref(corners[A], refA)                         # (F, 4, 3) corners
    # bilinear patch x(s,t) = sum w_a(s,t) pc_a: tangents at Gauss points
    dxs = ((pc[:, 1] - pc[:, 0])[:, None] * (1 - T)[None, :, None]
           + (pc[:, 3] - pc[:, 2])[:, None] * T[None, :, None])
    dxt = ((pc[:, 2] - pc[:, 0])[:, None] * (1 - S)[None, :, None]
           + (pc[:, 3] - pc[:, 1])[:, None] * S[None, :, None])
    nrm = np.cross(dxs, dxt)                              # (F, 4, 3)
    dA = np.linalg.norm(nrm, axis=-1)                     # area element
    normal = nrm / np.maximum(dA, 1e-300)[..., None]

    ga = _trilinear_grads_phys(corners[A], cellv[A], qA)
    gb = _trilinear_grads_phys(corners[B], cellv[B], qB)
    jump = np.einsum("fqd,fqd->fq", ga - gb, normal)
    # 2x2 Gauss on the unit square: weights 1/4 each, times the area
    # element at the Gauss point
    integral = 0.25 * (jump ** 2 * dA).sum(axis=1)
    area = 0.25 * dA.sum(axis=1)
    diam = np.sqrt(area)                                  # ~ face diameter
    # match kelly_estimate_3d's axis-aligned convention (diam = hypot of
    # the side lengths = sqrt(2*area) for squares)
    contrib = (np.sqrt(2.0) * diam / 24.0) * integral
    np.add.at(eta2, A, contrib)
    np.add.at(eta2, B, contrib)
    return np.sqrt(eta2)


# ---------------------------------------------------------------------------
# solution transfer on 3D multi-root forests
# ---------------------------------------------------------------------------

def _invert_trilinear(corners: np.ndarray, pts: np.ndarray,
                      iters: int = 15) -> np.ndarray:
    """Newton inversion of one root's trilinear map for many points:
    ``corners`` (8, 3) lex order, ``pts`` (P, 3) -> reference (P, 3)."""
    xi = np.full((pts.shape[0], 3), 0.5)
    c = corners
    for _ in range(iters):
        u, v, w = xi[:, :1], xi[:, 1:2], xi[:, 2:]
        ws, dws = [], [[], [], []]
        for a in range(8):
            bx, by, bz = a & 1, (a >> 1) & 1, (a >> 2) & 1
            fx = u if bx else 1 - u
            fy = v if by else 1 - v
            fz = w if bz else 1 - w
            ws.append(fx * fy * fz)
            dws[0].append((1.0 if bx else -1.0) * fy * fz)
            dws[1].append(fx * (1.0 if by else -1.0) * fz)
            dws[2].append(fx * fy * (1.0 if bz else -1.0))
        W = np.concatenate(ws, axis=1)                    # (P, 8)
        x = W @ c                                         # (P, 3)
        res = pts - x
        J = np.stack([np.concatenate(d, axis=1) @ c
                      for d in dws], axis=-1)             # (P, 3x, 3d)
        try:
            step = np.linalg.solve(J, res[:, :, None])[..., 0]
        except np.linalg.LinAlgError:
            step = np.linalg.lstsq(J.reshape(-1, 3), res.reshape(-1),
                                   rcond=None)[0]
        xi = np.clip(xi + step, -0.5, 1.5)   # keep Newton in the basin
    return xi


def transfer_nodal_multiroot3d(forest_old: MultiRootOctForest, mesh_old,
                               values: np.ndarray,
                               new_points: np.ndarray) -> np.ndarray:
    """Evaluate old Q1 nodal field(s) at ``new_points`` (the deal.II
    ``SolutionTransfer`` analogue of :func:`.transfer.transfer_nodal`, for
    3D multi-root forests): locate the containing root by inverting each
    root's trilinear map, then the containing leaf in exact root-reference
    coordinates, then interpolate trilinearly within the leaf."""
    from .transfer import _morton

    P = new_points.shape[0]
    was_1d = values.ndim == 1
    values = np.atleast_2d(values)
    cellv = values[..., mesh_old.cells]                   # (..., E, 8)

    best_res = np.full(P, np.inf)
    root_of = np.zeros(P, np.int64)
    ref = np.zeros((P, 3))
    for r in range(forest_old.n_roots):
        corners = forest_old.root_coords[forest_old.root_cells[r]]
        xi = _invert_trilinear(corners, new_points)
        xi_c = np.clip(xi, 0.0, 1.0)
        x_back = forest_old._trilinear(r, xi_c)
        res = np.linalg.norm(x_back - new_points, axis=-1)
        take = res < best_res - 1e-12
        best_res = np.where(take, res, best_res)
        root_of = np.where(take, r, root_of)
        ref[take] = xi_c[take]

    leaves = forest_old.sorted_leaves()
    Lmax = forest_old.max_level
    R = 2 ** Lmax
    lv = np.array([leaf[0] for leaf in leaves], dtype=np.int64)
    li = np.array([leaf[1:4] for leaf in leaves], dtype=np.int64)
    lr = np.array([leaf[4] for leaf in leaves], dtype=np.int64)
    starts = _morton(li << (Lmax - lv)[:, None], Lmax, 3)
    key = lr * (R ** 3) + starts
    order = np.argsort(key)
    f = np.minimum((ref * R).astype(np.int64), R - 1)
    pkey = root_of * (R ** 3) + _morton(f, Lmax, 3)
    c = order[np.searchsorted(key[order], pkey, side="right") - 1]

    n = (1 << lv[c]).astype(np.float64)
    idx = np.minimum((ref * n[:, None]).astype(np.int64),
                     (n[:, None] - 1).astype(np.int64))
    xi = ref * n[:, None] - idx                           # (P, 3) in [0, 1]
    wx = np.stack([1 - xi[:, 0], xi[:, 0]], axis=1)
    wy = np.stack([1 - xi[:, 1], xi[:, 1]], axis=1)
    wz = np.stack([1 - xi[:, 2], xi[:, 2]], axis=1)
    # lex corner order: a = bx + 2 by + 4 bz
    w = np.stack([wx[:, a & 1] * wy[:, (a >> 1) & 1] * wz[:, (a >> 2) & 1]
                  for a in range(8)], axis=1)             # (P, 8)
    out = np.einsum("...pv,pv->...p", cellv[..., c, :], w)
    return out[0] if was_1d else out
