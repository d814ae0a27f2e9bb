"""Hanging-node constraints for Q1 / Q2 spaces on a 1-irregular forest
(port of ``poroelasticity_dealii_tpu/amr/constraints.py``).

The deal.II ``DoFTools::make_hanging_node_constraints`` analogue
(``PoroElasticPressureSolver.h:75``, ``PoroElasticDisplacementSolver.h:113``)
as precomputed index/weight tables applied matrix-free, on torch tensors:

* ``distribute``: hanging values := interpolation of their masters (the
  ``ConstraintMatrix::distribute`` of the reference),
* ``condense_vec``: add hanging-row contributions to master rows and zero
  them (``condense`` on vectors / the RHS effect of
  ``distribute_local_to_global``),
* ``constrained(apply)``: C^T A C + identity-on-hanging wrapper keeping the
  operator SPD on the master subspace.

Masters repeat across hanging rows, so ``condense_vec`` sums each master's
contributions through a plan built with the tables
(:func:`..ops.operators.scatter_plan` over the master table): a fixed
order and no float atomics, so the condensed RHS is bitwise repeatable and
the fixed-stress solver's skip-if-unchanged rule keeps working.  An empty
table set is a host flag fixed at build time: every method then returns
its input untouched, and no method reads a value on the host or makes a
data-dependent shape, so all of them run inside captured CUDA graphs.

The four numpy builders are the reference's, unchanged:
:func:`build_hanging_constraints` (explicit 2D edge tables),
:func:`build_hanging_constraints_geometric` (dim/degree-generic
Lagrange-trace rule, 3D face and edge constraints),
:func:`build_hanging_constraints_3d_entities` and
:func:`build_hanging_constraints_from_edges` (the multi-root forests'
hanging faces and edges).  They return tables on the CPU;
:meth:`HangingConstraints.to` moves them."""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Tuple

import numpy as np
import torch

from ..mesh.core import FESpace
from ..ops.operators import ScatterPlan, scatter_plan, scatter_sum
from ..ops.shape import node_lattice, shape_tables
from .forest import QuadForest

# 1D quadratic Lagrange values at 1/4 and 3/4 of the coarse edge
_Q2_W_QUARTER = (0.375, 0.75, -0.125)    # (v0, m, v1) at x = 1/4


@dataclasses.dataclass(frozen=True)
class HangingConstraints:
    """Index tables on one device; ``empty`` (no hanging row) means every
    method is the identity.  Every method takes a vector ``(..., n_dofs)``
    (leading axes batched, as the projection's) and returns a new one."""
    hanging: torch.Tensor    # (H,) int64 constrained dof ids
    masters: torch.Tensor    # (H, W) int64 master dof ids (padded with
    #                          the hanging id, weight 0)
    weights: torch.Tensor    # (H, W) weights (padded with 0)
    targets: torch.Tensor    # (T,) int64, the distinct master ids
    plan: ScatterPlan        # master table entries of each target, in order
    empty: bool

    @classmethod
    def from_tables(cls, hanging, masters, weights, dtype,
                    device="cpu") -> "HangingConstraints":
        """From host tables (numpy or lists).  The condense plan lists,
        for each master, its entries of nonzero weight in table order; the
        zero-weight padding (a short row's self entries, the phantom rows
        of AMR bucketing) adds nothing and stays out of it, so the plan's
        width is the largest number of rows a master serves.  ``dtype`` is
        a torch or a numpy float type (the scipy oracle,
        :mod:`..validation`, passes ``np.float64``)."""
        if not isinstance(dtype, torch.dtype):
            dtype = getattr(torch, np.dtype(dtype).name)
        hanging = np.asarray(hanging, np.int64).reshape(-1)
        masters = np.asarray(masters, np.int64)
        weights = np.array(weights, np.float64)
        live = weights != 0.0
        targets, inverse = np.unique(masters[live], return_inverse=True)
        slots = np.full(masters.shape, -1, np.int64)   # -1: left out
        slots[live] = inverse
        as_idx = lambda a: torch.as_tensor(a, dtype=torch.int64,  # noqa: E731
                                           device=device)
        return cls(hanging=as_idx(hanging), masters=as_idx(masters),
                   weights=torch.as_tensor(weights, dtype=dtype,
                                           device=device),
                   targets=as_idx(targets),
                   plan=scatter_plan(slots, targets.shape[0], device),
                   empty=hanging.shape[0] == 0)

    def to(self, device) -> "HangingConstraints":
        return dataclasses.replace(
            self, hanging=self.hanging.to(device),
            masters=self.masters.to(device),
            weights=self.weights.to(device), targets=self.targets.to(device),
            plan=ScatterPlan(table=self.plan.table.to(device),
                             n_values=self.plan.n_values))

    def distribute(self, x):
        if self.empty:
            return x
        vals = (self.weights * x[..., self.masters]).sum(-1)
        return x.index_copy(-1, self.hanging, vals)

    def condense_vec(self, r):
        if self.empty:
            return r
        contrib = self.weights * r[..., self.hanging, None]
        sums = r[..., self.targets] + scatter_sum(contrib, self.plan)
        r = r.index_copy(-1, self.targets, sums)
        return r.index_fill(-1, self.hanging, 0.0)

    def zero_hanging(self, x):
        """Zero the hanging entries (correct warm start for the constrained
        solve, whose identity block drives them to zero)."""
        if self.empty:
            return x
        return x.index_fill(-1, self.hanging, 0.0)

    def constrained(self, apply_fn):
        """SPD operator on the master subspace: hanging rows/cols eliminated
        (C^T A C) with identity on the hanging block."""
        if self.empty:
            return apply_fn

        def apply(x):
            xh = x[..., self.hanging]
            y = self.condense_vec(apply_fn(self.distribute(x)))
            return y.index_copy(-1, self.hanging, xh)
        return apply


def empty_constraints(dtype, device="cpu") -> HangingConstraints:
    return HangingConstraints.from_tables(
        np.zeros((0,), np.int64), np.zeros((0, 1), np.int64),
        np.zeros((0, 1)), dtype, device)


def _q2_edge_triples(dim: int):
    """Q2 lattice (corner, corner, midnode) local index triples per cell
    edge: the midnode has exactly one lattice-interior axis, the corners
    are its endpoints along that axis."""
    lat = node_lattice(2, dim)
    out = []
    for a in range(lat.shape[0]):
        interior = [d for d in range(dim) if lat[a, d] == 1]
        if len(interior) != 1:
            continue
        d = interior[0]

        def corner(v):
            q = lat[a].copy()
            q[d] = v
            return int(np.nonzero((lat == q).all(axis=1))[0][0])
        out.append((corner(0), corner(2), a))
    return out


def _edge_midnode_map(space: FESpace) -> Dict[Tuple[int, int], int]:
    """(sorted corner-vertex pair) -> Q2 edge midnode id, from cell data
    (any dim: 4 edges per quad, 12 per hex)."""
    cn = space.cell_nodes
    dim = space.mesh.dim
    out: Dict[Tuple[int, int], int] = {}
    for (c0, c1, m) in _q2_edge_triples(dim):
        a = cn[:, c0].astype(np.int64)
        b = cn[:, c1].astype(np.int64)
        mm = cn[:, m]
        lo = np.minimum(a, b)
        hi = np.maximum(a, b)
        for k in range(len(a)):
            out[(int(lo[k]), int(hi[k]))] = int(mm[k])
    return out


def _q2_face_centers(dim: int):
    """Q2 lattice (4 corners (face-lex), center) local index tuples per
    cell face (3D: the 6 hex faces)."""
    lat = node_lattice(2, dim)
    out = []
    for a in range(lat.shape[0]):
        interior = [d for d in range(dim) if lat[a, d] == 1]
        if len(interior) != 2:
            continue
        d1, d2 = interior

        def corner(v1, v2):
            q = lat[a].copy()
            q[d1], q[d2] = v1, v2
            return int(np.nonzero((lat == q).all(axis=1))[0][0])
        out.append(((corner(0, 0), corner(2, 0), corner(0, 2),
                     corner(2, 2)), a))
    return out


def _face_center_map(space: FESpace) -> Dict[tuple, int]:
    """(sorted 4-corner-vertex tuple) -> Q2 face-center node id (3D)."""
    cn = space.cell_nodes
    out: Dict[tuple, int] = {}
    for (corners, m) in _q2_face_centers(space.mesh.dim):
        quad = cn[:, list(corners)].astype(np.int64)
        mm = cn[:, m]
        for k in range(quad.shape[0]):
            out[tuple(sorted(int(v) for v in quad[k]))] = int(mm[k])
    return out


def build_hanging_constraints_geometric(forest, mesh, p_space: FESpace,
                                        u_space: FESpace, dtype):
    """Dim/degree-generic hanging-node constraints on a 1-irregular forest.

    Algebraic formulation of deal.II's ``make_hanging_node_constraints``: a
    space node is *hanging* iff some leaf cell whose closure contains it
    does NOT have it in its Q_k lattice; its constraint row is the coarse
    cell's Lagrange trace evaluated at the node,

        value(nu) = sum_a  phi_a^K(nu) * value(a),

    which automatically restricts to K's nodes on the shared face/edge
    (tensor-product Lagrange bases vanish at foreign lattice planes) — so
    3D face AND edge constraints, for Q1 and Q2 alike, come out of one
    rule.  Verified equal to the explicit 2D edge-table builder
    (tests/test_amr3d.py) and by 3D patch tests.
    """
    dim = mesh.dim
    R = 2 ** forest.max_level
    sz = forest.upper - forest.lower
    leaves = set(forest.leaves)
    levels = sorted({leaf[0] for leaf in leaves})
    # mesh cells are in forest.sorted_leaves() order (to_mesh contract)
    cell_of_leaf = {leaf: i for i, leaf in enumerate(forest.sorted_leaves())}

    def rows_for_space(space: FESpace):
        k = space.degree
        denom = R * k
        q = np.round((space.node_coords - forest.lower) / sz * denom)
        q = q.astype(np.int64)                            # (N, dim)
        # membership is by ENTITY (cell_nodes), not position: a hanging
        # vertex and a coarse edge/face midnode can share coordinates but
        # are distinct dofs (deal.II semantics)
        cell_node_sets = [set(row) for row in
                          space.cell_nodes.astype(np.int64)]

        rows = []
        for node in range(q.shape[0]):
            qn = q[node]
            containing = []      # (leaf, s, member)
            for l in levels:
                s = R // (2 ** l)
                ks = k * s
                cand_ranges = []
                for a in range(dim):
                    i0 = qn[a] // ks
                    cands = {int(i0)}
                    if qn[a] % ks == 0:
                        cands.add(int(i0) - 1)
                    cand_ranges.append(
                        [i for i in cands if 0 <= i < 2 ** l])
                for idx in itertools.product(*cand_ranges):
                    leaf = (l,) + tuple(idx)
                    if leaf in leaves:
                        member = node in cell_node_sets[cell_of_leaf[leaf]]
                        containing.append((leaf, s, member))
            owner_lvl = min(c[0][0] for c in containing if c[2])
            # deal.II rule: constrain the REFINED side only — master = the
            # coarsest containing cell lacking the node, and it must be
            # coarser than every owner (else this node IS the coarse side,
            # e.g. the coarse edge midnode under a hanging vertex)
            foreign = [c for c in containing
                       if not c[2] and c[0][0] < owner_lvl]
            if not foreign:
                continue
            K, s, _ = max(foreign, key=lambda c: c[1])
            ks = k * s
            lo = np.array(K[1:]) * ks
            ref = (qn - lo) / ks * 2.0 - 1.0              # [-1, 1]^dim
            phi, _ = shape_tables(k, dim, ref[None, :])   # (1, NL)
            conn_K = space.cell_nodes[cell_of_leaf[K]]
            ms = []
            for a in range(conn_K.shape[0]):
                w = float(phi[0, a])
                if abs(w) < 1e-12:
                    continue
                ms.append((int(conn_K[a]), w))
            rows.append((node, ms))
        return rows

    p_rows = rows_for_space(p_space)
    u_rows = rows_for_space(u_space)
    return (_pack_rows(p_rows, 1, dtype), _pack_rows(u_rows, dim, dtype))


def _resolve_chains(rows):
    """Substitute masters that are themselves hanging (deal.II's
    ConstraintMatrix::close): possible at refinement-pattern corners."""
    table = {node: ms for node, ms in rows}
    out = []
    for node, ms in rows:
        for _ in range(8):  # chains are short; bound defensively
            if not any(mn in table for mn, _ in ms):
                break
            new = {}
            for mn, w in ms:
                if mn in table:
                    for mn2, w2 in table[mn]:
                        new[mn2] = new.get(mn2, 0.0) + w * w2
                else:
                    new[mn] = new.get(mn, 0.0) + w
            ms = list(new.items())
        out.append((node, ms))
    return out


def _pack_rows(rows, n_comp, dtype):
    """(node, [(master_node, w), ...]) rows -> dof-level tables."""
    rows = _resolve_chains(rows)
    rows = [(n, [(m, w) for m, w in ms if abs(w) > 1e-14]) for n, ms in rows]
    if not rows:
        return empty_constraints(dtype)
    W = max(len(ms) for _, ms in rows)
    H = len(rows) * n_comp
    hang = np.zeros(H, np.int32)
    mast = np.zeros((H, W), np.int64)
    wts = np.zeros((H, W))
    r = 0
    for node, ms in rows:
        for c in range(n_comp):
            hang[r] = node * n_comp + c
            mast[r, :] = node * n_comp + c        # pad with self, w=0
            for j, (mn, w) in enumerate(ms):
                mast[r, j] = mn * n_comp + c
                wts[r, j] = w
            r += 1
    return HangingConstraints.from_tables(hang, mast, wts, dtype)


def build_hanging_constraints(forest: QuadForest, mesh, p_space: FESpace,
                              u_space: FESpace, dtype):
    """Returns ``(pressure HangingConstraints, displacement (dof-level)
    HangingConstraints)``."""
    if mesh.dim != 2:
        raise NotImplementedError("hanging constraints are 2D-only")
    records, leaves = forest.interior_faces()
    R = 2 ** forest.max_level

    # integer vertex coordinate -> vertex id
    sz = forest.upper - forest.lower
    iv = np.round((mesh.vertices - forest.lower) / sz * R).astype(np.int64)
    vid = {(int(x), int(y)): i for i, (x, y) in enumerate(iv)}

    # unique hanging coarse edges from coarse-fine records
    coarse_edges = set()
    for rec in records:
        a, b, axis, line, lo, span = rec
        la, lb = leaves[a][0], leaves[b][0]
        if la == lb:
            continue
        span2 = 2 * span
        LO = lo - (lo % span2)
        coarse_edges.add((axis, line, LO, span2))

    triples = []
    for (axis, line, LO, span2) in sorted(coarse_edges):
        t = 1 - axis
        def pt(s):
            c = [0, 0]
            c[axis] = line
            c[t] = s
            return (c[0], c[1])
        triples.append((vid[pt(LO)], vid[pt(LO + span2)],
                        vid[pt(LO + span2 // 2)]))
    return build_hanging_constraints_from_edges(triples, mesh.dim,
                                                u_space, dtype)


def _lagrange_q2_1d(x: float):
    """1D quadratic Lagrange basis over nodes {0, 0.5, 1} at ``x``."""
    return ((1 - x) * (1 - 2 * x), 4 * x * (1 - x), x * (2 * x - 1))


def build_hanging_constraints_3d_entities(face_grids, edge_triples,
                                          u_space: FESpace, dtype):
    """3D hanging-node constraints from hanging-entity enumerations
    (:meth:`..amr.multiroot3d.MultiRootOctForest.hanging_faces` /
    ``hanging_edges``) — the forest-topology-agnostic 3D mirror of
    :func:`build_hanging_constraints_from_edges`.

    ``face_grids``: one dict per hanging coarse face mapping half-step
    face-frame positions (a, b) in {0, 1, 2}^2 to fine-mesh VERTEX ids —
    corners at (even, even), the refined side's edge-midpoint and
    face-center vertices elsewhere.  Every fine-side node on the face
    (fine vertices, fine Q2 edge midnodes at quarter points, fine Q2
    quarter-face centers) is constrained by the coarse face's Lagrange
    trace — bilinear in the 4 corners for Q1, biquadratic in the 9 coarse
    face nodes for Q2 — written in the face PARAMETER, which is exact on
    distorted trilinear parents (the trilinear map restricted to a face is
    bilinear in the parameters, so fine nodes sit at exact parametric
    fractions).  ``edge_triples``: (v0, v1, h) per hanging coarse edge,
    exactly as in 2D; face rows take precedence where both apply (the
    face trace restricted to a boundary edge IS the edge trace, so the
    overlap is consistent)."""
    q2 = u_space.degree == 2
    mid_u = _edge_midnode_map(u_space) if q2 else {}
    fc_u = _face_center_map(u_space) if q2 else {}

    p_rows: Dict[int, list] = {}
    u_rows: Dict[int, list] = {}

    for grid in face_grids:
        c00, c10 = grid[(0, 0)], grid[(2, 0)]
        c01, c11 = grid[(0, 2)], grid[(2, 2)]
        corners = (c00, c10, c01, c11)

        def bilinear(s, t):
            return [(c00, (1 - s) * (1 - t)), (c10, s * (1 - t)),
                    (c01, (1 - s) * t), (c11, s * t)]

        # Q1 pressure: the 5 non-corner grid vertices hang off the corners
        for (a, b), node in grid.items():
            if a % 2 == 0 and b % 2 == 0:
                continue
            p_rows.setdefault(node, bilinear(a / 2.0, b / 2.0))

        if not q2:
            for (a, b), node in grid.items():
                if a % 2 == 0 and b % 2 == 0:
                    continue
                u_rows.setdefault(node, bilinear(a / 2.0, b / 2.0))
            continue

        # Q2: 9 coarse masters at params {0, .5, 1}^2
        def emid(va, vb):
            return mid_u[tuple(sorted((va, vb)))]

        masters = {(0.0, 0.0): c00, (1.0, 0.0): c10,
                   (0.0, 1.0): c01, (1.0, 1.0): c11,
                   (0.5, 0.0): emid(c00, c10), (0.5, 1.0): emid(c01, c11),
                   (0.0, 0.5): emid(c00, c01), (1.0, 0.5): emid(c10, c11),
                   (0.5, 0.5): fc_u[tuple(sorted(corners))]}

        def trace(s, t):
            Ls, Lt = _lagrange_q2_1d(s), _lagrange_q2_1d(t)
            out = []
            for (ms, mt), node in masters.items():
                w = Ls[int(2 * ms)] * Lt[int(2 * mt)]
                if abs(w) > 1e-14:
                    out.append((node, w))
            return out

        # fine-side nodes on the face, with their face params:
        fine = []
        for (a, b), node in grid.items():       # fine vertices
            if a % 2 == 0 and b % 2 == 0:
                continue
            fine.append((node, a / 2.0, b / 2.0))
        for qa in (0, 1):                        # per fine quarter face
            for qb in (0, 1):
                q = [grid[(qa, qb)], grid[(qa + 1, qb)],
                     grid[(qa, qb + 1)], grid[(qa + 1, qb + 1)]]
                x0, y0 = qa / 2.0, qb / 2.0
                fine.extend([
                    (emid(q[0], q[1]), x0 + 0.25, y0),
                    (emid(q[2], q[3]), x0 + 0.25, y0 + 0.5),
                    (emid(q[0], q[2]), x0, y0 + 0.25),
                    (emid(q[1], q[3]), x0 + 0.5, y0 + 0.25),
                    (fc_u[tuple(sorted(q))], x0 + 0.25, y0 + 0.25)])
        for node, s, t in fine:
            u_rows.setdefault(node, trace(s, t))

    # hanging edges: fill nodes the face treatment didn't reach
    mid_map = mid_u
    for (v0, v1, h) in edge_triples:
        p_rows.setdefault(h, [(v0, 0.5), (v1, 0.5)])
        if q2:
            m = mid_map[tuple(sorted((v0, v1)))]
            m0 = mid_map[tuple(sorted((v0, h)))]
            m1 = mid_map[tuple(sorted((h, v1)))]
            w0, wm, w1 = _Q2_W_QUARTER
            u_rows.setdefault(h, [(m, 1.0)])
            u_rows.setdefault(m0, [(v0, w0), (m, wm), (v1, w1)])
            u_rows.setdefault(m1, [(v0, w1), (m, wm), (v1, w0)])
        else:
            u_rows.setdefault(h, [(v0, 0.5), (v1, 0.5)])

    dim = u_space.mesh.dim
    return (_pack_rows(sorted(p_rows.items()), 1, dtype),
            _pack_rows(sorted(u_rows.items()), dim, dtype))


def build_hanging_constraints_from_edges(triples, dim, u_space, dtype):
    """Hanging-node constraints from ``(v0, v1, h)`` vertex-id triples (one
    per hanging coarse edge: endpoints + hanging midpoint).

    Forest-topology-agnostic — the multi-root forest
    (:mod:`.multiroot`) enumerates its hanging edges, including across root
    boundaries, and delegates here.  The interpolation weights live in the
    coarse edge's PARAMETER (0.5/0.5 for Q1, the quarter-point quadratic
    trace for Q2), which is exact on distorted bilinear parents too: the
    bilinear map is affine along each edge, so the fine nodes sit at exact
    parametric fractions of the coarse edge."""
    mid_u = _edge_midnode_map(u_space) if u_space.degree == 2 else {}

    p_rows = []   # (hanging_node, [(master, w), ...])
    u_rows = []   # node-level; expanded to dofs below
    for (v0, v1, h) in triples:
        # Q1 pressure: h = (v0 + v1)/2
        p_rows.append((h, [(v0, 0.5), (v1, 0.5)]))
        if u_space.degree == 2:
            m = mid_u[tuple(sorted((v0, v1)))]
            m0 = mid_u[tuple(sorted((v0, h)))]
            m1 = mid_u[tuple(sorted((h, v1)))]
            w0, wm, w1 = _Q2_W_QUARTER
            u_rows.append((h, [(m, 1.0)]))
            u_rows.append((m0, [(v0, w0), (m, wm), (v1, w1)]))
            u_rows.append((m1, [(v0, w1), (m, wm), (v1, w0)]))
        else:
            u_rows.append((h, [(v0, 0.5), (v1, 0.5)]))

    return _pack_rows(p_rows, 1, dtype), _pack_rows(u_rows, dim, dtype)
