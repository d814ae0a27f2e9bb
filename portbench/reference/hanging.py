"""Hanging-node constraints of the Q1 and Q2 spaces on a 2:1 hexahedral
mesh, built from the mesh arrays alone, and the reference's operators on
the constrained spaces.

Written from deal.II's conforming constraints
(``DoFTools::make_hanging_node_constraints``), apart from the program: it
imports nothing of it and reads none of its tables.

* Numbering: the nodes of each space are its cells' Lagrange lattice
  points (the trilinear map of the corners at ``{0, 1/k, .., 1}^3``), one
  node for each distinct point: a coarse cell's edge or face midpoint and
  a finer neighbour's vertex at the same place are one node.  Points are
  compared on a lattice of an eighth of the smallest cell, exact for the
  octree meshes of a box that adaptive runs make.
* Hanging nodes: on a 2:1 mesh a finer cell's nodes on a face or an edge
  of a coarser neighbour K lie on the lattice of spacing ``1 / (2k)`` in
  K's reference cell; each such point of K's boundary that is not one of
  K's own nodes but is a node of the mesh hangs on K.
* Each hanging node is K's Q_k field at that point: the weights are K's
  shape values there, nonzero only for K's nodes on the face or edge.  A
  master that hangs itself is replaced by its own masters.
* ``distribute`` sets the hanging values from their masters; ``condense``
  is ``C^T``: each hanging row's entry goes to its masters with its
  weight, and the hanging rows are zeroed.  :class:`Problem` applies
  ``C^T A C``: the residuals of the three equations on the masters.
"""

from __future__ import annotations

import numpy as np
import torch

from . import fem


def lattice(k: int, step: float = None) -> np.ndarray:
    """Reference points ``{0, step, .., 1}^3`` (default step ``1/k``), x
    fastest."""
    t = np.linspace(0.0, 1.0, int(round(1.0 / (step or 1.0 / k))) + 1)
    iz, iy, ix = np.meshgrid(t, t, t, indexing="ij")
    return np.stack([ix.reshape(-1), iy.reshape(-1), iz.reshape(-1)], -1)


def trilinear(X: np.ndarray, xi: np.ndarray) -> np.ndarray:
    """The cells' trilinear maps ``X (E, 8, 3)`` at ``xi (K, 3)``:
    (E, K, 3)."""
    n1, _ = fem.tables(1, xi)
    return np.einsum("kv,evd->ekd", n1, X)


class Keys:
    """Points as integer triples on a lattice of spacing ``q`` from
    ``lo``, and one int64 key each."""

    def __init__(self, lo, hi, q: float):
        self.lo, self.q = np.asarray(lo, np.float64), float(q)
        self.m = int(np.max(np.round((np.asarray(hi) - self.lo) / q))) + 1

    def __call__(self, x) -> np.ndarray:
        i = np.round((np.asarray(x) - self.lo) / self.q).astype(np.int64)
        return (i[..., 2] * self.m + i[..., 1]) * self.m + i[..., 0]


class Space:
    """One scalar Q_k space on the mesh: node coordinates, each cell's
    nodes (local order x fastest), and the hanging rows ``hanging (H,)``,
    ``masters (H, W)``, ``weights (H, W)`` (zero weights pad a row)."""

    def __init__(self, X: np.ndarray, k: int, keys: Keys):
        E = X.shape[0]
        pts = trilinear(X, lattice(k)).reshape(-1, 3)
        uniq, first, inv = np.unique(keys(pts), return_index=True,
                                     return_inverse=True)
        self.degree = k
        self.coords = pts[first]
        self.cell_nodes = inv.reshape(E, (k + 1) ** 3).astype(np.int64)
        self.n = uniq.shape[0]
        # candidate points: K's boundary at spacing 1/(2k), off K's lattice
        fine = lattice(k, 0.5 / k)
        own = np.all(np.isclose((fine * k) % 1.0, 0.0), axis=-1)
        on_boundary = np.any((fine == 0.0) | (fine == 1.0), axis=-1)
        cand = fine[on_boundary & ~own]
        ck = keys(trilinear(X, cand))                     # (E, C)
        pos = np.clip(np.searchsorted(uniq, ck), 0, self.n - 1)
        found = uniq[pos] == ck
        e, c = np.nonzero(found)
        nodes = pos[e, c]
        nodes, pick = np.unique(nodes, return_index=True)
        e, c = e[pick], c[pick]
        weights = fem.tables(k, cand)[0][c]                # (H, (k+1)^3)
        weights[np.abs(weights) < 1e-14] = 0.0
        self._set(nodes, self.cell_nodes[e], weights)

    def _set(self, hanging, masters, weights):
        """Store the rows, nonzero weights first, with every master that
        hangs replaced by its own masters (deal.II's
        ``AffineConstraints::close``)."""
        if np.any(np.isin(masters, hanging) & (weights != 0.0)):
            hanging, masters, weights = _close(hanging, masters, weights)
        order = np.argsort(weights == 0.0, axis=1, kind="stable")
        masters = np.take_along_axis(masters, order, 1)
        weights = np.take_along_axis(weights, order, 1)
        width = max(1, int((weights != 0.0).sum(1).max(initial=0)))
        self.hanging = np.asarray(hanging, np.int64)
        self.masters = np.asarray(masters[:, :width], np.int64)
        self.weights = weights[:, :width]

    def on(self, dtype, device) -> "Space":
        self._t = (torch.as_tensor(self.hanging, device=device),
                   torch.as_tensor(self.masters, device=device),
                   torch.as_tensor(self.weights, dtype=dtype, device=device))
        return self

    def distribute(self, x):
        """``x (..., n)`` with each hanging value its masters' combination."""
        h, m, w = self._t
        if not h.numel():
            return x
        return x.index_copy(-1, h, (w * x[..., m]).sum(-1))

    def condense(self, r):
        """``C^T r``: hanging entries moved to their masters, then zeroed."""
        h, m, w = self._t
        if not h.numel():
            return r
        lead = r.shape[:-1]
        moved = (w * r[..., h, None]).reshape(lead + (-1,))
        return r.index_add(-1, m.reshape(-1), moved).index_fill(-1, h, 0.0)


def _close(hanging, masters, weights):
    """Rows whose masters hang, resolved by substitution."""
    rows = {}
    for h, ms, ws in zip(hanging, masters, weights):
        row = rows.setdefault(int(h), {})
        for m, w in zip(ms, ws):
            if w != 0.0:
                row[int(m)] = row.get(int(m), 0.0) + w
    for _ in range(8):
        chained = [h for h, r in rows.items() if any(m in rows for m in r)]
        if not chained:
            break
        for h in chained:
            new = {}
            for m, w in rows[h].items():
                for m2, w2 in (rows[m].items() if m in rows else [(m, 1.0)]):
                    new[m2] = new.get(m2, 0.0) + w * w2
            rows[h] = new
    else:
        raise ValueError("hanging-node chains do not close")
    width = max(len(r) for r in rows.values())
    hang = np.array(sorted(rows), np.int64)
    mast = np.tile(hang[:, None], (1, width))
    wts = np.zeros((len(hang), width))
    for i, h in enumerate(hang):
        for j, (m, w) in enumerate(sorted(rows[int(h)].items())):
            mast[i, j], wts[i, j] = m, w
    return hang, mast, wts


class Mesh:
    """The Q1 and Q2 spaces of a 2:1 hex mesh (``vertices (nv, 3)``,
    ``cells (E, 8)`` corners x bit first)."""

    def __init__(self, vertices, cells):
        V = np.asarray(vertices, np.float64)
        X = V[np.asarray(cells, np.int64)]                  # (E, 8, 3)
        h_min = float(np.min(np.linalg.norm(X[:, 1] - X[:, 0], axis=-1)))
        keys = Keys(V.min(0), V.max(0), h_min / 8.0)
        self.X = X
        self.q1 = Space(X, 1, keys)
        self.q2 = Space(X, 2, keys)
        self.keys = keys

    def index_of(self, space: Space, points) -> np.ndarray:
        """The node of ``space`` at each of ``points`` (raises where none
        is)."""
        sk = self.keys(space.coords)          # sorted: np.unique's order
        k = self.keys(points)
        idx = np.clip(np.searchsorted(sk, k), 0, space.n - 1)
        if not np.array_equal(sk[idx], k):
            raise ValueError("a point is no node of the reference's space")
        return idx


class Problem(fem.Problem):
    """:class:`.fem.Problem` on the constrained spaces of ``mesh``: every
    apply is ``C^T A C`` (its output zero on the hanging rows), and the
    well source is condensed."""

    def __init__(self, mesh: Mesh, phys, dtype=torch.float64, device="cpu"):
        q1 = mesh.q1
        super().__init__(q1.coords, q1.cell_nodes, mesh.q2.cell_nodes,
                         mesh.q2.n, phys, dtype, device)
        self.mesh = mesh
        self.c1 = q1.on(dtype, self.device)
        self.c2 = mesh.q2.on(dtype, self.device)
        self.f_well = self.c1.condense(self.f_well)

    def _u(self, u, f):
        """``f`` on each component of u (dof ``node * 3 + component``)."""
        return f(u.reshape(-1, 3).T).T.reshape(-1)

    def mass(self, p):
        return self.c1.condense(super().mass(self.c1.distribute(p)))

    def laplace(self, p):
        return self.c1.condense(super().laplace(self.c1.distribute(p)))

    def elasticity(self, u):
        return self._u(super().elasticity(self._u(u, self.c2.distribute)),
                       self.c2.condense)

    def coupling(self, p):
        return self._u(super().coupling(self.c1.distribute(p)),
                       self.c2.condense)

    def projection_rhs(self, u):
        return self.c1.condense(super().projection_rhs(
            self._u(u, self.c2.distribute)))


class Reader:
    """The program's fields of one mesh, its nodes in its order at ``x_p``
    (Q1) and ``x_u`` (Q2), on the reference's nodes of ``P``."""

    def __init__(self, P: Problem, x_p, x_u):
        self.P = P
        self.at, self.first = {}, {}
        for name, space, x in (("p", P.c1, x_p), ("u", P.c2, x_u)):
            at = P.mesh.index_of(space, x)
            nodes, first = np.unique(at, return_index=True)
            if nodes.shape[0] != space.n:
                raise ValueError("a node of the reference's space has no "
                                 "program node")
            self.at[name] = torch.as_tensor(at, device=P.device)
            self.first[name] = torch.as_tensor(first, device=P.device)

    def __call__(self, fields: dict):
        """``fields`` on the reference's nodes, each hanging value set from
        its masters (the first program node at a node gives its value);
        and the hanging gap: the largest distance of a program value from
        the reference's value at its node, over the largest value of its
        field."""
        out, gap = {}, 0.0
        for name, v in fields.items():
            v = v.detach().to(device=self.P.device, dtype=torch.float64)
            kind = "u" if name == "u" else "p"
            space = self.P.c2 if kind == "u" else self.P.c1
            if kind == "u":
                v = v.reshape(-1, 3).T
            full = space.distribute(v[..., self.first[kind]])
            scale = float(v.abs().max())
            if scale > 0:
                gap = max(gap, float((v - full[..., self.at[kind]])
                                     .abs().max()) / scale)
            out[name] = full.T.reshape(-1) if kind == "u" else full
        return out, gap
