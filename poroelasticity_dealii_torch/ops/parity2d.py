"""The 2D parity-resident operator layout, the 2D production mechanics
path (port of ``poroelasticity_dealii_tpu/ops/parity2d.py:54-461``), with
the per-rank apply of its y-slab sharded form
(:func:`make_apply_parity_local`, which
:func:`..parallel.rows.make_parity_ops_sharded` drives).

The layout ("parity" classes, degree 2): the node index along an axis is
``i = 2*cell + o`` with offset ``o`` in {0, 1, 2}; offsets 0 and 2 share
parity class 0 (length n+1), offset 1 is class 1 (length n, zero-padded to
n+1).  A flat x-fastest comp-interleaved vector becomes a
``(nc, 2, 2, n+1, n+1)`` tensor
``Xp[c, oy, ox, iy, ix] = x[((2*iy+oy)*gx + (2*ix+ox))*nc + c]``.

In this layout every per-cell local-node gather is a contiguous slice of a
class array, an operator apply is one ``(N_out, N_in) @ (N_in, n_cells)``
product (``torch.matmul`` in full IEEE float32: TF32 is off, as the
reference's ``Precision.HIGHEST``), and the scatter back is one slice-add
per local node into a zeroed output.  Each slice-add touches every entry at
most once, in a fixed order, so an apply holds no atomics and is bitwise
repeatable (the mechanics skip-if-unchanged rule compares right-hand sides
bitwise).  ``to_parity``/``from_parity`` are zero-padded bijective layout
maps, and no apply, transfer or mask writes the class-1 padding, so dots,
norms, axpys and elementwise masks in parity layout equal their flat
counterparts exactly: a whole CG or Richardson solve runs inside the
layout, and the conversions are paid once per solve.

:class:`ElasticityParityOps` has the attribute and method names of the 3D
rows kit (:class:`.comp_major.ElasticityRowOps`), so the fixed-stress
solver's rows branch runs on it unchanged.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from .shape import node_lattice


def _comp_major(M: np.ndarray, nci: int, nco: int) -> np.ndarray:
    """An element matrix reordered from interleaved (node*nc + c) indexing
    to comp-major (c*n_nodes + node) on both sides."""
    n_in = M.shape[1] // nci
    n_out = M.shape[0] // nco
    cols = np.array([node * nci + c
                     for c in range(nci) for node in range(n_in)])
    rows = np.array([node * nco + c
                     for c in range(nco) for node in range(n_out)])
    return np.asarray(M, np.float64)[np.ix_(rows, cols)]


def _cls_start(o: int):
    """Axis offset o in {0, 1, 2} -> (parity class, slice start)."""
    return (o, 0) if o < 2 else (0, 1)


_LAT_Q2 = node_lattice(2, 2)
_LAT_Q1 = node_lattice(1, 2)
# per Q2 local node (x-fastest): (class y, start y, class x, start x)
_Q2_SLOTS = tuple(_cls_start(int(o[1])) + _cls_start(int(o[0]))
                  for o in _LAT_Q2)


def to_parity_np(x, n: int, nc: int) -> np.ndarray:
    """Numpy :func:`to_parity`, for set-up constants (masks, diagonals)."""
    g, n1 = 2 * n + 1, n + 1
    X = np.pad(np.asarray(x, np.float64).reshape(g, g, nc),
               ((0, 1), (0, 1), (0, 0)))
    X = X.reshape(n1, 2, n1, 2, nc)
    return np.ascontiguousarray(X.transpose(4, 1, 3, 0, 2))


def to_parity(x: torch.Tensor, n: int, nc: int) -> torch.Tensor:
    """Flat x-fastest comp-interleaved vector -> (nc, 2, 2, n+1, n+1)."""
    g, n1 = 2 * n + 1, n + 1
    X = F.pad(x.reshape(g, g, nc), (0, 0, 0, 1, 0, 1))
    X = X.reshape(n1, 2, n1, 2, nc)
    return X.permute(4, 1, 3, 0, 2).contiguous()


def from_parity(Xp: torch.Tensor, n: int, nc: int) -> torch.Tensor:
    """Exact inverse of :func:`to_parity` (drops the zero padding)."""
    g, n1 = 2 * n + 1, n + 1
    X = Xp.permute(3, 1, 4, 2, 0).reshape(2 * n1, 2 * n1, nc)
    return X[:g, :g].reshape(-1)


def _gather_q2(Xp: torch.Tensor, n: int, nc: int) -> torch.Tensor:
    """Parity tensor -> per-cell operand (nc * 9, n*n): 9 contiguous
    slices, stacked comp-major."""
    pieces = [Xp[:, cy, cx, sy:sy + n, sx:sx + n]
              for cy, sy, cx, sx in _Q2_SLOTS]
    return torch.stack(pieces, 1).reshape(nc * 9, n * n)


def _scatter_q2(Ye: torch.Tensor, n: int, nc: int) -> torch.Tensor:
    """Per-cell results (nc, 9, n, n) -> parity tensor: one slice-add per
    local node into zeros, in local-node order (the padding stays 0)."""
    out = Ye.new_zeros((nc, 2, 2, n + 1, n + 1))
    for node, (cy, sy, cx, sx) in enumerate(_Q2_SLOTS):
        out[:, cy, cx, sy:sy + n, sx:sx + n] += Ye[:, node]
    return out


def _const(a, dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float64), dtype=dtype,
                           device=device).contiguous()


def make_apply_parity(element_matrix: np.ndarray, n: int, nc: int, dtype,
                      device):
    """Unconstrained Q2 -> Q2 operator apply, parity -> parity."""
    Kr = _const(_comp_major(element_matrix, nc, nc), dtype, device)

    def apply_p(Xp):
        Ye = Kr @ _gather_q2(Xp, n, nc)
        return _scatter_q2(Ye.reshape(nc, 9, n, n), n, nc)

    return apply_p


def make_apply_parity_local(element_matrix: np.ndarray, n: int, Ly: int,
                            nc: int, dtype, device):
    """``apply_local(xl, nv)``: one rank's y-slab apply of the sharded
    parity kit (``make_apply_parity_local`` of the reference).

    ``xl``: ``(nc, 2, 2, Ly + 1, n + 1)``, the rank's ``Ly`` iy-rows plus
    one halo row (the y+ neighbour's first row); ``nv``: the rank's count
    of real cell rows (tail ranks own padding rows).  Cell rows at or past
    ``nv`` contribute nothing, whatever the halo row holds.  Returns
    ``(nc, 2, 2, Ly + 1, n + 1)``: the slab's contributions, row ``Ly``
    the band for the y+ neighbour's first row.  The gather, the (18, 18)
    product and the slice-add scatter of :func:`make_apply_parity`,
    restricted to the slab's real cell rows."""
    Kr = _const(_comp_major(element_matrix, nc, nc), dtype, device)

    def apply_local(xl, nv: int):
        out = xl.new_zeros((nc, 2, 2, Ly + 1, n + 1))
        if nv <= 0:
            return out
        U = torch.stack([xl[:, cy, cx, sy:sy + nv, sx:sx + n]
                         for cy, sy, cx, sx in _Q2_SLOTS], 1)
        Ye = (Kr @ U.reshape(nc * 9, nv * n)).reshape(nc, 9, nv, n)
        for node, (cy, sy, cx, sx) in enumerate(_Q2_SLOTS):
            out[:, cy, cx, sy:sy + nv, sx:sx + n] += Ye[:, node]
        return out

    return apply_local


# ---------------------------------------------------------------------------
# parity-resident Q2 grid transfers (GMG level boundaries)
# ---------------------------------------------------------------------------
#
# Fine node o in 0..4 per axis within a coarse cell (global fine node
# 4*cc + o) has fine parity class p = o % 2 and in-class index
# i = 2*cc + j, j = o // 2.  Splitting i = 2q + r makes the per-coarse-cell
# scatter contiguous: q = cc + (j >> 1), r = j & 1, a slice-add into the
# (q, r)-split class tensor; the split itself is one pad and a reshape.

_O2QUAD = [(0, 0, 0), (1, 0, 0), (0, 1, 0), (1, 1, 0), (0, 0, 1)]
#           o=0        o=1        o=2        o=3        o=4
#          (class p, sub-index r, slice start s) per fine local offset


def _q2_refine_matrix() -> np.ndarray:
    """(25, 9) coarse-Q2 nodal interpolation onto the 5x5 fine nodes of
    one coarse cell (both sides x-fastest; fine node f at reference
    coordinates (fx/4, fy/4), coarse 1D Q2 nodes at 0, 1/2, 1)."""
    pts = np.linspace(0.0, 1.0, 5)
    phi = np.stack([2.0 * (pts - 0.5) * (pts - 1.0),
                    4.0 * pts * (1.0 - pts),
                    2.0 * pts * (pts - 0.5)])           # (3 nodes, 5 pts)
    M = np.zeros((25, 9))
    for f in range(25):
        fy, fx = f // 5, f % 5
        for c in range(9):
            cy, cx = c // 3, c % 3
            M[f, c] = phi[cy, fy] * phi[cx, fx]
    return M


# per fine local node f of a coarse cell: (py, px, ry, rx, sy, sx)
_F_SLOTS = tuple((_O2QUAD[f // 5][0], _O2QUAD[f % 5][0],
                  _O2QUAD[f // 5][1], _O2QUAD[f % 5][1],
                  _O2QUAD[f // 5][2], _O2QUAD[f % 5][2]) for f in range(25))


def make_parity_transfers(n_coarse: int, nc: int, dtype, device):
    """Raw (unmasked, multiplicity-unnormalised) Q2 GMG transfers in parity
    layout: ``(raw_prolong, raw_restrict, mult_np)`` with

    * ``raw_prolong``: coarse parity -> fine parity, a per-coarse-cell
      slice-add of the 25 interpolated fine-node values (summed at fine
      nodes that coarse cells share: divide by ``mult_np``);
    * ``raw_restrict``: its exact transpose (fine parity -> coarse);
    * ``mult_np``: numpy, the per-fine-entry contribution count in parity
      layout (``raw_prolong(ones)``; 0 at the class-1 padding).

    The caller composes P = diag(ff/mult) raw_p diag(cf) and R = P^T, the
    operators of :func:`..solvers.multigrid.build_gmg`'s flat transfers."""
    nC, nF = n_coarse, 2 * n_coarse
    M = _q2_refine_matrix()                             # (25, 9)
    Mc = _const(np.kron(np.eye(nc), M), dtype, device)  # comp-major
    McT = _const(np.kron(np.eye(nc), M.T), dtype, device)
    q1 = nC + 1

    def raw_prolong(Xc):
        Ye = (Mc @ _gather_q2(Xc, nC, nc)).reshape(nc, 25, nC, nC)
        # (nc, py, px, qy, ry, qx, rx): the fine in-class index is 2q + r
        acc = Ye.new_zeros((nc, 2, 2, q1, 2, q1, 2))
        for f, (py, px, ry, rx, sy, sx) in enumerate(_F_SLOTS):
            acc[:, py, px, sy:sy + nC, ry, sx:sx + nC, rx] += Ye[:, f]
        return acc.reshape(nc, 2, 2, 2 * q1, 2 * q1)[
            :, :, :, :nF + 1, :nF + 1].contiguous()

    def raw_restrict(Rf):
        R6 = F.pad(Rf, (0, 1, 0, 1)).reshape(nc, 2, 2, q1, 2, q1, 2)
        U = torch.stack([R6[:, py, px, sy:sy + nC, ry, sx:sx + nC, rx]
                         for py, px, ry, rx, sy, sx in _F_SLOTS], 1)
        Zc = McT @ U.reshape(nc * 25, nC * nC)
        return _scatter_q2(Zc.reshape(nc, 9, nC, nC), nC, nc)

    mult = np.zeros((nc, 2, 2, q1, 2, q1, 2))
    for py, px, ry, rx, sy, sx in _F_SLOTS:
        mult[:, py, px, sy:sy + nC, ry, sx:sx + nC, rx] += 1.0
    mult = mult.reshape(nc, 2, 2, 2 * q1, 2 * q1)[:, :, :, :nF + 1, :nF + 1]
    return raw_prolong, raw_restrict, np.ascontiguousarray(mult)


def make_coupling_parity(coupling_matrix: np.ndarray, n: int, nc: int,
                         dtype, device):
    """p (flat Q1 scalar grid) -> coupling RHS directly in parity layout.
    The Q1 input needs no parity split: its 4 local-node gathers are
    contiguous slices of the (n+1, n+1) node grid."""
    Cr = _const(_comp_major(coupling_matrix, 1, nc), dtype, device)
    g1 = n + 1

    def coupling_p(p):
        P = p.reshape(g1, g1)
        U = torch.stack([P[int(o[1]):int(o[1]) + n, int(o[0]):int(o[0]) + n]
                         for o in _LAT_Q1], 0).reshape(4, n * n)
        return _scatter_q2((Cr @ U).reshape(nc, 9, n, n), n, nc)

    return coupling_p


def make_projection_parity(projection_matrix: np.ndarray, n: int, nc: int,
                           dtype, device):
    """u (parity) -> strain-projection RHS (C, n_pdofs), every Voigt entry
    in one product."""
    C = projection_matrix.shape[0] // 4
    Pr = _const(_comp_major(projection_matrix, nc, C), dtype, device)
    g1 = n + 1

    def projection_p(Xp):
        Ye = (Pr @ _gather_q2(Xp, n, nc)).reshape(C, 4, n, n)
        out = Ye.new_zeros((C, g1, g1))
        for i, o in enumerate(_LAT_Q1):
            oy, ox = int(o[1]), int(o[0])
            out[:, oy:oy + n, ox:ox + n] += Ye[:, i]
        return out.reshape(C, g1 * g1)

    return projection_p


@dataclasses.dataclass
class ElasticityParityOps:
    """The parity layout as the mechanics DOF-vector format, with the
    operators the fixed-stress step applies in it: the rows kit's names
    (:class:`.comp_major.ElasticityRowOps`)."""
    n: int
    nc: int
    apply_rows: object             # unconstrained K: parity -> parity
    coupling_rows: object          # flat Q1 p -> parity RHS
    projection_rows: object        # parity u -> (C, n_pdofs)
    free_mask_rows: torch.Tensor   # Dirichlet mask in parity (padding = 0)
    diag_rows: torch.Tensor        # Jacobi diagonal in parity (padding = 1)
    block_precond: object = None   # none in 2D (JAX's parity kit has none)

    def to_rows(self, u_flat):
        return to_parity(u_flat, self.n, self.nc)

    def from_rows(self, R):
        return from_parity(R, self.n, self.nc)

    def constrained_apply(self, x):
        """``m * A(m x) + (1 - m) x``: identity on constrained dofs."""
        m = self.free_mask_rows
        return self.apply_rows(x * m) * m + x * (1.0 - m)

    def free_apply(self, x):
        """``m * A x`` for x already in the free subspace (zero at
        constrained entries and padding): equals :meth:`constrained_apply`
        there, one mask pass cheaper."""
        return self.apply_rows(x) * self.free_mask_rows

    def local_rows(self, R):
        """The part of full parity tensor ``R`` this kit holds: all of
        it."""
        return R


def make_parity_ops(element_matrix: np.ndarray, n: int, free_mask_u,
                    diag_elasticity, coupling_matrix: np.ndarray,
                    projection_matrix: np.ndarray, dtype, device,
                    nc: int = 2) -> ElasticityParityOps:
    """The parity-layout mechanics kit of a 2D structured Q2 grid with
    ``n`` cells per axis; set-up constants are built in numpy and moved
    once."""
    free_mask_u = np.asarray(free_mask_u, np.float64)
    ones_p = to_parity_np(np.ones(free_mask_u.shape), n, nc)
    diag_p = to_parity_np(diag_elasticity, n, nc) + (1.0 - ones_p)
    return ElasticityParityOps(
        n=n, nc=nc,
        apply_rows=make_apply_parity(element_matrix, n, nc, dtype, device),
        coupling_rows=make_coupling_parity(coupling_matrix, n, nc, dtype,
                                           device),
        projection_rows=make_projection_parity(projection_matrix, n, nc,
                                               dtype, device),
        free_mask_rows=_const(to_parity_np(free_mask_u, n, nc), dtype,
                              device),
        diag_rows=_const(diag_p, dtype, device))
