"""Plain finite elements of the 3D Q2/Q1 Biot problem on hexahedral meshes.

Written from the equations, in plain PyTorch, apart from the program under
test: it imports nothing of it.  It works on the mesh arrays and the deck
values that the harness hands the program, builds its own node numbering,
geometry, boundary data and well source, and applies the operators
matrix-free (gather the cell values, contract with the shape tables at the
Gauss points, scatter back with ``index_add_``):

* displacement: vector Q2 (27 nodes a cell), dof ``node * 3 + component``;
* pressure: Q1 (the mesh vertices);
* quadrature: ``QGauss(degree + 1)`` of each space, as deal.II's reference
  solver integrates: 3 points per axis for the elasticity and the coupling,
  2 for the mass, the Laplacian, the well source and the strain projection
  (the projection's right-hand side takes the Q2 gradients at the Q1 rule);
* the cell map is the trilinear map of each cell's 8 corners.

Two global numberings of the Q2 nodes are known, the two output formats
of the program: ``lattice`` (a structured n^3 box: the (2n+1)^3 node
lattice, x fastest) and ``entities`` (any conforming mesh: the vertices,
then each edge's midpoint in the order of its sorted vertex pair, each
face's centre in the order of its sorted vertex quadruple, then each
cell's centre in cell order).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# the deck's permeability unit, millidarcy, in m^2 (deal.II reference,
# InputDataPoroel.h)
MILLIDARCY = 9.869233e-16
# the strains' output order (xx, xy, xz, yy, yz, zz) and its parts
VOIGT = ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))
VOLUMETRIC = (0, 3, 5)
SHEAR = (1, 2, 4)


# --------------------------------------------------------------- the deck

@dataclasses.dataclass(frozen=True)
class Physics:
    """The deck values the equations read, with the derived moduli."""
    young: float
    poisson: float
    biot: float
    perm: float               # m^2
    visc: float
    poro: float
    f_comp: float
    p_init: float
    r_well: float
    flow_rate: float
    dt: float
    dirichlet: tuple          # ((label, component, value), ...)
    pressure_tol: float
    fss_tol: float
    max_fss: int
    max_pressure: int
    mech_cg_tol: float
    mech_cg_relative: bool
    pressure_cg_tol: float
    projection_cg_tol: float
    cg_max: int

    @property
    def lam(self) -> float:
        e, nu = self.young, self.poisson
        return e * nu / ((1.0 + nu) * (1.0 - 2.0 * nu))

    @property
    def mu(self) -> float:
        return 0.5 * self.young / (1.0 + self.poisson)

    @property
    def bulk(self) -> float:
        return self.lam + 2.0 / 3.0 * self.mu

    @property
    def biot_modulus(self) -> float:
        """M: 1/M = phi c_f + (b - phi) / K_s, K_s = K / (1 - b)."""
        ks = self.bulk / (1.0 - self.biot)
        n = ks / (self.biot - self.poro)
        return (n / self.f_comp) / (n * self.poro + 1.0 / self.f_comp)


def _floats(text: str) -> list:
    return [float(v) for v in str(text).split(",") if v.strip()]


def physics_from_deck(deck: dict) -> Physics:
    """:class:`Physics` of a deck given as ``{subsection: {key: value}}``
    (the configuration file's ``deck``); an entry the deck leaves out
    takes the source's default.  Raises on a deck entry whose physics this
    reference does not implement."""
    def get(sub, key, default=None):
        v = deck.get(sub, {}).get(key, default)
        if v is None:
            raise KeyError(f"the deck lacks {sub}/{key}")
        return v

    situ = deck.get("In situ", {})
    for key in ("Stress boundary labels", "Pressure boundary labels"):
        if _floats(situ.get(key, "")):
            raise NotImplementedError(f"the reference has no {key}")
    if int(deck.get("TPU", {}).get("Gravity direction", -1)) >= 0:
        raise NotImplementedError("the reference has no gravity load")
    if deck.get("TPU", {}).get("Volumetric strain resync", "false") != \
            "false":
        raise NotImplementedError("the reference runs the deck's "
                                  "predictor-only volumetric strain")
    labels = [int(v) for v in _floats(get("In situ",
                                          "Displacement boundary labels"))]
    comps = [int(v) for v in _floats(
        get("In situ", "Displacement boundary components"))]
    values = _floats(get("In situ", "Displacement boundary values"))
    tpu = deck.get("TPU", {})
    return Physics(
        young=float(get("Properties", "Young modulus")),
        poisson=float(get("Properties", "Poisson ratio")),
        biot=float(get("Properties", "Biot coefficient")),
        perm=float(get("Properties", "Permeability")) * MILLIDARCY,
        visc=float(get("Properties", "Viscosity")),
        poro=float(get("Properties", "Porosity")),
        f_comp=float(get("Properties", "Fluid compressibility")),
        p_init=float(get("In situ", "Initial pressure")),
        r_well=float(get("Properties", "Well radius")),
        flow_rate=float(get("Properties", "Flow rate")),
        dt=float(get("Solver", "Time step")),
        dirichlet=tuple(zip(labels, comps, values)),
        pressure_tol=float(get("Solver", "Pressure tolerance", 1e-8)),
        fss_tol=float(get("Solver", "FSS tolerance", 1e-8)),
        max_fss=int(deck.get("Solver", {}).get("Max FSS iterations", 50)),
        max_pressure=int(deck.get("Solver", {}).get(
            "Max pressure iterations", 50)),
        mech_cg_tol=float(tpu.get("Mechanics CG tolerance", 1e-12)),
        mech_cg_relative=tpu.get("Mechanics CG relative", "false") == "true",
        pressure_cg_tol=float(tpu.get("Pressure CG tolerance", 1e-8)),
        projection_cg_tol=float(tpu.get("Projection CG tolerance", 1e-8)),
        cg_max=int(tpu.get("CG max iterations", 1000)))


# ------------------------------------------------------ shapes and rules

def gauss(n: int):
    """n-point Gauss rule per axis on [0, 1]^3, points x fastest."""
    x, w = np.polynomial.legendre.leggauss(n)
    x, w = 0.5 * (x + 1.0), 0.5 * w
    i = np.arange(n)
    iz, iy, ix = np.meshgrid(i, i, i, indexing="ij")
    pts = np.stack([x[ix], x[iy], x[iz]], -1).reshape(-1, 3)
    wts = (w[ix] * w[iy] * w[iz]).reshape(-1)
    return pts, wts


def _lagrange(nodes, x):
    """1D Lagrange values and derivatives (len(x), len(nodes))."""
    x = np.asarray(x, float)[:, None]
    nodes = np.asarray(nodes, float)
    val = np.ones((x.shape[0], len(nodes)))
    der = np.zeros_like(val)
    for i, xi in enumerate(nodes):
        others = [xj for j, xj in enumerate(nodes) if j != i]
        for xj in others:
            val[:, i] *= (x[:, 0] - xj) / (xi - xj)
        for m, xm in enumerate(others):
            term = np.full(x.shape[0], 1.0 / (xi - xm))
            for xj in others:
                if xj != xm:
                    term *= (x[:, 0] - xj) / (xi - xj)
            der[:, i] += term
    return val, der


def tables(degree: int, pts):
    """Values (Q, N) and reference gradients (Q, N, 3) of the Q_degree
    shape functions at ``pts``; local nodes x fastest."""
    nodes = np.linspace(0.0, 1.0, degree + 1)
    v = [_lagrange(nodes, pts[:, a]) for a in range(3)]
    k = degree + 1
    i = np.arange(k)
    iz, iy, ix = (a.reshape(-1) for a in np.meshgrid(i, i, i, indexing="ij"))
    val = v[0][0][:, ix] * v[1][0][:, iy] * v[2][0][:, iz]
    grad = np.stack([v[0][1][:, ix] * v[1][0][:, iy] * v[2][0][:, iz],
                     v[0][0][:, ix] * v[1][1][:, iy] * v[2][0][:, iz],
                     v[0][0][:, ix] * v[1][0][:, iy] * v[2][1][:, iz]], -1)
    return val, grad


# --------------------------------------------------------- Q2 numbering

# local Q2 node (a, b, c), a fastest, each 0, 1 or 2
_LAT = np.array([(a, b, c) for c in range(3) for b in range(3)
                 for a in range(3)])


def _corners_of(lat) -> list:
    """The cell corners (0..7, x bit first) a Q2 lattice node lies
    between: 1 for a vertex, 2 an edge, 4 a face, 8 the centre."""
    choices = [[0] if t == 0 else [1] if t == 2 else [0, 1] for t in lat]
    return [cx + 2 * cy + 4 * cz for cz in choices[2] for cy in choices[1]
            for cx in choices[0]]


def q2_numbering(cells: np.ndarray, n_vertices: int, order: str,
                 n: int = None):
    """(cell_nodes (E, 27) int64, node count) of the Q2 space: ``order``
    ``lattice`` (cells of an n^3 box in x-fastest order, n given) or
    ``entities`` (see the module docstring)."""
    cells = np.asarray(cells, np.int64)
    E = cells.shape[0]
    if order == "lattice":
        g = 2 * n + 1
        e = np.arange(E)
        cx, cy, cz = e % n, (e // n) % n, e // (n * n)
        out = ((2 * cx[:, None] + _LAT[None, :, 0])
               + g * ((2 * cy[:, None] + _LAT[None, :, 1])
                      + g * (2 * cz[:, None] + _LAT[None, :, 2])))
        return out, g ** 3
    if order != "entities":
        raise ValueError(f"unknown Q2 numbering {order!r}")
    out = np.zeros((E, 27), np.int64)
    groups = {1: [], 2: [], 4: [], 8: []}
    for a, lat in enumerate(_LAT):
        groups[len(_corners_of(lat))].append(a)
    for a in groups[1]:
        out[:, a] = cells[:, _corners_of(_LAT[a])[0]]
    base = n_vertices
    for size in (2, 4):
        keys = np.stack([np.sort(cells[:, _corners_of(_LAT[a])], axis=1)
                         for a in groups[size]], axis=1)   # (E, k, size)
        uniq, inv = np.unique(keys.reshape(-1, size), axis=0,
                              return_inverse=True)
        inv = inv.reshape(E, len(groups[size]))
        for j, a in enumerate(groups[size]):
            out[:, a] = base + inv[:, j]
        base += uniq.shape[0]
    out[:, groups[8][0]] = base + np.arange(E)
    return out, base + E


# ------------------------------------------------------------- the problem

def _index_add(n: int, index, values):
    """Sum ``values (..., E, k)`` into ``(..., n)`` at ``index (E, k)``."""
    lead = values.shape[:-2]
    out = values.new_zeros(lead + (n,))
    return out.index_add_(-1, index.reshape(-1),
                          values.reshape(lead + (-1,)))


class Problem:
    """The discrete operators, boundary data and source of one mesh and
    deck, on ``device`` in ``dtype``.  ``vertices (nv, 3)``, ``cells
    (E, 8)`` corners x bit first; ``cell_nodes (E, 27)`` the Q2 numbering
    (:func:`q2_numbering`)."""

    def __init__(self, vertices, cells, cell_nodes, n_q2: int,
                 phys: Physics, dtype=torch.float64, device="cpu"):
        self.phys, self.dtype = phys, dtype
        self.device = torch.device(device)
        dev = dict(dtype=dtype, device=self.device)
        V = np.asarray(vertices, np.float64)
        self.n_p, self.n_q2 = V.shape[0], int(n_q2)
        self.n_u = 3 * self.n_q2
        self.cells = torch.as_tensor(np.asarray(cells, np.int64),
                                     device=self.device)
        self.cn2 = torch.as_tensor(np.asarray(cell_nodes, np.int64),
                                   device=self.device)
        X = torch.as_tensor(V, dtype=torch.float64,
                            device=self.device)[self.cells]   # (E, 8, 3)
        self.rule = {}
        for npts in (2, 3):
            pts, wts = gauss(npts)
            n1, d1 = tables(1, pts)
            n2, d2 = tables(2, pts)
            t = lambda a: torch.as_tensor(a, dtype=torch.float64,  # noqa
                                          device=self.device)
            jac = torch.einsum("evd,qva->eqda", X, t(d1))   # dx_d / dxi_a
            jinv = torch.linalg.inv(jac)                    # dxi_a / dx_d
            jxw = torch.linalg.det(jac).abs() * t(wts)
            xq = torch.einsum("qv,evd->eqd", t(n1), X)
            self.rule[npts] = {k: v.to(dtype) for k, v in dict(
                n1=t(n1), d1=t(d1), n2=t(n2), d2=t(d2), jinv=jinv,
                jxw=jxw, xq=xq).items()}
        # Q2 node coordinates (the trilinear map at the lattice points)
        n1_nodes, _ = tables(1, _LAT / 2.0)
        xn = torch.einsum("nv,evd->end", torch.as_tensor(
            n1_nodes, dtype=torch.float64, device=self.device), X)
        x2 = torch.zeros((self.n_q2, 3), dtype=torch.float64,
                         device=self.device)
        x2[self.cn2.reshape(-1)] = xn.reshape(-1, 3)
        self._dirichlet(x2, V)
        self._well()
        self._diagonals()

    # ---- boundary data and source ---------------------------------------
    def _dirichlet(self, x2, V):
        """First-listed-wins pinning of (node, component) on the labelled
        box faces (label 2 * axis + side)."""
        lo, hi = V.min(0), V.max(0)
        tol = 1e-9 * float(np.linalg.norm(hi - lo))
        free = torch.ones(self.n_u, dtype=torch.bool, device=self.device)
        val = torch.zeros(self.n_u, dtype=torch.float64, device=self.device)
        for label, comp, value in self.phys.dirichlet:
            axis, side = divmod(int(label), 2)
            plane = hi[axis] if side else lo[axis]
            nodes = torch.nonzero((x2[:, axis] - plane).abs() <= tol)[:, 0]
            dofs = nodes * 3 + int(comp)
            newly = dofs[free[dofs]]
            val[newly] = value
            free[newly] = False
        self.free_u = free.to(self.dtype)
        self.dirichlet_u = val.to(self.dtype)

    def _well(self):
        """f_well: the disc well through the axis x = y = 0 of radius r,
        source -Q / (pi r^2) inside, at the Q1 rule's points."""
        ph, r = self.phys, self.rule[2]
        xq = r["xq"]
        inside = xq[..., 0] ** 2 + xq[..., 1] ** 2 <= ph.r_well ** 2
        src = inside.to(torch.float64) \
            * (-ph.flow_rate / (np.pi * ph.r_well ** 2))
        src = src.to(self.dtype)
        fe = torch.einsum("qi,eq->ei", r["n1"], r["jxw"] * src)
        self.f_well = _index_add(self.n_p, self.cells, fe)

    def _diagonals(self):
        r2, r3 = self.rule[2], self.rule[3]
        g = torch.einsum("qna,eqad->eqnd", r2["d1"], r2["jinv"])
        self.diag_mass = _index_add(self.n_p, self.cells, torch.einsum(
            "eq,qn->en", r2["jxw"], r2["n1"] ** 2))
        self.diag_laplace = _index_add(self.n_p, self.cells, torch.einsum(
            "eq,eqnd->en", r2["jxw"], g * g))
        ph = self.phys
        parts = []
        for s in torch.split(torch.arange(self.cells.shape[0],
                                          device=self.device), 4096):
            gu = torch.einsum("qna,eqad->eqnd", r3["d2"], r3["jinv"][s])
            g2 = gu * gu
            de = (ph.lam + ph.mu) * g2 + ph.mu * g2.sum(-1, keepdim=True)
            parts.append(torch.einsum("eq,eqnc->enc", r3["jxw"][s], de))
        diag = _index_add(self.n_q2, self.cn2, torch.cat(parts).permute(
            2, 0, 1)).transpose(0, 1).reshape(-1)
        self.diag_elasticity = diag

    # ---- applies ----------------------------------------------------------
    def mass(self, p):
        """M p; ``p (..., n_p)``."""
        r = self.rule[2]
        v = torch.einsum("qn,...en->...eq", r["n1"], p[..., self.cells])
        return _index_add(self.n_p, self.cells, torch.einsum(
            "qn,...eq->...en", r["n1"], v * r["jxw"]))

    def laplace(self, p):
        """L p (the stiffness of grad p . grad q)."""
        r = self.rule[2]
        gr = torch.einsum("qna,...en->...eqa", r["d1"], p[..., self.cells])
        gx = torch.einsum("...eqa,eqad->...eqd", gr, r["jinv"])
        back = torch.einsum("...eqd,eqad->...eqa", gx * r["jxw"][..., None],
                            r["jinv"])
        return _index_add(self.n_p, self.cells, torch.einsum(
            "qna,...eqa->...en", r["d1"], back))

    def _grad_u(self, u, npts):
        """grad u at a rule's points, H[e, q, c, d] = du_c / dx_d."""
        r = self.rule[npts]
        ue = u.reshape(self.n_q2, 3)[self.cn2]               # (E, 27, 3)
        gr = torch.einsum("qna,enc->eqac", r["d2"], ue)
        return torch.einsum("eqac,eqad->eqcd", gr, r["jinv"])

    def elasticity(self, u):
        """K u: sigma = lam tr(eps) I + 2 mu eps against eps(v)."""
        ph, r = self.phys, self.rule[3]
        h = self._grad_u(u, 3)
        tr = h.diagonal(dim1=2, dim2=3).sum(-1)
        eye = torch.eye(3, dtype=self.dtype, device=self.device)
        s = ph.mu * (h + h.transpose(2, 3)) + ph.lam * tr[..., None, None] \
            * eye
        s = s * r["jxw"][..., None, None]
        t = torch.einsum("eqcd,eqad->eqac", s, r["jinv"])
        fe = torch.einsum("qna,eqac->enc", r["d2"], t)
        return _index_add(self.n_q2, self.cn2, fe.permute(2, 0, 1)) \
            .transpose(0, 1).reshape(-1)

    def coupling(self, p):
        """b int p div(v): the mechanics load of the pressure."""
        ph, r = self.phys, self.rule[3]
        pq = torch.einsum("qn,en->eq", r["n1"], p[self.cells])
        w = (ph.biot * pq * r["jxw"])[..., None, None] * r["jinv"]
        fe = torch.einsum("qna,eqac->enc", r["d2"], w)
        return _index_add(self.n_q2, self.cn2, fe.permute(2, 0, 1)) \
            .transpose(0, 1).reshape(-1)

    def projection_rhs(self, u):
        """int psi_i eps_c(u) for the six strain components: (6, n_p)."""
        r = self.rule[2]
        h = self._grad_u(u, 2)
        eps = 0.5 * (h + h.transpose(2, 3))
        comps = torch.stack([eps[..., a, b] for a, b in VOIGT], 0)
        return _index_add(self.n_p, self.cells, torch.einsum(
            "qi,ceq->cei", r["n1"], comps * r["jxw"]))

    def flow_residual(self, p, p_old, eps_v, eps_v0):
        """The flow equation's residual: -(M((b/dt)(eps_v - eps_v0) +
        (p - p_old)/(M_b dt)) + (k/mu) L p + f_well)."""
        ph = self.phys
        acc = (ph.biot / ph.dt) * (eps_v - eps_v0) \
            + (p - p_old) / (ph.biot_modulus * ph.dt)
        return -(self.mass(acc) + (ph.perm / ph.visc) * self.laplace(p)
                 + self.f_well)
