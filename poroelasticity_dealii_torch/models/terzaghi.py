"""Terzaghi 1D consolidation — analytical verification problem.

BASELINE.json config #1 / SURVEY §4 integration tier.  A uniform column with
uniform initial excess pore pressure p0, drained at the top boundary,
impermeable elsewhere, under uniaxial-strain mechanics (rollers on the sides
and bottom, traction-free top).  The coupled Biot system then reduces
exactly to 1D pressure diffusion

    (1/M + b²/(λ + 2G)) ∂p/∂t = (k/μ) ∂²p/∂z²,

i.e. consolidation coefficient ``cv = (k/μ) / (1/M + b²/(λ+2G))`` with the
uniaxial (constrained) modulus λ+2G, and the classic series solution

    p(z, t) = p0 (4/π) Σ_{m odd} (1/m) sin(mπz/2H) exp(-(mπ/2H)² cv t)

with z the distance from the drained boundary and H the drainage length.

NOTE: this verifies the *corrected* coupling mode
(``Volumetric strain resync = true``).  The reference-faithful quirk mode
(SURVEY §2.1.4) does not solve the Biot equations — its eps_v never follows
the mechanics — and is verified separately against an independent 1D
finite-difference replication of its exact update equations
(tests/test_terzaghi.py).
"""

from __future__ import annotations


import numpy as np

from ..config import InputData, from_entries


def consolidation_coefficient(data: InputData) -> float:
    kv = data.lame_constant + 2.0 * data.shear_modulus  # uniaxial modulus
    storage = 1.0 / data.m_modulus + data.biot_coef ** 2 / kv
    return (data.perm / data.visc) / storage


def terzaghi_pressure(z, t: float, cv: float, H: float, p0: float,
                      n_terms: int = 400):
    """Series solution; z = distance from the drained boundary (0..H)."""
    z = np.asarray(z, dtype=np.float64)
    s = np.zeros_like(z)
    for j in range(n_terms):
        m = 2 * j + 1
        s += (4.0 / np.pi / m) * np.sin(m * np.pi * z / (2.0 * H)) \
            * np.exp(-((m * np.pi / (2.0 * H)) ** 2) * cv * t)
    return p0 * s


def terzaghi_config(height: float = 10.0, level: int = 4,
                    p0: float = 1e5, dt: float = 25.0, t_max: float = 250.0,
                    resync: bool = True) -> InputData:
    """2D column (square domain, x-invariant solution): rollers on sides and
    bottom, free drained top (label 3), no well."""
    data = from_entries({
        ("Mesh", "Dimensions"): "2",
        ("Mesh", "Domain size"): f"{height}, {height}",
        ("Mesh", "Initial refinement level"): str(level),
        ("Properties", "Young modulus"): "1.4e10",
        ("Properties", "Poisson ratio"): "0.3",
        ("Properties", "Biot coefficient"): "0.9",
        ("Properties", "Permeability"): "10",
        ("Properties", "Fluid compressibility"): "5.8e-10",
        ("Properties", "Porosity"): "0.3",
        ("Properties", "Viscosity"): "1e-3",
        ("Properties", "Flow rate"): "0",
        ("Properties", "Well radius"): "0.1",
        ("In situ", "Initial pressure"): str(p0),
        ("In situ", "Displacement boundary labels"): "0, 1, 2",
        ("In situ", "Displacement boundary components"): "0, 0, 1",
        ("In situ", "Displacement boundary values"): "0, 0, 0",
        ("In situ", "Pressure boundary labels"): "3",
        ("In situ", "Pressure boundary values"): "0",
        ("Solver", "Time step"): str(dt),
        ("Solver", "Time max"): str(t_max),
        ("TPU", "Output VTK"): "false",
        ("TPU", "Volumetric strain resync"): "true" if resync else "false",
    })
    return data


def quirk_mode_1d_reference(p_init: float, n_nodes: int, H: float,
                            data: InputData, dt: float, n_steps: int,
                            drained_top: bool = True) -> np.ndarray:
    """Independent 1D FEM replication of the REFERENCE's exact quirk-mode
    update equation (for parity testing the default mode):

        M [ (pⁿ⁺¹ - pⁿ)/(M_biot Δt) + (b²/K)(pⁿ⁺¹ - p⁰)/Δt ] + (k/μ) L pⁿ⁺¹ = 0

    with consistent 1D Q1 mass/stiffness matrices on a uniform grid; the
    drained node is eliminated.  Returns pressure profile after n_steps.
    """
    h = H / (n_nodes - 1)
    # 1D Q1 consistent mass and laplace matrices
    M = np.zeros((n_nodes, n_nodes))
    L = np.zeros((n_nodes, n_nodes))
    for e in range(n_nodes - 1):
        M[e:e + 2, e:e + 2] += h / 6.0 * np.array([[2, 1], [1, 2]])
        L[e:e + 2, e:e + 2] += 1.0 / h * np.array([[1, -1], [-1, 1]])
    a_m = 1.0 / data.m_modulus
    a_k = data.biot_coef ** 2 / data.bulk_modulus
    kmu = data.perm / data.visc
    free = np.ones(n_nodes, dtype=bool)
    if drained_top:
        free[-1] = False
    # p0 is the BC-applied initial field (the solver pins drained nodes at
    # t=0 too), so constrained columns vanish from every term.
    p0 = np.full(n_nodes, p_init)
    p0[~free] = 0.0
    p = p0.copy()
    ff = np.ix_(free, free)
    A = (a_m + a_k) / dt * M[ff] + kmu * L[ff]
    for _ in range(n_steps):
        rhs = M[ff] @ ((a_m / dt) * p[free] + (a_k / dt) * p0[free])
        p[free] = np.linalg.solve(A, rhs)
    return p
