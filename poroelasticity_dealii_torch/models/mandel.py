"""Mandel's problem — analytical verification of the fixed-stress coupling.

BASELINE.json config #2 / SURVEY §4 integration tier.  A poroelastic slab
|x| <= a, |y| <= b squeezed between rigid frictionless plates by a constant
force 2F per unit depth, drained at x = ±a.  The non-monotone pressure
response (Mandel-Cryer effect: pressure first *rises* above its initial
undrained value in the center) exists only when the pore-pressure /
mechanics coupling is correct in both directions — which is exactly what
makes it the canonical FSS verification problem.

Solution (Cheng & Detournay 1988 / Abousleiman et al. 1996), with Biot
coefficient alpha, Biot modulus M, drained bulk/shear moduli K and G:

  Ku  = K + alpha^2 M                    (undrained bulk modulus)
  B   = alpha M / Ku                     (Skempton coefficient)
  nu_u = (3 nu + alpha B (1-2 nu)) / (3 - alpha B (1-2 nu))
  c   = (k/mu_f) M (K + 4G/3) / (Ku + 4G/3)        (diffusivity)
  tan(alpha_i) = (1-nu)/(nu_u-nu) * alpha_i        (series roots)

  p(x,t)  = (2 F B (1+nu_u) / (3 a)) * sum_i [ sin a_i /
            (a_i - sin a_i cos a_i) * (cos(a_i x/a) - cos a_i)
            * exp(-a_i^2 c t / a^2) ]
  u_y(y,t) = [ -F (1-nu)/(2 G a) + sum_i F (1-nu_u) sin a_i cos a_i /
            (G a (a_i - sin a_i cos a_i)) * exp(-a_i^2 c t/a^2) ] * y

The quarter-domain FEM setup imposes the rigid plate as a time-dependent
uniform u_y(b, t) Dirichlet value (via the solver's ``bc_scale``), symmetry
rollers on x=0 / y=0, and drainage p=0 at x=a.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
from scipy.optimize import brentq

from ..config import InputData, from_entries


class MandelParams(NamedTuple):
    a: float          # half-width (drainage direction)
    b: float          # half-height
    force: float      # F: half the total plate force per unit depth
    skempton: float
    nu: float
    nu_u: float
    diffusivity: float
    shear: float
    roots: np.ndarray


def mandel_params(data: InputData, a: float, b: float, force: float,
                  n_roots: int = 60) -> MandelParams:
    alpha = data.biot_coef
    M = data.m_modulus
    K = data.bulk_modulus
    G = data.shear_modulus
    nu = data.poisson_ratio
    Ku = K + alpha ** 2 * M
    B = alpha * M / Ku
    nu_u = (3 * nu + alpha * B * (1 - 2 * nu)) / (3 - alpha * B * (1 - 2 * nu))
    c = (data.perm / data.visc) * M * (K + 4 * G / 3) / (Ku + 4 * G / 3)
    eta = (1 - nu) / (nu_u - nu)
    # roots of tan(x) = eta x, one in each interval (i*pi, i*pi + pi/2)
    roots = []
    for i in range(n_roots):
        lo = i * np.pi + 1e-9
        hi = i * np.pi + np.pi / 2 - 1e-9
        f = lambda x: np.tan(x) - eta * x  # noqa: E731
        if np.sign(f(lo)) == np.sign(f(hi)):
            lo = i * np.pi + np.pi / 4
        roots.append(brentq(f, lo, hi, xtol=1e-14))
    return MandelParams(a=a, b=b, force=force, skempton=B, nu=nu, nu_u=nu_u,
                        diffusivity=c, shear=G, roots=np.asarray(roots))


def mandel_pressure(x, t: float, mp: MandelParams) -> np.ndarray:
    x = np.asarray(x, dtype=np.float64)
    s = np.zeros_like(x)
    for ai in mp.roots:
        coef = np.sin(ai) / (ai - np.sin(ai) * np.cos(ai))
        s += coef * (np.cos(ai * x / mp.a) - np.cos(ai)) \
            * np.exp(-ai ** 2 * mp.diffusivity * t / mp.a ** 2)
    return (2.0 * mp.force * mp.skempton * (1 + mp.nu_u) / (3 * mp.a)) * s


def mandel_plate_displacement(t: float, mp: MandelParams) -> float:
    """u_y at the plate (y = b); negative = compression."""
    s = 0.0
    for ai in mp.roots:
        s += (np.sin(ai) * np.cos(ai) / (ai - np.sin(ai) * np.cos(ai))) \
            * np.exp(-ai ** 2 * mp.diffusivity * t / mp.a ** 2)
    u_b = (-mp.force * (1 - mp.nu) / (2 * mp.shear * mp.a)
           + mp.force * (1 - mp.nu_u) / (mp.shear * mp.a) * s)
    return u_b * mp.b


def mandel_config(a: float = 10.0, level: int = 4,
                  dt: float = 10.0, t_max: float = 500.0) -> InputData:
    """Quarter-domain config on [0,a]x[0,a] (b = a): symmetry rollers on
    x=0 (label 0) and y=0 (label 2); drained free edge x=a (label 1);
    rigid frictionless plate at y=b (label 3) as u_y Dirichlet with unit
    pattern — the caller drives ``bc_scale`` with the analytic u_y(b,t)."""
    return from_entries({
        ("Mesh", "Dimensions"): "2",
        ("Mesh", "Domain size"): f"{2 * a}, {2 * a}",
        ("Mesh", "Initial refinement level"): str(level),
        ("Properties", "Young modulus"): "1.4e10",
        ("Properties", "Poisson ratio"): "0.3",
        ("Properties", "Biot coefficient"): "0.9",
        ("Properties", "Permeability"): "100",
        ("Properties", "Fluid compressibility"): "5.8e-10",
        ("Properties", "Porosity"): "0.3",
        ("Properties", "Viscosity"): "1e-3",
        ("Properties", "Flow rate"): "0",
        ("Properties", "Well radius"): "0.1",
        ("In situ", "Initial pressure"): "0",  # overwritten by caller
        ("In situ", "Displacement boundary labels"): "0, 2, 3",
        ("In situ", "Displacement boundary components"): "0, 1, 1",
        ("In situ", "Displacement boundary values"): "0, 0, 1",
        ("In situ", "Pressure boundary labels"): "1",
        ("In situ", "Pressure boundary values"): "0",
        ("Solver", "Time step"): str(dt),
        ("Solver", "Time max"): str(t_max),
        ("TPU", "Output VTK"): "false",
        ("TPU", "Volumetric strain resync"): "true",
    })
