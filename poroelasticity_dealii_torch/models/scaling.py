"""Nondimensionalization of the coupled Biot problem.

``TPU / Nondimensionalize = true`` rescales the deck so every field the
solver touches is O(1): stresses/pressures by the Young modulus S,
lengths by the largest domain extent L, time by the time step T.  The
practical wins: deck-level ABSOLUTE tolerances become meaningful in f32
(dimensional mechanics residuals live at ~1e6 Pa·m² where an absolute
1e-12 is unreachable), magnitudes print/plot at O(1), and f32 mechanics
error improves mildly (measured 2.3e-5 -> 1.6e-5 relative u error on the
golden deck; pressure is already at its f32 floor either way).

The transformation is exact (a similarity scaling of the discrete
system): with consistently scaled tolerances the f64 solve reproduces
the dimensional run's iteration counts and, after :meth:`Scales.p` /
:meth:`Scales.u` rescaling, its fields to rounding.  Verified in
tests/test_scaling.py.

Scale map (primary deck fields; derived moduli follow automatically
since they are computed properties):

==================  ==========================
Young modulus        E' = E/S = 1
fluid compressibility  c' = c·S
permeability         k' = k·S·T/L²   (only k/μ enters)
bulk density         ρ' = ρ·L/S      (body force ρg)
well radius          r' = r/L
flow rate            Q' = Q·T/L²     (source −Q/(πr²) is a 1/time rate)
pressures / tractions  v' = v/S
displacement BCs     g' = g/L
domain size          D' = D/L
time step / t max    t' = t/T
FSS & pressure tol   tol' = tol·T/L^dim        (residual = ∫ψ·(1/time))
mech CG tol (abs)    tol' = tol/(S·L^(dim-1))  (residual = ∫∇ψ:σ)
==================  ==========================
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np

from ..config import InputData


class Scales(NamedTuple):
    """Characteristic scales; multiply nondimensional fields by these to
    recover SI values."""
    length: float      # L [m]
    stress: float      # S [Pa]
    time: float        # T [s]

    def p(self, p_nd):
        return p_nd * self.stress

    def u(self, u_nd):
        return u_nd * self.length

    def stresses(self, sig_nd):
        return sig_nd * self.stress

    # strains are dimensionless in both systems


def nondimensionalize(data: InputData):
    """Return ``(scaled InputData, Scales)``.

    With a gmsh ``Mesh file`` the deck's ``Domain size`` still defines
    the length scale L (any L gives an exact similarity rescale as long
    as it is applied to EVERY length); the runner divides the loaded
    mesh coordinates by the same L (see :func:`scale_mesh`), which makes
    the gmsh path equivalent to the structured generator's scaled grid.
    """
    L = float(max(data.domain_size))
    S = float(data.youngs_modulus)
    T = float(data.time_step)
    d = data.dim
    scaled = dataclasses.replace(
        data,
        domain_size=tuple(v / L for v in data.domain_size),
        youngs_modulus=data.youngs_modulus / S,
        f_comp=data.f_comp * S,
        perm=data.perm * S * T / L ** 2,
        bulk_density=data.bulk_density * L / S,
        r_well=data.r_well / L,
        flow_rate=data.flow_rate * T / L ** 2,
        time_step=data.time_step / T,
        t_max=data.t_max / T,
        p_init=data.p_init / S,
        pressure_boundary_values=tuple(
            v / S for v in data.pressure_boundary_values),
        stress_boundary_values=tuple(
            v / S for v in data.stress_boundary_values),
        displacement_boundary_values=tuple(
            v / L for v in data.displacement_boundary_values),
        fss_tol=data.fss_tol * T / L ** d,
        pressure_tol=data.pressure_tol * T / L ** d,
        mech_cg_tol=(data.mech_cg_tol if data.mech_cg_relative
                     else data.mech_cg_tol / (S * L ** (d - 1))),
        nondimensionalize=False,   # applied exactly once
    )
    return scaled, Scales(length=L, stress=S, time=T)


def scale_mesh(mesh, scales: Scales):
    """Divide a (dimensional) mesh's vertex coordinates by the length
    scale — the mesh-file counterpart of generating the structured grid
    from the scaled ``Domain size``."""
    import dataclasses as _dc
    return _dc.replace(mesh, vertices=mesh.vertices / scales.length)
