"""Judge an episode's states by the discrete equations of the reference.

Each state is read as the program (or the control) wrote it and judged in
float64 against the operators of :class:`.fem.Problem`, which the
reference built itself.  Three numbers, each the worst over the states:

* ``mech_residual``: the mechanics equation ``K u = b int p div v`` on the
  free dofs, and ``u = bc * g`` on the Dirichlet dofs (scaled by K's
  diagonal), over the norm of the lifted right-hand side;
* ``flow_residual``: the norm of the flow equation's residual (M's
  accumulation of the volumetric strain since t = 0 and of the pressure
  change over the step, the Darcy term and the well), the quantity whose
  bound the deck states as its pressure tolerance; the worse of two
  readings, one with the volumetric strain the program returned, one with
  the strain the deck's scheme gives its pressures (the start state's,
  moved by the fixed-stress predictor ``(b/K)(p - p_init)``: the strain
  moves by nothing else), so that a wrong or lost strain reads too;
* ``projection_residual``: each strain component ``M s_c = int psi
  eps_c(u)`` (at the start state the normal components and the
  volumetric strain, their sum), the worst component's residual over the
  largest component's right-hand side.

The start state is judged at the deck's initial pressure.  A step is
judged from the state before it: its pressure is the step's old pressure,
and the flow equation takes the start state's t = 0 strain.  After a
remesh the start is the transferred state (:mod:`.remesh` judges the
transfer): its pressure is the first step's old pressure and the
predictor's origin, its strains the predictor's start and the t = 0
strain; its displacement and strains are a solve's warm start and are
not judged.

Adaptive meshes add three numbers, each compared only for a cell whose
limits name it (:data:`ADAPTIVE`): ``hanging_gap``, the largest distance
of a hanging value from its masters' combination
(:class:`.hanging.Reader`); ``transfer_gap`` and ``marks_mismatch``
(:mod:`.remesh`).
"""

from __future__ import annotations

import torch

from .fem import SHEAR, VOLUMETRIC, Problem

NUMBERS = ("mech_residual", "flow_residual", "projection_residual")
ADAPTIVE = ("hanging_gap", "transfer_gap", "marks_mismatch")


def _f64(x):
    return x.detach().to(torch.float64)


def worst(a: float, b: float) -> float:
    """The larger of two readings; NaN if either is NaN."""
    return a + b if a != a or b != b else max(a, b)


def mech_residual(P: Problem, p, u, bc: float) -> float:
    m = P.free_u
    g = bc * P.dirichlet_u
    load = P.coupling(p)
    r = m * (P.elasticity(u) - load) \
        + (1.0 - m) * P.diag_elasticity * (u - g)
    b = m * (load - P.elasticity(g))
    return float(torch.linalg.norm(r) / torch.linalg.norm(b))


def projection_residual(P: Problem, u, strains, lanes, eps_sum=()) -> float:
    """``strains`` (len(lanes), n_p) against the projection of u's
    components ``lanes``; each of ``eps_sum`` a vector that must equal the
    projection of their sum."""
    rhs = P.projection_rhs(u)[list(lanes)]
    res = P.mass(strains) - rhs
    scale = torch.linalg.norm(rhs, dim=-1).max()
    top = torch.linalg.norm(res, dim=-1).max()
    for e in eps_sum:
        top = torch.maximum(top, torch.linalg.norm(P.mass(e) - rhs.sum(0)))
    return float(top / scale)


def judge(P: Problem, start: dict, steps: list, at_t0: bool = True) -> dict:
    """The three numbers of an episode at the deck's load: ``start`` and
    each of ``steps`` a dict of ``p``, ``u``, ``eps_v``, ``strains`` (any
    float dtype, any device; ``start`` also ``eps_v0``).  ``at_t0``
    false: ``start`` is what a remesh's transfer gave, not a solved state,
    so only the steps are judged, from its pressure and strains."""
    ph = P.phys
    s0 = {k: _f64(v).to(P.device) for k, v in start.items()}
    vol = list(VOLUMETRIC)
    if at_t0:
        p_start = torch.full_like(s0["p"], ph.p_init)
        out = {"mech_residual": mech_residual(P, p_start, s0["u"], 1.0),
               "flow_residual": 0.0,
               "projection_residual": projection_residual(
                   P, s0["u"], s0["strains"][vol], vol,
                   (s0["eps_v0"], s0["eps_v"]))}
    else:
        p_start = s0["p"]
        out = dict.fromkeys(NUMBERS, 0.0)
    p_old = p_start
    for state in steps:
        s = {k: _f64(v).to(P.device) for k, v in state.items()}
        out["mech_residual"] = worst(out["mech_residual"],
                                      mech_residual(P, s["p"], s["u"], 1.0))
        eps_v = s0["eps_v"] + (ph.biot / ph.bulk) * (s["p"] - p_start)
        for e in (s["eps_v"], eps_v):
            r = P.flow_residual(s["p"], p_old, e, s0["eps_v0"])
            out["flow_residual"] = worst(out["flow_residual"],
                                          float(torch.linalg.norm(r)))
        lanes = vol + list(SHEAR)
        out["projection_residual"] = worst(
            out["projection_residual"], projection_residual(
                P, s["u"], s["strains"][lanes], lanes))
        p_old = s["p"]
    return out
