"""Fixed-stress-split coupled Biot solver (port of
``poroelasticity_dealii_tpu/solvers/fss.py``).

One time step alternates a pressure inner loop (GMG- or Jacobi-CG on the
fixed-stress-stabilised flow system) with a mechanics CG and a batched
strain-projection CG, until the flow residual falls below the FSS
tolerance; the shear strains are projected once after the loop.  The
pressure and FSS loops run on the host and read their residual norm once
per iteration (the reference's ``while`` conditions); every CG keeps its
loop state on the device and reads one flag per chunk of iterations
(:mod:`.cg`), and on the card each chunk is a captured CUDA graph
(:class:`.cuda_graphs.ChunkGraphs`, one per solver; ``cuda_graphs=False``
runs the same chunks eagerly).  The step's CG counts stay on the device
until the step, or a block of steps (:meth:`FixedStressSolver.multi_step`),
ends.  Each step records its phases as spans (:mod:`..utils.profiling`):
``fss.step`` around the whole, ``fss.bc_response``, one
``fss.pressure_loop`` per FSS iteration, ``fss.mechanics`` (the coupling
right-hand side and the solve) and ``fss.projection`` (the right-hand side
and the volumetric solve in the loop, the shear solve after it), and counts
each host read where it is made.

The solver takes a structured discretization
(:class:`.structured.GridDiscretization`) or a generic one
(:class:`.discretization.Discretization`, any quad or hex mesh, adaptive
ones with hanging nodes included).
On the generic one the pressure Jacobian is the mass and Laplace applies
(the reference folds them into one stencil on structured grids only) with a
Jacobi preconditioner, and the mechanics is flat Jacobi-CG.

The mechanics vector is in the kit's layout when the discretization has a
rows kit (``disc.row_ops``: the comp-major row layout in 3D, the parity
layout in 2D) and flat otherwise (the conv backend): ``State.u_rows`` is
then None and ``State.mech_b`` flat.  With an elasticity V-cycle
(``disc.gmg_precond_rows`` on the parity kit, ``disc.gmg_precond`` on flat
vectors, 2D and 3D) the mechanics solve is GMG-Richardson in float32 and
GMG-CG in float64, as in the reference; otherwise Jacobi-CG, on the rows
kit with the node-block (3x3) Jacobi preconditioner when the deck's
``Mechanics preconditioner`` is ``block``.  The pressure Jacobian is one
stencil of the grid's pressure degree, preconditioned by the pressure GMG
on equal cells per axis.  With ``Mixed precision refinement = on`` a
float64 run on a structured grid refines float32 solves of a twin
discretization (:meth:`FixedStressSolver._mixed_precision_inner`): the
flat mechanics solve, the bc response, the pressure and the projection;
the rows kit keeps its native f64 mechanics, as in the reference.
With a slab kit of the sharded production path
(:class:`..parallel.rows.ShardedKit`: the 3D z-slab rows, the 2D y-slab
parity) ``State.u_rows`` and ``State.mech_b`` are the rank's slabs and
``State.u`` the gathered whole vector; the mechanics norms, dots and the
bitwise-skip test go through the kit's reductions, so every rank takes the
same branch.  The gspmd and psum discretizations
(:mod:`..parallel.sharding`) keep every vector whole; the gspmd hook
``wrap_pressure_stencil`` puts the fused pressure Jacobian on slabs too.
The ghost discretization (:mod:`..parallel.ghost`) shards every vector:
the state, the diagonals, masks and lifts are the rank's chunks, and every
reduction (each CG's dots and norms, the pressure and FSS residual norms,
the projection tolerances, the bitwise-skip test, the Debug NaNs check) is
taken from its kit (``disc.kit``) across the group.
Every sharded discretization runs its CG chunks eagerly (they hold
collectives).
On a generic discretization with hanging nodes (an adaptive mesh,
:mod:`..amr`) the reference's constraint hooks run where it runs them:
the pressure residual and the projection RHS are condensed, the pressure
Jacobian, the mass of the projection and the elasticity
(``disc.elasticity_constrained``) are the constrained operators, the
solves start with zero hanging entries and their results are distributed,
and the Dirichlet lift goes through the constrained elasticity.  Every
other discretization (conforming meshes, structured grids, the rows and
slab kits) holds empty tables, whose hooks return their input untouched,
so those paths compute what they did bit for bit.

Semantics kept from the reference (deliberate quirks):

* the volumetric strain moves only through the fixed-stress predictor
  ``eps_v += (b/K) delta_p``; it is not resynchronised from u (unless the
  deck's resync switch is on);
* ``eps_v0`` is the t = 0 projection, fixed for all time;
* the pressure update ``delta_p`` is reset once per FSS iteration and warm
  starts each pressure CG inside it;
* the FSS error starts at ``2 * pressure_tol``.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from ..amr.constraints import empty_constraints
from ..config import InputData
from ..ops import dense
from ..ops.operators import SHEAR_ENTRIES, VOIGT_PAIRS, VOLUMETRIC_ENTRIES
from ..ops.stencil import make_stencil_apply
from . import structured
from ..parallel.rows import ShardedKit
from ..utils import profiling
from .cg import (LocalReductions, cg_solve, cg_solve_batched,
                 lane_norm, richardson_solve)
from .cuda_graphs import ChunkGraphs
from .discretization import Discretization
from .multigrid import build_gmg_pressure
from .structured import GridDiscretization, _single_cell_spaces


# CG iterations per host read at each call site.  A chunk runs up to
# size - 1 frozen iterations past convergence, each a full apply, against
# one host read (a pipeline drain) per chunk:
# * mechanics: 37-112 iterations a solve on the bench path; 8 wastes at most
#   7 applies of ~0.1 ms (the K1 kernel and the vector ops) per solve;
# * pressure: 1-4 GMG-preconditioned iterations a solve, each a V-cycle of
#   a few hundred small kernels, so a wasted iteration costs more than a
#   host read: 2;
# * projection: 20-45 batched mass-matrix iterations a solve, cheap ones: 8;
# * bc response: one solve of about a hundred iterations, once: 16;
# * mechanics with an elasticity V-cycle (GMG-Richardson in f32, GMG-CG in
#   f64): 1-5 iterations a solve, and a frozen iteration costs a whole
#   V-cycle (~3 ms of device time at 512^2 on the H100, more than a host
#   read): 1;
# * the float32 inner solves of mixed-precision refinement, as their f64
#   call sites: mechanics 8, pressure 2, projection 8;
# * refinement's f64 outer Richardson loops: each pass runs a whole inner
#   solve, which reads its own chunk flags on the host, so a pass cannot be
#   captured; the loop runs eagerly and reads its residual once per pass
#   (2-4 passes a solve), as the pressure and FSS loops do: 1.
CHUNK = {"mechanics": 8, "pressure": 2, "projection": 8, "bc_response": 16,
         "mechanics_gmg": 1, "mechanics_f32": 8, "pressure_f32": 2,
         "projection_f32": 8, "refinement": 1}

# ``TPU / Debug NaNs``: the solves whose results a step records, by code
# (StepStats.nan_site; 0: every result finite)
NAN_SITES = (None, "pressure residual", "pressure CG", "mechanics solve",
             "bc-response solve", "projection CG")


@dataclasses.dataclass
class StepStats:
    """Per-time-step convergence record, as host values (stacked along a
    leading (K,) axis by :meth:`FixedStressSolver.multi_step`)."""
    fss_iterations: int
    pressure_error: float             # final FSS residual norm
    pressure_iterations: int          # total inner pressure solves
    pressure_cg_iterations: int
    mech_cg_iterations: int
    projection_cg_iterations: int
    fss_error_history: np.ndarray     # (max_fss,) padded with -1
    cg_converged: bool = True         # False if any linear solve ended
    #                                   before its tolerance
    cg_stalled: bool = False          # True if a mechanics solve that did
    #                                   not converge ended on Richardson's
    #                                   stagnation exit, not the cap
    nan_site: int = 0                 # Debug NaNs: the first solve of the
    #                                   step whose result was not finite
    #                                   (a NAN_SITES code; 0 none or off)


@dataclasses.dataclass
class State:
    """Restart state: pressure, displacement, strains."""
    p: torch.Tensor                 # (n_pdofs,)
    u: Optional[torch.Tensor]       # (n_udofs,); None after a want_u=False
    #                                 step (see materialize_u)
    eps_v: torch.Tensor             # volumetric strain (n_pdofs,)
    eps_v0: torch.Tensor            # t = 0 volumetric strain
    strains: torch.Tensor           # (n_voigt, n_pdofs)
    # derived caches, not part of the restart vector: u in the row layout
    # (the mechanics warm start) and the last mechanics RHS (a bitwise
    # equal new RHS skips the mechanics solve)
    u_rows: Optional[torch.Tensor] = None
    mech_b: Optional[torch.Tensor] = None


def _as_dtype(x: float, dtype: torch.dtype) -> float:
    """``x`` rounded to ``dtype``: the reference compares its float32
    residuals against tolerances cast to float32."""
    return float(torch.tensor(x, dtype=dtype))


def _read_stats(steps: list) -> list:
    """Host :class:`StepStats` of steps whose CG counts, flags and (with
    ``Debug NaNs``) finiteness record are device tensors: one
    device-to-host read for all of them.  A step that recorded a
    non-finite result raises ``FloatingPointError`` naming the solve and
    the step's place in the call (``step_in_call``, from 0)."""
    if not steps:
        return []
    debug = isinstance(steps[0].nan_site, torch.Tensor)
    dev = profiling.read("stats", torch.stack([torch.stack([
        s.pressure_cg_iterations, s.mech_cg_iterations,
        s.projection_cg_iterations, s.cg_converged.long(),
        s.cg_stalled.long()] + ([s.nan_site.long()] if debug else []))
        for s in steps]).tolist)
    for i, row in enumerate(dev):
        if debug and row[5]:
            err = FloatingPointError(
                f"Debug NaNs: the {NAN_SITES[row[5]]} gave a non-finite "
                "result" + (f" in step {i + 1} of this {len(steps)}-step "
                            "call" if len(steps) > 1 else ""))
            err.step_in_call = i
            raise err
    return [dataclasses.replace(
        s, pressure_cg_iterations=row[0], mech_cg_iterations=row[1],
        projection_cg_iterations=row[2], cg_converged=bool(row[3]),
        cg_stalled=bool(row[4]), nan_site=0)
        for s, row in zip(steps, dev)]


@contextlib.contextmanager
def numbered_steps(first: int):
    """Around a :meth:`FixedStressSolver.time_step` or ``multi_step`` call
    whose first step is step ``first`` of a run: a Debug NaNs
    ``FloatingPointError`` is raised again with the step's number in the
    run."""
    try:
        yield
    except FloatingPointError as e:
        if not hasattr(e, "step_in_call"):
            raise
        raise FloatingPointError(
            f"step {first + e.step_in_call}: {e}") from e


def _refined_inner(solve32, dtype: torch.dtype, batched: bool = False):
    """Mixed-precision refinement's inner step (the reference's
    ``_refined_inner``, ``fss.py:73-84``): the f64 residual scaled to unit
    norm (a zero residual is left as is), solved in float32 by ``solve32``,
    scaled back; ``batched``: one norm per row (the projection's lanes)."""
    def inner(r):
        s = torch.linalg.norm(r, dim=-1, keepdim=True) if batched \
            else torch.linalg.norm(r)
        safe = torch.where(s > 0, s, torch.ones_like(s))
        return solve32((r / safe).float()).to(dtype) * safe
    return inner


class FixedStressSolver:
    """The fixed-stress time step for one discretization and deck.

    ``cuda_graphs``: on the card, run each CG chunk as a captured CUDA
    graph (the default); False runs the same chunks eagerly, for
    comparisons.  A sharded discretization always runs them eagerly: its
    chunks hold NCCL collectives."""

    def __init__(self, disc: Union[GridDiscretization, Discretization],
                 data: InputData, cuda_graphs: bool = True):
        """``data.debug_nans`` (``TPU / Debug NaNs``): each step records on
        the device the first of its solves whose result is not finite (the
        pressure residual, the pressure CG, the mechanics solve, the
        bc-response solve, the projection CG), and :meth:`time_step` /
        :meth:`multi_step` raise ``FloatingPointError`` naming it when they
        read the step's counts: no extra host read, and nothing added to
        the captured chunks.  Off, the step computes nothing extra."""
        self.disc, self.data = disc, data
        ro = disc.row_ops
        self._rows = ro is not None
        # the reductions of the mechanics vectors and of the pressure-space
        # ones (pressure, strains, projection lanes): across the group on
        # the ghost form's kit (every vector sharded) and, for the
        # mechanics, on a slab kit; else local
        kit = getattr(disc, "kit", None)
        self._reduce = kit or (ro if isinstance(ro, ShardedKit)
                               else LocalReductions)
        self._p_reduce = kit or LocalReductions
        sharded = getattr(disc, "slab_group", None) is not None
        self.graphs = ChunkGraphs() if (
            cuda_graphs and disc.device.type == "cuda" and not sharded) \
            else None
        # hanging-node constraints: a generic (adaptive) mesh's own, empty
        # tables (identity hooks) on every other discretization
        if isinstance(disc, Discretization):
            self._hcp, self._hcu = disc._hcp, disc._hcu
        else:
            self._hcp = self._hcu = empty_constraints(disc.dtype,
                                                      disc.device)
        # the Dirichlet lift A g without the Dirichlet mask, through the
        # hanging-node constrained operator (the identity wrap without
        # hanging nodes; the rows kits' meshes have none); by linearity
        # the bc_scale-dependent lift is bc_scale * lift
        if self._rows:
            self._dirichlet = ro.to_rows(disc.dirichlet_values)
            self._lift = ro.apply_rows(self._dirichlet)
            self._f_neumann = ro.to_rows(disc.f_neumann)
            self._free_mask = ro.free_mask_rows
        else:
            self._dirichlet = disc.dirichlet_values
            self._lift = self._hcu.constrained(disc.elasticity)(
                disc.dirichlet_values)
            self._f_neumann = disc.f_neumann
            self._free_mask = disc.free_mask_u
        self._jac_stencils = {}
        self._p_gmg = {}
        self._bc_response_cache = None
        # node-block Jacobi on the rows kit (the reference's rows branch
        # only), its planes built now, outside any captured chunk
        self._block = ro.block_precond if (
            self._rows and data.mech_precond == "block") else None
        if self._block is not None:
            self._block.build()
        self._ir = self._mixed_precision_inner()

    def release(self) -> None:
        """Free the captured graphs (the adaptive driver calls it before it
        builds the next mesh's solver)."""
        if self.graphs is not None:
            self.graphs.release()

    def _cast(self, x: float) -> float:
        return _as_dtype(x, self.disc.dtype)

    def _note_nan(self, flag, site: str, x, mechanics: bool = False):
        """Debug NaNs: the step's record ``flag`` (an int32 device scalar,
        0 while every checked result was finite) set to ``site``'s code if
        it is still 0 and ``x`` is not finite; None, with nothing computed,
        when the option is off.  A sharded vector is checked across the
        group, so every rank records the same code."""
        if flag is None:
            return None
        red = self._reduce if mechanics else self._p_reduce
        ok = red.all_equal(torch.isfinite(x), True)
        return flag.masked_fill((flag == 0) & ~ok, NAN_SITES.index(site))

    def _cg(self, site, *args, graph_key=(), batched=False, **kw):
        """``cg_solve`` (or ``cg_solve_batched``) at call site ``site``: its
        chunk size, and its graphs keyed on ``(site, *graph_key)``."""
        solve = cg_solve_batched if batched else cg_solve
        return solve(*args, chunk=CHUNK[site], graphs=self.graphs,
                     graph_key=(site, *graph_key), **kw)

    def _richardson(self, site, *args, **kw):
        """``richardson_solve`` at call site ``site``, as :meth:`_cg`."""
        return richardson_solve(*args, chunk=CHUNK[site], graphs=self.graphs,
                                graph_key=(site,), **kw)

    @staticmethod
    def _refine(apply, b, x0, inner, tol, max_iter, batched=False):
        """Refinement's f64 outer loop: Richardson preconditioned by the
        float32 solve ``inner``, run eagerly (see :data:`CHUNK`)."""
        norm = lane_norm if batched else LocalReductions.norm
        return richardson_solve(apply, b, x0, inner, tol, max_iter, norm=norm,
                                chunk=CHUNK["refinement"],
                                graph_key=("refinement",))

    # ---------------- mixed-precision refinement ----------------------------

    def _mixed_precision_inner(self):
        """``TPU / Mixed precision refinement = on`` (the reference's
        ``_mixed_precision_inner``, ``fss.py:152-237``): for a float64 run
        on a structured grid (not a sharded one), a float32 twin of the
        discretization (``multigrid="off"``, the deck's elasticity backend:
        rows CG on the kernels, or flat Jacobi-CG on the flat kernel) whose
        whole solves, to 1e-5 of a unit-norm residual, precondition f64
        Richardson loops: the flat mechanics solve and the bc response
        (returned), the projection's mass solves (``_ir_mass``) and, per
        dt, the pressure solve (:meth:`_ir_pressure`).  ``auto`` is off:
        the reference turns it on only on a TPU.  Returns the mechanics
        inner step, or None."""
        d, data = self.disc, self.data
        self._ir_mass = self._ir_disc32 = self._ir_solver32 = None
        self._ir_press = {}
        if not (data.mixed_precision_refinement == "on"
                and d.dtype == torch.float64
                and isinstance(d, GridDiscretization)
                and d.wrap_pressure_stencil is None):
            return None
        verts = d.pressure_space.mesh.vertices
        disc32 = structured.build_grid_discretization(
            dataclasses.replace(data, dtype="float32"),
            cells_per_axis=d.info_u.cells_per_axis,
            pressure_degree=d.info_p.degree,
            displacement_degree=d.info_u.degree, lower=verts.min(axis=0),
            upper=verts.max(axis=0), multigrid="off",
            elasticity_backend=data.elasticity_backend, device=d.device,
            kernels=d.kernels)
        # relative to the unit-norm residual: each pass contracts by ~this
        itol, cap = _as_dtype(1e-5, torch.float32), data.cg_max_iterations
        ro32 = disc32.row_ops
        if ro32 is not None:
            bp32 = ro32.block_precond if data.mech_precond == "block" \
                else None
            if bp32 is not None:
                bp32.build()

            def solve32(r32):
                return ro32.from_rows(self._cg(
                    "mechanics_f32", ro32.constrained_apply,
                    ro32.to_rows(r32), torch.zeros_like(ro32.diag_rows),
                    ro32.diag_rows, tol=itol, max_iter=cap,
                    apply_iter=ro32.free_apply, precond=bp32,
                    flexible=False).x)
        else:
            def solve32(r32):
                return self._cg("mechanics_f32",
                                disc32.elasticity_constrained, r32,
                                torch.zeros_like(r32),
                                disc32.diag_elasticity, tol=itol,
                                max_iter=cap).x

        def mass32(r32):
            return self._cg("projection_f32", disc32.mass, r32,
                            torch.zeros_like(r32), disc32.diag_mass, itol,
                            cap, batched=True).x

        self._ir_mass = _refined_inner(mass32, d.dtype, batched=True)
        self._ir_disc32 = disc32
        return _refined_inner(solve32, d.dtype)

    def _ir_pressure(self, dt):
        """Refinement's inner pressure solve for ``dt`` (the reference's
        ``_ir_pressure``, ``fss.py:239-277``): a float32 twin solver's fused
        Jacobian and GMG-CG (Jacobi below the multigrid threshold); None
        when refinement is off."""
        if self._ir_disc32 is None:
            return None
        if dt not in self._ir_press:
            if self._ir_solver32 is None:
                self._ir_solver32 = FixedStressSolver(
                    self._ir_disc32,
                    dataclasses.replace(self.data, dtype="float32"),
                    cuda_graphs=False)
            s32 = self._ir_solver32
            pre32, diag32 = s32._pressure_precond(dt), \
                s32._pressure_jacobian_diag(dt)
            itol = _as_dtype(1e-5, torch.float32)

            def solve32(r32):
                return self._cg(
                    "pressure_f32",
                    lambda x: s32._pressure_jacobian_apply(x, dt), r32,
                    torch.zeros_like(r32), diag32, tol=itol,
                    max_iter=self.data.cg_max_iterations, precond=pre32,
                    graph_key=(dt,)).x

            self._ir_press[dt] = _refined_inner(solve32, self.disc.dtype)
        return self._ir_press[dt]

    # ---------------- pressure system pieces -------------------------------

    def _pressure_residual(self, p, p_old, eps_v, eps_v0, dt):
        """Negated Biot flow residual on free pressure dofs:
        -[M ((b/dt)(eps_v - eps_v0) + (p - p_old)/(M_biot dt))
          + (k/mu) L p + F_well]."""
        d, data = self.disc, self.data
        acc = (data.biot_coef / dt) * (eps_v - eps_v0) \
            + (1.0 / data.m_modulus / dt) * (p - p_old)
        res = d.mass(acc) + (data.perm / data.visc) * d.laplace(p) \
            + d.f_well
        # hanging-row condensation (the reference's condense(residual))
        return self._hcp.condense_vec(-res) * d.free_mask_p

    def _fused_jacobian_stencil(self, dt):
        """Pressure Jacobian mass/(M dt) + (k/mu) L as one stencil (on a
        structured grid; the Q1 slice stencil for Q1 pressure), through the
        discretization's ``wrap_pressure_stencil`` hook when it has one
        (the gspmd slabs)."""
        if dt not in self._jac_stencils:
            d, data = self.disc, self.data
            verts = d.pressure_space.mesh.vertices
            _, sp1, _ = _single_cell_spaces(
                data, d.info_p.cells_per_axis, d.info_p.degree,
                d.info_u.degree, span=verts.max(axis=0) - verts.min(axis=0))
            Me = dense.mass_element_matrices(sp1)[0]
            Le = dense.laplace_element_matrices(sp1)[0]
            J = Me / (data.m_modulus * dt) + (data.perm / data.visc) * Le
            kp = d.info_p.degree
            st = make_stencil_apply(J, kp, kp, 1, 1, d.dim,
                                    d.info_p.cells_per_axis, d.dtype,
                                    d.device)
            if d.wrap_pressure_stencil is not None:
                st = d.wrap_pressure_stencil(st)
            self._jac_stencils[dt] = st
        return self._jac_stencils[dt]

    def _pressure_jacobian_apply(self, x, dt):
        d, data = self.disc, self.data
        fp = d.free_mask_p
        if isinstance(d, GridDiscretization):
            y = self._fused_jacobian_stencil(dt)(x * fp)
        else:
            def base(z):
                return d.pressure_operator(z, 1.0 / data.m_modulus / dt,
                                           data.perm / data.visc)
            y = self._hcp.constrained(base)(x * fp)
        return y * fp + x * (1.0 - fp)

    def _pressure_jacobian_diag(self, dt):
        d, data = self.disc, self.data
        diag = (1.0 / data.m_modulus / dt) * d.diag_mass \
            + (data.perm / data.visc) * d.diag_laplace
        return torch.where(d.free_mask_p > 0, diag, torch.ones_like(diag))

    def _pressure_precond(self, dt):
        """GMG V-cycle for the pressure Jacobian, or None (Jacobi) when the
        grid is below the multigrid threshold, not structured or has unequal
        cells per axis."""
        d, data = self.disc, self.data
        if not isinstance(d, GridDiscretization) or not d.info_p.isotropic:
            return None
        n = d.info_p.cells_per_axis[0]
        # module attribute, looked up per call (tests patch the threshold)
        n_levels = structured._gmg_levels(n, d.dim, d.n_pdofs, "auto",
                                          auto_threshold=30_000,
                                          degree=d.info_p.degree, n_comp=1)
        if n_levels < 2:
            return None
        if dt not in self._p_gmg:
            verts = d.pressure_space.mesh.vertices
            self._p_gmg[dt], _ = build_gmg_pressure(
                data, n_fine=n, n_levels=n_levels, dtype=d.dtype,
                device=d.device, dt=dt, pressure_degree=d.info_p.degree,
                lower=verts.min(axis=0), upper=verts.max(axis=0))
        return self._p_gmg[dt]

    # ---------------- mechanics solve ---------------------------------------

    def _mechanics_solve(self, p, u_warm, bc_scale=1.0, b_prev=None):
        """Elasticity solve with the pressure-coupling RHS, traction and
        Dirichlet values scaled by ``bc_scale``, on the mechanics vector
        (rows or flat, see the module docstring).

        ``b_prev``: the previous RHS.  When the new RHS is bitwise equal,
        the warm start already solves the system: the tolerance becomes
        inf, so CG stops after its initial residual.

        Returns ``(u, iters, converged, stalled, b)``, the count and the
        flags as device tensors."""
        d, data = self.disc, self.data
        ro = d.row_ops
        m = self._free_mask
        g = bc_scale * self._dirichlet
        if self._rows:
            rhs = ro.coupling_rows(p) + self._f_neumann
        else:
            rhs = self._hcu.condense_vec(d.coupling_rhs(p, data.biot_coef)
                                         + self._f_neumann)
        b = m * (rhs - bc_scale * self._lift) + (1.0 - m) * g
        # b and x0 carry the Dirichlet values, so every CG direction is
        # zero at constrained rows and the free-subspace apply is exact
        x0 = self._hcu.zero_hanging(m * u_warm + (1.0 - m) * g)
        # the tolerance on the device, in the working type (the reference
        # casts it there); a bitwise-equal RHS lifts it to inf
        if data.mech_cg_relative:
            tol = self._reduce.norm(b) * data.mech_cg_tol
        else:
            tol = torch.full((), data.mech_cg_tol, dtype=d.dtype,
                             device=d.device)
        if b_prev is not None:
            tol = tol.masked_fill(self._reduce.all_equal(b, b_prev),
                                  float("inf"))
        if self._rows:
            apply, diag, gmg = ro.constrained_apply, ro.diag_rows, \
                d.gmg_precond_rows
        else:
            apply, diag, gmg = d.elasticity_constrained, \
                d.diag_elasticity, d.gmg_precond
        if not self._rows and self._ir is not None:
            # f64 by mixed-precision refinement: each pass one f64 apply
            # and one whole f32 solve, ~1e-5 contraction a pass
            res = self._refine(apply, b, x0, self._ir, tol, 30)
        elif gmg is not None and d.dtype == torch.float32:
            # a strong preconditioner in f32: CG's p.Ap sinks into the
            # apply's rounding noise, Richardson has no quadratic forms
            res = self._richardson("mechanics_gmg", apply, b, x0, gmg, tol,
                                   data.cg_max_iterations,
                                   norm=self._reduce.norm)
        elif gmg is not None:
            # f64: GMG-CG (the reference's tolerances lie below the true
            # residual's roundoff floor, which only the recurred CG
            # residual passes)
            res = self._cg("mechanics_gmg", apply, b, x0, diag, tol=tol,
                           max_iter=data.cg_max_iterations, precond=gmg,
                           dot=self._reduce.dot, norm=self._reduce.norm)
        elif self._rows:
            # node-block Jacobi when asked for: a fixed SPD preconditioner
            # with identity blocks at constrained nodes, so the
            # free-subspace apply stays exact and the update stays
            # Fletcher-Reeves
            res = self._cg("mechanics", apply, b, x0, diag, tol=tol,
                           max_iter=data.cg_max_iterations,
                           apply_iter=ro.free_apply, precond=self._block,
                           flexible=False, dot=self._reduce.dot,
                           norm=self._reduce.norm)
        else:
            res = self._cg("mechanics", apply, b, x0, diag, tol=tol,
                           max_iter=data.cg_max_iterations,
                           dot=self._reduce.dot, norm=self._reduce.norm)
        return self._hcu.distribute(res.x), res.iterations, res.converged, \
            res.stalled, b

    def _bc_response(self):
        """du/d(bc_scale) on the mechanics vector: the constrained solve
        against the unit-Dirichlet-pattern RHS, computed once.  Constrained
        rows carry the pattern itself, so ``u + ds * response`` lands on
        the new boundary values."""
        if self._bc_response_cache is None:
            d = self.disc
            # seeds a warm start only: a few digits suffice
            rel = 1e-8 if d.dtype == torch.float64 else 2e-6
            if self._ir is not None:
                self._bc_response_cache = self._bc_response_refined(rel)
                return self._bc_response_cache
            m = self._free_mask
            b = m * (-self._lift) + (1.0 - m) * self._dirichlet
            if self._rows:
                apply, diag = d.row_ops.constrained_apply, d.row_ops.diag_rows
            else:
                apply, diag = d.elasticity_constrained, d.diag_elasticity
            res = self._cg("bc_response", apply, b, torch.zeros_like(b),
                           diag, tol=rel * self._reduce.norm(b),
                           max_iter=5000, dot=self._reduce.dot,
                           norm=self._reduce.norm)
            self._bc_response_cache = self._hcu.distribute(res.x)
        return self._bc_response_cache

    def _bc_response_refined(self, rel):
        """:meth:`_bc_response` by refinement, on flat vectors as in the
        reference (then into the kit's layout).  The start carries the
        Dirichlet pattern, so the residual is zero at constrained rows,
        which a rows inner (free-subspace apply) could not reduce."""
        d = self.disc
        ro = d.row_ops
        m = d.free_mask_u
        lift = ro.from_rows(self._lift) if self._rows else self._lift
        b = m * (-lift) + (1.0 - m) * d.dirichlet_values
        res = self._refine(d.elasticity_constrained, b, (1.0 - m) * b,
                           self._ir, rel * torch.linalg.norm(b), 30)
        return ro.to_rows(res.x) if self._rows else res.x

    # ---------------- strain projection -------------------------------------

    def _projection_rhs(self, u):
        """All-Voigt strain-projection RHS (n_voigt, n_pdofs) from the
        mechanics vector."""
        if self._rows:
            return self.disc.row_ops.projection_rows(u)
        return self.disc.strain_projection_rhs(u)

    def _project(self, entries, warm, rhs_all):
        """L2-project the Voigt components ``entries`` onto the pressure
        space: one batched mass-matrix CG.  Returns
        ``(strains, total iterations, converged)``, the last two as device
        tensors."""
        d, hc, red = self.disc, self._hcp, self._p_reduce
        rhs = hc.condense_vec(rhs_all[entries])
        tol = self.data.projection_cg_tol * red.lane_norm(rhs)
        if self._ir_mass is not None:
            # refinement, one lane per component (the reference's vmap)
            res = self._refine(hc.constrained(d.mass), rhs,
                               hc.zero_hanging(warm), self._ir_mass, tol, 20,
                               batched=True)
        else:
            res = self._cg("projection", hc.constrained(d.mass), rhs,
                           hc.zero_hanging(warm), d.diag_mass, tol,
                           self.data.cg_max_iterations, batched=True,
                           dot=red.lane_dot, norm=red.lane_norm)
        return hc.distribute(res.x), res.iterations.sum(), \
            res.converged.all()

    # ---------------- initialization ----------------------------------------

    def initial_state(self, bc_scale=1.0) -> State:
        d, data = self.disc, self.data
        dim = d.dim
        fp = d.free_mask_p
        p0 = torch.full((d.n_pdofs,), data.p_init, dtype=d.dtype,
                        device=d.device)
        p = p0 * fp + d.dirichlet_values_p * (1.0 - fp)
        u0 = torch.zeros(d.n_udofs, dtype=d.dtype, device=d.device)
        if self._rows:
            u0 = d.row_ops.to_rows(u0)
        u, _, _, _, b0 = self._mechanics_solve(p, u0, bc_scale)
        vol = VOLUMETRIC_ENTRIES[dim]
        warm = torch.zeros((len(vol), d.n_pdofs), dtype=d.dtype,
                           device=d.device)
        vol_strains, _, _ = self._project(vol, warm, self._projection_rhs(u))
        strains = torch.zeros((len(VOIGT_PAIRS[dim]), d.n_pdofs),
                              dtype=d.dtype, device=d.device)
        strains[vol] = vol_strains
        eps_v = vol_strains.sum(0)
        # mech_b = zeros: the first time step always solves
        return State(p=p, u=d.row_ops.from_rows(u) if self._rows else u,
                     eps_v=eps_v, eps_v0=eps_v, strains=strains,
                     u_rows=u if self._rows else None,
                     mech_b=torch.zeros_like(b0))

    # ---------------- one time step -----------------------------------------

    def time_step(self, state: State, dt: float, bc_scale: float = 1.0,
                  bc_scale_prev: Optional[float] = None,
                  want_u: bool = True):
        """One dt: the FSS loop (pressure inner loop, mechanics solve,
        normal-strain projection), then the shear strains.

        ``bc_scale`` scales the Dirichlet values; passing the previous
        step's ``bc_scale_prev`` superposes the linear response to the
        change onto the mechanics warm start.  ``want_u=False`` leaves
        ``State.u`` None on the rows backend (u stays in rows; see
        :meth:`materialize_u`); on the flat backend it is a no-op.  The
        stats are read from the device once, at the end of the step."""
        with profiling.step():
            state, stats = self._step(state, dt, bc_scale, bc_scale_prev,
                                      want_u)
            host = _read_stats([stats])
        profiling.note_cg(host)
        return state, host[0]

    def multi_step(self, state: State, dt: float, n_steps: int = None,
                   bc_scales=None, bc_scale_prev: Optional[float] = None,
                   want_u: bool = False):
        """K time steps as one block (the reference's ``multi_step``,
        ``fss.py:717-805``): ``bc_scales`` (K,) per-step Dirichlet scales
        (default K = ``n_steps`` ones); each step superposes the response
        to its change of scale onto the mechanics warm start, the first
        step's change taken from ``bc_scale_prev`` (default: none).  u
        stays in rows across the block and is filled at its end when
        ``want_u``.  Returns ``(state, stats)``, every :class:`StepStats`
        field stacked along a leading (K,) axis, read from the device once
        for the block; the result equals K :meth:`time_step` calls bit for
        bit.

        Unlike the reference's one ``lax.scan`` dispatch, the block is K
        device-resident steps in a Python loop: every chunk boundary of a
        CG, and every pressure and FSS iteration, still reads one value on
        the host.  Each step is a ``fss.step`` span; the block's one read of
        the stats comes after the last."""
        if bc_scales is None:
            if n_steps is None:
                raise ValueError("pass n_steps or bc_scales")
            bc_scales = np.ones((n_steps,), float)
        bc_scales = [float(bc) for bc in np.asarray(bc_scales, float)]
        prev = bc_scales[0] if bc_scale_prev is None else float(bc_scale_prev)
        steps = []
        for bc in bc_scales:
            with profiling.step():
                state, stats = self._step(state, dt, bc, prev, want_u=False)
            steps.append(stats)
            prev = bc
        if want_u and self._rows:
            state = self.materialize_u(state)
        host = _read_stats(steps)
        profiling.note_cg(host)
        return state, StepStats(**{
            f.name: np.stack([getattr(s, f.name) for s in host])
            for f in dataclasses.fields(StepStats)})

    def _step(self, state: State, dt, bc_scale, bc_scale_prev, want_u):
        """:meth:`time_step` with the stats' CG counts, flags and
        finiteness record left on the device."""
        ds = 0.0 if bc_scale_prev is None else bc_scale - bc_scale_prev
        nan = torch.zeros((), dtype=torch.int32, device=self.disc.device) \
            if self.data.debug_nans else None
        response = None
        if ds != 0.0:
            with profiling.span("fss.bc_response"):
                response = self._bc_response()
                nan = self._note_nan(nan, "bc-response solve", response,
                                     mechanics=True)
        if self._rows:
            if state.u_rows is None:
                state = dataclasses.replace(
                    state, u_rows=self.disc.row_ops.to_rows(state.u))
            state = dataclasses.replace(state, u=None)
            if response is not None:
                state = dataclasses.replace(
                    state, u_rows=state.u_rows + ds * response)
        else:
            state = dataclasses.replace(state, u_rows=None)
            if response is not None:
                state = dataclasses.replace(state, u=state.u + ds * response)
        return self._time_step_impl(state, dt, bc_scale,
                                    want_u or not self._rows, nan)

    def materialize_u(self, state: State) -> State:
        """Fill ``state.u`` from the row layout after a want_u=False step."""
        if state.u is not None:
            return state
        return dataclasses.replace(
            state, u=self.disc.row_ops.from_rows(state.u_rows))

    def _time_step_impl(self, state: State, dt, bc_scale, want_u, nan):
        d, data = self.disc, self.data
        dim = d.dim
        vol, shear = VOLUMETRIC_ENTRIES[dim], SHEAR_ENTRIES[dim]
        p_old = state.p
        resync = data.resync_volumetric_strain
        # the reference compares against the t = 0 strain for all time;
        # resync mode uses the step-start strain
        eps_v0 = state.eps_v if resync else state.eps_v0
        pressure_tol = self._cast(data.pressure_tol)
        fss_tol = self._cast(data.fss_tol)
        jac_diag = self._pressure_jacobian_diag(dt)
        red = self._p_reduce
        # with refinement the f32 inner replaces the f64 pressure GMG
        irp = self._ir_pressure(dt)
        p_precond = None if irp is not None else self._pressure_precond(dt)

        def jac(x):
            return self._pressure_jacobian_apply(x, dt)

        # the step's CG counts and converged flag, on the device
        zero = torch.zeros((), dtype=torch.int64, device=d.device)
        cg_p = cg_u = cg_proj = zero
        cg_ok = torch.ones((), dtype=torch.bool, device=d.device)
        cg_stall = torch.zeros_like(cg_ok)

        def pressure_inner(p, eps_v, cg_p, cg_ok):
            """Stationary iteration on the fixed-stress-stabilised flow
            system; the predictor moves eps_v before each residual.  One
            host read of the residual norm per iteration."""
            nonlocal nan
            delta_p = torch.zeros_like(p)     # reset per FSS iteration
            r = self._pressure_residual(p, p_old, eps_v, eps_v0, dt)
            nan = self._note_nan(nan, "pressure residual", r)
            err = profiling.read("pressure_residual", red.norm(r).item)
            k = 0
            while k < data.max_pressure_iterations and err > pressure_tol:
                ptol = data.pressure_cg_tol * red.norm(r)
                if irp is not None:
                    res = self._refine(jac, r, self._hcp.zero_hanging(delta_p),
                                       irp, ptol, 20)
                else:
                    res = self._cg("pressure", jac, r,
                                   self._hcp.zero_hanging(delta_p), jac_diag,
                                   tol=ptol, max_iter=data.cg_max_iterations,
                                   precond=p_precond, graph_key=(dt,),
                                   dot=red.dot, norm=red.norm)
                delta_p = self._hcp.distribute(res.x)
                nan = self._note_nan(nan, "pressure CG", delta_p)
                p = p + delta_p
                eps_v = eps_v + (data.biot_coef / data.bulk_modulus) \
                    * delta_p
                r = self._pressure_residual(p, p_old, eps_v, eps_v0, dt)
                nan = self._note_nan(nan, "pressure residual", r)
                err = profiling.read("pressure_residual", red.norm(r).item)
                k += 1
                cg_p = cg_p + res.iterations
                cg_ok = cg_ok & res.converged
            return p, eps_v, k, cg_p, cg_ok

        n_voigt = len(VOIGT_PAIRS[dim])
        # err starts at exactly 2 * pressure_tol, so with fss_tol below it
        # the loop runs at least once and the shear solve reuses its final
        # projection RHS; otherwise the RHS must exist before the loop
        u = state.u_rows if self._rows else state.u
        if data.fss_tol >= 2.0 * data.pressure_tol:
            with profiling.span("fss.projection"):
                proj_rhs = self._projection_rhs(u)
        else:
            proj_rhs = torch.zeros((n_voigt, d.n_pdofs), dtype=d.dtype,
                                   device=d.device)
        p, eps_v = state.p, state.eps_v
        vol_strains = state.strains[vol]
        mech_b = state.mech_b if state.mech_b is not None \
            else torch.zeros_like(self._free_mask)
        err = self._cast(2.0 * data.pressure_tol)
        err_hist = np.full((data.max_fss_iterations,), -1.0)
        it = press_total = 0
        while it < data.max_fss_iterations and err > fss_tol:
            with profiling.span("fss.pressure_loop"):
                p, eps_v, n_press, cg_p, cg_ok = pressure_inner(
                    p, eps_v, cg_p, cg_ok)
            with profiling.span("fss.mechanics"):
                u, it_u, ok_u, st_u, mech_b = self._mechanics_solve(
                    p, u, bc_scale, b_prev=mech_b)
                nan = self._note_nan(nan, "mechanics solve", u,
                                     mechanics=True)
            with profiling.span("fss.projection"):
                proj_rhs = self._projection_rhs(u)
                vol_strains, it_pr, ok_pr = self._project(vol, vol_strains,
                                                          proj_rhs)
                nan = self._note_nan(nan, "projection CG", vol_strains)
            if resync:
                eps_v = vol_strains.sum(0)
            r = self._pressure_residual(p, p_old, eps_v, eps_v0, dt)
            nan = self._note_nan(nan, "pressure residual", r)
            err = profiling.read("fss_residual", red.norm(r).item)
            err_hist[it] = err
            it += 1
            press_total += n_press
            cg_u, cg_proj = cg_u + it_u, cg_proj + it_pr
            cg_ok = cg_ok & ok_u & ok_pr
            cg_stall = cg_stall | st_u

        strains = state.strains.clone()
        strains[vol] = vol_strains
        if shear:
            # the final FSS iteration's projection RHS: the same u
            with profiling.span("fss.projection"):
                shear_strains, it_sh, ok_sh = self._project(
                    shear, state.strains[shear], proj_rhs)
                nan = self._note_nan(nan, "projection CG", shear_strains)
            strains[shear] = shear_strains
            cg_proj = cg_proj + it_sh
            cg_ok = cg_ok & ok_sh
        if self._rows:
            u_flat, u_rows = (d.row_ops.from_rows(u) if want_u else None), u
        else:
            u_flat, u_rows = u, None
        new_state = State(
            p=p, u=u_flat, eps_v=eps_v, eps_v0=state.eps_v0,
            strains=strains, u_rows=u_rows, mech_b=mech_b)
        stats = StepStats(
            fss_iterations=it, pressure_error=err,
            pressure_iterations=press_total, pressure_cg_iterations=cg_p,
            mech_cg_iterations=cg_u, projection_cg_iterations=cg_proj,
            fss_error_history=err_hist, cg_converged=cg_ok,
            cg_stalled=cg_stall, nan_site=0 if nan is None else nan)
        return new_state, stats

    # ---------------- nodal effective stresses ------------------------------

    def effective_stresses(self, strains):
        """sigma = C : eps nodally, isotropic:
        sigma_ij = lam tr(eps) delta_ij + 2 mu eps_ij."""
        d = self.disc
        tr = sum(strains[e] for e in VOLUMETRIC_ENTRIES[d.dim])
        rows = []
        for e, (i, j) in enumerate(VOIGT_PAIRS[d.dim]):
            s = 2.0 * d.mu * strains[e]
            if i == j:
                s = s + d.lam * tr
            rows.append(s)
        return torch.stack(rows, dim=0)
