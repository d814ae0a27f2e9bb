"""Shape bucketing for AMR (port of
``poroelasticity_dealii_tpu/amr/bucketing.py``): pad an adaptive
discretization's cells, dofs and constraint tables up to geometric size
buckets, as the reference does on every adaptive build (deck ``TPU / AMR
bucketing``, default true).

The reference pads so that remeshes landing in the same buckets reuse
compiled executables.  The port compiles nothing per shape (its CUDA graphs
are captured per solver, and a remesh builds a new solver), so here the
padding only keeps the option's meaning: the padded run computes what the
unpadded one does, on longer vectors.

Padding is exact, by the reference's invariants:

* phantom cells carry zero geometry (``jxw = 0``, ``jinv = 0``) and
  connectivity pointing at dof 0, so every value they compute is 0; their
  corner offsets, which the generic kernels rebuild the geometry from,
  are the reference cube's, so the kernels' products there are finite.  The
  scatter plans leave them out (their connectivity is -1 in the plans'
  copy, :func:`..ops.operators.scatter_plan`), so the plans' width, the
  largest valence, does not grow with the padding;
* phantom dofs are Dirichlet-constrained to zero (``free_mask = 0``,
  ``dirichlet_values = 0``, preconditioner diagonals 1): solver vectors
  stay exactly zero there, and extra zeros change no norm or dot beyond
  the order of their sums;
* phantom constraint rows constrain the last (phantom) dof to a
  zero-weight combination of itself, so ``distribute``, ``condense_vec``
  and ``constrained`` act as the identity on real data.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..ops.geometry import reference_offsets
from ..ops.operators import scatter_plan
from .constraints import HangingConstraints


def bucket_size(n: int, ratio: float = 1.25, quantum: int = 32) -> int:
    """Smallest bucket STRICTLY greater than ``n``: quantum-aligned sizes
    growing geometrically (32, 64, 96, 128, 160, 224, 288, ...).  Strict
    so at least one phantom dof always exists (the no-op constraint rows
    need one to point at)."""
    m = quantum
    while m <= n:
        m = max(m + quantum, int(math.ceil(m * ratio / quantum)) * quantum)
    return m


def _pad_last(a: torch.Tensor, n_to: int, fill=0.0) -> torch.Tensor:
    """Pad the LAST axis of ``a`` to length ``n_to`` with ``fill``."""
    return torch.nn.functional.pad(a, (0, n_to - a.shape[-1]), value=fill)


def _pad_offsets(off: torch.Tensor, n_to: int) -> torch.Tensor:
    """Pad the corner offsets ``(2^dim - 1, dim, E)`` to ``n_to`` cells
    with the reference cube's."""
    ref = torch.as_tensor(reference_offsets(off.shape[1]), dtype=off.dtype,
                          device=off.device)
    return torch.cat([off, ref[..., None].expand(
        *ref.shape, n_to - off.shape[-1])], dim=-1)


def _pad_constraints(hc: HangingConstraints, n_dofs_pad: int, H_to: int,
                     W_to: int, dtype) -> HangingConstraints:
    """Pad the (H, W) constraint tables with no-op rows: each padding row
    constrains the last (phantom) dof to a zero-weight combination of
    itself.  Duplicate phantom-row writes all store the same value, so the
    index copies stay deterministic."""
    phantom = n_dofs_pad - 1
    H = int(hc.hanging.shape[0])
    W = int(hc.masters.shape[1])
    hanging = np.full(H_to, phantom, np.int64)
    masters = np.full((H_to, W_to), phantom, np.int64)
    weights = np.zeros((H_to, W_to))
    if H:
        hanging[:H] = hc.hanging.cpu().numpy()
        masters[:H, :W] = hc.masters.cpu().numpy()
        weights[:H, :W] = hc.weights.cpu().double().numpy()
    return HangingConstraints.from_tables(hanging, masters, weights, dtype,
                                          hc.hanging.device)


def pad_amr_discretization(disc, ratio: float = 1.25, quantum: int = 32):
    """Return a copy of a generic AMR ``Discretization`` padded to shape
    buckets (cells, pressure dofs, displacement dofs, both constraint
    tables).  The FE spaces stay the REAL ones — host boundaries (VTK,
    Kelly, transfer) read real sizes from them and slice."""
    E = disc.n_cells
    n_p = disc.n_pdofs
    n_u = disc.n_udofs
    Ep = bucket_size(E, ratio, quantum)
    npp = bucket_size(n_p, ratio, quantum)
    nup = bucket_size(n_u, ratio, quantum)
    dt = disc.dtype
    dim = disc.dim

    # constraint tables: W padded to the dim/degree-stable width so a
    # mesh moment with only edge (not face) constraints still buckets
    # width = one face's worth of master dofs, (k+1)^(dim-1).  Vector
    # components add constraint ROWS (constraints._pack_rows expands
    # H × n_comp), never width — each row's masters are same-component —
    # so no per-component factor applies here
    w_cap_u = max((disc.displacement_space.degree + 1) ** (dim - 1),
                  int(disc._hcu.masters.shape[1]))
    w_cap_p = max((disc.pressure_space.degree + 1) ** (dim - 1),
                  int(disc._hcp.masters.shape[1]))
    hc_p = _pad_constraints(
        disc._hcp, npp,
        bucket_size(int(disc._hcp.hanging.shape[0]), ratio, quantum),
        w_cap_p, dt)
    hc_u = _pad_constraints(
        disc._hcu, nup,
        bucket_size(int(disc._hcu.hanging.shape[0]), ratio, quantum),
        w_cap_u, dt)

    return dataclasses.replace(
        disc,
        conn_p=_pad_last(disc.conn_p, Ep, 0),
        conn_u=_pad_last(disc.conn_u, Ep, 0),
        plan_p=scatter_plan(_pad_last(disc.conn_p, Ep, -1).cpu().numpy(),
                            npp, disc.device),
        plan_u=scatter_plan(_pad_last(disc.conn_u, Ep, -1).cpu().numpy(),
                            nup, disc.device),
        jinv_u=_pad_last(disc.jinv_u, Ep, 0.0),
        jxw_u=_pad_last(disc.jxw_u, Ep, 0.0),
        jinv_p=_pad_last(disc.jinv_p, Ep, 0.0),
        jxw_p=_pad_last(disc.jxw_p, Ep, 0.0),
        cell_offsets=_pad_offsets(disc.cell_offsets, Ep),
        free_mask_u=_pad_last(disc.free_mask_u, nup, 0.0),
        dirichlet_values=_pad_last(disc.dirichlet_values, nup, 0.0),
        f_neumann=_pad_last(disc.f_neumann, nup, 0.0),
        f_well=_pad_last(disc.f_well, npp, 0.0),
        free_mask_p=_pad_last(disc.free_mask_p, npp, 0.0),
        dirichlet_values_p=_pad_last(disc.dirichlet_values_p, npp, 0.0),
        diag_mass=_pad_last(disc.diag_mass, npp, 1.0),
        diag_laplace=_pad_last(disc.diag_laplace, npp, 1.0),
        diag_elasticity=_pad_last(disc.diag_elasticity, nup, 1.0),
        hc_p=hc_p, hc_u=hc_u)


def real_sizes(disc):
    """(n_pdofs, n_udofs) of the REAL mesh (from the FE spaces)."""
    return (disc.pressure_space.n_nodes,
            disc.pressure_space.mesh.dim * disc.displacement_space.n_nodes)


def slice_state(state, n_p: int, n_u: int):
    """Restrict a (possibly padded) State to the real dof counts (derived
    caches dropped — they are layout/shape-bound)."""
    return dataclasses.replace(
        state, p=state.p[:n_p], u=state.u[:n_u], eps_v=state.eps_v[:n_p],
        eps_v0=state.eps_v0[:n_p], strains=state.strains[:, :n_p],
        u_rows=None, mech_b=None)


def pad_state(state, n_p: int, n_u: int, mech_b=None):
    """Zero-pad a real-sized State to the padded dof counts (phantom
    entries are exactly zero — the invariant the padded operators keep)."""
    return dataclasses.replace(
        state, p=_pad_last(state.p, n_p), u=_pad_last(state.u, n_u),
        eps_v=_pad_last(state.eps_v, n_p),
        eps_v0=_pad_last(state.eps_v0, n_p),
        strains=_pad_last(state.strains, n_p), u_rows=None, mech_b=mech_b)
