"""Preconditioned conjugate gradients and preconditioned Richardson (port
of ``poroelasticity_dealii_tpu/solvers/cg.py:61-204``).

The loop state lives on the device: the iterate, residual, direction, the
scalars ``rz`` and ``rnorm``, the count ``k`` and the tolerance.  The
iteration count is the number of A-applies, and an iteration runs while
``k < max_iter and rnorm > tol``, the reference's ``lax.while_loop``
condition, compared in float64 on the dtype-rounded norm.  Iterations run in
chunks of at most ``chunk``: one iteration body freezes a solve whose
condition fails (``torch.where``, as the reference's ``vmap`` of the
``while_loop`` freezes finished lanes), so the iterations a chunk runs past
convergence change nothing, and the host reads one flag per chunk
(:func:`.cuda_graphs.run_chunks`, which counts the reads and the chunks'
iterations under the call site's name: ``graph_key``'s first item, else
the solver's).  With a :class:`.cuda_graphs.ChunkGraphs`
each chunk is the replay of a captured CUDA graph.  The batched form gives
each right-hand side its own tolerance and count.  A Jacobi (Fletcher-Reeves)
iteration runs its vector update after the apply as one piece: on CUDA
vectors the kernels of :mod:`..ops.cg_update` (:func:`_jacobi_update_cuda`),
else plain torch (:func:`_jacobi_update_plain`), bit for bit the same; the
chunks count its iterations under ``fused_steps``.  :func:`richardson_solve`
keeps the same device-resident state and chunks, on one right-hand side or
a batch.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import numpy as np
import torch

from ..ops import cg_update
from .cuda_graphs import run_chunks


@dataclasses.dataclass
class CGResult:
    x: torch.Tensor
    iterations: torch.Tensor      # int64, 0-d or (n_rhs,)
    residual_norm: torch.Tensor   # x's dtype, 0-d or (n_rhs,)
    converged: torch.Tensor       # bool, 0-d or (n_rhs,)
    stalled: torch.Tensor = None  # bool: ended on the stagnation exit
    #                               (richardson_solve) rather than the cap


def lane_norm(x: torch.Tensor) -> torch.Tensor:
    """The 2-norm of each lane (last axis) of a batch."""
    return torch.linalg.norm(x, dim=-1)


class LocalReductions:
    """The reductions of vectors this process holds whole, and the
    defaults of :func:`cg_solve` (``dot``, ``norm``) and
    :func:`cg_solve_batched` (``lane_dot``, ``lane_norm``: one value per
    lane of the last axis).  The sharded kits
    (:class:`..parallel.rows.ShardedKit`) have the same five, taken across
    their group.  Each returns a device tensor."""

    @staticmethod
    def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.dot(a.reshape(-1), b.reshape(-1))

    norm = staticmethod(torch.linalg.norm)

    @staticmethod
    def all_equal(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return (a == b).all()

    @staticmethod
    def lane_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return (a * b).sum(-1)

    lane_norm = staticmethod(lane_norm)


def _site(graph_key, solver: str) -> str:
    """The call site's name: ``graph_key``'s first item, else ``solver``."""
    return graph_key[0] if graph_key else solver


def _tol64(tol, like: torch.Tensor) -> torch.Tensor:
    """``tol`` (number, array or tensor) as a float64 tensor on ``like``'s
    device: the exact value of a dtype-rounded tolerance.  A number is
    filled in on the device (no host-to-device copy, which would wait for
    the stream)."""
    if isinstance(tol, torch.Tensor):
        return tol.to(device=like.device, dtype=torch.float64)
    if np.ndim(tol) == 0:
        return torch.full((), float(tol), dtype=torch.float64,
                          device=like.device)
    return torch.as_tensor(np.asarray(tol, np.float64), device=like.device)


def _jacobi_update_plain(x, r, p, ap, rz, rnorm, dinv, active, dot, norm,
                         pre=None, flexible=False):
    """The CG iteration after its apply ``ap = A p``: the new ``(x, r, p,
    rz, rnorm)``, each left as it was where ``active`` is false.  ``rz``,
    ``rnorm`` and ``active`` are 0-d, or one per lane of a batch ``(n_rhs,
    n)``; ``dinv`` is the Jacobi inverse diagonal, or ``pre`` the
    preconditioner; ``flexible``: Polak-Ribiere beta clipped at 0, else
    Fletcher-Reeves; ``dot`` and ``norm`` as :func:`cg_solve` (a batch's:
    one value per lane).  Plain torch: every iteration on the CPU, and the
    operator-preconditioned and flexible ones everywhere; with ``dinv`` and
    Fletcher-Reeves, the twin of :func:`_jacobi_update_cuda`."""
    lane = (lambda t: t[:, None]) if active.dim() else (lambda t: t)
    alpha = rz / dot(p, ap)
    x_new = x + lane(alpha) * p
    r_new = r - lane(alpha) * ap
    z = r_new * dinv if pre is None else pre(r_new)
    rz_new = dot(r_new, z)
    if flexible:
        beta = torch.clamp(dot(z, r_new - r) / rz, min=0.0)
    else:
        beta = rz_new / rz
    p_new = z + lane(beta) * p
    a = lane(active)
    return (torch.where(a, x_new, x), torch.where(a, r_new, r),
            torch.where(a, p_new, p), torch.where(active, rz_new, rz),
            torch.where(active, norm(r_new), rnorm))


def _jacobi_update_cuda(x, r, p, ap, rz, rnorm, dinv, active, dot, norm):
    """:func:`_jacobi_update_plain`'s Jacobi, Fletcher-Reeves update with
    its vector algebra in two kernels (:mod:`..ops.cg_update`), each
    element rounded as there: the same bits.  The dots and the norm read
    the frozen residual ``r_out`` for ``r_new``; the two differ only where
    ``active`` is false, whose values the freeze discards."""
    alpha = rz / dot(p, ap)
    # an apply or a caller's vectors may be strided (a no-op when
    # contiguous)
    x, r_out, z = cg_update.jacobi_step(
        x.contiguous(), r.contiguous(), p.contiguous(), ap.contiguous(),
        dinv.contiguous(), alpha, active)
    rz_new = dot(r_out, z)
    p = cg_update.direction(z, p.contiguous(), rz_new / rz, active)
    return (x, r_out, p, torch.where(active, rz_new, rz),
            torch.where(active, norm(r_out), rnorm))


def _jacobi_update(b: torch.Tensor, dinv: torch.Tensor, batched: bool):
    """The update a Jacobi, Fletcher-Reeves CG solve of right-hand side
    ``b`` runs: the kernels on CUDA vectors, which raise on what they do
    not take (:func:`..ops.cg_update.check`), else the plain twin."""
    if b.device.type != "cuda":
        return _jacobi_update_plain
    cg_update.check(b, dinv, batched)
    return _jacobi_update_cuda


def cg_solve(apply_a: Callable, b: torch.Tensor, x0: torch.Tensor,
             diag: torch.Tensor = None, tol=0.0, max_iter: int = 1000,
             precond: Callable = None, apply_iter: Callable = None,
             flexible: bool = None, dot: Callable = LocalReductions.dot,
             norm: Callable = LocalReductions.norm, chunk: int = 8,
             graphs=None, graph_key=None) -> CGResult:
    """Solve ``A x = b`` by preconditioned CG from the start vector ``x0``.

    ``tol`` is an absolute residual L2 tolerance (number or 0-d tensor).
    ``diag``: Jacobi preconditioner, used when ``precond`` is None.
    ``apply_iter``: a cheaper operator for the per-iteration applies on
    search directions (it must equal ``apply_a`` on the Krylov subspace
    visited, e.g. the free-subspace elasticity apply when b and x0 carry
    the Dirichlet values); ``apply_a`` gives the initial residual.
    ``flexible``: Polak-Ribiere beta clipped at 0 (default: on exactly when
    an operator preconditioner is given).  ``dot``, ``norm``: the inner
    product and the residual norm (0-d tensors); the sharded mechanics kit
    passes its all-reduced ones, so every rank reads the same flag at every
    chunk boundary.  ``chunk``: iterations per host read.  ``graphs``,
    ``graph_key``: run each chunk as a captured graph of ``graphs``
    (:class:`.cuda_graphs.ChunkGraphs`) keyed on ``graph_key``, a tuple
    that starts with the call site's name, and on the shapes (the
    operators must be the same on every call with that key)."""
    if flexible is None:
        flexible = precond is not None
    if apply_iter is None:
        apply_iter = apply_a
    consts = (_tol64(tol, b),)
    if precond is None:
        consts += (1.0 / diag,)    # a per-solve input of a captured chunk
    if precond is None and not flexible:
        update = _jacobi_update(b, consts[1], False)
    else:
        update = functools.partial(_jacobi_update_plain, pre=precond,
                                   flexible=flexible)

    def pre(r, consts):
        return precond(r) if precond is not None else r * consts[1]

    def init(inputs, consts):
        b, x0 = inputs
        r = b - apply_a(x0)
        z = pre(r, consts)
        k = torch.zeros((), dtype=torch.int64, device=b.device)
        return (k, x0, r, z, dot(r, z), norm(r))

    def cond(state, consts):
        k, rnorm = state[0], state[-1]
        return (k < max_iter) & (rnorm.double() > consts[0])

    def step(state, consts):
        k, x, r, p, rz, rnorm = state
        active = cond(state, consts)
        dinv = consts[1] if precond is None else None
        return (k + active.long(), *update(x, r, p, apply_iter(p), rz, rnorm,
                                            dinv, active, dot, norm))

    fused = update is _jacobi_update_cuda
    key = None if graphs is None else (
        *graph_key, "cg", b.dtype, tuple(b.shape), max_iter, flexible,
        precond is None, fused)
    k, x, _, _, _, rnorm = run_chunks(init, step, cond, (b, x0), consts,
                                      max_iter, chunk, graphs, key,
                                      _site(graph_key, "cg"), fused)
    converged = rnorm.double() <= consts[0]
    return CGResult(x=x, iterations=k, residual_norm=rnorm,
                    converged=converged, stalled=torch.zeros_like(converged))


def richardson_solve(apply_a: Callable, b: torch.Tensor, x0: torch.Tensor,
                     precond: Callable, tol, max_iter: int,
                     norm: Callable = LocalReductions.norm, chunk: int = 1,
                     graphs=None, graph_key=None) -> CGResult:
    """Preconditioned Richardson iteration ``x += M^{-1}(b - A x)``, the f32
    companion of :func:`cg_solve` for strong operator preconditioners (a
    GMG V-cycle), whose CG quadratic forms fall below the f32 apply's own
    rounding noise: no dot product enters the update.

    An iteration runs while ``k < max_iter``, ``rnorm > tol`` and
    ``rnorm < 0.98 * rprev`` (the residual fell by 2% or more in the last
    iteration); ``stalled`` marks a solve that ended on that stagnation
    exit short of its tolerance.  The residual is carried in the state, so
    an iteration costs one preconditioner call and one apply.  ``tol``,
    ``norm``, ``chunk``, ``graphs`` and ``graph_key`` as in
    :func:`cg_solve`; a frozen iteration still runs its V-cycle, so chunks
    are short.

    Batched (the reference's ``vmap`` of the solve): ``b``, ``x0``
    (n_rhs, n), ``tol`` (n_rhs,) and ``norm`` taken over the last axis
    (:func:`lane_norm`); ``apply_a`` and ``precond`` act on the last axis.
    Each lane keeps its own count and exits, and a chunk runs while any
    lane is active."""
    consts = (_tol64(tol, b), b)

    def init(inputs, consts):
        (x0,) = inputs
        r = consts[1] - apply_a(x0)
        rnorm = norm(r)
        k = torch.zeros(rnorm.shape, dtype=torch.int64, device=x0.device)
        return (k, x0, r, rnorm, torch.full_like(rnorm, float("inf")))

    def lanes(state, consts):
        k, _, _, rnorm, rprev = state
        return (k < max_iter) & (rnorm.double() > consts[0]) \
            & (rnorm < 0.98 * rprev)

    def step(state, consts):
        k, x, r, rnorm, rprev = state
        active = lanes(state, consts)
        x_new = x + precond(r)
        r_new = consts[1] - apply_a(x_new)
        a = active.unsqueeze(-1)
        return (k + active.long(), torch.where(a, x_new, x),
                torch.where(a, r_new, r),
                torch.where(active, norm(r_new), rnorm),
                torch.where(active, rnorm, rprev))

    key = None if graphs is None else (
        *graph_key, "richardson", b.dtype, tuple(b.shape), max_iter)
    k, x, _, rnorm, rprev = run_chunks(
        init, step, lambda s, c: lanes(s, c).any(), (x0,), consts, max_iter,
        chunk, graphs, key, _site(graph_key, "richardson"))
    converged = rnorm.double() <= consts[0]
    return CGResult(x=x, iterations=k, residual_norm=rnorm,
                    converged=converged,
                    stalled=~converged & (rnorm >= 0.98 * rprev))


def cg_solve_batched(apply_a: Callable, b: torch.Tensor, x0: torch.Tensor,
                     diag: torch.Tensor, tol, max_iter: int, chunk: int = 8,
                     graphs=None, graph_key=None,
                     dot: Callable = LocalReductions.lane_dot,
                     norm: Callable = LocalReductions.lane_norm) -> CGResult:
    """Multi-RHS Jacobi-CG sharing one operator: ``b``, ``x0`` (n_rhs, n),
    ``tol`` (n_rhs,) absolute tolerances.  ``apply_a`` acts on the last
    axis and broadcasts over the first.  ``chunk``, ``graphs``,
    ``graph_key``: as in :func:`cg_solve`; a chunk runs while any lane is
    active.  ``dot``, ``norm``: one inner product and one residual norm
    per lane (the ghost kit passes its all-reduced ones)."""
    consts = (_tol64(tol, b), 1.0 / diag)
    update = _jacobi_update(b, consts[1], True)

    def init(inputs, consts):
        b, x0 = inputs
        r = b - apply_a(x0)
        z = r * consts[1]
        k = torch.zeros(b.shape[0], dtype=torch.int64, device=b.device)
        return (k, x0, r, z, dot(r, z), norm(r))

    def lanes(state, consts):
        k, rnorm = state[0], state[-1]
        return (k < max_iter) & (rnorm.double() > consts[0])

    def step(state, consts):
        k, x, r, p, rz, rnorm = state
        active = lanes(state, consts)
        return (k + active.long(), *update(x, r, p, apply_a(p), rz, rnorm,
                                            consts[1], active, dot, norm))

    fused = update is _jacobi_update_cuda
    key = None if graphs is None else (
        *graph_key, "cg_batched", b.dtype, tuple(b.shape), max_iter, fused)
    k, x, _, _, _, rnorm = run_chunks(
        init, step, lambda s, c: lanes(s, c).any(), (b, x0), consts,
        max_iter, chunk, graphs, key, _site(graph_key, "cg_batched"), fused)
    converged = rnorm.double() <= consts[0]
    return CGResult(x=x, iterations=k, residual_norm=rnorm,
                    converged=converged, stalled=torch.zeros_like(converged))
