"""Preconditioned conjugate gradients (port of
``poroelasticity_dealii_tpu/solvers/cg.py:61-148, 193-204``).

The loop runs on the host and reads the residual norm back once per
iteration; the iteration count is the number of A-applies and the loop runs
while ``k < max_iter and rnorm > tol``, exactly the reference's
``lax.while_loop`` condition.  The batched form gives each right-hand side
the ``vmap`` lane semantics of the reference: every lane stops at its own
tolerance and keeps its own count, converged lanes stay frozen.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch


@dataclasses.dataclass
class CGResult:
    x: torch.Tensor
    iterations: object        # int, or (n_rhs,) int array when batched
    residual_norm: object     # float, or (n_rhs,) array
    converged: object         # bool, or (n_rhs,) bool array


class LocalReductions:
    """The reductions of vectors this process holds whole, and
    :func:`cg_solve`'s defaults.  The sharded mechanics kit
    (:class:`..parallel.rows.ShardedRowOps`) has the same three, taken
    across its group."""

    @staticmethod
    def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.dot(a.reshape(-1), b.reshape(-1))

    norm = staticmethod(torch.linalg.norm)
    all_equal = staticmethod(torch.equal)


def cg_solve(apply_a: Callable, b: torch.Tensor, x0: torch.Tensor,
             diag: torch.Tensor = None, tol=0.0, max_iter: int = 1000,
             precond: Callable = None, apply_iter: Callable = None,
             flexible: bool = None, dot: Callable = LocalReductions.dot,
             norm: Callable = LocalReductions.norm) -> CGResult:
    """Solve ``A x = b`` by preconditioned CG from the start vector ``x0``.

    ``tol`` is an absolute residual L2 tolerance (float or 0-d tensor).
    ``diag``: Jacobi preconditioner, used when ``precond`` is None.
    ``apply_iter``: a cheaper operator for the per-iteration applies on
    search directions (it must equal ``apply_a`` on the Krylov subspace
    visited, e.g. the free-subspace elasticity apply when b and x0 carry
    the Dirichlet values); ``apply_a`` gives the initial residual.
    ``flexible``: Polak-Ribiere beta clipped at 0 (default: on exactly when
    an operator preconditioner is given).  ``dot``, ``norm``: the inner
    product and the residual norm (0-d tensors); the sharded mechanics kit
    passes its all-reduced ones, so every rank reads the same norm at every
    loop test."""
    if flexible is None:
        flexible = precond is not None
    if apply_iter is None:
        apply_iter = apply_a
    if precond is None:
        inv_diag = 1.0 / diag
        precond = lambda r: r * inv_diag  # noqa: E731
    tol = float(tol)

    x = x0
    r = b - apply_a(x0)
    z = precond(r)
    p = z
    rz = dot(r, z)
    rnorm = norm(r).item()
    k = 0
    while k < max_iter and rnorm > tol:
        ap = apply_iter(p)
        alpha = rz / dot(p, ap)
        x = x + alpha * p
        r_new = r - alpha * ap
        z = precond(r_new)
        rz_new = dot(r_new, z)
        if flexible:
            beta = torch.clamp(dot(z, r_new - r) / rz, min=0.0)
        else:
            beta = rz_new / rz
        p = z + beta * p
        r, rz = r_new, rz_new
        rnorm = norm(r).item()
        k += 1
    return CGResult(x=x, iterations=k, residual_norm=rnorm,
                    converged=rnorm <= tol)


def cg_solve_batched(apply_a: Callable, b: torch.Tensor, x0: torch.Tensor,
                     diag: torch.Tensor, tol, max_iter: int) -> CGResult:
    """Multi-RHS Jacobi-CG sharing one operator: ``b``, ``x0`` (n_rhs, n),
    ``tol`` (n_rhs,) absolute tolerances.  ``apply_a`` acts on the last
    axis and broadcasts over the first."""
    tol = torch.as_tensor(tol, device=b.device).to(torch.float64)
    inv_diag = 1.0 / diag
    x = x0
    r = b - apply_a(x0)
    z = r * inv_diag
    p = z
    rz = (r * z).sum(-1)
    rnorm = torch.linalg.norm(r, dim=-1)
    k = torch.zeros(b.shape[0], dtype=torch.int64, device=b.device)
    while True:
        active = (k < max_iter) & (rnorm.double() > tol)
        if not bool(active.any()):
            break
        ap = apply_a(p)
        alpha = rz / (p * ap).sum(-1)
        x_new = x + alpha[:, None] * p
        r_new = r - alpha[:, None] * ap
        z = r_new * inv_diag
        rz_new = (r_new * z).sum(-1)
        p_new = z + (rz_new / rz)[:, None] * p
        a = active[:, None]
        x = torch.where(a, x_new, x)
        r = torch.where(a, r_new, r)
        p = torch.where(a, p_new, p)
        rz = torch.where(active, rz_new, rz)
        rnorm = torch.where(active, torch.linalg.norm(r_new, dim=-1), rnorm)
        k = k + active.long()
    rn = rnorm.double().cpu().numpy()
    return CGResult(x=x, iterations=k.cpu().numpy(), residual_norm=rn,
                    converged=rn <= tol.cpu().numpy())
