"""The port's chunked CG loops against the loop they replace, which read the
residual norm back on every iteration, written out here as the reference.

A chunk of C iterations freezes a solve whose condition fails, so for every
C the iterate, the count, the final norm and the converged flag must equal
the per-iteration loop's bit for bit (the same operations in the same
order on the same values; no tolerance).  The cases cover a solve that
converges mid-chunk, the iteration cap reached mid-chunk, ``tol = inf``
(no iteration), ``tol = 0`` (the cap), the flexible (Polak-Ribiere) and
Fletcher-Reeves updates with an operator preconditioner, and batched lanes
that stop in different chunks.
"""

import numpy as np
import pytest
import torch

from poroelasticity_dealii_torch.solvers import cg as tcg
from poroelasticity_dealii_torch.solvers.cuda_graphs import run_chunks

CHUNKS = [1, 3, 8, 1000]


# ---------------------------------------------------------------------------
# the per-iteration loops (the port's CG before the chunked loop)
# ---------------------------------------------------------------------------

def ref_cg_solve(apply_a, b, x0, diag=None, tol=0.0, max_iter=1000,
                 precond=None, flexible=None):
    if flexible is None:
        flexible = precond is not None
    if precond is None:
        inv_diag = 1.0 / diag
        precond = lambda r: r * inv_diag  # noqa: E731
    tol = float(tol)
    dot = lambda a, c: torch.dot(a.reshape(-1), c.reshape(-1))  # noqa: E731
    x = x0
    r = b - apply_a(x0)
    z = precond(r)
    p = z
    rz = dot(r, z)
    rnorm = torch.linalg.norm(r).item()
    k = 0
    while k < max_iter and rnorm > tol:
        ap = apply_a(p)
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
        rnorm = torch.linalg.norm(r).item()
        k += 1
    return x, k, rnorm, rnorm <= tol


def ref_cg_solve_batched(apply_a, b, x0, diag, tol, max_iter):
    tol = torch.as_tensor(tol).to(torch.float64)
    inv_diag = 1.0 / diag
    x = x0
    r = b - apply_a(x0)
    z = r * inv_diag
    p = z
    rz = (r * z).sum(-1)
    rnorm = torch.linalg.norm(r, dim=-1)
    k = torch.zeros(b.shape[0], dtype=torch.int64)
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
    return x, k, rnorm, rnorm.double() <= tol


# ---------------------------------------------------------------------------
# problems
# ---------------------------------------------------------------------------

def _spd(n, seed, cond):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    return (q * np.geomspace(1.0, cond, n)) @ q.T


def _problem(case, dtype):
    """(apply, b, x0, diag, tol, max_iter, precond, flexible) of a case."""
    n = 60
    a = _spd(n, 1, 1e4) + np.diag(np.geomspace(1.0, 1e3, n))
    rng = np.random.default_rng(2)
    b = rng.standard_normal(n)
    A, B = (torch.as_tensor(v, dtype=dtype) for v in (a, b))
    diag = torch.as_tensor(np.diag(a).copy(), dtype=dtype)
    x0 = torch.as_tensor(0.1 * rng.standard_normal(n), dtype=dtype)
    bnorm = float(np.linalg.norm(b))
    tol, max_iter, precond, flexible = 1e-6 * bnorm, 1000, None, None
    if case == "cap_mid_chunk":
        tol, max_iter = 1e-300, 7
    elif case == "tol_inf":
        tol = float("inf")
    elif case == "tol_zero":
        tol, max_iter = 0.0, 20
    elif case == "dtype_tol":
        # a 0-d tensor in the working type, as the solver's sites pass
        tol = torch.linalg.norm(B) * 1e-5
    elif case in ("flexible", "fletcher_reeves"):
        # an operator preconditioner: a damped inverse of the diagonal
        # blocks (SPD, not the Jacobi scaling)
        m = torch.as_tensor(np.linalg.inv(a + 0.5 * np.diag(np.diag(a)))
                            * 0.7 + np.diag(0.3 / np.diag(a)), dtype=dtype)
        m = 0.5 * (m + m.T)
        precond = lambda r: m @ r  # noqa: E731
        flexible = case == "flexible"
        tol = 1e-9 * bnorm
    return (lambda x: A @ x), B, x0, diag, tol, max_iter, precond, flexible


CASES = ["converge", "cap_mid_chunk", "tol_inf", "tol_zero", "dtype_tol",
         "flexible", "fletcher_reeves"]


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("case", CASES)
def test_chunked_cg_equals_per_iteration_loop(case, chunk):
    dtype = torch.float32 if case == "dtype_tol" else torch.float64
    apply, b, x0, diag, tol, max_iter, precond, flexible = _problem(case,
                                                                    dtype)
    x_ref, k_ref, rn_ref, ok_ref = ref_cg_solve(
        apply, b, x0, diag, tol, max_iter, precond, flexible)
    res = tcg.cg_solve(apply, b, x0, diag, tol=tol, max_iter=max_iter,
                       precond=precond, flexible=flexible, chunk=chunk)
    assert torch.equal(res.x, x_ref)
    assert int(res.iterations) == k_ref
    assert float(res.residual_norm) == rn_ref
    assert bool(res.converged) == ok_ref
    expected = {"tol_inf": 0, "tol_zero": 20, "cap_mid_chunk": 7}
    if case in expected:
        assert k_ref == expected[case]
    else:
        assert ok_ref and 0 < k_ref < max_iter


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("max_iter", [1000, 75])
def test_chunked_batched_cg_equals_per_iteration_loop(chunk, max_iter):
    """Lanes of very different scales and tolerances stop in different
    chunks (100, 97, 52 and 103 iterations); with max_iter = 75 three
    lanes hit the cap (mid-chunk for C = 8) after one has stopped."""
    n, k = 50, 4
    a = _spd(n, 5, 1e3)
    rng = np.random.default_rng(6)
    b = rng.standard_normal((k, n))
    b[1] *= 1e6
    last = 1e-12 if max_iter == 1000 else 0.0
    tol = np.array([1e-10, 1e-9, 1e-3, last]) * np.linalg.norm(b, axis=1)
    A = torch.as_tensor(a)
    apply = lambda x: x @ A.T  # noqa: E731
    B = torch.as_tensor(b)
    x0 = torch.zeros((k, n), dtype=torch.float64)
    diag = torch.as_tensor(np.diag(a).copy())
    x_ref, k_ref, rn_ref, ok_ref = ref_cg_solve_batched(apply, B, x0, diag,
                                                        tol, max_iter)
    res = tcg.cg_solve_batched(apply, B, x0, diag, tol, max_iter,
                               chunk=chunk)
    assert torch.equal(res.x, x_ref)
    assert torch.equal(res.iterations, k_ref)
    assert torch.equal(res.residual_norm, rn_ref)
    assert torch.equal(res.converged, ok_ref)
    counts = k_ref.tolist()
    if max_iter == 1000:
        assert bool(ok_ref.all()) and len(set(counts)) == 4
        assert len({(c - 1) // 8 for c in counts}) > 1    # chunks of 8
    else:
        assert counts == [75, 75, 52, 75]


@pytest.mark.parametrize("size,budget,limit,steps,reads", [
    (1, 100, 10, 10, 11),      # one step a read; the last read stops it
    (3, 100, 10, 12, 5),       # 4 chunks of 3 (2 frozen steps), 5 reads
    (8, 100, 10, 16, 3),
    (8, 11, 30, 11, 2),        # the budget cuts the second chunk to 3
    (1000, 100, 10, 100, 1),   # one chunk, cut to the budget
    (4, 100, 0, 0, 1),         # false at the start: no chunk at all
])
def test_run_chunks_reads_once_per_chunk(size, budget, limit, steps, reads):
    """``run_chunks`` reads the flag once before each chunk (and once to
    stop, unless the budget is spent), cuts a chunk to the budget left,
    and its frozen steps leave the state as it was."""
    seen = {"steps": 0, "reads": 0}

    def cond(state, consts):
        return state[0] < consts[0]

    def step(state, consts):
        seen["steps"] += 1
        return (state[0] + cond(state, consts).long(),)

    def read(state, consts):
        seen["reads"] += 1
        return cond(state, consts)

    out = run_chunks(lambda inputs, consts: inputs, step, read,
                     (torch.zeros((), dtype=torch.int64),),
                     (torch.tensor(limit),), budget, size)
    assert int(out[0]) == min(limit, budget)
    assert seen == {"steps": steps, "reads": reads}
