"""The torch port's Q2 elasticity multigrid and ``richardson_solve``
against the JAX package (``solvers/multigrid.py``, ``solvers/cg.py``), in
float64 on the CPU from seeded numpy inputs: the parity embedding and the
prolongation multiplicity (exact), the flat and parity-resident Q2
transfers, and whole V-cycles with and without ``parity_layout`` at n = 8
and 16 with 2 and 3 levels (1e-10 relative to the JAX result's max); and
Richardson's iteration count, stall flag and solution (count and flag
exact, x to 1e-10), its stagnation guard, and its chunks."""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from poroelasticity_dealii_tpu.ops import parity2d as jp  # noqa: E402
from poroelasticity_dealii_tpu.solvers import cg as jcg  # noqa: E402
from poroelasticity_dealii_tpu.solvers import multigrid as jmg  # noqa: E402
from poroelasticity_dealii_tpu.solvers import structured as jst  # noqa: E402

from poroelasticity_dealii_torch import read_input_file  # noqa: E402
from poroelasticity_dealii_torch.ops import parity2d as tp  # noqa: E402
from poroelasticity_dealii_torch.solvers import cg as tcg  # noqa: E402
from poroelasticity_dealii_torch.solvers import multigrid as tmg  # noqa: E402
from poroelasticity_dealii_torch.solvers import structured as tst  # noqa: E402

GOLDEN = "configs/golden_2d.data"
TOL = 1e-10
F64 = torch.float64
LEVELS = [(8, 2), (8, 3), (16, 2), (16, 3)]


def _rel(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.fixture(scope="module")
def data():
    return read_input_file(GOLDEN)


@pytest.fixture(scope="module")
def hierarchies(data):
    """{(n, levels, parity): (port precond, port levels, JAX precond, JAX
    levels)}."""
    out = {}
    for n, L in LEVELS:
        for par in (False, True):
            pt, lt = tmg.build_gmg_elasticity(data, n, L, F64, "cpu",
                                              parity_layout=par)
            pj, lj = jmg.build_gmg_elasticity(data, n, L, np.float64,
                                              parity_layout=par)
            out[(n, L, par)] = (pt, lt, pj, lj)
    return out


def _free_vec(n, seed, data):
    d = tst.build_grid_discretization(data, cells_per_axis=n,
                                      multigrid="off",
                                      elasticity_backend="conv", device="cpu")
    r = np.random.default_rng(seed).standard_normal(d.n_udofs)
    return r * d.free_mask_u.numpy(), d


@pytest.mark.parametrize("dim,n_comp", [(2, 2), (3, 3), (2, 1)])
def test_embedding_and_multiplicity_equal_jax(dim, n_comp):
    from poroelasticity_dealii_torch.mesh.structured import (
        build_structured_space, structured_mesh)
    Et = tmg._parity_embedding_matrices(dim, 2, n_comp)
    Ej = jmg._parity_embedding_matrices(dim, 2, n_comp)
    assert np.array_equal(Et, Ej)
    nf = 4
    space, _ = build_structured_space(structured_mesh((10.0,) * dim, nf),
                                      nf, 2)
    conn = space.vector_cell_dofs(n_comp) if n_comp > 1 else \
        space.cell_nodes
    n_dofs = space.n_nodes * n_comp
    assert np.array_equal(
        tmg._prolong_multiplicity_np(Et, conn, nf, dim, n_comp, n_dofs),
        jmg._prolong_multiplicity_np(Ej, conn, nf, dim, n_comp, n_dofs))


@pytest.mark.parametrize("n_coarse", [2, 4, 8])
def test_parity_transfers_match_jax(n_coarse):
    rng = np.random.default_rng(n_coarse)
    tpp, trp, tmult = tp.make_parity_transfers(n_coarse, 2, F64, "cpu")
    jpp, jrp, jmult = jp.make_parity_transfers(n_coarse, 2, jnp.float64)
    assert np.array_equal(tmult, np.asarray(jmult))
    nf = 2 * n_coarse
    xc = tp.to_parity(torch.tensor(rng.standard_normal(
        (2 * n_coarse + 1) ** 2 * 2)), n_coarse, 2)
    xf = tp.to_parity(torch.tensor(rng.standard_normal(
        (2 * nf + 1) ** 2 * 2)), nf, 2)
    assert _rel(tpp(xc).numpy(), jpp(jnp.asarray(xc.numpy()))) <= 1e-12
    assert _rel(trp(xf).numpy(), jrp(jnp.asarray(xf.numpy()))) <= 1e-12
    # exact transposes: <P xc, xf> = <xc, R xf>
    a = float((tpp(xc) * xf).sum())
    b = float((xc * trp(xf)).sum())
    assert abs(a - b) <= 1e-12 * abs(a)


@pytest.mark.parametrize("n,L", LEVELS)
def test_flat_and_parity_transfers_match_jax(n, L, data, hierarchies):
    """Every level's masked P and R (flat), and P and R in parity layout
    where both ends are parity levels, against JAX's; R = P^T."""
    rng = np.random.default_rng(7 * n + L)
    for par in (False, True):
        _, lt, _, lj = hierarchies[(n, L, par)]
        for lv in range(L - 1):
            nf, nc = n // 2 ** lv, n // 2 ** (lv + 1)
            xc = rng.standard_normal((2 * nc + 1) ** 2 * 2)
            xf = rng.standard_normal((2 * nf + 1) ** 2 * 2)
            Pt = lt[lv].prolong(torch.tensor(xc)).numpy()
            Rt = lt[lv].restrict(torch.tensor(xf)).numpy()
            assert _rel(Pt, lj[lv].prolong(jnp.asarray(xc))) <= 1e-12
            assert _rel(Rt, lj[lv].restrict(jnp.asarray(xf))) <= 1e-12
            assert abs(Pt @ xf - xc @ Rt) <= 1e-12 * abs(Pt @ xf)
            if lt[lv].prolong_l is None:
                assert lj[lv].prolong_l is None
                continue
            Xc = tp.to_parity(torch.tensor(xc), nc, 2)
            Xf = tp.to_parity(torch.tensor(xf), nf, 2)
            # the parity-resident pair is the same P and R
            assert _rel(tp.from_parity(lt[lv].prolong_l(Xc), nf, 2), Pt) \
                <= 1e-12
            assert _rel(tp.from_parity(lt[lv].restrict_l(Xf), nc, 2), Rt) \
                <= 1e-12
            assert _rel(lt[lv].restrict_l(Xf).numpy(),
                        lj[lv].restrict_l(jnp.asarray(Xf.numpy()))) <= 1e-12


@pytest.mark.parametrize("par", [False, True])
@pytest.mark.parametrize("n,L", LEVELS)
def test_vcycle_matches_jax(n, L, par, data, hierarchies):
    pt, lt, pj, lj = hierarchies[(n, L, par)]
    r, _ = _free_vec(n, 3 * n + L, data)
    want = np.asarray(pj(jnp.asarray(r)))
    assert _rel(pt(torch.tensor(r)).numpy(), want) <= TOL
    assert [lv.lmax for lv in lt] == [lv.lmax for lv in lj]
    if par:
        assert lt[0].apply_l is not None and hasattr(pt, "rows")
        got = tp.from_parity(pt.rows(tp.to_parity(torch.tensor(r), n, 2)),
                             n, 2)
        assert _rel(got.numpy(), want) <= TOL
        assert (lt[L - 2].restrict_l is None) and (L < 3 or
                                                   lt[0].restrict_l
                                                   is not None)
    else:
        assert not hasattr(pt, "rows")


def test_gmg_levels_rule_matches_jax():
    for n in (8, 16, 64, 512, 40, 96):
        for dim in (2, 3):
            for mg in ("auto", "on", "off"):
                for dofs in (1000, 200_000):
                    assert tst._gmg_levels(n, dim, dofs, mg) == \
                        jst._gmg_levels(n, dim, dofs, mg)
    assert tst._gmg_levels(512, 2, 2_102_786, "auto") == 6
    assert tst.PARITY_AUTO_MIN_UDOFS == jst.PARITY_AUTO_MIN_UDOFS


# ---------------------------------------------------------------------------
# richardson_solve
# ---------------------------------------------------------------------------

def _elasticity_case(data, hierarchies, n=8, L=2):
    """The constrained 2D elasticity operator at n with the V-cycle of
    (n, L) as preconditioner, in both packages, and a right-hand side."""
    jd = jst.build_grid_discretization(data, cells_per_axis=n,
                                       multigrid="off",
                                       elasticity_backend="conv")
    r, td = _free_vec(n, 5, data)
    b = r + (1.0 - td.free_mask_u.numpy()) * 1e-3
    pt, _, pj, _ = hierarchies[(n, L, False)]
    return (td.elasticity_constrained, pt, jd.elasticity_constrained, pj, b)


@pytest.mark.parametrize("case", ["converged", "cap", "stagnation"])
def test_richardson_matches_jax(case, data, hierarchies):
    """A converged solve, one cut at its cap and one that stops on the
    stagnation exit (the V-cycle damped to 1%, so an iteration removes
    about 1% of the residual): equal counts, flags and x."""
    at, pt, aj, pj, b = _elasticity_case(data, hierarchies)
    tol = 1e-9 * np.linalg.norm(b)
    max_iter = 3 if case == "cap" else 100
    w = 0.01 if case == "stagnation" else 1.0
    x0 = np.zeros_like(b)
    rj = jcg.richardson_solve(aj, jnp.asarray(b), jnp.asarray(x0),
                              lambda r: w * pj(r), jnp.asarray(tol),
                              max_iter)
    rt = tcg.richardson_solve(at, torch.tensor(b), torch.tensor(x0),
                              lambda r: w * pt(r), tol, max_iter)
    assert int(rt.iterations) == int(rj.iterations)
    assert bool(rt.converged) == bool(rj.converged)
    assert bool(rt.stalled) == bool(rj.stalled)
    assert _rel(rt.x.numpy(), rj.x) <= TOL
    assert {"converged": bool(rt.converged),
            "cap": int(rt.iterations) == 3 and not bool(rt.stalled),
            "stagnation": bool(rt.stalled) and not bool(rt.converged)
            }[case]


def test_richardson_f64_floor_is_a_stagnation_exit(data, hierarchies):
    """Tolerance 0 in float64: both packages stop on the stagnation exit
    at the roundoff floor, well before the cap, with the same x (the exit
    iteration itself is set by roundoff: within 2 of each other)."""
    at, pt, aj, pj, b = _elasticity_case(data, hierarchies)
    x0 = np.zeros_like(b)
    rj = jcg.richardson_solve(aj, jnp.asarray(b), jnp.asarray(x0), pj,
                              jnp.asarray(0.0), 200)
    rt = tcg.richardson_solve(at, torch.tensor(b), torch.tensor(x0), pt,
                              0.0, 200)
    for res in (rj, rt):
        assert bool(res.stalled) and not bool(res.converged)
        assert int(res.iterations) < 100
    assert abs(int(rt.iterations) - int(rj.iterations)) <= 2
    assert _rel(rt.x.numpy(), rj.x) <= TOL


def test_richardson_stagnation_guard_matches_jax():
    """JAX's ``tests/test_cg.py::test_richardson_stagnation_guard`` in
    both packages: an unattainable tolerance stops on stagnation."""
    n = 50
    rng = np.random.default_rng(3)
    A = np.eye(n) + 0.1 * np.ones((n, n)) / n
    A = (A + A.T) / 2
    b = rng.standard_normal(n).astype(np.float32)
    Minv = np.linalg.inv(A)
    Aj, Mj = jnp.asarray(A, jnp.float32), jnp.asarray(Minv, jnp.float32)
    At, Mt = torch.tensor(A, dtype=torch.float32), torch.tensor(
        Minv, dtype=torch.float32)
    rj = jcg.richardson_solve(lambda x: Aj @ x, jnp.asarray(b),
                              jnp.zeros(n, jnp.float32), lambda r: Mj @ r,
                              tol=jnp.asarray(0.0, jnp.float32),
                              max_iter=1000)
    rt = tcg.richardson_solve(lambda x: At @ x, torch.tensor(b),
                              torch.zeros(n), lambda r: Mt @ r,
                              tol=torch.tensor(0.0), max_iter=1000)
    for res in (rj, rt):
        assert int(res.iterations) < 50
        assert not bool(res.converged) and bool(res.stalled)
        np.testing.assert_allclose(np.asarray(res.x),
                                   np.linalg.solve(A, b), rtol=1e-4)


@pytest.mark.parametrize("chunk", [1, 2, 5, 100])
def test_richardson_chunks_equal_one_step_reads(chunk, data, hierarchies):
    """Any chunk size gives the result of one host read per iteration,
    bit for bit (the frozen iterations change nothing)."""
    at, pt, _, _, b = _elasticity_case(data, hierarchies)
    b = torch.tensor(b)
    tol = 1e-9 * float(torch.linalg.norm(b))
    ref = tcg.richardson_solve(at, b, torch.zeros_like(b), pt, tol, 100,
                               chunk=1)
    got = tcg.richardson_solve(at, b, torch.zeros_like(b), pt, tol, 100,
                               chunk=chunk)
    assert int(got.iterations) == int(ref.iterations) > 1
    assert torch.equal(got.x, ref.x)
    assert torch.equal(got.residual_norm, ref.residual_norm)
    assert bool(got.stalled) == bool(ref.stalled)
