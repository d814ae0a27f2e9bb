"""The structured path's solver options in the torch port against the JAX
package, on the CPU from seeded numpy inputs (JAX in float64 unless a test
says float32, its Pallas rows kit never run here):

* 3D elasticity GMG: the V-cycle of a 2-level n = 8 hierarchy to 1e-12 of
  JAX's (the hierarchy built by ``build_grid_discretization`` with
  ``multigrid="on"``, and the level count JAX's rule gives at 40^3); the
  f32 GMG-Richardson step (p to 1e-5, u to 1e-4 of max) and the f64
  GMG-CG step (every count exact, the residual to 1e-6 relative);
* anisotropic grids: operators at (4, 2, 3) and (8, 3) to 1e-12 of max and
  f64 steps (counts exact, p to 1e-9), Mandel on 16 x 4 and Terzaghi on
  2 x 16 cells against JAX's runs (counts exact, p to 1e-9) and their
  series;
* degree pairs (Q1/Q1, Q2/Q2, Q3/Q1 in 2D, Q2/Q2 in 3D): operators to
  1e-12 and one f64 step each (counts exact, p to 1e-9), the degree-2
  pressure GMG V-cycle to 1e-12;
* node-block Jacobi: the blocks equal JAX's exactly, the preconditioner to
  1e-14, a mechanics CG with it (counts exact, x to 1e-10), block against
  Jacobi steps of the port (the deck's blocks are diagonal to roundoff, as
  JAX's docstring says: equal counts), and the z-slab kit's
  preconditioner on 2 and 3 gloo ranks bitwise equal to the unsharded
  one, the 2-rank step with it within the sharded-step tolerances;
* mixed-precision refinement: the six cases of ``tests/test_refinement.py``
  on the port (refined against the port's plain f64 path), each run also
  held against JAX's refined run of the same n = 4 conv or rows deck
  (counts and outer passes equal, the rows kit's native f64 mechanics CG
  within 1 per FSS iteration; p and u within 1e-9);
* the refusals that stay (JAX's errors), and decks with these options
  through ``SimulationRunner``.
"""

import dataclasses

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from poroelasticity_dealii_tpu.config import read_input_file as jread  # noqa: E402
from poroelasticity_dealii_tpu.ops import pallas_comp_major as jpcm  # noqa: E402
from poroelasticity_dealii_tpu.solvers import FixedStressSolver as JF  # noqa: E402
from poroelasticity_dealii_tpu.solvers import cg as jcg  # noqa: E402
from poroelasticity_dealii_tpu.solvers import multigrid as jmg  # noqa: E402
from poroelasticity_dealii_tpu.solvers import structured as jst  # noqa: E402

from poroelasticity_dealii_torch.config import read_input_file  # noqa: E402
from poroelasticity_dealii_torch.models.runner import SimulationRunner  # noqa: E402
from poroelasticity_dealii_torch.ops import comp_major as cm  # noqa: E402
from poroelasticity_dealii_torch.ops.node_blocks import \
    elasticity_node_blocks  # noqa: E402
from poroelasticity_dealii_torch.parallel import rows as pr  # noqa: E402
from poroelasticity_dealii_torch.parallel.sharding import make_slab_group  # noqa: E402
from poroelasticity_dealii_torch.solvers import cg as tcg  # noqa: E402
from poroelasticity_dealii_torch.solvers import multigrid as tmg  # noqa: E402
from poroelasticity_dealii_torch.solvers import structured as tst  # noqa: E402
from poroelasticity_dealii_torch.solvers.fss import FixedStressSolver  # noqa: E402
from test_torch_rows_sharding import _spawn  # noqa: E402

DECK = "configs/consolidation_3d.data"
GOLDEN = "configs/golden_2d.data"
F64 = torch.float64
BC = (1.05, 1.0)             # (bc_scale, bc_scale_prev) of a compared step
COUNTS = ("fss_iterations", "pressure_iterations", "pressure_cg_iterations",
          "mech_cg_iterations", "projection_cg_iterations")


def _rel(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _deck3(**kw):
    """The 3D deck with a relative mechanics tolerance (its absolute 1e-12
    lies below the float64 roundoff of the right-hand side, where CG counts
    follow the summation order)."""
    kw = {"mech_cg_relative": True, "mech_cg_tol": 1e-10, **kw}
    return (dataclasses.replace(jread(DECK), **kw),
            dataclasses.replace(read_input_file(DECK), **kw))


def _step_pair(jdata, tdata, steps=1, bc=BC, **build):
    """One JAX and one port run of ``steps`` steps from initial_state on
    the same build: [(numpy p, u, stats dict)] per package."""
    jd = jst.build_grid_discretization(jdata, **build)
    td = tst.build_grid_discretization(tdata, device="cpu", **build)
    out = []
    for solver in (JF(jd, jdata), FixedStressSolver(td, tdata)):
        st = solver.initial_state()
        for _ in range(steps):
            st, ss = solver.time_step(st, jdata.time_step, bc[0],
                                      bc_scale_prev=bc[1])
        out.append((np.asarray(st.p), np.asarray(st.u), {
            f: np.asarray(getattr(ss, f)).item()
            for f in COUNTS + ("pressure_error", "cg_converged")}))
    return out, jd, td


def _assert_counts(got, want, slack=0):
    """FSS, pressure and pressure-CG counts exact; mechanics and
    projection CG counts within ``slack`` per FSS iteration (the
    golden-physics decks: a residual there ends within roundoff of its
    tolerance, where the two packages' summation orders part by an
    iteration or two)."""
    assert got[:3] == want[:3], (got, want)
    assert all(abs(a - b) <= slack * got[0]
               for a, b in zip(got[3:], want[3:])), (got, want)


def _assert_step_equal(pair, p_rtol=1e-9, slack=0):
    (pj, uj, sj), (pt, ut, s_t) = pair
    assert s_t["cg_converged"] and sj["cg_converged"]
    _assert_counts([s_t[f] for f in COUNTS], [sj[f] for f in COUNTS], slack)
    assert abs(s_t["pressure_error"] - sj["pressure_error"]) <= \
        1e-6 * abs(sj["pressure_error"])
    np.testing.assert_allclose(pt, pj, rtol=p_rtol)
    np.testing.assert_allclose(ut, uj, rtol=0, atol=1e-8 * np.abs(uj).max())


def _assert_operators_equal(jd, td, seed, tol=1e-12):
    """mass, Laplace, elasticity, coupling and projection of the two
    discretizations on the same seeded vectors."""
    rng = np.random.default_rng(seed)
    p = rng.standard_normal(td.n_pdofs)
    u = rng.standard_normal(td.n_udofs)
    tp, tu = torch.tensor(p), torch.tensor(u)
    for got, want in (
            (td.mass(tp), jd.mass(jnp.asarray(p))),
            (td.laplace(tp), jd.laplace(jnp.asarray(p))),
            (td.elasticity(tu), jd.elasticity(jnp.asarray(u))),
            (td.coupling_rhs(tp), jd.coupling_rhs(jnp.asarray(p), 0.0)),
            (td.strain_projection_rhs(tu),
             jd.strain_projection_rhs(jnp.asarray(u)))):
        assert _rel(got.numpy(), want) <= tol
    for f in ("free_mask_u", "dirichlet_values", "free_mask_p", "f_well",
              "f_neumann", "diag_elasticity", "diag_mass", "diag_laplace"):
        want = np.asarray(getattr(jd, f))
        np.testing.assert_allclose(getattr(td, f).numpy(), want, rtol=1e-12,
                                   atol=1e-14 * max(np.abs(want).max(), 1))


# ---------------------------------------------------------------------------
# 3D elasticity GMG
# ---------------------------------------------------------------------------

def test_3d_vcycle_matches_jax():
    """The 2-level n = 8 V-cycle built by each package's
    build_grid_discretization(multigrid="on") on the conv backend, and by
    build_gmg_elasticity, on a seeded free vector; 'auto' at 40^3 gives
    JAX's 4 levels."""
    jdata, tdata = _deck3()
    jd = jst.build_grid_discretization(jdata, cells_per_axis=8,
                                       multigrid="on",
                                       elasticity_backend="conv")
    td = tst.build_grid_discretization(tdata, cells_per_axis=8,
                                       multigrid="on",
                                       elasticity_backend="conv",
                                       device="cpu")
    assert td.row_ops is None and td.gmg_precond is not None
    r = np.random.default_rng(8).standard_normal(td.n_udofs) \
        * td.free_mask_u.numpy()
    want = np.asarray(jd.gmg_precond(jnp.asarray(r)))
    assert _rel(td.gmg_precond(torch.tensor(r)).numpy(), want) <= 1e-12
    pt, lt = tmg.build_gmg_elasticity(tdata, 8, 2, F64, "cpu")
    assert len(lt) == 2
    assert _rel(pt(torch.tensor(r)).numpy(), want) <= 1e-12
    n_udofs = 3 * 81 ** 3
    assert tst._gmg_levels(40, 3, n_udofs, "auto") == \
        jst._gmg_levels(40, 3, n_udofs, "auto") == 4


def test_3d_gmg_richardson_f32_step_matches_jax():
    """float32 with GMG (tests/test_multigrid.py:126's deck): both
    packages run GMG-Richardson mechanics; counts of the FSS and pressure
    loops equal, p within 1e-5 and u within 1e-4 of max."""
    kw = dict(dtype="float32", fss_tol=1e-4, pressure_tol=1e-4,
              mech_cg_tol=1e-4, mech_cg_relative=True, pressure_cg_tol=1e-5,
              projection_cg_tol=1e-5)
    jdata, tdata = _deck3(**kw)
    ((pj, uj, sj), (pt, ut, s_t)), _, td = _step_pair(
        jdata, tdata, bc=(1.2, None), cells_per_axis=8, multigrid="on",
        elasticity_backend="conv")
    assert td.gmg_precond is not None and td.dtype == torch.float32
    assert s_t["cg_converged"] and sj["cg_converged"]
    assert s_t["mech_cg_iterations"] > 0
    for f in ("fss_iterations", "pressure_iterations"):
        assert s_t[f] == sj[f]
    assert _rel(pt, pj) <= 1e-5
    assert _rel(ut, uj) <= 1e-4


def test_3d_gmg_cg_f64_step_matches_jax():
    jdata, tdata = _deck3()
    pair, _, td = _step_pair(jdata, tdata, cells_per_axis=8, multigrid="on",
                             elasticity_backend="conv")
    assert td.gmg_precond is not None
    assert pair[1][2]["mech_cg_iterations"] > 0
    _assert_step_equal(pair)


def test_multigrid_on_with_unequal_counts_raises_as_jax():
    """'on' on an anisotropic grid raises JAX's error; the rows backend
    builds the (unused) hierarchy on 'on' as JAX's does, none on 'auto'."""
    jdata, tdata = _deck3()
    for mod, data, kw in ((jst, jdata, {}), (tst, tdata, {"device": "cpu"})):
        with pytest.raises(NotImplementedError,
                           match="elasticity GMG needs equal cells"):
            mod.build_grid_discretization(data, cells_per_axis=(4, 2, 4),
                                          multigrid="on",
                                          elasticity_backend="conv", **kw)
    d = tst.build_grid_discretization(tdata, cells_per_axis=8, multigrid="on",
                                      device="cpu")
    assert d.row_ops is not None and d.gmg_precond is not None
    assert tst.build_grid_discretization(tdata, cells_per_axis=8,
                                         device="cpu").gmg_precond is None


# ---------------------------------------------------------------------------
# anisotropic grids
# ---------------------------------------------------------------------------

REL_MECH = {"mech_cg_relative": True, "mech_cg_tol": 1e-10}


def _aniso_data(dim):
    """tests/test_structured.py::_setup_aniso's decks, both packages, with
    the relative mechanics tolerance of :func:`_deck3`."""
    out = []
    for read in (jread, read_input_file):
        data = dataclasses.replace(read(GOLDEN), **REL_MECH)
        if dim == 3:
            data = dataclasses.replace(
                data, dim=3, domain_size=(12.0, 6.0, 3.0),
                displacement_boundary_labels=(0, 1, 2, 3, 4, 5),
                displacement_boundary_components=(0, 0, 1, 1, 2, 2),
                displacement_boundary_values=(0, -1e-5, 0, -1e-5, 0, -1e-5))
        else:
            data = dataclasses.replace(data, domain_size=(10.0, 4.0))
        out.append(data)
    return out, (4, 2, 3) if dim == 3 else (8, 3)


@pytest.mark.parametrize("dim", [2, 3])
def test_aniso_operators_and_step_match_jax(dim):
    (jdata, tdata), ns = _aniso_data(dim)
    pair, jd, td = _step_pair(jdata, tdata, cells_per_axis=ns)
    assert td.info_p.cells_per_axis == ns and not td.info_p.isotropic
    assert td.row_ops is None and td.gmg_precond is None
    _assert_operators_equal(jd, td, seed=dim)
    assert pair[1][2]["pressure_iterations"] > 0
    _assert_step_equal(pair, slack=2)


def _runs_against_jax(jdata, tdata, bc_fn, steps, lower=None, upper=None):
    """``steps`` steps of both packages with Dirichlet scale ``bc_fn(t)``:
    every step's counts as :func:`_assert_counts` (slack 2) and p within
    1e-9; returns the port's last
    p, its discretization and t."""
    kw = {} if lower is None else {"lower": lower, "upper": upper}
    jd = jst.build_grid_discretization(jdata, **kw)
    td = tst.build_grid_discretization(tdata, device="cpu", **kw)
    sj, s_t = JF(jd, jdata), FixedStressSolver(td, tdata)
    aj, at = sj.initial_state(bc_scale=bc_fn(0.0)), \
        s_t.initial_state(bc_scale=bc_fn(0.0))
    t = 0.0
    for _ in range(steps):
        t += tdata.time_step
        aj, xj = sj.time_step(aj, jdata.time_step, bc_scale=bc_fn(t))
        at, xt = s_t.time_step(at, tdata.time_step, bc_scale=bc_fn(t))
        _assert_counts([getattr(xt, f) for f in COUNTS],
                       [int(getattr(xj, f)) for f in COUNTS], slack=2)
        np.testing.assert_allclose(at.p.numpy(), np.asarray(aj.p),
                                   rtol=1e-9, atol=1e-12 * float(
                                       np.abs(np.asarray(aj.p)).max()))
    return at.p.numpy(), td, t


def test_mandel_on_16x4_cells_matches_jax():
    from poroelasticity_dealii_torch.models import mandel as tm
    from poroelasticity_dealii_tpu.models import mandel as jm
    a, force = 10.0, 7.2e6     # tests/test_mandel.py's A and FORCE
    datas = []
    for m in (jm, tm):
        data = m.mandel_config(a=a, level=4, dt=5.0)
        mp_ = m.mandel_params(data, a=a, b=a, force=force)
        p0 = force * mp_.skempton * (1 + mp_.nu_u) / (3 * a)
        datas.append(dataclasses.replace(data, p_init=float(p0),
                                         cells_per_axis=(16, 4), **REL_MECH))
    mp_ = tm.mandel_params(datas[1], a=a, b=a, force=force)
    p, td, t = _runs_against_jax(
        *datas, lambda t: tm.mandel_plate_displacement(t, mp_), 20,
        lower=[0.0, 0.0], upper=[a, a])
    assert td.info_p.cells_per_axis == (16, 4)
    x = td.pressure_space.node_coords[:, 0]
    p_ana = tm.mandel_pressure(x, t, mp_)
    assert np.linalg.norm(p - p_ana) / np.linalg.norm(p_ana) < 0.06


def test_terzaghi_on_2x16_cells_matches_jax():
    from poroelasticity_dealii_torch.models import terzaghi as tz
    from poroelasticity_dealii_tpu.models import terzaghi as jz
    datas = [dataclasses.replace(m.terzaghi_config(level=4, dt=25.0,
                                                   resync=True),
                                 cells_per_axis=(2, 16), **REL_MECH)
             for m in (jz, tz)]
    p, td, _ = _runs_against_jax(*datas, lambda t: 1.0, 10)
    assert td.info_p.cells_per_axis == (2, 16)
    h, p0 = datas[1].domain_size[1], datas[1].p_init
    z = h / 2 - td.pressure_space.node_coords[:, 1]
    p_ana = tz.terzaghi_pressure(z, 250.0, tz.consolidation_coefficient(
        datas[1]), h, p0)
    assert np.linalg.norm(p - p_ana) / np.linalg.norm(p_ana) < 0.03


# ---------------------------------------------------------------------------
# degree pairs
# ---------------------------------------------------------------------------

PAIRS = [(2, (1, 1), 4), (2, (2, 2), 4), (2, (1, 3), 4), (3, (2, 2), 2)]


@pytest.mark.parametrize("dim,degrees,n", PAIRS)
def test_degree_pair_operators_and_step_match_jax(dim, degrees, n):
    kp, ku = degrees
    if dim == 2:
        jdata, tdata = (dataclasses.replace(read(GOLDEN), **REL_MECH)
                        for read in (jread, read_input_file))
    else:
        jdata, tdata = _deck3()
    pair, jd, td = _step_pair(jdata, tdata, cells_per_axis=n,
                              pressure_degree=kp, displacement_degree=ku)
    assert (td.info_p.degree, td.info_u.degree) == (kp, ku)
    assert td.row_ops is None
    _assert_operators_equal(jd, td, seed=10 * kp + ku)
    assert pair[1][2]["pressure_iterations"] > 0
    _assert_step_equal(pair, slack=2 if dim == 2 else 0)


def test_degree2_pressure_vcycle_matches_jax():
    _, data = _deck3()
    jdata, _ = _deck3()
    pt, lt = tmg.build_gmg_pressure(data, 4, 2, F64, "cpu", dt=30.0,
                                    pressure_degree=2)
    pj, _ = jmg.build_gmg_pressure(jdata, 4, 2, np.float64, dt=30.0,
                                   pressure_degree=2)
    assert lt[0].free_mask.shape[0] == 9 ** 3
    r = np.random.default_rng(5).standard_normal(9 ** 3) \
        * lt[0].free_mask.numpy()
    assert _rel(pt(torch.tensor(r)).numpy(), pj(jnp.asarray(r))) <= 1e-12


def test_other_degrees_go_to_the_conv_kit_and_refuse_rows():
    """Q2/Q2 'auto' in 3D and Q2/Q2 'auto' in 2D at size build the flat
    kit; 'pallas' and 'parity' ask for Q2/Q1 (JAX's messages); elasticity
    GMG needs Q2 displacement."""
    _, tdata = _deck3()
    d = tst.build_grid_discretization(tdata, cells_per_axis=2,
                                      pressure_degree=2, device="cpu")
    assert d.row_ops is None
    with pytest.raises(NotImplementedError,
                       match="Pallas elasticity backend needs a 3D Q2"):
        tst.build_grid_discretization(tdata, cells_per_axis=2,
                                      displacement_degree=1,
                                      elasticity_backend="pallas",
                                      device="cpu")
    with pytest.raises(NotImplementedError,
                       match="parity elasticity backend needs a 2D"):
        tst.build_grid_discretization(read_input_file(GOLDEN),
                                      cells_per_axis=4, pressure_degree=2,
                                      elasticity_backend="parity",
                                      device="cpu")
    with pytest.raises(NotImplementedError, match="assumes Q2"):
        tst.build_grid_discretization(tdata, cells_per_axis=8,
                                      displacement_degree=1, multigrid="on",
                                      device="cpu")


# ---------------------------------------------------------------------------
# node-block Jacobi
# ---------------------------------------------------------------------------

def _random_block_case(n, seed):
    """A random symmetric element matrix and a random free mask (many
    nodes free in several components, so the blocks are full)."""
    rng = np.random.default_rng(seed)
    ke = rng.standard_normal((81, 81))
    ke = ke @ ke.T + 81 * np.eye(81)
    mask = (rng.random((2 * n + 1) ** 3 * 3) > 0.2).astype(np.float64)
    return ke, mask


@pytest.mark.parametrize("n", [2, 3])
def test_node_blocks_equal_jax(n):
    ke, mask = _random_block_case(n, n)
    got = elasticity_node_blocks(ke, n, mask)
    assert np.array_equal(got, jpcm.elasticity_node_blocks(ke, n, mask))
    off = got - got * np.eye(3)
    assert np.abs(off).max() > 0


@pytest.mark.parametrize("nz_pad", [None, 6])
def test_block_precond_matches_jax(nz_pad):
    n = 3
    ke, mask = _random_block_case(n, 7)
    inv = np.linalg.inv(elasticity_node_blocks(ke, n, mask))
    rows = (nz_pad or n + 1) * 24
    R = np.random.default_rng(1).standard_normal((rows, cm._width(n)))
    got = cm.make_block_precond(inv, n, F64, "cpu", nz_pad=nz_pad)(
        torch.tensor(R)).numpy()
    want = np.asarray(jpcm.make_block_precond(inv, n, jnp.float64,
                                              nz_pad=nz_pad)(jnp.asarray(R)))
    assert _rel(got, want) <= 1e-14
    # the lazy form builds the same planes, once
    lazy = cm.lazy_block_precond(ke, n, mask, F64, "cpu", nz_pad=nz_pad)
    assert torch.equal(lazy(torch.tensor(R)), torch.tensor(got))
    assert lazy.build() is lazy.build()


def test_block_jacobi_mechanics_cg_matches_jax():
    """A mechanics solve in the row layout with the node-block
    preconditioner (flexible=False, the free-subspace apply per
    iteration), on the deck's constrained operator at n = 4, relative
    tolerance 1e-10: JAX's cg_solve with JAX's preconditioner and the
    port's, counts equal and x within 1e-10."""
    jdata, tdata = _deck3()
    n = 4
    td = tst.build_grid_discretization(tdata, cells_per_axis=n,
                                       device="cpu")
    jd = jst.build_grid_discretization(jdata, cells_per_axis=n,
                                       multigrid="off",
                                       elasticity_backend="conv")
    ro = td.row_ops
    mask = td.free_mask_u.numpy()
    b = np.random.default_rng(4).standard_normal(td.n_udofs) * mask
    tol = 1e-10 * np.linalg.norm(b)
    bp_j = jpcm.make_block_precond(np.linalg.inv(elasticity_node_blocks(
        td.element_ke, n, mask)), n, jnp.float64)
    m_rows = jnp.asarray(cm.to_rows_np(mask, n))

    def japply(R):
        return jpcm.to_rows(jd.elasticity_constrained(
            jpcm.from_rows(R, n)), n) * m_rows + R * (1.0 - m_rows)

    B = jpcm.to_rows(jnp.asarray(b), n)
    want = jcg.cg_solve(japply, B, jnp.zeros_like(B),
                        jnp.asarray(ro.diag_rows.numpy()), tol=tol,
                        max_iter=500, precond=bp_j, flexible=False)
    got = tcg.cg_solve(ro.constrained_apply, ro.to_rows(torch.tensor(b)),
                       torch.zeros_like(ro.diag_rows), ro.diag_rows,
                       tol=tol, max_iter=500, apply_iter=ro.free_apply,
                       precond=ro.block_precond, flexible=False)
    assert bool(got.converged) and bool(want.converged)
    assert int(got.iterations) == int(want.iterations) > 0
    assert _rel(got.x.numpy(), want.x) <= 1e-10


def test_block_steps_equal_jacobi_counts_on_the_deck():
    """'Mechanics preconditioner = block' on the rows kit: the deck's
    blocks are diagonal to roundoff, so the counts equal Jacobi's and the
    fields agree to the solve's tolerance (the JAX package's docstring,
    pallas_comp_major.py:187-194)."""
    _, tdata = _deck3()
    runs = {}
    for prec in ("jacobi", "block"):
        data = dataclasses.replace(tdata, mech_precond=prec)
        s = FixedStressSolver(tst.build_grid_discretization(
            data, cells_per_axis=4, device="cpu"), data)
        assert (s._block is not None) == (prec == "block")
        st, ss = s.time_step(s.initial_state(), data.time_step, *BC[:1],
                             bc_scale_prev=BC[1])
        runs[prec] = (st, ss)
    (sj, xj), (sb, xb) = runs["jacobi"], runs["block"]
    assert [getattr(xb, f) for f in COUNTS] == \
        [getattr(xj, f) for f in COUNTS]
    assert xb.mech_cg_iterations > 0
    np.testing.assert_allclose(sb.p.numpy(), sj.p.numpy(), rtol=1e-9)
    np.testing.assert_allclose(sb.u.numpy(), sj.u.numpy(), rtol=0,
                               atol=1e-8 * float(sj.u.abs().max()))


SLAB_N = 4


def _block_data():
    return dataclasses.replace(read_input_file(DECK), mech_cg_relative=True,
                               mech_cg_tol=1e-10, mech_precond="block")


def _slab_worker(rank, world, R):
    """The rank's slab of ``R`` through the slab kit's block
    preconditioner, and (2 ranks) one block-Jacobi step of the sharded
    production path."""
    data = _block_data()
    disc = tst.build_grid_discretization(data, cells_per_axis=SLAB_N,
                                         multigrid="off", device="cpu")
    sdisc = pr.shard_production_discretization(disc, make_slab_group("cpu"))
    ro = sdisc.row_ops
    out = {"z": ro.block_precond(ro.local_rows(R))}
    if world == 2:
        s = FixedStressSolver(sdisc, data)
        assert s._block is ro.block_precond
        st, ss = s.time_step(s.initial_state(), data.time_step, BC[0],
                             bc_scale_prev=BC[1])
        out["step"] = (st.p.clone(), st.u.clone(),
                       [getattr(ss, f) for f in COUNTS])
    return out


@pytest.mark.parametrize("world", [2, 3])
def test_slab_block_precond_matches_unsharded(world, tmp_path):
    data = _block_data()
    disc = tst.build_grid_discretization(data, cells_per_axis=SLAB_N,
                                         multigrid="off", device="cpu")
    ro = disc.row_ops
    R = ro.to_rows(torch.tensor(np.random.default_rng(world).standard_normal(
        disc.n_udofs)))
    outs = _spawn(_slab_worker, world, tmp_path, R)
    Lz = pr.slab_layers(SLAB_N, world)
    z = torch.cat([o["z"] for o in outs])
    assert z.shape[0] == world * Lz * 24
    assert torch.equal(z[:R.shape[0]], ro.block_precond(R))
    assert torch.equal(z[R.shape[0]:], torch.zeros_like(z[R.shape[0]:]))
    if world == 2:
        s = FixedStressSolver(disc, data)
        st, ss = s.time_step(s.initial_state(), data.time_step, BC[0],
                             bc_scale_prev=BC[1])
        for o in outs:
            p, u, counts = o["step"]
            np.testing.assert_allclose(p.numpy(), st.p.numpy(), rtol=1e-9)
            np.testing.assert_allclose(u.numpy(), st.u.numpy(), rtol=1e-8,
                                       atol=1e-10 * float(st.u.abs().max()))
            want = [getattr(ss, f) for f in COUNTS]
            assert counts[:3] == want[:3]
            assert abs(counts[3] - want[3]) <= 2
            assert abs(counts[4] - want[4]) <= 2


# ---------------------------------------------------------------------------
# mixed-precision refinement: tests/test_refinement.py's six cases, each
# also held against JAX's refined run of the same deck
# ---------------------------------------------------------------------------

def _refinement_data(read, mode, **kw):
    return dataclasses.replace(
        read(DECK), dtype="float64", t_max=120.0, mech_cg_tol=1e-12,
        mech_cg_relative=True, mixed_precision_refinement=mode, **kw)


def _refinement_solver(mode, cells=4, **kw):
    data = _refinement_data(read_input_file, mode, **kw)
    disc = tst.build_grid_discretization(data, cells_per_axis=cells,
                                         multigrid="off", device="cpu")
    return data, disc, FixedStressSolver(disc, data)


def _jax_refinement_solver(mode, cells=4, **kw):
    data = _refinement_data(jread, mode, **kw)
    disc = jst.build_grid_discretization(data, cells_per_axis=cells,
                                         multigrid="off")
    return data, disc, JF(disc, data)


def _bc_response_passes(monkeypatch):
    """Record, in order, the outer passes of each package's refinements
    capped at 30 passes (the flat mechanics solves and the bc response):
    {"jax": [...], "port": [...]}."""
    import jax

    passes = {"jax": [], "port": []}
    j_orig, t_orig = jcg.richardson_solve, FixedStressSolver._refine

    def j_rich(*a, **k):
        res = j_orig(*a, **k)
        if k.get("max_iter") == 30:
            jax.debug.callback(lambda n: passes["jax"].append(int(n)),
                               res.iterations)
        return res

    def t_refine(apply, b, x0, inner, tol, max_iter, batched=False):
        res = t_orig(apply, b, x0, inner, tol, max_iter, batched)
        if max_iter == 30:
            passes["port"].append(int(res.iterations))
        return res

    monkeypatch.setattr(jcg, "richardson_solve", j_rich)
    monkeypatch.setattr(FixedStressSolver, "_refine", staticmethod(t_refine))
    return passes


def _counts_of(stats):
    return [int(np.asarray(getattr(stats, f))) for f in COUNTS]


def test_refinement_knob_parses():
    from poroelasticity_dealii_torch.config import from_entries
    assert read_input_file(DECK).mixed_precision_refinement == "auto"
    with pytest.raises(Exception):
        from_entries({("TPU", "Mixed precision refinement"): "sometimes"})


def test_refinement_auto_is_off():
    for mode in ("auto", "off"):
        _, _, solver = _refinement_solver(mode, elasticity_backend="conv")
        assert solver._ir is None and solver._ir_mass is None
        assert solver._ir_pressure(30.0) is None


def _two_steps(make, mode):
    """The conv deck's initial state and two steps: (data, disc, solver,
    initial state, [(state, stats)] * 2)."""
    data, disc, solver = make(mode, elasticity_backend="conv")
    st0 = solver.initial_state()
    st, steps = st0, []
    for _ in range(2):
        st, stats = solver.time_step(st, data.time_step)
        steps.append((st, stats))
    return data, disc, solver, st0, steps


@pytest.fixture(scope="module")
def refined_pair():
    """The port's conv deck with the knob off and on."""
    return {mode: _two_steps(_refinement_solver, mode)
            for mode in ("off", "on")}


@pytest.fixture(scope="module")
def jax_refined():
    """JAX's refined run of the same deck."""
    return _two_steps(_jax_refinement_solver, "on")


def test_refined_matches_plain_f64(refined_pair):
    """Both converge, the solutions agree to the mechanics tolerance, and
    the refined path counts a handful of outer passes in every solve."""
    _, _, plain, st0_p, steps_p = refined_pair["off"]
    _, _, refined, st0_r, steps_r = refined_pair["on"]
    assert refined._ir is not None and refined._ir_mass is not None
    assert plain._ir is None
    np.testing.assert_allclose(st0_r.u.numpy(), st0_p.u.numpy(), rtol=0,
                               atol=1e-11 * float(st0_p.u.abs().max()))
    for (_, sp), (_, sr) in zip(steps_p, steps_r):
        assert sp.cg_converged and sr.cg_converged
        assert sr.mech_cg_iterations <= 6
        assert sr.pressure_cg_iterations <= 3 * sr.pressure_iterations + 3
        assert sr.projection_cg_iterations <= sp.projection_cg_iterations
    (st_p, sp), (st_r, sr) = steps_p[-1], steps_r[-1]
    scale = float(st_p.u.abs().max())
    np.testing.assert_allclose(st_r.u.numpy(), st_p.u.numpy(), rtol=0,
                               atol=1e-10 * scale)
    np.testing.assert_allclose(st_r.p.numpy(), st_p.p.numpy(), rtol=1e-10)
    assert sr.fss_iterations == sp.fss_iterations
    assert sr.pressure_iterations == sp.pressure_iterations


def test_refined_matches_jax(refined_pair, jax_refined):
    """The refined conv run against JAX's refined run of the same deck:
    at each step every count equal, the outer passes of the refined
    mechanics, pressure and projection solves included, and p and u
    within 1e-9 of JAX's (the initial state's u too)."""
    _, _, _, st0_t, steps_t = refined_pair["on"]
    _, _, jsolver, st0_j, steps_j = jax_refined
    assert jsolver._mixed_precision_inner() is not None
    uj0 = np.asarray(st0_j.u)
    np.testing.assert_allclose(st0_t.u.numpy(), uj0, rtol=0,
                               atol=1e-9 * np.abs(uj0).max())
    for (st_t, s_t), (st_j, sj) in zip(steps_t, steps_j):
        assert s_t.cg_converged and bool(sj.cg_converged)
        assert _counts_of(s_t) == _counts_of(sj)
        uj = np.asarray(st_j.u)
        np.testing.assert_allclose(st_t.u.numpy(), uj, rtol=0,
                                   atol=1e-9 * np.abs(uj).max())
        np.testing.assert_allclose(st_t.p.numpy(), np.asarray(st_j.p),
                                   rtol=1e-9)


def test_refined_bc_response_ramp(monkeypatch):
    """The bc-scale ramp drives the refined bc response: the port's step
    equals its plain f64 step to 1e-9, and against JAX's refined step
    every count and the bc response's outer passes are equal, u within
    1e-9."""
    passes = _bc_response_passes(monkeypatch)
    runs = {}
    for mode, make in (("off", _refinement_solver),
                       ("on", _refinement_solver),
                       ("jax", _jax_refinement_solver)):
        data, _, solver = make("off" if mode == "off" else "on",
                               elasticity_backend="conv")
        st, stats = solver.time_step(solver.initial_state(), data.time_step,
                                     bc_scale=1.1, bc_scale_prev=1.0)
        assert bool(stats.cg_converged), mode
        runs[mode] = (np.asarray(st.u), _counts_of(stats))
    scale = float(np.abs(runs["off"][0]).max())
    np.testing.assert_allclose(runs["on"][0], runs["off"][0],
                               rtol=0, atol=1e-9 * scale)
    assert runs["on"][1] == runs["jax"][1]
    np.testing.assert_allclose(runs["on"][0], runs["jax"][0], rtol=0,
                               atol=1e-9 * np.abs(runs["jax"][0]).max())
    # the initial state's mechanics, the bc response, the step's mechanics
    assert len(passes["port"]) == 3
    assert passes["port"] == passes["jax"], passes


def test_refined_residual_meets_reference_tolerance(refined_pair):
    """The f64 residual of the refined mechanics solution itself meets
    the 1e-12-relative tolerance."""
    _, disc, refined, _, steps = refined_pair["on"]
    st = steps[0][0]
    m = disc.free_mask_u
    b = m * (disc.coupling_rhs(st.p) + disc.f_neumann - refined._lift) \
        + (1.0 - m) * disc.dirichlet_values
    r = b - disc.elasticity_constrained(st.u)
    assert float(torch.linalg.norm(r) / torch.linalg.norm(b)) < 1e-12


def test_refined_bc_response_ramp_rows_inner(monkeypatch):
    """The ramp with the rows kit (the deck's 'auto' in 3D): the mechanics
    solve is native f64 rows CG, the bc response is refined with the f32
    rows inner (free-subspace apply), and the step equals the plain one to
    1e-9.  Against JAX's refined rows step (its Pallas kernels interpreted
    on the CPU): FSS, pressure, pressure-CG and projection counts and the
    bc response's outer passes equal, the native f64 mechanics CG count
    within 1 per FSS iteration (its 1e-12-relative residual ends within
    roundoff of its tolerance, where the two kits' summation orders
    part), u within 1e-9."""
    passes = _bc_response_passes(monkeypatch)
    sols, counts = {}, {}
    for mode, make in (("off", _refinement_solver),
                       ("on", _refinement_solver),
                       ("jax", _jax_refinement_solver)):
        data, disc, s = make("off" if mode == "off" else "on",
                             elasticity_backend="pallas")
        assert disc.row_ops is not None
        if mode == "on":
            assert s._ir is not None and s._ir_disc32.row_ops is not None
        if mode == "jax":
            assert s._mixed_precision_inner() is not None
            assert s.__dict__["_ir_disc32"].row_ops is not None
        st, stats = s.time_step(s.initial_state(), data.time_step,
                                bc_scale=1.1, bc_scale_prev=1.0)
        assert bool(stats.cg_converged), mode
        sols[mode] = np.asarray(s.materialize_u(st).u)
        counts[mode] = _counts_of(stats)
    scale = float(np.abs(sols["off"]).max())
    np.testing.assert_allclose(sols["on"], sols["off"], rtol=0,
                               atol=1e-9 * scale)
    _assert_counts(counts["on"], counts["jax"], slack=1)
    assert counts["on"][4] == counts["jax"][4]
    np.testing.assert_allclose(sols["on"], sols["jax"], rtol=0,
                               atol=1e-9 * np.abs(sols["jax"]).max())
    # the rows kit solves its mechanics natively: the bc response alone
    assert len(passes["port"]) == 1
    assert passes["port"] == passes["jax"], passes


# ---------------------------------------------------------------------------
# decks through the runner
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("option", [
    {"cells_per_axis": (4, 2, 2)},
    {"mech_precond": "block"},
    {"mixed_precision_refinement": "on", "dtype": "float64",
     "elasticity_backend": "conv"},
    {"elasticity_backend": "conv", "cells_per_axis": (4, 4, 4)}])
def test_runner_runs_option_decks(option, tmp_path, monkeypatch):
    """Each option through SimulationRunner (one step, no VTK): the conv
    deck with 'auto' multigrid builds its elasticity hierarchy once the
    threshold allows it."""
    monkeypatch.setattr(
        tst, "_gmg_levels",
        lambda n, dim, n_dofs, mg, **k: 2 if n == 4 and mg != "off" and not k
        else 1)
    kw = {"cells_per_axis": (3, 3, 3), **option}
    data = dataclasses.replace(
        read_input_file(DECK), t_max=read_input_file(DECK).time_step,
        output_vtk=False, output_directory=str(tmp_path), **kw)
    runner = SimulationRunner(data, device="cpu")
    if option.get("cells_per_axis") == (4, 4, 4):
        assert runner.disc.gmg_precond is not None
    state = runner.run()
    assert bool(torch.isfinite(state.p).all())
    assert (tmp_path / "run_log.jsonl").exists()
