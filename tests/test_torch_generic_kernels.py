"""The generic path's hand-written kernels (``csrc/generic.cu``, wrappers in
``ops/generic_apply.py``) and the applies that dispatch to them:

* ``Discretization.pressure_operator`` (``alpha M + beta L`` in one call)
  against the JAX package's ``alpha * mass + beta * laplace`` on the
  meshes of ``tests/test_torch_generic.py`` (distorted 2D/3D, both gmsh
  meshes, Cryer's octant), batched and not, float64 within 1e-12 of max;
  its plain form bit for bit the two applies it replaces in the
  fixed-stress solver; psum chunks and ghost windows (2 and 4 ranks in
  one process) against the unsharded apply;
* the dispatch rules: a CPU tensor takes the plain twins and counts no
  launch, every copy of a discretization (``.to()``, AMR bucketing, the
  psum shard, the ghost rank build) reaches the kernel wrappers with
  operand records of its own tensors, other degrees than Q2/Q1 run the
  plain applies, a tensor on another device raises;
* the launch plans, tile shapes, constants and entry points against the
  source, no atomics in any source or header, every kernel of the source
  grouped under its wrapper by ``tools/profile_step.py``;
* on the card (``-m cuda``, skipped here): each kernel against its twin
  on distorted 2D and 3D meshes, ``irregular_3d.msh``, bucketed AMR
  meshes with phantom cells, geometry shared by every cell and a ghost
  window, float64 within 1e-12 and float32 within 2e-6 of max, two calls
  bitwise equal; the operand records checked once, each call checking
  only its input.

The module imports nothing of JAX at its top, so the card's tests run
with ``python -m pytest --noconftest tests/test_torch_generic_kernels.py
-m cuda`` on a machine without JAX."""

import dataclasses
import re

import numpy as np
import pytest
import torch

from poroelasticity_dealii_torch import read_input_file
from poroelasticity_dealii_torch.amr.bucketing import pad_amr_discretization
from poroelasticity_dealii_torch.amr.driver import build_amr_discretization
from poroelasticity_dealii_torch.amr.forest import QuadForest
from poroelasticity_dealii_torch.mesh import hyper_rectangle
from poroelasticity_dealii_torch.mesh.generator import perturb_interior
from poroelasticity_dealii_torch.ops import _cuda
from poroelasticity_dealii_torch.ops import comp_major as cm
from poroelasticity_dealii_torch.ops import generic_apply as ga
from poroelasticity_dealii_torch.ops import operators as ops
from poroelasticity_dealii_torch.parallel import ghost as gh
from poroelasticity_dealii_torch.parallel.sharding import (
    SlabGroup, shard_discretization)
from poroelasticity_dealii_torch.solvers.discretization import \
    build_discretization

GOLDEN = "configs/golden_2d.data"
DECK_3D = "configs/consolidation_3d.data"
CPU = torch.device("cpu")
CSRC = _cuda._PKG / "csrc"
TOL = {torch.float64: 1e-12, torch.float32: 2e-6}   # relative to max |y|
ALPHA, BETA = 0.7, 1.3
LANES = (None, 3, 6)      # unbatched, the 2D and 3D projection lanes


def _rel(got, want) -> float:
    got = torch.as_tensor(np.asarray(got, np.float64))
    want = torch.as_tensor(np.asarray(want, np.float64))
    assert got.shape == want.shape
    scale = want.abs().max().item()
    return (got - want).abs().max().item() / (scale if scale > 0 else 1.0)


def _p_input(d, lanes, seed=5):
    shape = (d.n_pdofs,) if lanes is None else (lanes, d.n_pdofs)
    return np.random.default_rng(seed).standard_normal(shape)


# ---------------------------------------------------------------------------
# pressure_operator against JAX and against the applies it replaces
# ---------------------------------------------------------------------------

def _jax_case(case):
    """(port disc, JAX disc) of a ``tests/test_torch_generic.py`` case."""
    pytest.importorskip("jax")
    import test_torch_generic as tg
    return tg._built(case)


@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("case", ["perturbed_2d_6", "perturbed_3d_3",
                                  "perturbed_3d_4", "irregular_2d_msh",
                                  "irregular_3d_msh", "cryer_3"])
def test_pressure_operator_equals_jax(case, lanes):
    import jax.numpy as jnp
    d, jd = _jax_case(case)
    x = _p_input(d, lanes)
    got = d.pressure_operator(torch.as_tensor(x), ALPHA, BETA)
    def jax_op(v):      # JAX's applies take one vector: lane by lane
        v = jnp.asarray(v)
        return ALPHA * np.asarray(jd.mass(v)) + BETA * np.asarray(
            jd.laplace(v))

    want = jax_op(x) if lanes is None else np.stack([jax_op(v) for v in x])
    assert got.dtype == torch.float64
    assert _rel(got.numpy(), want) <= 1e-12


def _small(dim=3, n=3, **kw):
    data = read_input_file(DECK_3D if dim == 3 else GOLDEN)
    mesh = perturb_interior(hyper_rectangle([10.0] * dim, cells_per_axis=n),
                            0.2, seed=n)
    return data, build_discretization(mesh, data, device="cpu", **kw)


def test_plain_form_is_the_solver_s_two_applies_bit_for_bit():
    """On the CPU the pressure Jacobian's one call gives the bits of the
    expression the fixed-stress solver evaluated before it, and the mass
    and Laplacian alone are the plain applies, bit for bit."""
    data, d = _small()
    x = torch.as_tensor(_p_input(d, None))
    xb = torch.as_tensor(_p_input(d, 6))
    a, b = 1.0 / data.m_modulus / data.time_step, data.perm / data.visc
    for v in (x, xb):
        mass = ops.apply_mass(v, d.conn_p, d.plan_p, d.psi_p_at_pq, d.jxw_p)
        lap = ops.apply_laplace(v, d.conn_p, d.plan_p, d.dref_p_at_pq,
                                d.jinv_p, d.jxw_p)
        assert torch.equal(d.mass(v), mass)
        assert torch.equal(d.laplace(v), lap)
        assert torch.equal(d.pressure_operator(v, a, b), a * mass + b * lap)
    u = torch.as_tensor(np.random.default_rng(2).standard_normal(d.n_udofs))
    assert torch.equal(d.elasticity(u), ops.apply_elasticity(
        u, d.conn_u, d.plan_u, d.dref_u_at_uq, d.jinv_u, d.jxw_u, d.lam,
        d.mu))
    assert torch.equal(d.pressure_operator(x, 0.0, 0.0),
                       torch.zeros_like(x))


def test_solver_pressure_jacobian_calls_the_fused_operator(monkeypatch):
    """The generic branch of the pressure Jacobian is one
    ``pressure_operator`` call per apply, with the solver's coefficients."""
    from poroelasticity_dealii_torch.solvers.fss import FixedStressSolver
    data, d = _small(n=2)
    calls = []
    real = type(d).pressure_operator

    def spy(self, x, alpha, beta):
        calls.append((alpha, beta))
        return real(self, x, alpha, beta)

    monkeypatch.setattr(type(d), "pressure_operator", spy)
    s = FixedStressSolver(d, data)
    x = torch.as_tensor(_p_input(d, None))
    dt = data.time_step
    s._pressure_jacobian_apply(x, dt)
    assert calls == [(1.0 / data.m_modulus / dt, data.perm / data.visc)]


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("case", ["golden3", "cube8"])
def test_ghost_window_pressure_operator_matches_unsharded(case, k):
    """Ghost's new window entry: every rank's window-local pressure
    operator, windows and returns through the in-process transport,
    stitched, against the unsharded renumbered apply (1 and 3 lanes)."""
    import test_torch_ghost as tgh
    rd = tgh._renumbered(case)[0]
    ranks = tgh._ranks(case, k)
    assert gh.WINDOW_APPLIES["pressure_operator"] == ("p", "p")
    for lanes in (None, 3):
        x = torch.as_tensor(_p_input(rd, lanes))
        got, _ = gh.split_apply(ranks, "pressure_operator", x, ALPHA, BETA)
        ref = rd.pressure_operator(x, ALPHA, BETA)
        assert _rel(got, ref) <= 1e-13
        assert _rel(got, ALPHA * rd.mass(x) + BETA * rd.laplace(x)) <= 1e-13


def test_psum_chunks_sum_to_the_unsharded_pressure_operator():
    """The psum form's pressure operator on each chunk (no group: one
    process, no all-reduce) sums to the unsharded one."""
    _, d = _small(n=4)
    x = torch.as_tensor(_p_input(d, 3))
    chunks = [shard_discretization(d, SlabGroup(r, 3, None, CPU))
              for r in range(3)]
    got = sum(c.pressure_operator(x, ALPHA, BETA) for c in chunks)
    assert _rel(got, d.pressure_operator(x, ALPHA, BETA)) <= 1e-13


@pytest.mark.parametrize("case", ["perturbed_3d_3", "amr_2d"])
def test_generic_library_csr_equals_the_applies(case):
    """The generic kernels' yardstick (tools/apply_bench.py::
    generic_library_csr, one CSR matrix of the assembled operator)
    computes what the applies compute, phantom cells left out."""
    from poroelasticity_dealii_torch.tools import apply_bench
    d = _small()[1] if case == "perturbed_3d_3" else \
        apply_bench.generic_case(case)
    rng = np.random.default_rng(8)
    u = torch.as_tensor(rng.standard_normal(d.n_udofs))
    x = torch.as_tensor(rng.standard_normal(d.n_pdofs))
    M = apply_bench.generic_library_csr(d, "generic_elasticity_apply")
    assert _rel(torch.mv(M, u), d.elasticity(u)) <= 1e-13
    M = apply_bench.generic_library_csr(d, "generic_q1_apply", ALPHA, BETA)
    assert _rel(torch.mv(M, x), d.pressure_operator(x, ALPHA, BETA)) <= 1e-13


def test_generic_run_on_the_cpu():
    """tools/apply_bench.py generic at n = 2 on the CPU: every apply, both
    dtypes, against its twin (itself there), no kernel and no time."""
    from poroelasticity_dealii_torch.tools import apply_bench
    recs = apply_bench.generic_run(2, "cpu", library=False)
    assert [(r["apply"], r["dtype"]) for r in recs] == [
        (a, t) for t in ("float32", "float64")
        for a in (*apply_bench.GENERIC_APPLIES, *apply_bench.GENERIC_BATCHED)]
    assert [r["lanes"] for r in recs[-2:]] == [6, 6]
    for r in recs:
        assert r["bitwise_repeat"] and r["finite"] and r["kernel"] is None
        assert r["max_abs_err"] == 0.0 and "ms" not in r
        assert r["bound_by"] == "bytes" and r["launches"] == {}


# ---------------------------------------------------------------------------
# dispatch rules
# ---------------------------------------------------------------------------

@pytest.fixture
def spies(monkeypatch):
    """Records the kernel wrappers' calls (each still computes)."""
    seen = []
    for name in ("generic_elasticity_apply", "generic_q1_apply"):
        real = getattr(ga, name)

        def spy(*args, _real=real, _name=name):
            seen.append(_name)
            return _real(*args)

        monkeypatch.setattr(ga, name, spy)
    return seen


def _apply_all(d):
    x = torch.as_tensor(_p_input(d, None))
    u = torch.as_tensor(np.random.default_rng(3).standard_normal(d.n_udofs))
    return [d.mass(x), d.laplace(x), d.pressure_operator(x, ALPHA, BETA),
            d.elasticity(u)]


def _window_applies(r):
    """A ghost rank's window-local applies (its windows: C + 2H values)."""
    rng = np.random.default_rng(6)
    wp = torch.as_tensor(rng.standard_normal(r.C_p + 2 * r.H_p))
    wu = torch.as_tensor(rng.standard_normal(r.C_u + 2 * r.H_u))
    return [r.window_apply("mass", wp), r.window_apply("laplace", wp),
            r.window_apply("pressure_operator", wp, ALPHA, BETA),
            r.window_apply("elasticity", wu)]


def test_cpu_tensors_take_the_twins_and_count_nothing(spies):
    _, d = _small()
    cm.reset_launch_counts()
    out = _apply_all(d)
    assert spies == ["generic_q1_apply"] * 3 + ["generic_elasticity_apply"]
    assert list(cm.launch_counts().values()) == [0] * len(cm.LAUNCH_KEYS)
    x = torch.as_tensor(_p_input(d, None))
    u = torch.as_tensor(np.random.default_rng(3).standard_normal(d.n_udofs))
    q1 = (d.conn_p, d.psi_p_at_pq, d.dref_p_at_pq, d.jinv_p, d.jxw_p)
    twins = [ga.generic_q1_apply_plain(x, *q1, a, b, d.plan_p)
             for a, b in ((1.0, 0.0), (0.0, 1.0), (ALPHA, BETA))]
    twins.append(ga.generic_elasticity_apply_plain(
        u, d.conn_u, d.dref_u_at_uq, d.jinv_u, d.jxw_u, d.lam, d.mu,
        d.plan_u))
    for a, b in zip(out, twins):
        assert torch.equal(a, b)


def _copy(name):
    """(a copy of a discretization whose own records exist, its applies)
    by way ``name``."""
    _, d = _small()
    _apply_all(d)
    if name == "to":
        c = d.to("cpu")
    elif name == "replace":
        c = dataclasses.replace(d, jinv_p=d.jinv_p.clone())
    elif name == "psum":
        c = shard_discretization(d, SlabGroup(0, 2, None, CPU))
    elif name == "bucketed":
        forest = QuadForest.uniform([-5, -5], [5, 5], 2)
        forest.refine_and_coarsen([leaf for leaf in forest.leaves
                                   if leaf[1] == 0 and leaf[2] == 0], [])
        amr = build_amr_discretization(forest, read_input_file(GOLDEN),
                                       device="cpu")
        _apply_all(amr)
        c = pad_amr_discretization(amr)
    else:
        c = gh.shard_renumbered(gh.renumber_discretization(d),
                                SlabGroup(1, 2, None, CPU))
        return c, lambda: _window_applies(c)
    return c, lambda: _apply_all(c)


@pytest.mark.parametrize("name", ["to", "replace", "psum", "bucketed",
                                  "ghost"])
def test_every_copy_reaches_the_wrappers_with_its_own_operands(spies, name):
    """Every copy of a discretization (``.to()``, ``dataclasses.replace``,
    the psum shard, AMR bucketing, the ghost rank build) sends its applies
    to the kernel wrappers, with operand records made from the copy's own
    tensors, never the source's."""
    c, apply = _copy(name)
    spies.clear()
    apply()
    assert spies == ["generic_q1_apply"] * 3 + ["generic_elasticity_apply"]
    q, e = c.q1_operands, c.elasticity_operands
    assert all(a is b for a, b in zip(
        (q.conn, q.psi, q.dref, q.jinv, q.jxw, q.offsets, q.plan),
        (c.conn_p, c.psi_p_at_pq, c.dref_p_at_pq, c.jinv_p, c.jxw_p,
         c.cell_offsets, c.plan_p)))
    assert all(a is b for a, b in zip(
        (e.conn, e.dref, e.jinv, e.jxw, e.offsets, e.plan),
        (c.conn_u, c.dref_u_at_uq, c.jinv_u, c.jxw_u, c.cell_offsets,
         c.plan_u)))
    assert (e.lam, e.mu) == (c.lam, c.mu)
    # the map's tables at each kernel's own Gauss points, in the copy's
    # dtype and on its device
    dim = c.dim
    assert tuple(e.dn1.shape) == (3 ** dim, 2 ** dim, dim)
    assert tuple(e.weights.shape) == (3 ** dim,)
    for t in (e.dn1, e.weights):
        assert t.dtype == c.dtype and t.device == c.device
    assert c.q1_operands is q        # made once per instance


@pytest.mark.parametrize("degrees,reached", [
    ((1, 2), ["generic_q1_apply"] * 3 + ["generic_elasticity_apply"]),
    ((2, 2), ["generic_elasticity_apply"]),
    ((1, 3), ["generic_q1_apply"] * 3),
])
def test_degree_rule(spies, degrees, reached):
    """The kernels take Q1 pressures and Q2 displacements (2D and 3D):
    every other degree runs the plain applies by that rule."""
    kp, ku = degrees
    _, d = _small(dim=2, n=2, pressure_degree=kp, displacement_degree=ku)
    assert ga.takes_q1(d.psi_p_at_pq, d.dref_p_at_pq, 2) == (kp == 1)
    assert ga.takes_elasticity(d.dref_u_at_uq, 2) == (ku == 2)
    _apply_all(d)
    assert spies == reached


def test_wrappers_raise_off_the_cpu_without_a_kernel():
    """A tensor on neither the CPU nor a CUDA device raises: no twin
    behind the wrapper's back."""
    _, d = _small()
    m = lambda t: t.to("meta")  # noqa: E731
    e = d.elasticity_operands
    with pytest.raises(ValueError, match="no kernel"):
        ga.generic_q1_apply(m(torch.zeros(d.n_pdofs)), ga.Q1Operands(
            m(d.conn_p), m(d.psi_p_at_pq), m(d.dref_p_at_pq), m(d.jinv_p),
            m(d.jxw_p), m(d.cell_offsets), d.plan_p), 1.0, 0.0)
    with pytest.raises(ValueError, match="no kernel"):
        ga.generic_elasticity_apply(
            m(torch.zeros(d.n_udofs)), ga.ElasticityOperands(
                m(d.conn_u), m(d.dref_u_at_uq), m(d.jinv_u), m(d.jxw_u),
                m(d.cell_offsets), m(e.dn1), m(e.weights), d.lam, d.mu,
                d.plan_u))
    # a CPU discretization's operands have no kernel to be checked for
    with pytest.raises(ValueError, match="no kernel"):
        d.q1_operands.checked


# ---------------------------------------------------------------------------
# the source against its Python side
# ---------------------------------------------------------------------------

def _generic_source() -> str:
    return (CSRC / "generic.cu").read_text()


def _constexpr_env(struct_body: str, env: dict) -> dict:
    """Evaluate the ``static constexpr`` members of a struct body of the
    source in order (C integer arithmetic on non-negative operands, one
    level of ``?:``), with ``env`` holding the template's parameters."""
    env = dict(env)
    for name, expr in re.findall(
            r"static constexpr (?:int|bool) (\w+) =\s*([^;]*);", struct_body):
        e = re.sub(r"static_cast<int>\((sizeof\(T\))\)", r"\1", expr)
        e = e.replace("sizeof(T)", "ITEM").replace("P::", "")
        e = re.sub(r"\(([^()?]*)\?([^():]*):([^()]*)\)",
                   r"((\2) if (\1) else (\3))", e)
        m = re.fullmatch(r"([^?]*)\?([^:]*):(.*)", e)
        if m:
            e = f"(({m.group(2)}) if ({m.group(1)}) else ({m.group(3)}))"
        env[name] = eval(e.replace("/", "//"), {}, env)  # noqa: S307
    return env


@pytest.mark.parametrize("dtype,ctype,dim", [
    (torch.float32, "float", 3), (torch.float64, "double", 3),
    (torch.float32, "float", 2), (torch.float64, "double", 2)])
def test_elasticity_tile_and_smem_match_source(dtype, ctype, dim):
    text = _generic_source()
    tile = re.search(r"struct GenericTile<%s, %d> \{(.*?)\};" % (ctype, dim),
                     text, re.S).group(1)
    consts = {k: int(v) for k, v in re.findall(
        r"static constexpr int (\w+) = (\d+);", tile)}
    t = ga.ELASTICITY_TILE[(dtype, dim)]
    assert (consts["kCells"], consts["kThreads"], consts["kMinBlocks"]) == \
        (t["cells"], t["threads"], t["blocks_per_sm"])
    shape = re.search(r"struct ElasticityShape \{(.*?)\n\};", text,
                      re.S).group(1)
    item = 4 if dtype == torch.float32 else 8
    env = _constexpr_env(shape, {"DIM": dim, "ITEM": item, **consts})
    assert env["kSmemBytes"] == ga.elasticity_smem_bytes(dtype, dim)
    # the tile fits the card: the opt-in per block and the blocks per SM
    assert env["kSmemBytes"] <= 232_448
    assert t["blocks_per_sm"] * (env["kSmemBytes"] + 1024) <= 233_472
    # float64 whole 16-row DMMA tiles and 8-deep K steps, the padded rows
    # covering the data; float32 the sum factorisation's rows: its
    # intermediates (B and G halves of every line of 3 nodes), R and U
    assert env["kCols"] % 16 == 0 and env["kLDX"] % 4 == 0
    assert env["kLD1"] % 4 == 0
    assert env["kQMPad"] % 8 == 0 and env["kNPad"] % 8 == 0
    for k in ("kD1", "kU", "kR", "kUStage"):
        assert env[k] % 4 == 0, k
    if item == 4:
        assert (env["kXRows"], env["kRRows"], env["kURows"]) == \
            (2 * env["kNQ"], env["kQM"], env["kNQ"])
        assert env["kD1"] == env["kR"]             # no D1 in float32
    else:
        assert (env["kXRows"], env["kRRows"], env["kURows"]) == \
            (0, env["kQMPad"], env["kNPad"])
    # DMMA fragment loads at two wavefronts (strides mod 16 doubles)
    assert env["kLD1"] % 16 in (4, 12) and env["kLDX"] % 16 in (4, 8, 12)
    assert env["kNQ"] == 3 ** dim and env["kNV"] == dim * 3 ** dim
    # the ring: two stages at least; value regions, then the 128-byte
    # aligned TMA boxes and the stages' mbarriers, in that order
    assert env["kStages"] == ga.ELASTICITY_STAGES >= 2
    assert env["kValues"] * item <= env["kConnAt"]
    for k in ("kConnAt", "kOffAt", "kBarAt", "kConnStage", "kOffStage"):
        assert env[k] % 128 == 0, k
    assert env["kConnStage"] >= env["kConnBox"]
    assert env["kOffStage"] >= env["kOffBox"]
    # the tensor maps' boxes: (rows, cells), each side <= 256, whole
    # 16-byte rows, and the bytes each stage's barrier expects
    (crows, ccells), (orows, ocells) = ga.tma_boxes("elasticity", dtype, dim)
    assert ccells == ocells == t["cells"]
    assert (crows, orows) == (env["kNV"], env["kOffRows"])
    assert env["kConnBox"] == crows * ccells * 4
    assert env["kOffBox"] == orows * ocells * item
    for rows, cells, size in ((crows, ccells, 4), (orows, ocells, item)):
        assert 1 <= rows <= 256 and 1 <= cells <= 256
        assert cells * size % 16 == 0


@pytest.mark.parametrize("dtype,ctype,dim", [
    (torch.float32, "float", 3), (torch.float64, "double", 3),
    (torch.float32, "float", 2), (torch.float64, "double", 2)])
def test_q1_block_and_boxes_match_source(dtype, ctype, dim):
    text = _generic_source()
    shape = re.search(r"struct Q1Shape \{(.*?)\n\};", text, re.S).group(1)
    item = 4 if dtype == torch.float32 else 8
    env = _constexpr_env(shape, {
        "DIM": dim, "ITEM": item, "kQ1Cells": _source_int("kQ1Cells"),
        "kQ1Group": _source_int("kQ1Group")})
    assert env["kThreads"] == ga.q1_threads(dim) <= 1024
    assert env["kThreads"] % 32 == 0 and ga.Q1_GROUP == 2   # lane pairs
    assert env["kNP"] == 2 ** dim
    (crows, ccells), (orows, ocells) = ga.tma_boxes("q1", dtype, dim)
    assert ccells == ocells == ga.Q1_CELLS == 32       # a warp's lanes
    assert env["kConnBox"] == crows * ccells * 4 == 2 ** dim * 32 * 4
    assert env["kOffBox"] == orows * ocells * item
    assert orows == env["kOffRows"] == (2 ** dim - 1) * dim
    for rows, cells, size in ((crows, ccells, 4), (orows, ocells, item)):
        assert 1 <= rows <= 256 and cells * size % 16 == 0
    # the static shared memory of a block (the boxes and the barrier)
    # stays under the 48 KB limit
    assert env["kConnBox"] + env["kOffBox"] + 8 <= 48 * 1024


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("dim,cells", [(3, 64_000), (3, 420), (3, 17),
                                       (2, 65_536), (2, 143), (2, 1),
                                       (3, 0)])
def test_launch_plans(dtype, dim, cells):
    sms = 132
    t = ga.ELASTICITY_TILE[(dtype, dim)]
    p = ga.elasticity_plan(cells, dtype, dim, sms)
    tiles = -(-cells // t["cells"])
    assert p.grid == min(tiles, sms * t["blocks_per_sm"])
    assert p.smem_bytes == ga.elasticity_smem_bytes(dtype, dim)
    assert p.scratch_numel == dim * 3 ** dim * cells < 2 ** 31
    q = ga.q1_plan(cells, dim, 6)
    assert q.grid * ga.Q1_CELLS >= cells > (q.grid - 1) * ga.Q1_CELLS \
        or cells == q.grid == 0
    assert q.scratch_numel == 6 * 2 ** dim * cells and q.smem_bytes == 0


def _source_int(name: str) -> int:
    return int(re.search(r"constexpr int %s = (\d+);" % name,
                         _generic_source()).group(1))


def test_constants_match_source():
    assert _source_int("kMaxLanes") == ga.MAX_LANES
    assert _source_int("kQ1Cells") == ga.Q1_CELLS
    assert _source_int("kQ1Group") == ga.Q1_GROUP
    assert _source_int("kMapBytes") == _cuda.MAP_BYTES
    assert ga.CELL_ALIGN * 4 % 16 == 0         # int32 and float32 rows


def test_entry_point_parameter_types_match_signatures():
    """Each generic entry point's C parameters, by type, against its ctypes
    argtypes: pointers, doubles (lam, mu; alpha, beta) and ints."""
    block = _generic_source()
    block = block[block.index('extern "C" {'):]
    kinds = {"void*": _cuda._P, "double": _cuda._D, "int": _cuda._I}
    for name in ("generic_elasticity_apply", "generic_q1_apply"):
        for suffix in ("f32", "f64"):
            params = re.search(r"int %s_%s\(([^)]*)\)" % (name, suffix),
                               block).group(1)
            types = []
            for p in params.split(","):
                words = p.replace("const ", "").split()
                types.append(kinds["void*" if "*" in p else words[0]])
            assert types == list(_cuda._SIGNATURES[name]), (name, suffix)
    name, argtypes = _cuda.MAP_SIGNATURE
    params = re.search(r"int %s\(([^)]*)\)" % name, block).group(1)
    types = [kinds["void*" if "*" in p else
                   p.replace("const ", "").split()[0]]
             for p in params.split(",")]
    assert types == list(argtypes)


def test_no_atomics_in_sources_or_headers():
    for src in (*_cuda.SOURCES, *_cuda.HEADERS):
        code = re.sub(r"//[^\n]*|/\*.*?\*/", "", src.read_text(), flags=re.S)
        assert not re.search(r"\batomic\w*|\bred\.", code), src.name
    assert sorted(_cuda.HEADERS) == sorted(CSRC.glob("*.cuh"))
    for src in _cuda.SOURCES:
        for inc in re.findall(r'#include "([^"]+)"', src.read_text()):
            assert CSRC / inc in _cuda.HEADERS, inc


def test_no_tensor_core_product_in_a_float32_path():
    """The only tensor-core instruction of generic.cu is the float64 DMMA
    helper, reached from the double overloads alone."""
    code = re.sub(r"//[^\n]*", "", _generic_source())
    assert "mma.sync" not in code and "wgmma" not in code
    for fn in re.findall(r"__device__ __forceinline__ void \w+\(const float"
                         r"[^{]*\{(.*?)\n\}", code, re.S):
        assert "dmma" not in fn


@pytest.mark.parametrize("name,wrapper", [
    ("void (anonymous namespace)::generic_elasticity_products_kernel<float, "
     "3>(float const*, int const*)", "generic_elasticity_apply"),
    ("generic_elasticity_products_kernel<double, 2>",
     "generic_elasticity_apply"),
    ("plan_sum_kernel<float, 1>", "generic_elasticity_apply"),
    ("void (anonymous namespace)::plan_sum_kernel<double, 1>(double const*, "
     "int const*, double*, int, int, int, int)", "generic_elasticity_apply"),
    ("generic_q1_products_kernel<double, 3, 6, true>", "generic_q1_apply"),
    ("generic_q1_products_kernel<float, 2, 1, false>", "generic_q1_apply"),
    ("plan_sum_kernel<float, 6>", "generic_q1_apply"),
    ("plan_sum_kernel<double, 6>", "generic_q1_apply"),
])
def test_profiler_groups_generic_kernels(name, wrapper):
    from poroelasticity_dealii_torch.tools import profile_step
    assert profile_step._wrapper(name) == wrapper
    assert wrapper in profile_step.WRAPPERS


def test_profiler_groups_every_kernel_of_the_generic_source():
    from poroelasticity_dealii_torch.tools import profile_step
    kernels = re.findall(r"__global__ void __launch_bounds__\([^;{]*?\)\s*"
                         r"\n(\w+)\(", _generic_source())
    assert sorted(kernels) == ["generic_elasticity_products_kernel",
                               "generic_q1_products_kernel",
                               "plan_sum_kernel"]
    assert profile_step._wrapper("generic_q1_products_kernel") == \
        "generic_q1_apply"
    assert profile_step._wrapper("generic_elasticity_products_kernel") == \
        "generic_elasticity_apply"


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _check_pair(kern, plain, dtype):
    y1, y2 = kern(), kern()
    ref = plain()
    torch.cuda.synchronize()
    assert torch.isfinite(y1).all()
    assert _rel(y1.cpu(), ref.cpu()) <= TOL[dtype]
    assert torch.equal(y1, y2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", ["perturbed_2d_6", "perturbed_3d_3",
                                  "perturbed_3d_4", "irregular_3d_msh",
                                  "amr_2d", "amr_3d", "shared_geometry"])
def test_kernels_match_twins_on_the_card(dev, case, dtype):
    from poroelasticity_dealii_torch.tools import apply_bench
    assert case in apply_bench.GENERIC_CASES
    d = apply_bench.on_device(apply_bench.generic_case(case), dtype, dev)
    cm.reset_launch_counts()
    pairs = apply_bench.generic_pairs(d)
    for label, kern, plain in pairs:
        _check_pair(kern, plain, dtype)
    calls = cm.launch_counts()
    assert calls["generic_elasticity_apply"] == 2
    assert calls["generic_q1_apply"] == 2 * (len(pairs) - 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_ghost_window_on_the_card(dev, dtype):
    """Rank 1 of a 2-way ghost split (window-local conn and plans over
    C + 2H values) on the card: the window applies against their twins."""
    from poroelasticity_dealii_torch.tools import apply_bench
    cm.reset_launch_counts()
    for label, kern, plain in apply_bench.ghost_window_pairs(dtype, dev):
        _check_pair(kern, plain, dtype)
    calls = cm.launch_counts()
    assert calls["generic_elasticity_apply"] == 2
    assert calls["generic_q1_apply"] == 2


@pytest.mark.cuda
def test_wrappers_refuse_what_they_do_not_take(dev):
    _, d = _small(dim=3, n=2)
    d = d.to(dev)
    x = torch.zeros((7, d.n_pdofs), dtype=d.dtype, device=dev)
    with pytest.raises(ValueError, match="B <= 6"):
        ga.generic_q1_apply(x, d.q1_operands, 1.0, 0.0)
    u = torch.zeros(2 * d.n_udofs, dtype=d.dtype, device=dev)[::2]
    with pytest.raises(ValueError, match="contiguous"):
        ga.generic_elasticity_apply(u, d.elasticity_operands)
    with pytest.raises(TypeError, match="dtype"):
        ga.generic_elasticity_apply(u.contiguous().float(),
                                    d.elasticity_operands)
    bad = dataclasses.replace(
        d.q1_operands, offsets=d.cell_offsets[..., :-1].contiguous())
    with pytest.raises(ValueError, match="geometry has"):
        ga.generic_q1_apply(x[0], bad, 1.0, 0.0)


@pytest.mark.cuda
def test_operands_are_checked_once(dev, monkeypatch):
    """The first launch checks a discretization's operands; every later
    call checks its input vector alone."""
    _, d = _small(dim=3, n=2)
    d = d.to(dev)
    x = torch.ones(d.n_pdofs, dtype=d.dtype, device=dev)
    u = torch.ones(d.n_udofs, dtype=d.dtype, device=dev)
    d.mass(x), d.elasticity(u)
    assert "checked" in vars(d.q1_operands)
    assert "checked" in vars(d.elasticity_operands)
    checks = []
    real = _cuda.check

    def spy(name, *args):
        checks.append(name)
        return real(name, *args)

    monkeypatch.setattr(_cuda, "check", spy)
    d.pressure_operator(x, ALPHA, BETA), d.elasticity(u)
    assert checks == ["x", "u"]
