"""The sharded forms that keep the solver's vectors whole (``parallel/``):
gspmd (structured stencils on node-plane slabs), psum (cells chunked, one
all-reduce per apply, adaptive meshes included) and the 2D y-slab
production form (the parity kit on slabs), against the port's unsharded
runs and the JAX package's sharded functions; and the runner and the
adaptive driver with each mode (ghost's too; its own tests are in
``tests/test_torch_ghost.py``).

Ranks are gloo CPU processes spawned as in ``tests/test_torch_rows_sharding
.py`` (``file://`` rendezvous in the test's temporary directory, every
spawn joined with a timeout).  The workers import no jax; JAX's sharded
functions run in the test process on the 8 virtual CPU devices that
``tests/conftest.py`` sets up, as the JAX package's own tests run them.
The tolerances are those of ``tests/test_sharding.py`` and
``tests/test_parity_sharding.py``.  The CUDA-marked test holds the flat
elasticity kernel's slab mode against its plain twin on the card and
skips here.
"""

import dataclasses
import functools
import json

import numpy as np
import pytest
import torch

from poroelasticity_dealii_torch import read_input_file
from poroelasticity_dealii_torch.amr.driver import (AMRSimulationRunner,
                                                    build_amr_discretization)
from poroelasticity_dealii_torch.amr.forest import QuadForest
from poroelasticity_dealii_torch.mesh import hyper_rectangle
from poroelasticity_dealii_torch.models.runner import (
    run_from_data, structured_generic_mesh)
from poroelasticity_dealii_torch.ops import elasticity as eg
from poroelasticity_dealii_torch.ops.comp_major import _width, launch_counts
from poroelasticity_dealii_torch.ops.parity2d import make_parity_ops
from poroelasticity_dealii_torch.parallel import rows as pr
from poroelasticity_dealii_torch.parallel.ghost import \
    renumber_discretization
from poroelasticity_dealii_torch.parallel.sharding import (
    ShardedDiscretization, SlabGroup, SlabStencil, make_slab_group,
    shard_discretization, shard_grid_discretization)
from poroelasticity_dealii_torch.solvers.cg import cg_solve
from poroelasticity_dealii_torch.solvers.discretization import \
    build_discretization
from poroelasticity_dealii_torch.solvers.fss import FixedStressSolver
from poroelasticity_dealii_torch.solvers.structured import \
    build_grid_discretization
from test_torch_rows_sharding import _spawn

GOLDEN = "configs/golden_2d.data"
DECK3 = "configs/consolidation_3d.data"
ADAPTIVE = "configs/golden_2d_adaptive.data"
COUNTS = ("fss_iterations", "pressure_iterations", "pressure_cg_iterations",
          "mech_cg_iterations", "projection_cg_iterations")


def _deck3(**kw):
    """The 3D deck with a relative mechanics tolerance (its absolute 1e-12
    lies below the float64 roundoff of the right-hand side)."""
    return dataclasses.replace(read_input_file(DECK3), mech_cg_relative=True,
                               mech_cg_tol=1e-10, **kw)


def _stats(s) -> dict:
    return {k: int(getattr(s, k)) for k in COUNTS}


def _fields(st) -> dict:
    return {k: getattr(st, k).clone() for k in ("p", "u", "eps_v",
                                                 "strains")}


def _np(x):
    return np.asarray(x)


# ---------------------------------------------------------------------------
# gspmd: every wrapped apply and the step bitwise equal to the unsharded port
# ---------------------------------------------------------------------------

# (deck, cells per axis, domain size or None)
GSPMD_GRIDS = (("2d", 8, None), ("2d", 16, None), ("2d", (16, 8), (10.0, 5.0)),
               ("3d", 4, None), ("3d", 6, None))


def _grid_case(kind, cells, domain):
    data = read_input_file(GOLDEN) if kind == "2d" else _deck3()
    if domain is not None:
        data = dataclasses.replace(data, domain_size=domain)
    disc = build_grid_discretization(data, cells_per_axis=cells,
                                     multigrid="off",
                                     elasticity_backend="conv", device="cpu")
    return data, disc


def _applies(disc, data, seed=0) -> dict:
    """Every apply the gspmd form wraps, on one set of seeded inputs: the
    five stencils, the constrained elasticity, a batched mass (the
    projection solves) and the fused pressure Jacobian through the
    solver (its hook)."""
    rng = np.random.default_rng(seed)
    u = torch.as_tensor(rng.standard_normal(disc.n_udofs))
    p = torch.as_tensor(rng.standard_normal(disc.n_pdofs))
    pb = torch.as_tensor(rng.standard_normal((3, disc.n_pdofs)))
    jac = FixedStressSolver(disc, data)._pressure_jacobian_apply(
        p, data.time_step)
    return {"mass": disc.mass(p), "mass_batched": disc.mass(pb),
            "laplace": disc.laplace(p), "elasticity": disc.elasticity(u),
            "elasticity_constrained": disc.elasticity_constrained(u),
            "coupling": disc.coupling_rhs(p), "jacobian": jac,
            "projection": disc.strain_projection_rhs(u)}


def _gspmd_apply_worker(rank, world):
    g = make_slab_group("cpu")
    SlabStencil.calls.clear()
    out = {}
    for case in GSPMD_GRIDS:
        data, disc = _grid_case(*case)
        out[case] = _applies(shard_grid_discretization(disc, g), data)
    return {"applies": out, "calls": dict(SlabStencil.calls)}


@pytest.mark.parametrize("world", [2, 3])
def test_gspmd_applies_bitwise_equal_unsharded(world, tmp_path):
    """2D n = 8, 16 and the anisotropic 16 x 8 grid, 3D n = 4 and 6, in
    float64: each rank's wrapped applies equal the whole-grid ones bit for
    bit (3 ranks leave uneven slabs: 17, 33 and 13 node planes)."""
    outs = _spawn(_gspmd_apply_worker, world, tmp_path)
    for case in GSPMD_GRIDS:
        data, disc = _grid_case(*case)
        ref = _applies(disc, data)
        for rank, out in enumerate(outs):
            for name, want in ref.items():
                got = out["applies"][case][name]
                assert torch.equal(got, want), (case, name, rank)
    calls = outs[0]["calls"]
    assert set(calls) == {"mass", "laplace", "elasticity", "coupling",
                          "projection", "jacobian"}, calls


def _gspmd_step_worker(rank, world):
    g = make_slab_group("cpu")
    out = {}
    for kind, cells in (("2d", 16), ("3d", 4)):
        data, disc = _grid_case(kind, cells, None)
        s = FixedStressSolver(shard_grid_discretization(disc, g), data)
        st0 = s.initial_state()
        st1, stats = s.time_step(st0, data.time_step)
        out[kind] = {"initial": _fields(st0), "step": _fields(st1),
                     "stats": _stats(stats),
                     "graphs": s.graphs is None}
    return out


@functools.lru_cache(maxsize=None)
def _gspmd_unsharded(kind, cells):
    data, disc = _grid_case(kind, cells, None)
    s = FixedStressSolver(disc, data)
    st0 = s.initial_state()
    st1, stats = s.time_step(st0, data.time_step)
    return {"initial": _fields(st0), "step": _fields(st1),
            "stats": _stats(stats)}


@functools.lru_cache(maxsize=None)
def _jax_gspmd_step():
    """JAX's ``shard_grid_discretization`` step on the golden deck at 16^2
    (conv, multigrid off) over 8 devices."""
    from poroelasticity_dealii_tpu.config import read_input_file as jread
    from poroelasticity_dealii_tpu.parallel import (make_device_mesh,
                                                    shard_grid_discretization
                                                    as jshard)
    from poroelasticity_dealii_tpu.solvers import FixedStressSolver as JF
    from poroelasticity_dealii_tpu.solvers.structured import \
        build_grid_discretization as jbuild
    data = jread(GOLDEN)
    disc = jbuild(data, cells_per_axis=16, backend="conv", multigrid="off")
    s = JF(jshard(disc, make_device_mesh(8)), data)
    st, stats = s.time_step(s.initial_state(), data.time_step)
    return {"p": _np(st.p), "u": _np(st.u),
            "stats": {k: int(getattr(stats, k)) for k in COUNTS}}


@pytest.mark.parametrize("world", [2, 3])
def test_gspmd_step_bitwise_equal_unsharded_and_matches_jax(world, tmp_path):
    """initial_state and one FSS step on 2 and 3 ranks, 2D (golden deck at
    16^2) and 3D (n = 4): bitwise equal to the unsharded conv run on every
    rank, chunks run eagerly; the 2D step against JAX's gspmd step (FSS,
    pressure and projection counts equal, p to rtol 1e-10, u to atol
    1e-13)."""
    outs = _spawn(_gspmd_step_worker, world, tmp_path)
    jax_ref = _jax_gspmd_step()
    for kind, cells in (("2d", 16), ("3d", 4)):
        ref = _gspmd_unsharded(kind, cells)
        for out in outs:
            o = out[kind]
            assert o["graphs"]
            assert o["stats"] == ref["stats"]
            for when in ("initial", "step"):
                for k, want in ref[when].items():
                    assert torch.equal(o[when][k], want), (kind, when, k)
    o = outs[0]["2d"]
    # the golden deck's absolute mechanics tolerance (1e-12) lies below the
    # float64 roundoff of its right-hand side: mechanics CG counts follow
    # the summation order there (the port's stencils sum in another order
    # than XLA's convolutions), so JAX's test compares the FSS count
    for k in COUNTS:
        if k != "mech_cg_iterations":
            assert o["stats"][k] == jax_ref["stats"][k], k
    np.testing.assert_allclose(o["step"]["p"], jax_ref["p"], rtol=1e-10)
    np.testing.assert_allclose(o["step"]["u"], jax_ref["u"], atol=1e-13)


def test_gspmd_refuses_a_generic_discretization():
    data = read_input_file(GOLDEN)
    disc = build_discretization(hyper_rectangle(data.domain_size, 2), data,
                                device="cpu")
    with pytest.raises(TypeError, match="conv-stencil"):
        shard_grid_discretization(disc, make_slab_group("cpu"))


def test_flat_kernel_slab_twin_is_the_stencil_on_the_sub_grid():
    """The slab mode's plain twin (``nz`` cell layers of n x n cells) is
    the plain stencil on that sub-grid, and a slab of the whole grid's
    input planes gives the whole apply's planes away from its ends."""
    n, nz = 3, 2
    rng = np.random.default_rng(0)
    ke = torch.as_tensor(rng.standard_normal((81, 81)))
    g = 2 * n + 1
    u = torch.as_tensor(rng.standard_normal(g * g * g * 3))
    whole = eg.elasticity_grid_apply(u, ke, n).reshape(g, g, g, 3)
    # cells 1..2 along z: input planes 2..6, output planes 3..4 are whole
    sub = u.reshape(g, g, g, 3)[2:2 * (1 + nz) + 1].reshape(-1)
    y = eg.elasticity_grid_apply(sub, ke, n, nz=nz)
    assert y.shape == ((2 * nz + 1) * g * g * 3,)
    assert torch.equal(y, eg.elasticity_grid_apply_plain(sub, ke, n, nz))
    assert torch.equal(y.reshape(2 * nz + 1, g, g, 3)[1:4], whole[3:6])
    assert launch_counts()["grid_slab"] == 0


# ---------------------------------------------------------------------------
# 2D production: the y-slab parity kit
# ---------------------------------------------------------------------------

def _random_ke18(seed=0):
    ke = np.random.default_rng(seed).standard_normal((18, 18))
    return ke + ke.T


def _parity_apply_worker(rank, world, ns):
    g = make_slab_group("cpu")
    out = {}
    for n in ns:
        nud = (2 * n + 1) ** 2 * 2
        ones = np.ones(nud)
        ko = pr.make_parity_ops_sharded(_random_ke18(), n, ones, ones, g,
                                        np.zeros((18, 4)), np.zeros((12, 18)),
                                        torch.float64)
        u = torch.as_tensor(np.random.default_rng(n).standard_normal(nud))
        R = ko.to_rows(u)
        out[n] = {"y": ko.from_rows(ko.apply_rows(R)),
                  "round_trip": ko.from_rows(R), "shape": tuple(R.shape),
                  "nv": ko.nv}
    return out


@functools.lru_cache(maxsize=None)
def _jax_parity_apply(n):
    import jax.numpy as jnp
    from poroelasticity_dealii_tpu.parallel import make_device_mesh
    from poroelasticity_dealii_tpu.parallel.rows import \
        make_parity_ops_sharded as jmake
    nud = (2 * n + 1) ** 2 * 2
    ones = np.ones(nud)
    ro = jmake(_random_ke18(), n, ones, ones, make_device_mesh(8),
               dtype=jnp.float64)
    u = jnp.asarray(np.random.default_rng(n).standard_normal(nud))
    return _np(ro.from_rows(ro.apply_rows(ro.to_rows(u))))


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_parity_apply_matches_unsharded_and_jax(world, tmp_path):
    """n = 7 (8 iy-rows: on 4 ranks the last slab holds one real cell row)
    and n = 16: the sharded apply equals the unsharded parity apply and
    JAX's ``make_parity_ops_sharded`` apply to 1e-12 of max; the layout
    round trip through the padded slabs is exact."""
    ns = (7, 16)
    outs = _spawn(_parity_apply_worker, world, tmp_path, ns)
    for n in ns:
        nud = (2 * n + 1) ** 2 * 2
        ones = np.ones(nud)
        kit = make_parity_ops(_random_ke18(), n, ones, ones,
                              np.zeros((18, 4)), np.zeros((12, 18)),
                              torch.float64, "cpu")
        u = torch.as_tensor(np.random.default_rng(n).standard_normal(nud))
        y0 = kit.from_rows(kit.apply_rows(kit.to_rows(u)))
        yj = _jax_parity_apply(n)
        Ly = pr.slab_layers(n, world)
        for rank, out in enumerate(outs):
            o = out[n]
            assert o["shape"] == (2, 2, 2, Ly, n + 1)
            assert o["nv"] == pr.real_layers(n, world, rank)
            assert torch.equal(o["round_trip"], u)
            scale = float(y0.abs().max())
            np.testing.assert_allclose(o["y"], y0, rtol=1e-12,
                                       atol=1e-12 * scale)
            np.testing.assert_allclose(o["y"], yj, rtol=1e-12,
                                       atol=1e-12 * scale)


def _golden_relative():
    """The golden deck with a relative mechanics tolerance, 1e-10: its
    absolute 1e-12 lies below the float64 roundoff of the right-hand side,
    where Jacobi-CG counts follow the summation order."""
    return dict(mech_cg_relative=True, mech_cg_tol=1e-10)


def _production2d_worker(rank, world, gmg):
    data = dataclasses.replace(read_input_file(GOLDEN), **_golden_relative())
    disc = build_grid_discretization(data, cells_per_axis=16,
                                     multigrid="on" if gmg else "off",
                                     elasticity_backend="parity",
                                     device="cpu")
    sdisc = pr.shard_production_discretization(disc, make_slab_group("cpu"))
    s = FixedStressSolver(sdisc, data)
    st, stats = s.time_step(s.initial_state(), data.time_step)
    st = s.materialize_u(st)
    return {"p": st.p, "u": st.u, "stats": _stats(stats),
            "kit": type(sdisc.row_ops).__name__,
            "gmg": sdisc.gmg_precond_rows is not None,
            "hook": sdisc.wrap_pressure_stencil is not None}


@functools.lru_cache(maxsize=None)
def _jax_production2d_step(gmg):
    from poroelasticity_dealii_tpu.config import read_input_file as jread
    from poroelasticity_dealii_tpu.parallel import make_device_mesh
    from poroelasticity_dealii_tpu.parallel.rows import \
        shard_production_discretization as jshard
    from poroelasticity_dealii_tpu.solvers import FixedStressSolver as JF
    from poroelasticity_dealii_tpu.solvers.structured import \
        build_grid_discretization as jbuild
    data = dataclasses.replace(jread(GOLDEN), **_golden_relative())
    disc = jbuild(data, cells_per_axis=16, multigrid="on" if gmg else "off",
                  elasticity_backend="parity")
    s = JF(jshard(disc, make_device_mesh(8)), data)
    st, stats = s.time_step(s.initial_state(), data.time_step)
    st = s.materialize_u(st)
    return {"p": _np(st.p), "u": _np(st.u),
            "stats": {k: int(getattr(stats, k)) for k in COUNTS}}


@pytest.mark.parametrize("gmg", [False, True], ids=["jacobi", "parity_gmg"])
@pytest.mark.parametrize("world", [2, 4])
def test_production_2d_step_matches_jax(world, gmg, tmp_path):
    """One step of the golden deck (relative mechanics tolerance, on both
    sides) at 16^2 on the y-slab parity kit, with and without the parity
    V-cycle (gathered, run whole, sliced back), against JAX's
    ``shard_production_discretization`` step: pressure and mechanics
    counts equal, p to rtol 1e-9, u to rtol 1e-8 and atol 1e-10 max
    (``tests/test_parity_sharding.py``)."""
    outs = _spawn(_production2d_worker, world, tmp_path, gmg)
    ref = _jax_production2d_step(gmg)
    for out in outs:
        assert out["kit"] == "ShardedParityOps" and out["hook"]
        assert out["gmg"] == gmg
        assert out["stats"]["mech_cg_iterations"] > 0
        for k in ("fss_iterations", "pressure_iterations",
                  "mech_cg_iterations"):
            assert out["stats"][k] == ref["stats"][k], k
        np.testing.assert_allclose(out["p"], ref["p"], rtol=1e-9)
        np.testing.assert_allclose(out["u"], ref["u"], rtol=1e-8,
                                   atol=1e-10 * np.abs(ref["u"]).max())
        assert torch.equal(out["p"], outs[0]["p"])


# ---------------------------------------------------------------------------
# what the slab kits send
# ---------------------------------------------------------------------------

def _comm_worker(rank, world, kind, n, iters):
    """``iters`` mechanics CG iterations through the sharded kit with its
    counter reset just before: the counter's record."""
    if kind == "2d":
        data = read_input_file(GOLDEN)
        disc = build_grid_discretization(data, cells_per_axis=n,
                                         multigrid="off",
                                         elasticity_backend="parity",
                                         device="cpu")
    else:
        disc = build_grid_discretization(_deck3(), cells_per_axis=n,
                                         multigrid="off", device="cpu")
    ro = pr.shard_production_discretization(disc, make_slab_group("cpu")) \
        .row_ops
    u = torch.as_tensor(np.random.default_rng(0).standard_normal(
        disc.n_udofs))
    b = ro.free_mask_rows * ro.to_rows(u)
    ro.comm.reset()
    res = cg_solve(ro.constrained_apply, b, torch.zeros_like(b),
                   ro.diag_rows, tol=0.0, max_iter=iters,
                   apply_iter=ro.free_apply, dot=ro.dot, norm=ro.norm)
    return {"comm": dataclasses.asdict(ro.comm),
            "iterations": int(res.iterations),
            "slab": ro.free_mask_rows.numel(),
            "item": ro.free_mask_rows.element_size()}


@pytest.mark.parametrize("kind,n", [("2d", 16), ("3d", 8)])
def test_slab_kit_sends_halo_bands_and_scalars(kind, n, tmp_path):
    """5 CG iterations on 2 ranks, counted by the kit (``kit.comm``): each
    rank sends one band per apply (2D: one iy-row of 2*2*2*(n+1) values;
    3D: 24 rows of the row layout), every all-reduce is a scalar (3 per
    iteration and 2 at the start), and nothing is gathered; the bytes add
    up to the messages' sizes."""
    iters = 5
    band = 2 * 2 * 2 * (n + 1) if kind == "2d" else 24 * _width(n)
    for rank, out in enumerate(_spawn(_comm_worker, 2, tmp_path, kind, n,
                                      iters)):
        c = out["comm"]
        assert out["iterations"] == iters
        assert "all_gather" not in c["messages"]
        # one band out per apply (rank 0 returns, rank 1 sends its first)
        assert c["messages"]["p2p"] == iters + 1
        assert c["largest"]["p2p"] == band
        assert c["bytes"]["p2p"] == (iters + 1) * band * out["item"]
        assert c["messages"]["all_reduce"] == 3 * iters + 2
        assert c["largest"]["all_reduce"] == 1
        assert 2 * band < out["slab"]


# ---------------------------------------------------------------------------
# psum: cells chunked, one all-reduce per apply
# ---------------------------------------------------------------------------

def _psum_disc(kind):
    data = read_input_file(GOLDEN)
    if kind == "uniform":
        # 64 cells, as the JAX test: chunks of 32 / 21-22 on 2 / 3 ranks
        return data, build_discretization(
            hyper_rectangle(data.domain_size, 3), data, device="cpu")
    f = QuadForest.uniform([-5, -5], [5, 5], 2)
    f.refine_and_coarsen([leaf for leaf in f.leaves
                          if leaf[1] == 0 and leaf[2] == 0], [])
    return data, build_amr_discretization(f, data, device="cpu")


def _psum_applies(disc, data, seed=0):
    rng = np.random.default_rng(seed)
    p = torch.as_tensor(rng.standard_normal(disc.n_pdofs))
    pb = torch.as_tensor(rng.standard_normal((2, disc.n_pdofs)))
    u = torch.as_tensor(rng.standard_normal(disc.n_udofs))
    return {"mass": disc.mass(p), "mass_batched": disc.mass(pb),
            "laplace": disc.laplace(p), "elasticity": disc.elasticity(u),
            "elasticity_constrained": disc.elasticity_constrained(u),
            "coupling": disc.coupling_rhs(p, data.biot_coef),
            "projection": disc.strain_projection_rhs(u)}


def _psum_worker(rank, world, kind):
    data, disc = _psum_disc(kind)
    sdisc = shard_discretization(disc, make_slab_group("cpu"))
    s = FixedStressSolver(sdisc, data)
    st0 = s.initial_state()
    st1, stats = s.time_step(st0, data.time_step)
    return {"applies": _psum_applies(sdisc, data), "u0": st0.u,
            "step": _fields(st1), "stats": _stats(stats),
            "cells": sdisc.cells, "n_cells": sdisc.n_cells,
            "shared_tables": sdisc.hc_p is not None
            and not sdisc.hc_p.empty}


@functools.lru_cache(maxsize=None)
def _jax_psum_step(kind):
    """JAX's ``shard_discretization`` step over 8 devices: the golden deck
    on 8 x 8 cells, or on JAX's hanging-node quadtree."""
    from poroelasticity_dealii_tpu.amr import QuadForest as JQ
    from poroelasticity_dealii_tpu.amr.driver import \
        build_amr_discretization as jamr
    from poroelasticity_dealii_tpu.config import read_input_file as jread
    from poroelasticity_dealii_tpu.mesh import hyper_rectangle as jrect
    from poroelasticity_dealii_tpu.parallel import (make_device_mesh,
                                                    shard_discretization
                                                    as jshard)
    from poroelasticity_dealii_tpu.solvers import (FixedStressSolver as JF,
                                                   build_discretization
                                                   as jbuild)
    data = jread(GOLDEN)
    if kind == "uniform":
        disc = jbuild(jrect(data.domain_size, 3), data)
    else:
        f = JQ.uniform([-5, -5], [5, 5], 2)
        f.refine_and_coarsen([leaf for leaf in f.leaves
                              if leaf[1] == 0 and leaf[2] == 0], [])
        disc = jamr(f, data)
    s = JF(jshard(disc, make_device_mesh(8)), data)
    st0 = s.initial_state()
    st, stats = s.time_step(st0, data.time_step)
    return {"u0": _np(st0.u), "p": _np(st.p), "u": _np(st.u),
            "eps_v": _np(st.eps_v),
            "stats": {k: int(getattr(stats, k)) for k in COUNTS}}


@pytest.mark.parametrize("world", [2, 3])
def test_psum_applies_and_step_match_unsharded_and_jax(world, tmp_path):
    """The golden deck on 8 x 8 cells (64, uneven over 3 ranks): the five
    applies, the constrained elasticity and a batched mass equal the
    unsharded ones to 1e-13 of max; one step against JAX's psum step with
    ``tests/test_sharding.py``'s tolerances (FSS and pressure counts
    equal, initial u to atol 1e-14, p to rtol 1e-10, u to atol 1e-13,
    eps_v to rtol 1e-8)."""
    outs = _spawn(_psum_worker, world, tmp_path, "uniform")
    data, disc = _psum_disc("uniform")
    ref = _psum_applies(disc, data)
    jax_ref = _jax_psum_step("uniform")
    assert sum(o["n_cells"] for o in outs) == disc.n_cells
    assert [o["cells"] for o in outs] == [
        (r * 64 // world, (r + 1) * 64 // world) for r in range(world)]
    for out in outs:
        for name, want in ref.items():
            got = out["applies"][name]
            scale = float(want.abs().max())
            assert float((got - want).abs().max()) <= 1e-13 * scale, name
        for k in ("fss_iterations", "pressure_iterations"):
            assert out["stats"][k] == jax_ref["stats"][k], k
        np.testing.assert_allclose(out["u0"], jax_ref["u0"], atol=1e-14)
        np.testing.assert_allclose(out["step"]["p"], jax_ref["p"],
                                   rtol=1e-10)
        np.testing.assert_allclose(out["step"]["u"], jax_ref["u"],
                                   atol=1e-13)
        np.testing.assert_allclose(out["step"]["eps_v"], jax_ref["eps_v"],
                                   rtol=1e-8, atol=1e-18)
        assert torch.equal(out["step"]["p"], outs[0]["step"]["p"])


@pytest.mark.parametrize("world", [2, 3])
def test_psum_hanging_quadtree_matches_jax(world, tmp_path):
    """JAX's hanging-node quadtree (``test_sharding.py::
    test_sharded_amr_mesh_1_vs_8``): the constraint tables ride along
    replicated; FSS counts equal, p to rtol 1e-9, u to rtol 1e-7."""
    outs = _spawn(_psum_worker, world, tmp_path, "quadtree")
    ref = _jax_psum_step("quadtree")
    for out in outs:
        assert out["shared_tables"]
        assert out["stats"]["fss_iterations"] == ref["stats"]["fss_iterations"]
        np.testing.assert_allclose(out["step"]["p"], ref["p"], rtol=1e-9)
        np.testing.assert_allclose(out["step"]["u"], ref["u"], rtol=1e-7,
                                   atol=1e-12 * np.abs(ref["u"]).max())


def test_psum_refuses_a_structured_grid():
    data = read_input_file(GOLDEN)
    disc = build_grid_discretization(data, cells_per_axis=4, device="cpu")
    with pytest.raises(TypeError, match="generic discretization"):
        shard_discretization(disc, make_slab_group("cpu"))


def test_psum_one_rank_keeps_every_cell():
    """A group of one: the chunk is the whole mesh, and every apply is the
    unsharded one bit for bit (nothing to reduce)."""
    data, disc = _psum_disc("quadtree")
    sdisc = shard_discretization(disc, make_slab_group("cpu"))
    assert isinstance(sdisc, ShardedDiscretization)
    assert sdisc.cells == (0, disc.n_cells)
    got, want = _psum_applies(sdisc, data), _psum_applies(disc, data)
    for name in want:
        assert torch.equal(got[name], want[name]), name


# ---------------------------------------------------------------------------
# the runner and the adaptive driver
# ---------------------------------------------------------------------------

def _run_log(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


def _assert_counts(a, b, slack):
    """Run-log records ``a`` and ``b``: FSS, pressure and pressure-CG
    counts equal; mechanics and projection CG counts within ``slack`` (0
    for a bitwise-equal form; psum's all-reduce sums in another order)."""
    for k in ("fss_iterations", "pressure_iterations"):
        assert a[k] == b[k], k
    ca, cb = a["cg_iterations"], b["cg_iterations"]
    assert ca["pressure"] == cb["pressure"]
    for k in ("mechanics", "projection"):
        assert abs(ca[k] - cb[k]) <= slack, (k, ca, cb)
    np.testing.assert_allclose(a["pressure_error"], b["pressure_error"],
                               rtol=1e-6)


RUNNER_SLACK = {"psum": 3, "ghost": 3, "gspmd": 0, "production": 0}
RUNNER_CASES = {
    # mode: (deck, deck overrides, unsharded reference's overrides)
    "psum": (DECK3, {"initial_refinement_level": 2},
             {"sharding": "psum"}),
    "ghost": (DECK3, {"initial_refinement_level": 2},
              {"sharding": "ghost"}),
    "gspmd": (DECK3, {"initial_refinement_level": 2},
              {"elasticity_backend": "conv"}),
    "production": (GOLDEN, {"elasticity_backend": "parity"}, {}),
}


def _runner_data(mode, out, sharding):
    deck, kw, _ = RUNNER_CASES[mode]
    data = read_input_file(deck)
    if deck == DECK3:
        kw = {"mech_cg_relative": True, "mech_cg_tol": 1e-10, **kw}
    return dataclasses.replace(data, t_max=2 * data.time_step,
                               output_directory=str(out), sharding=sharding,
                               **kw)


def _runner_worker(rank, world, mode, out_root):
    """Each rank with its own output directory: only rank 0's may receive
    files."""
    st = run_from_data(_runner_data(mode, f"{out_root}/rank{rank}", mode),
                       device="cpu")
    return {"p": st.p, "u": st.u}


@pytest.mark.parametrize("mode", ["psum", "ghost", "gspmd", "production"])
def test_runner_runs_mode_on_two_ranks(mode, tmp_path):
    """``Sharding = psum``, ``ghost`` and ``gspmd`` on the 3D deck at n =
    4, and ``production`` on the golden 2D deck on the parity kit, from
    the deck under 2 gloo ranks for 2 steps: the unsharded run's run log,
    counts equal (psum's and ghost's reference: the same generic
    discretization on one process, their mechanics and projection CG
    within 3: another summation order; gspmd's: the conv backend it
    shards), and one set of output files, rank 0's.  Ghost's ranks
    return the whole state in its renumbered order."""
    outs = _spawn(_runner_worker, 2, tmp_path / "spawn", mode, str(tmp_path))
    ref_data = dataclasses.replace(
        _runner_data(mode, tmp_path / "unsharded", "none"),
        **RUNNER_CASES[mode][2])
    if ref_data.sharding != "none":
        with pytest.warns(RuntimeWarning, match="single process"):
            ref_state = run_from_data(ref_data, device="cpu")
    else:
        ref_state = run_from_data(ref_data, device="cpu")
    log = _run_log(tmp_path / "rank0" / "run_log.jsonl")
    ref = _run_log(tmp_path / "unsharded" / "run_log.jsonl")
    assert len(log) == len(ref) == 2
    for a, b in zip(log, ref):
        _assert_counts(a, b, RUNNER_SLACK[mode])
    assert len(list((tmp_path / "rank0").glob("solution-*.vtk"))) == 3
    assert not (tmp_path / "rank1").exists()
    p, u = ref_state.p, ref_state.u
    if mode == "ghost":
        _, op, ou = renumber_discretization(build_discretization(
            structured_generic_mesh(ref_data), ref_data, device="cpu"))
        p, u = p[op], u[ou]
    for o in outs:
        np.testing.assert_allclose(o["p"], p, rtol=1e-9)
        np.testing.assert_allclose(o["u"], u, rtol=1e-8,
                                   atol=1e-10 * float(u.abs().max()))


ADAPTIVE_STEPS = 6


def _adaptive_data(out, sharding):
    """The golden adaptive deck for 6 steps with a relative mechanics
    tolerance (its absolute 1e-12 lies below the float64 roundoff)."""
    data = read_input_file(ADAPTIVE)
    return dataclasses.replace(data, t_max=ADAPTIVE_STEPS * data.time_step,
                               output_directory=str(out), output_vtk=False,
                               sharding=sharding, mech_cg_relative=True,
                               mech_cg_tol=1e-10)


def _adaptive_worker(rank, world, out_root):
    run_from_data(_adaptive_data(f"{out_root}/rank{rank}", "psum"),
                  device="cpu")
    return {}


def test_adaptive_deck_runs_psum_on_two_ranks(tmp_path):
    """The golden adaptive deck with ``Sharding = psum`` on 2 ranks for 6
    steps, through its first remesh (before step 5): n_cells, n_pdofs,
    FSS, pressure and pressure-CG counts per step equal the unsharded
    adaptive run's (mechanics and projection CG within 3), rank 0 writing
    the run log alone."""
    _spawn(_adaptive_worker, 2, tmp_path / "spawn", str(tmp_path))
    run_from_data(_adaptive_data(tmp_path / "unsharded", "none"),
                  device="cpu")
    log = _run_log(tmp_path / "rank0" / "run_log.jsonl")
    ref = _run_log(tmp_path / "unsharded" / "run_log.jsonl")
    assert len(log) == len(ref) == ADAPTIVE_STEPS
    assert [r["n_cells"] for r in log] == [r["n_cells"] for r in ref]
    assert log[0]["n_cells"] < log[-1]["n_cells"]
    for a, b in zip(log, ref):
        assert a["n_pdofs"] == b["n_pdofs"]
        _assert_counts(a, b, 3)
    assert not (tmp_path / "rank1").exists()


def test_adaptive_psum_one_process_warns_at_every_remesh(tmp_path):
    data = dataclasses.replace(_adaptive_data(tmp_path, "psum"),
                               initial_refinement_level=2,
                               max_refinement_level=3, refine_every=2,
                               t_max=2 * read_input_file(ADAPTIVE).time_step)
    with pytest.warns(RuntimeWarning, match="single process") as rec:
        runner = AMRSimulationRunner(data, device="cpu")
        runner.run()
    assert len([w for w in rec if "single process" in str(w.message)]) == 2
    assert not isinstance(runner.disc, ShardedDiscretization)


# ---------------------------------------------------------------------------
# on the card: the flat kernel's slab mode against its twin and stitched
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n_dev", [2, 3])
def test_flat_slab_kernel_matches_twin_and_stitches(n_dev, dtype):
    """At n = 7 the gspmd elasticity slabs on the card (the flat kernel's
    slab mode) each agree with the plain stencil on their sub-grid, and
    the stitched result equals the whole-grid kernel bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    n = 7
    data = _deck3()
    disc = build_grid_discretization(data, cells_per_axis=n,
                                     multigrid="off",
                                     elasticity_backend="conv", device="cuda",
                                     dtype=dtype)
    spec = disc.stencil_elasticity.spec
    assert spec.flat_kernel
    u = torch.as_tensor(np.random.default_rng(0).standard_normal(
        disc.n_udofs), dtype=dtype, device="cuda")
    whole = disc.stencil_elasticity(u)
    slabs = []
    for rank in range(n_dev):
        group = SlabGroup(rank, n_dev, None, torch.device("cuda"))
        st = SlabStencil(spec, group, "elasticity")
        slabs.append((st, st.sub))
    g = 2 * n + 1
    X = u.reshape(g, g, g, 3)
    out = torch.zeros_like(X)
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    ke = torch.as_tensor(spec.element_matrix, dtype=dtype, device="cuda")
    for st, sub in slabs:
        xs = X[st.in0:st.in0 + st.n_in].reshape(-1)
        y = sub(xs)
        ref = eg.elasticity_grid_apply_plain(xs, ke, n, (st.n_in - 1) // 2)
        assert float((y - ref).abs().max() / ref.abs().max()) <= tol
        out[st.Z0:st.Z1] = y.reshape(-1, g, g, 3)[st.out0:
                                                  st.out0 + st.Z1 - st.Z0]
    assert torch.equal(out.reshape(-1), whole)
