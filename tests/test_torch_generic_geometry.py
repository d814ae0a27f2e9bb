"""The geometry the generic kernels rebuild (``csrc/generic.cu``): each
cell's corner offsets ``cell_offsets`` and the plain forms of the
rebuild, ``ops/geometry.py::map_factors`` (the elasticity kernel's) and
``q1_tensor_map`` (the Q1 kernel's tensor-product form), against the JAX
package:

* ``J^-1`` and ``JxW`` rebuilt from the offsets equal JAX's
  ``geometry_factors`` (numpy branch, from the cells' corners) on every
  small case of ``tools/apply_bench.GENERIC_CASES`` (2D and 3D, the gmsh
  hex mesh, bucketed AMR meshes, geometry shared by every cell), at the
  pressure's and the displacements' Gauss points: float64 within 1e-13 of
  max |J^-1| and max |JxW|; float32 (offsets cast, rebuilt in float32)
  within 1e-6 of JAX's float64 factors; the tensor-product form's det J
  and K = JxW J^-1 J^-T at the pressure's points likewise;
* the mass, Laplace and elasticity applies fed the rebuilt geometry equal
  JAX's ``apply_mass``, ``apply_laplace`` and ``apply_elasticity`` on the
  meshes of ``tests/test_torch_generic.py`` (float64 within 1e-12 of max,
  float32 within 1e-5, as that file's tolerances);
* ``cell_offsets`` survives every copy a run makes (AMR bucketing with
  finite phantom cells, psum chunks, ghost windows, ``.to()``, geometry
  on a cell axis of 1), equal to the offsets of each cell's corners."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from poroelasticity_dealii_tpu.ops.geometry import \
    geometry_factors as jax_geometry_factors
from poroelasticity_dealii_tpu.ops.quadrature import \
    gauss_tensor as jax_gauss_tensor

import test_torch_generic as tg
from poroelasticity_dealii_torch.ops import generic_apply as ga
from poroelasticity_dealii_torch.ops.geometry import (map_factors, map_tables,
                                                      q1_tensor_map,
                                                      reference_offsets)
from poroelasticity_dealii_torch.parallel import ghost as gh
from poroelasticity_dealii_torch.parallel.sharding import (
    SlabGroup, shard_discretization)
from poroelasticity_dealii_torch.tools import apply_bench

CPU = torch.device("cpu")
GEO_TOL = {torch.float64: 1e-13, torch.float32: 1e-6}   # of max |JAX f64|
APPLY_TOL = {torch.float64: tg.TOL, torch.float32: tg.F32_TOL}
_CASES = {}


def _case(name):
    if name not in _CASES:
        _CASES[name] = apply_bench.generic_case(name)
    return _CASES[name]


def _corners(d) -> np.ndarray:
    """(E_real, 2^dim, dim) float64 corners of the real cells of ``d``."""
    mesh = d.pressure_space.mesh
    return np.asarray(mesh.vertices, np.float64)[mesh.cells]


def _offsets_of(corners) -> np.ndarray:
    """(2^dim - 1, dim, E) offsets X_n - X_0 of ``corners``."""
    return np.transpose(corners[:, 1:] - corners[:, :1], (1, 2, 0))


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", apply_bench.GENERIC_CASES)
def test_rebuilt_geometry_equals_jax_geometry_factors(case, dtype):
    d = _case(case)
    corners = _corners(d)
    Eg = d.cell_offsets.shape[-1]
    if Eg == 1:                    # geometry shared by every cell
        corners = corners[:1]
    E = corners.shape[0]
    off = d.cell_offsets.to(dtype)
    for points_1d in (2, 3):       # the Q1 kernel's rule, the elasticity's
        dn1, w = map_tables(d.dim, points_1d)
        _, det, jinv, jxw = map_factors(off, torch.as_tensor(dn1),
                                        torch.as_tensor(w))
        assert jinv.dtype == jxw.dtype == dtype
        assert bool(torch.isfinite(jinv).all() and (det > 0).all())
        pts, wts = jax_gauss_tensor(points_1d, d.dim)
        want_jinv, want_jxw = jax_geometry_factors(corners, pts, wts)
        got_jinv = jinv[..., :E].permute(3, 0, 1, 2).numpy()
        got_jxw = jxw[:, :E].T.numpy()
        assert _rel(got_jinv, want_jinv) <= GEO_TOL[dtype], points_1d
        assert _rel(got_jxw, want_jxw) <= GEO_TOL[dtype], points_1d


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", apply_bench.GENERIC_CASES)
def test_q1_tensor_map_equals_jax_geometry_factors(case, dtype):
    d = _case(case)
    corners = _corners(d)
    if d.cell_offsets.shape[-1] == 1:
        corners = corners[:1]
    E = corners.shape[0]
    det, K = q1_tensor_map(d.cell_offsets.to(dtype))
    assert det.dtype == K.dtype == dtype
    assert bool(torch.isfinite(K).all() and (det > 0).all())
    pts, wts = jax_gauss_tensor(2, d.dim)
    want_jinv, want_jxw = jax_geometry_factors(corners, pts, wts)
    want_K = want_jxw[..., None, None] * np.einsum(
        "eqmi,eqni->eqmn", want_jinv, want_jinv)
    assert _rel(det[:, :E].T.numpy(), want_jxw) <= GEO_TOL[dtype]
    assert _rel(K[..., :E].permute(3, 0, 1, 2).numpy(), want_K) <= \
        GEO_TOL[dtype]


def _rebuilt(d, points_1d):
    """(jinv, jxw) of ``d`` rebuilt from its offsets at ``points_1d``
    Gauss points per axis, in its dtype."""
    dn1, w = map_tables(d.dim, points_1d)
    return map_factors(d.cell_offsets, torch.as_tensor(dn1),
                       torch.as_tensor(w))[2:]


def _rebuilt_apply(d, name, x):
    if name == "elasticity":
        jinv, jxw = _rebuilt(d, 3)
        return ga.generic_elasticity_apply_plain(
            x, d.conn_u, d.dref_u_at_uq, jinv, jxw, d.lam, d.mu, d.plan_u)
    jinv, jxw = _rebuilt(d, 2)
    a, b = {"mass": (1.0, 0.0), "laplace": (0.0, 1.0)}[name]
    return ga.generic_q1_apply_plain(x, d.conn_p, d.psi_p_at_pq,
                                     d.dref_p_at_pq, jinv, jxw, a, b,
                                     d.plan_p)


@pytest.mark.parametrize("apply", ["mass", "laplace", "elasticity"])
@pytest.mark.parametrize("case", tg.CASES)
def test_applies_on_rebuilt_geometry_equal_jax(case, apply):
    d, jd = tg._built(case)
    x = tg._input(d, apply)
    got = _rebuilt_apply(d, apply, torch.as_tensor(x))
    assert got.dtype == torch.float64
    want = tg._apply(jd, apply, jnp.asarray(x))
    assert _rel(got.numpy(), want) <= APPLY_TOL[torch.float64]


@pytest.mark.parametrize("apply", ["mass", "laplace", "elasticity"])
def test_float32_applies_on_rebuilt_geometry_equal_jax(apply):
    d, jd = tg._built("perturbed_3d_4", torch.float32)
    assert d.cell_offsets.dtype == torch.float32
    x = tg._input(d, apply, np.float32)
    got = _rebuilt_apply(d, apply, torch.as_tensor(x))
    want = tg._apply(jd, apply, jnp.asarray(x))
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), want) <= APPLY_TOL[torch.float32]


def _ghost_ranks(d, k):
    r = gh.renumber_discretization(d)
    return [gh.shard_renumbered(r, SlabGroup(i, k, None, CPU))
            for i in range(k)]


@pytest.mark.parametrize("way", ["bucketed", "psum", "ghost", "to",
                                 "shared"])
def test_cell_offsets_survive_every_copy(way):
    """Every copy holds, for each of its cells, the offsets of that cell's
    corners (phantom cells: the reference cube's), in the copy's dtype."""
    if way == "bucketed":
        d = _case("amr_3d")
        E = d.pressure_space.mesh.n_cells
        assert d.n_cells > E                      # phantom cells exist
        np.testing.assert_array_equal(d.cell_offsets[..., :E].numpy(),
                                      _offsets_of(_corners(d)))
        phantom = d.cell_offsets[..., E:]
        assert bool(torch.isfinite(phantom).all())
        np.testing.assert_array_equal(
            phantom.numpy(), np.broadcast_to(
                reference_offsets(3)[..., None], phantom.shape))
        # the phantom cells' rebuilt geometry is finite (the kernels'
        # products there are never summed, but computed)
        for p in (2, 3):
            assert all(bool(torch.isfinite(t).all()) for t in _rebuilt(d, p))
        return
    d = _case("perturbed_3d_4")
    want = _offsets_of(_corners(d))
    if way == "psum":
        chunks = [shard_discretization(d, SlabGroup(r, 3, None, CPU))
                  for r in range(3)]
        for c in chunks:
            c0, c1 = c.cells
            np.testing.assert_array_equal(c.cell_offsets.numpy(),
                                          want[..., c0:c1])
            assert c.q1_operands.offsets is c.cell_offsets
        assert sum(c.n_cells for c in chunks) == d.n_cells
    elif way == "ghost":
        ranks = _ghost_ranks(d, 2)
        for r in ranks:
            c0, c1 = r.cells
            np.testing.assert_array_equal(r.cell_offsets.numpy(),
                                          want[..., c0:c1])
            assert r.elasticity_operands.offsets is r.cell_offsets
        assert sum(r.n_cells for r in ranks) == d.n_cells
    elif way == "to":
        c = apply_bench.on_device(d, torch.float32, "cpu")
        assert c.cell_offsets.dtype == torch.float32
        np.testing.assert_array_equal(c.cell_offsets.numpy(),
                                      want.astype(np.float32))
        c = d.to("cpu")
        np.testing.assert_array_equal(c.cell_offsets.numpy(), want)
        assert c.q1_operands.offsets is c.cell_offsets
    else:
        c = _case("shared_geometry")
        assert tuple(c.cell_offsets.shape) == (7, 3, 1)
        np.testing.assert_array_equal(c.cell_offsets.numpy(),
                                      _offsets_of(_corners(c)[:1]))
        assert c.q1_operands.offsets.shape[-1] == 1
        # a cell axis of 1 stands for every cell: its map is the first
        # cell's, which the twin's shared jinv and jxw hold
        jinv, jxw = _rebuilt(c, 2)
        assert _rel(jinv.numpy(), c.jinv_p.numpy()) <= 1e-13
        assert _rel(jxw.numpy(), c.jxw_p.numpy()) <= 1e-13
        assert dataclasses.replace(c).cell_offsets is c.cell_offsets
