"""The ghost sharded form of the port (``parallel/ghost.py``, ``Sharding =
ghost``) against the JAX package's ``shard_discretization_ghost`` on the
same number of (virtual) devices and against the port's unsharded runs:

* the first-touch renumbering, the chunk windows (``C``, ``H``) and the
  window-local connectivity, and the two refusals (hanging nodes, a halo
  spanning every rank);
* the five applies, through the in-process transport over all ranks'
  chunks and on 2, 3 and 4 gloo ranks (the D-round windows, ``H > C``,
  included);
* one fixed-stress step on 1, 2 and 4 ranks from a JAX ghost state carried
  in through ``interop``, and ``multi_step`` and ``Debug NaNs`` on 2;
* what a CG sends (``kit.comm``): halo-sized point-to-point messages and
  all-reduces of one value per lane, growing with the interface (the
  port's counterpart of JAX's HLO audit);
* a checkpointed ghost run on 2 ranks, resumed.

Ranks are gloo CPU processes spawned as in ``tests/test_torch_rows_sharding
.py`` (every spawn joined with a timeout); the workers import no jax.  The
JAX references run in the test process on the virtual CPU devices of
``tests/conftest.py``, once each per module; the tolerances are those of
``tests/test_ghost_sharding.py``.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from poroelasticity_dealii_torch import read_input_file
from poroelasticity_dealii_torch.amr.driver import build_amr_discretization
from poroelasticity_dealii_torch.amr.forest import QuadForest
from poroelasticity_dealii_torch.interop import (FIELDS, state_from_numpy,
                                                 state_to_numpy)
from poroelasticity_dealii_torch.mesh import hyper_rectangle
from poroelasticity_dealii_torch.models.runner import (
    SimulationRunner, run_from_data, structured_generic_mesh)
from poroelasticity_dealii_torch.parallel import ghost as gh
from poroelasticity_dealii_torch.parallel.sharding import (SlabGroup,
                                                           make_slab_group)
from poroelasticity_dealii_torch.solvers.cg import cg_solve, cg_solve_batched
from poroelasticity_dealii_torch.solvers.discretization import \
    build_discretization
from poroelasticity_dealii_torch.solvers.fss import FixedStressSolver
from test_torch_rows_sharding import _spawn

GOLDEN = "configs/golden_2d.data"
CPU = torch.device("cpu")
COUNTS = ("fss_iterations", "pressure_iterations")
APPLIES = ("mass", "laplace", "elasticity", "coupling_rhs",
           "strain_projection_rhs")
# (rtol, atol relative to max |ref|, absolute atol) per apply: JAX's
# (tests/test_ghost_sharding.py), its mass entry rtol-only there; the 3D
# mass has entries near cancellation (7e-5 of max, rounding 3.5e-17), so
# it also takes 1e-14 of max
APPLY_TOL = {"mass": (1e-13, 1e-14, 0.0), "laplace": (1e-12, 0.0, 1e-13),
             "elasticity": (1e-12, 1e-6, 0.0),
             "coupling_rhs": (1e-12, 0.0, 1e-13),
             "strain_projection_rhs": (1e-12, 0.0, 1e-13)}
BIOT = 0.8


# ---------------------------------------------------------------------------
# the meshes: JAX's golden fixture (refinement 3: 8 x 8 cells), the golden
# deck on 2 x 2 cells (H > C on 4 ranks) and JAX's 3D weak-scaling deck
# ---------------------------------------------------------------------------

def _data(case):
    data = read_input_file(GOLDEN)
    if case.startswith("cube"):
        data = dataclasses.replace(
            data, dim=3, domain_size=(10.0, 10.0, 10.0),
            displacement_boundary_labels=(0, 1, 2, 3, 4, 5),
            displacement_boundary_components=(0, 0, 1, 1, 2, 2),
            displacement_boundary_values=(0, -1e-5, 0, -1e-5, 0, -1e-5))
    return data


def _mesh(case, hyper):
    """``case``: ``golden3`` / ``golden1`` (refinement 3 / 1), ``cube8``,
    ``cube16``; ``hyper``: the package's ``hyper_rectangle``."""
    if case.startswith("golden"):
        return hyper(read_input_file(GOLDEN).domain_size, int(case[-1]))
    return hyper((10.0, 10.0, 10.0), cells_per_axis=int(case[4:]))


@functools.lru_cache(maxsize=None)
def _port(case):
    data = _data(case)
    return data, build_discretization(_mesh(case, hyper_rectangle), data,
                                      device="cpu")


@functools.lru_cache(maxsize=None)
def _renumbered(case):
    return gh.renumber_discretization(_port(case)[1])


@functools.lru_cache(maxsize=None)
def _ranks(case, k):
    """Every rank of a k-way split, built in this process."""
    return [gh.shard_renumbered(_renumbered(case), SlabGroup(d, k, None, CPU))
            for d in range(k)]


@functools.lru_cache(maxsize=None)
def _jax_disc(case):
    from poroelasticity_dealii_tpu.config import read_input_file as jread
    from poroelasticity_dealii_tpu.mesh import hyper_rectangle as jrect
    from poroelasticity_dealii_tpu.solvers import build_discretization as jb
    data = jread(GOLDEN)
    if case.startswith("cube"):
        data = dataclasses.replace(data, **{
            f: getattr(_data(case), f) for f in (
                "dim", "domain_size", "displacement_boundary_labels",
                "displacement_boundary_components",
                "displacement_boundary_values")})
    return data, jb(_mesh(case, jrect), data)


@functools.lru_cache(maxsize=None)
def _jax_ghost(case, k):
    from poroelasticity_dealii_tpu.parallel import (
        make_device_mesh, shard_discretization_ghost as jshard)
    return jshard(_jax_disc(case)[1], make_device_mesh(k))


@functools.lru_cache(maxsize=None)
def _jax_applies(case, k=None):
    """JAX's five applies on :func:`_inputs`: its ghost ones on k devices,
    or (k None) its unsharded ones on its renumbered discretization (each
    ghost apply traces and compiles a shard_map, seconds on the CPU)."""
    if k is None:
        from poroelasticity_dealii_tpu.parallel import \
            renumber_discretization as jrenum
        disc = jrenum(_jax_disc(case)[1])[0]
    else:
        disc = _jax_ghost(case, k)
    xs = _inputs(case)
    return {name: np.asarray(_apply(disc, name, xs[_operand(name)]))
            for name in APPLIES}


def _inputs(case):
    """Seeded inputs in the renumbered numbering: p, u, a 3-lane p."""
    rd = _renumbered(case)[0]
    rng = np.random.default_rng(0)
    return {"p": rng.standard_normal(rd.n_pdofs),
            "u": rng.standard_normal(rd.n_udofs),
            "pb": rng.standard_normal((3, rd.n_pdofs))}


def _operand(name):
    return "u" if name in ("elasticity", "strain_projection_rhs") else "p"


def _apply(disc, name, x):
    return getattr(disc, name)(x, BIOT) if name == "coupling_rhs" \
        else getattr(disc, name)(x)


def _assert_apply(name, got, ref):
    rtol, rel_atol, atol = APPLY_TOL[name]
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=rtol,
                               atol=max(atol, rel_atol * np.abs(ref).max()))


# ---------------------------------------------------------------------------
# 1. renumbering, windows and refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [2, 4, 8])
@pytest.mark.parametrize("case", ["golden3", "cube8"])
def test_renumbering_and_windows_match_jax(case, k):
    """``order_p``, ``order_udof`` exactly JAX's and permutations; ``C_*``,
    ``H_*`` JAX's; every rank's window-local connectivity JAX's columns of
    its cells (JAX pads the last chunks with cells of index 0, which the
    port leaves out); the 8-way golden split has H > C (D = 2 rounds)."""
    jg = _jax_ghost(case, k)
    ranks = _ranks(case, k)
    rd = _renumbered(case)[0]
    for order, n in ((ranks[0].order_p, rd.n_pdofs),
                     (ranks[0].order_udof, rd.n_udofs)):
        assert sorted(order.tolist()) == list(range(n))
    np.testing.assert_array_equal(ranks[0].order_p, jg.order_p)
    np.testing.assert_array_equal(ranks[0].order_udof, jg.order_udof)
    E = rd.n_cells
    E_per = -(-E // k)
    for d, r in enumerate(ranks):
        assert (r.C_p, r.H_p, r.C_u, r.H_u) == (jg.C_p, jg.H_p, jg.C_u,
                                                jg.H_u)
        c0, c1 = min(d * E_per, E), min((d + 1) * E_per, E)
        assert r.cells == (c0, c1)
        for mine, theirs in ((r.conn_p, jg.conn_p_loc),
                             (r.conn_u, jg.conn_u_loc)):
            np.testing.assert_array_equal(mine.numpy(),
                                          np.asarray(theirs)[:, c0:c1])
        assert r.n_pdofs == r.C_p and r.n_udofs == r.C_u
    if (case, k) == ("golden3", 8):
        assert ranks[0].H_p > ranks[0].C_p and ranks[0].H_u <= ranks[0].C_u


def _shuffled(mesh, seed=0):
    """``mesh`` with its cells in a random order."""
    perm = np.random.default_rng(seed).permutation(mesh.n_cells)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size)
    return dataclasses.replace(mesh, cells=mesh.cells[perm],
                               face_cells=inv[mesh.face_cells]
                               .astype(mesh.face_cells.dtype))


def test_ghost_refusals_are_jax_s():
    """JAX's refusals, with its words: a hanging-node mesh
    (``NotImplementedError``, both packages); a halo that spans all ranks
    (``ValueError``; the windows of any cell order stay below it, so the
    guard is held directly); a structured grid (``TypeError``: no cell
    arrays)."""
    from poroelasticity_dealii_tpu.amr import QuadForest as JQ
    from poroelasticity_dealii_tpu.amr.driver import \
        build_amr_discretization as jamr
    from poroelasticity_dealii_tpu.parallel import \
        renumber_discretization as jrenum
    from poroelasticity_dealii_torch.solvers.structured import \
        build_grid_discretization
    data, jdata = read_input_file(GOLDEN), _jax_disc("golden3")[0]
    forests = []
    for cls in (QuadForest, JQ):
        f = cls.uniform([-5, -5], [5, 5], 2)
        f.refine_and_coarsen([leaf for leaf in f.leaves
                              if leaf[1] == 0 and leaf[2] == 0], [])
        forests.append(f)
    words = "ghost sharding on AMR meshes"
    with pytest.raises(NotImplementedError, match=words):
        gh.renumber_discretization(
            build_amr_discretization(forests[0], data, device="cpu"))
    with pytest.raises(NotImplementedError, match=words):
        jrenum(jamr(forests[1], jdata))
    gh._check_halo(4, 10, 30, 20, 60)
    with pytest.raises(ValueError, match="halo spans all devices .H_p=31/"
                       "C_p=10, H_u=0/C_u=20.: cell order is not spatially"):
        gh._check_halo(4, 10, 31, 20, 0)
    with pytest.raises(TypeError, match="generic discretization"):
        gh.shard_discretization_ghost(
            build_grid_discretization(data, cells_per_axis=4, device="cpu"),
            make_slab_group("cpu"))


def test_shuffled_cell_order_gives_wide_windows_as_jax():
    """The golden fixture with its cells in a random order: the 8-way
    split's windows are JAX's and span several ranks (H_p = 72 over C_p =
    11: 7 rounds of whole chunks a side), and the stitched applies still
    equal the unsharded ones."""
    from poroelasticity_dealii_tpu.mesh import hyper_rectangle as jrect
    from poroelasticity_dealii_tpu.parallel import (
        make_device_mesh, shard_discretization_ghost as jshard)
    from poroelasticity_dealii_tpu.solvers import build_discretization as jb
    data, jdata = read_input_file(GOLDEN), _jax_disc("golden3")[0]
    mine = build_discretization(_shuffled(_mesh("golden3", hyper_rectangle)),
                                data, device="cpu")
    jg = jshard(jb(_shuffled(_mesh("golden3", jrect)), jdata),
                make_device_mesh(8))
    renumbered = gh.renumber_discretization(mine)
    ranks = [gh.shard_renumbered(renumbered, SlabGroup(d, 8, None, CPU))
             for d in range(8)]
    r0 = ranks[0]
    assert (r0.C_p, r0.H_p, r0.C_u, r0.H_u) == (jg.C_p, jg.H_p, jg.C_u,
                                                jg.H_u)
    assert r0.H_p > 6 * r0.C_p
    rng = np.random.default_rng(1)
    for name in APPLIES:
        x = torch.as_tensor(rng.standard_normal(
            r0._length(_operand(name))))
        _assert_apply(name, _stitched(ranks, name, x),
                      _apply(renumbered[0], name, x))


# ---------------------------------------------------------------------------
# 2. the applies
# ---------------------------------------------------------------------------

def _stitched(ranks, name, x):
    """Apply ``name`` of a split whose every rank runs in this process."""
    return gh.split_apply(ranks, name, x,
                          *((BIOT,) if name == "coupling_rhs" else ()))[0]


@pytest.mark.parametrize("case,k", [("golden3", 8), ("golden1", 4),
                                    ("cube8", 8)])
def test_in_process_splits_match_unsharded_and_jax(case, k):
    """Every split of 1..k ranks through the in-process transport (what
    ``chip_smoke.py::ghost_split_phase`` runs at 40^3): the stitched
    applies equal the renumbered unsharded applies (the source applies
    permuted, bit for bit) within JAX's tolerances; the k-way split of
    JAX's own fixture (golden, 8 devices) also JAX's ghost applies, the
    others JAX's unsharded applies on its renumbered discretization."""
    rd = _renumbered(case)[0]
    src = _port(case)[1]
    op, ou = (torch.as_tensor(o) for o in _renumbered(case)[1:])
    xs = {key: torch.as_tensor(v) for key, v in _inputs(case).items()}
    jax_ref = _jax_applies(case, k if case == "golden3" else None)
    for name in APPLIES:
        x = xs[_operand(name)]
        ref = _apply(rd, name, x)
        back = {"p": op, "u": ou}[_operand(name)]
        unp = torch.empty_like(x)
        unp[back] = x
        out = {"p": op, "u": ou}[gh.WINDOW_APPLIES[name][1]]
        assert torch.equal(ref, _apply(src, name, unp)[..., out])
        for n_dev in range(1, k + 1):
            _assert_apply(name, _stitched(_ranks(case, n_dev), name, x), ref)
        _assert_apply(name, _stitched(_ranks(case, k), name, x),
                      jax_ref[name])
    _assert_apply("mass", _stitched(_ranks(case, k), "mass", xs["pb"]),
                  rd.mass(xs["pb"]))


APPLY_CASES = ("golden3", "golden1")


def _apply_worker(rank, world):
    g = make_slab_group("cpu")
    out = {}
    for case in APPLY_CASES:
        gd = gh.shard_renumbered(_renumbered(case), g)
        xs = {key: torch.as_tensor(v) for key, v in _inputs(case).items()}
        res = {}
        for name in APPLIES:
            kin, kout = gh.WINDOW_APPLIES[name]
            y = _apply(gd, name, gd.owned(xs[kin], kin))
            res[name] = gd.whole(y, kout)
        res["mass_batched"] = gd.whole(gd.mass(gd.owned(xs["pb"], "p")),
                                       "p")
        out[case] = {"applies": res, "CH": (gd.C_p, gd.H_p, gd.C_u, gd.H_u),
                     "p2p": gd.kit.comm.messages.get("p2p", 0),
                     "cells": gd.cells}
    return out


@pytest.mark.parametrize("world", [2, 3, 4])
def test_applies_on_ranks_match_unsharded_and_jax(world, tmp_path):
    """The five applies and a 3-lane mass on ``world`` gloo ranks, each
    rank given its chunk of the same seeded vectors and the results
    gathered (``whole``): the unsharded renumbered applies and JAX's (its
    unsharded applies on its renumbered discretization, which its own
    test holds to its ghost ones) within JAX's tolerances; the windows
    JAX's ghost windows on ``world`` devices.  The golden deck on 2 x 2
    cells over 4 ranks has H > C: its windows take D = 2 rounds of whole
    chunks; over 3 ranks the last rank has no cell and still takes part
    in every exchange."""
    outs = _spawn(_apply_worker, world, tmp_path)
    for case in APPLY_CASES:
        rd = _renumbered(case)[0]
        xs = {key: torch.as_tensor(v) for key, v in _inputs(case).items()}
        jg, jax_ref = _jax_ghost(case, world), _jax_applies(case)
        for rank, out in enumerate(outs):
            o = out[case]
            assert o["CH"] == (jg.C_p, jg.H_p, jg.C_u, jg.H_u)
            assert o["p2p"] > 0
            for name in APPLIES:
                x = xs[_operand(name)]
                _assert_apply(name, o["applies"][name], _apply(rd, name, x))
                _assert_apply(name, o["applies"][name], jax_ref[name])
            _assert_apply("mass", o["applies"]["mass_batched"],
                          rd.mass(xs["pb"]))
    if world == 4:
        C_p, H_p = outs[0]["golden1"]["CH"][:2]
        assert H_p > C_p
    if world == 3:
        assert outs[2]["golden1"]["cells"] == (4, 4)


# ---------------------------------------------------------------------------
# 3. one fixed-stress step
# ---------------------------------------------------------------------------

def _fields(st) -> dict:
    return {k: np.asarray(getattr(st, k)) for k in FIELDS}


@functools.lru_cache(maxsize=None)
def _jax_step(k):
    """JAX's ghost ``initial_state`` and one ``time_step`` on k devices
    (the golden fixture, float64)."""
    from poroelasticity_dealii_tpu.solvers import FixedStressSolver as JF
    data = _jax_disc("golden3")[0]
    s = JF(_jax_ghost("golden3", k), data)
    st0 = s.initial_state()
    st1, stats = s.time_step(st0, data.time_step)
    return {"initial": _fields(st0), "step": _fields(st1),
            "stats": {c: int(getattr(stats, c)) for c in COUNTS}}


def _stats(stats) -> dict:
    return {c: int(getattr(stats, c)) for c in COUNTS}


def _whole(state, gd) -> dict:
    """The gathered restart fields, as tensors (what a spawned rank may
    hand back)."""
    return {k: torch.as_tensor(v) for k, v in
            state_to_numpy(state, ghost=gd).items() if k in FIELDS}


def _step_worker(rank, world, carried):
    data = _port("golden3")[0]
    gd = gh.shard_renumbered(_renumbered("golden3"), make_slab_group("cpu"))
    s = FixedStressSolver(gd, data)
    out = {"graphs": s.graphs is None,
           "initial": _whole(s.initial_state(), gd)}
    st0 = state_from_numpy({k: v.numpy() for k, v in carried.items()},
                           device="cpu", ghost=gd)
    st1, stats = s.time_step(st0, data.time_step)
    out.update(step=_whole(st1, gd), stats=_stats(stats))
    if world == 2:
        # Steps per dispatch: a block of 2 equals 2 time_step calls; Debug
        # NaNs on equals off
        a, _ = s.time_step(st1, data.time_step)
        a, _ = s.time_step(a, data.time_step)
        b, _ = s.multi_step(st1, data.time_step, n_steps=2)
        sd = FixedStressSolver(gd, dataclasses.replace(data, debug_nans=True))
        c, _ = sd.time_step(st0, data.time_step)
        out["multi_step_bitwise"] = all(torch.equal(getattr(a, f),
                                                    getattr(b, f))
                                        for f in FIELDS)
        out["debug_nans_bitwise"] = all(torch.equal(getattr(c, f),
                                                    getattr(st1, f))
                                        for f in FIELDS)
    return out


@pytest.mark.parametrize("world", [1, 2, 4])
def test_step_matches_unsharded_and_jax(world, tmp_path):
    """The golden fixture in float64 on ``world`` ranks: the initial state
    (u to atol 1e-14) and, from JAX's ghost initial state carried in
    through ``interop``, one step against JAX's ghost step on ``world``
    devices and the unsharded port's step on the renumbered
    discretization: FSS and pressure counts equal, p to rtol 1e-10, u to
    atol 1e-13; the chunks run eagerly; on 2 ranks a ``multi_step`` block
    of 2 equals 2 steps and ``Debug NaNs`` on equals off, bit for bit."""
    ref = _jax_step(world)
    outs = _spawn(_step_worker, world, tmp_path,
                  {k: torch.tensor(v) for k, v in ref["initial"].items()})
    data, rd = _port("golden3")[0], _renumbered("golden3")[0]
    s = FixedStressSolver(rd, data)
    st, stats = s.time_step(state_from_numpy(ref["initial"], device="cpu"),
                            data.time_step)
    for want in (ref, {"step": _fields(st), "stats": _stats(stats)}):
        for out in outs:
            assert out["graphs"]
            assert out["stats"] == want["stats"]
            np.testing.assert_allclose(out["step"]["p"], want["step"]["p"],
                                       rtol=1e-10)
            np.testing.assert_allclose(out["step"]["u"], want["step"]["u"],
                                       atol=1e-13)
    for out in outs:
        np.testing.assert_allclose(out["initial"]["u"], ref["initial"]["u"],
                                   atol=1e-14)
        if world == 2:
            assert out["multi_step_bitwise"] and out["debug_nans_bitwise"]


# ---------------------------------------------------------------------------
# 4. what a CG sends
# ---------------------------------------------------------------------------

def _comm_worker(rank, world, iters):
    out = {}
    for case in ("cube8", "cube16"):
        gd = gh.shard_discretization_ghost(_port(case)[1],
                                           make_slab_group("cpu"))
        rng = np.random.default_rng(0)
        b = gd.owned(torch.as_tensor(rng.standard_normal(
            gd._length("u"))), "u")
        kit = gd.kit
        kit.comm.reset()
        res = cg_solve(gd.elasticity, b, torch.zeros_like(b),
                       gd.diag_elasticity, tol=0.0, max_iter=iters,
                       dot=kit.dot, norm=kit.norm)
        cg = dataclasses.asdict(kit.comm)
        pb = gd.owned(torch.as_tensor(rng.standard_normal(
            (3, gd._length("p")))), "p")
        kit.comm.reset()
        resb = cg_solve_batched(gd.mass, pb, torch.zeros_like(pb),
                                gd.diag_mass, tol=np.zeros(3),
                                max_iter=iters, dot=kit.lane_dot,
                                norm=kit.lane_norm)
        out[case] = {"cg": cg, "batched": dataclasses.asdict(kit.comm),
                     "iterations": [int(res.iterations),
                                    resb.iterations.tolist()],
                     "H_u": gd.H_u, "n_udofs": gd._length("u"),
                     "item": b.element_size()}
    return out


def test_cg_sends_halo_windows_and_scalars(tmp_path):
    """5 elasticity CG iterations (and 5 of a 3-lane batched mass CG) on 2
    ranks, 3D at 8^3 and 16^3, counted by the kit: every p2p message holds
    at most H_u values, every all-reduce one value (one per lane), nothing
    is gathered; the p2p bytes grow from 8^3 to 16^3 by the H_u ratio
    within 1% and by less than 0.75x the volume ratio, and at 16^3 they
    are less than one vector (``test_ghost_sharding.py``'s HLO audit)."""
    iters = 5
    outs = _spawn(_comm_worker, 2, tmp_path, iters)
    for out in outs:
        for case in ("cube8", "cube16"):
            o = out[case]
            assert o["iterations"] == [iters, [iters] * 3]
            c, cb = o["cg"], o["batched"]
            assert "all_gather" not in c["messages"]
            assert "all_gather" not in cb["messages"]
            assert c["largest"]["p2p"] <= o["H_u"]
            # 2 messages per apply (window, return): 1 + iters applies
            assert c["messages"]["p2p"] == 2 * (iters + 1)
            assert c["largest"]["all_reduce"] == 1
            assert cb["largest"]["all_reduce"] == 3
        small, big = out["cube8"], out["cube16"]
        ratio = big["cg"]["bytes"]["p2p"] / small["cg"]["bytes"]["p2p"]
        assert ratio == pytest.approx(big["H_u"] / small["H_u"], rel=0.01)
        assert ratio < 0.75 * big["n_udofs"] / small["n_udofs"]
        assert big["cg"]["bytes"]["p2p"] < big["n_udofs"] * big["item"]


# ---------------------------------------------------------------------------
# 5. the runner: a checkpointed ghost run, resumed
# ---------------------------------------------------------------------------

def _runner_data(out, sharding, **kw):
    data = read_input_file(GOLDEN)
    return dataclasses.replace(
        data, t_max=2 * data.time_step, output_directory=str(out),
        sharding=sharding, output_vtk=False, checkpoint_every=1,
        checkpoint_directory=f"{out}/ckpt", mech_cg_relative=True,
        mech_cg_tol=1e-10, **kw)


def _ckpt_worker(rank, world, out_root, resume_from):
    state = run_from_data(_runner_data(f"{out_root}/rank{rank}", "ghost"),
                          resume_from=resume_from, device="cpu")
    return {k: getattr(state, k) for k in FIELDS}


def test_runner_checkpoints_and_resumes_ghost_on_two_ranks(tmp_path):
    """The golden deck with ``Sharding = ghost`` on 2 ranks, a checkpoint
    every step: rank 0 alone writes them, whole and in the renumbered
    order (the unsharded run's arrays permuted by ``order_p`` /
    ``order_udof``, within 1e-10 of max), and both ranks resumed from
    step 1 end bit for bit where the uninterrupted run ends."""
    full = _spawn(_ckpt_worker, 2, tmp_path / "spawn_full",
                  str(tmp_path / "full"), None)
    ckpt = tmp_path / "full" / "rank0" / "ckpt"
    assert sorted(p.name for p in ckpt.iterdir()) == \
        ["ckpt-000001.npz", "ckpt-000002.npz"]
    assert not (tmp_path / "full" / "rank1").exists()
    data = _runner_data(tmp_path / "unsharded", "ghost")
    with pytest.warns(RuntimeWarning, match="single process"):
        runner = SimulationRunner(dataclasses.replace(data,
                                                      checkpoint_every=0),
                                  device="cpu")
    ref = runner.run()
    _, op, ou = gh.renumber_discretization(build_discretization(
        structured_generic_mesh(data), data, device="cpu"))
    with np.load(ckpt / "ckpt-000002.npz") as z:
        for key, order in (("p", op), ("u", ou)):
            want = getattr(ref, key).numpy()[order]
            assert z[key].shape == want.shape
            assert np.abs(z[key] - want).max() <= 1e-10 * np.abs(want).max()
        np.testing.assert_array_equal(z["p"], full[0]["p"].numpy())
    res = _spawn(_ckpt_worker, 2, tmp_path / "spawn_res",
                 str(tmp_path / "res"), str(ckpt / "ckpt-000001.npz"))
    for a, b in zip(full, res):
        for k in FIELDS:
            assert torch.equal(a[k], b[k]), k
