"""The sharded production path of the port (``parallel/``), the z-slab
counterpart of ``tests/test_rows_sharding.py``: ranks are CPU processes in
a gloo process group, as the JAX tests shard over virtual CPU devices.

* the slab form of the row-layout apply's plain twin against JAX's
  ``make_pallas_apply_rows(nz=Lz)`` with a run-time ``nv`` (interpret mode);
* the sharded apply over 2, 3 and 4 ranks against the unsharded apply, and
  the ``to_rows``/``from_rows`` round trip through the padded shape;
* the production step over 1, 2 and 4 ranks against the port's unsharded
  step, the 2-rank step against JAX's unsharded step, and a JAX state
  carried into the 2-rank solver;
* the collectives of 5 mechanics CG iterations: one 24-row band per
  point-to-point message, scalar all-reduces;
* the runner: a sharded run from the deck, checkpoints of both formats and
  the resume from them, the one-process warning, and the modes it
  refuses.

Ranks are spawned (``torch.multiprocessing``, a ``file://`` rendezvous in
the test's temporary directory, so no TCP port) and joined with a timeout:
a hung collective fails its test instead of running into the suite's limit.
The workers are module functions that import only torch and the port; JAX
is imported inside the tests that compare with it, in the test process.
The CUDA-marked tests hold the slab kernel against its plain twin on the
card and skip here.
"""

import dataclasses
import functools
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from poroelasticity_dealii_torch import read_input_file
from poroelasticity_dealii_torch.interop import state_from_numpy
from poroelasticity_dealii_torch.models.runner import (SimulationRunner,
                                                       run_from_data)
from poroelasticity_dealii_torch.ops import comp_major as cm
from poroelasticity_dealii_torch.parallel import rows as pr
from poroelasticity_dealii_torch.parallel.sharding import make_slab_group
from poroelasticity_dealii_torch.solvers.cg import cg_solve
from poroelasticity_dealii_torch.solvers.fss import FixedStressSolver
from poroelasticity_dealii_torch.solvers.structured import \
    build_grid_discretization

DECK = "configs/consolidation_3d.data"
JOIN_TIMEOUT = 120        # seconds for every rank of one spawn to finish
N_STEP = 6                # the production step's grid (JAX's test: 6)
BC = [(1.05, 1.0), (1.1, 1.05)]     # (bc_scale, bc_scale_prev) per step


# ---------------------------------------------------------------------------
# spawning gloo ranks
# ---------------------------------------------------------------------------

def _rank_entry(rank, fn, world, tmp, args):
    """One rank: join the gloo group, run ``fn(rank, world, *args)``, save
    its result for the test process."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous",
                            rank=rank, world_size=world)
    try:
        torch.save(fn(rank, world, *args), f"{tmp}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _spawn(fn, world, tmp, *args):
    """``[fn(rank, world, *args) for each rank]``, run on ``world`` spawned
    gloo ranks; fails the test if they have not all finished within
    :data:`JOIN_TIMEOUT` (and kills them) or if one raised."""
    tmp.mkdir(parents=True, exist_ok=True)
    ctx = mp.start_processes(_rank_entry, args=(fn, world, str(tmp), args),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + JOIN_TIMEOUT
    try:
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                pytest.fail(f"{world} ranks of {fn.__name__} still running "
                            f"after {JOIN_TIMEOUT} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
                proc.join()
    return [torch.load(tmp / f"rank{r}.pt") for r in range(world)]


def _data(**kw):
    """The 3D deck with a relative mechanics tolerance (the deck's absolute
    1e-12 is below the float64 roundoff of its right-hand side, where CG
    counts follow the summation order)."""
    return dataclasses.replace(read_input_file(DECK), mech_cg_relative=True,
                               mech_cg_tol=1e-10, **kw)


def _rel(got, ref) -> float:
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _random_ke(seed=0):
    rng = np.random.default_rng(seed)
    ke = rng.standard_normal((81, 81))
    return ke + ke.T


# ---------------------------------------------------------------------------
# 1. the slab form's plain twin against JAX's slab kernel
# ---------------------------------------------------------------------------

SLAB_N = 5


@functools.lru_cache(maxsize=None)
def _jax_slab_apply(Lz):
    import jax.numpy as jnp
    from poroelasticity_dealii_tpu.ops import pallas_comp_major as pcm
    return pcm.make_pallas_apply_rows(_random_ke(), SLAB_N, jnp.float64,
                                      tc=2, interpret=True, nz=Lz)


@pytest.mark.parametrize("Lz,nv", [(2, 0), (2, 1), (2, 2), (3, 0), (3, 1),
                                   (3, 2), (3, 3)])
def test_slab_twin_matches_jax(Lz, nv):
    """``nv`` in {0, 1, Lz-1, Lz}; the input is nonzero everywhere, also
    in the rows past nv and in the halo band, which cells past nv must not
    read."""
    import jax.numpy as jnp
    n = SLAB_N
    R = np.random.default_rng(10 * Lz + nv).standard_normal(
        ((Lz + 1) * 24, cm._width(n)))
    want = np.asarray(_jax_slab_apply(Lz)(jnp.asarray(R), nv))
    got = cm.elasticity_rows_apply_plain(
        torch.as_tensor(R), None, torch.as_tensor(_random_ke()), n,
        cm.UNMASKED, nz=Lz, nv=nv).numpy()
    assert got.shape == want.shape == R.shape
    np.testing.assert_allclose(got, want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())
    assert (np.abs(got).max() > 0) == (nv > 0)


def test_slab_form_refuses_masks_and_bad_counts():
    n = 3
    x = torch.zeros((3 * 24, cm._width(n)), dtype=torch.float64)
    ke = torch.as_tensor(_random_ke())
    with pytest.raises(ValueError, match="UNMASKED"):
        cm.elasticity_rows_apply(x, x, ke, n, cm.FREE, nz=2, nv=1)
    with pytest.raises(ValueError, match="nv"):
        cm.elasticity_rows_apply(x, None, ke, n, cm.UNMASKED, nz=2, nv=3)
    # the whole grid is the slab form with nz = nv = n
    xg = torch.as_tensor(np.random.default_rng(1).standard_normal(
        cm._rows_shape(n)))
    assert torch.equal(
        cm.elasticity_rows_apply(xg, None, ke, n, cm.UNMASKED),
        cm.elasticity_rows_apply(xg, None, ke, n, cm.UNMASKED, nz=n, nv=n))


# ---------------------------------------------------------------------------
# 2. the sharded apply and the layout round trip
# ---------------------------------------------------------------------------

def _apply_worker(rank, world, sizes):
    group = make_slab_group("cpu")
    out = {}
    for n in sizes:
        nud = (2 * n + 1) ** 3 * 3
        u = torch.as_tensor(np.random.default_rng(n).standard_normal(nud))
        ro = pr.make_row_ops_sharded(
            _random_ke(), n, np.ones(nud), np.ones(nud), group,
            np.zeros((81, 8)), np.zeros((48, 81)), torch.float64)
        R = ro.to_rows(u)
        out[n] = {"y": ro.from_rows(ro.apply_rows(R)),
                  "round_trip": ro.from_rows(R), "shape": tuple(R.shape),
                  "gathered": tuple(ro.gather_rows(R).shape), "nv": ro.nv}
    return out


@pytest.mark.parametrize("world", [2, 3, 4])
def test_sharded_apply_matches_unsharded(world, tmp_path):
    """n = 5 on 4 ranks leaves the tail rank no real cell layer (nv = 0)."""
    sizes = (5, 8)
    outs = _spawn(_apply_worker, world, tmp_path, sizes)
    ke = torch.as_tensor(_random_ke())
    for n in sizes:
        u = torch.as_tensor(np.random.default_rng(n).standard_normal(
            (2 * n + 1) ** 3 * 3))
        want = cm.from_rows(cm.elasticity_rows_apply_plain(
            cm.to_rows(u, n), None, ke, n, cm.UNMASKED), n)
        Lz = pr.slab_layers(n, world)
        assert [o[n]["nv"] for o in outs] == [
            pr.real_layers(n, world, r) for r in range(world)]
        for o in outs:
            assert o[n]["shape"] == (Lz * 24, cm._width(n))
            assert o[n]["gathered"] == (world * Lz * 24, cm._width(n))
            np.testing.assert_allclose(o[n]["y"], want, rtol=1e-12,
                                       atol=1e-12 * float(want.abs().max()))
            assert torch.equal(o[n]["round_trip"], u)
    if world == 4:
        assert outs[-1][5]["nv"] == 0


# ---------------------------------------------------------------------------
# 3-4. the production step, and a JAX state carried in
# ---------------------------------------------------------------------------

def _stats(s) -> dict:
    return {k: getattr(s, k) for k in (
        "fss_iterations", "pressure_iterations", "pressure_cg_iterations",
        "mech_cg_iterations", "projection_cg_iterations", "pressure_error",
        "cg_converged")}


def _fields(st) -> dict:
    return {k: getattr(st, k).clone() for k in ("p", "u", "eps_v",
                                                 "strains")}


def _production_run(group, jax_step1=None) -> dict:
    """initial_state and step 1 on the sharded discretization over
    ``group``; with ``jax_step1`` (JAX's state after step 1, numpy), also
    step 2 from that state carried in."""
    data = _data()
    disc = build_grid_discretization(data, cells_per_axis=N_STEP,
                                     multigrid="off", device="cpu")
    sdisc = pr.shard_production_discretization(disc, group)
    s = FixedStressSolver(sdisc, data)
    st0 = s.initial_state()
    bc, prev = BC[0]
    st1, stats1 = s.time_step(st0, data.time_step, bc, bc_scale_prev=prev)
    out = {"initial": _fields(st0), "step1": _fields(st1),
           "stats1": _stats(stats1), "nv": sdisc.row_ops.nv,
           "u_rows_shape": tuple(st1.u_rows.shape)}
    if jax_step1 is not None:
        carried = state_from_numpy(jax_step1, device="cpu",
                                   row_ops=sdisc.row_ops)
        out["carried_u_rows_shape"] = tuple(carried.u_rows.shape)
        bc, prev = BC[1]
        st2, stats2 = s.time_step(carried, data.time_step, bc,
                                  bc_scale_prev=prev)
        out["step2"] = _fields(st2)
        out["stats2"] = _stats(stats2)
    return out


def _production_worker(rank, world, jax_step1):
    return _production_run(make_slab_group("cpu"), jax_step1)


def _jax_run():
    """JAX's unsharded rows path at N_STEP: numpy states after
    initial_state and each step of BC, and the stats."""
    from poroelasticity_dealii_tpu.config import read_input_file as jread
    from poroelasticity_dealii_tpu.solvers import FixedStressSolver as JF
    from poroelasticity_dealii_tpu.solvers import structured as jst
    data = dataclasses.replace(jread(DECK), mech_cg_relative=True,
                               mech_cg_tol=1e-10)
    d = jst.build_grid_discretization(data, cells_per_axis=N_STEP,
                                      multigrid="off",
                                      elasticity_backend="pallas")
    s = JF(d, data)
    st = s.initial_state()
    states, stats = [st], []
    for bc, prev in BC:
        st, ss = s.time_step(st, data.time_step, bc, bc_scale_prev=prev)
        states.append(st)
        stats.append({f: np.asarray(getattr(ss, f)).item() for f in (
            "fss_iterations", "pressure_iterations",
            "pressure_cg_iterations", "mech_cg_iterations",
            "projection_cg_iterations", "pressure_error", "cg_converged")})
    as_np = [{k: (None if getattr(x, k) is None else np.asarray(
        getattr(x, k))) for k in x._fields} for x in states]
    return as_np, stats


@functools.lru_cache(maxsize=None)
def _unsharded_run() -> dict:
    data = _data()
    s = FixedStressSolver(build_grid_discretization(
        data, cells_per_axis=N_STEP, multigrid="off", device="cpu"), data)
    st0 = s.initial_state()
    bc, prev = BC[0]
    st1, stats1 = s.time_step(st0, data.time_step, bc, bc_scale_prev=prev)
    return {"initial": _fields(st0), "step1": _fields(st1),
            "stats1": _stats(stats1)}


def _sharded_runs(world, tmp_path, jax_step1=None):
    """Every rank's :func:`_production_run` on ``world`` ranks (one process
    and no group for 1)."""
    if world == 1:
        return [_production_run(make_slab_group("cpu"), jax_step1)]
    return _spawn(_production_worker, world, tmp_path, jax_step1)


def _assert_close(got, want, what):
    """p to 1e-9 relative, u to 1e-8 with atol 1e-10 max|u| (JAX's
    sharded-step test), strains and eps_v as u."""
    np.testing.assert_allclose(got["p"], want["p"], rtol=1e-9, err_msg=what)
    for k in ("u", "eps_v", "strains"):
        w = np.asarray(want[k])
        np.testing.assert_allclose(got[k], w, rtol=1e-8,
                                   atol=1e-10 * np.abs(w).max(),
                                   err_msg=f"{what} {k}")


def _assert_counts(got, want, slack=2):
    assert got["fss_iterations"] == want["fss_iterations"]
    assert got["pressure_iterations"] == want["pressure_iterations"]
    assert got["pressure_cg_iterations"] == want["pressure_cg_iterations"]
    assert abs(got["mech_cg_iterations"]
               - want["mech_cg_iterations"]) <= slack
    assert abs(got["projection_cg_iterations"]
               - want["projection_cg_iterations"]) <= slack
    assert got["cg_converged"] and want["cg_converged"]


@pytest.mark.parametrize("world", [1, 2, 4])
def test_production_step_matches_unsharded(world, tmp_path):
    runs = _sharded_runs(world, tmp_path)
    ref = _unsharded_run()
    Lz = pr.slab_layers(N_STEP, world)
    for rank, out in enumerate(runs):
        assert out["nv"] == pr.real_layers(N_STEP, world, rank)
        assert out["u_rows_shape"] == (Lz * 24, cm._width(N_STEP))
        _assert_close(out["initial"], ref["initial"], f"rank {rank} t=0")
        _assert_close(out["step1"], ref["step1"], f"rank {rank} step 1")
        _assert_counts(out["stats1"], ref["stats1"])
        assert out["stats1"]["pressure_iterations"] > 0
        assert out["stats1"]["mech_cg_iterations"] > 0
        # the replicated pressure side: bitwise equal on every rank
        assert torch.equal(out["step1"]["p"], runs[0]["step1"]["p"])
        assert out["stats1"] == runs[0]["stats1"]


def _assert_jax(got_fields, got_stats, ref, ref_stats):
    """test_torch_fss.py::test_whole_slice_f64_matches_jax's tolerances."""
    for k in ("p", "u", "strains"):
        assert _rel(got_fields[k], ref[k]) <= 1e-8, k
    np.testing.assert_allclose(got_fields["eps_v"], ref["eps_v"], rtol=1e-8,
                               atol=1e-8 * np.abs(ref["eps_v"]).max())
    if got_stats is not None:
        _assert_counts(got_stats, ref_stats)
        np.testing.assert_allclose(got_stats["pressure_error"],
                                   ref_stats["pressure_error"], rtol=1e-6)


def test_sharded_slice_and_state_carry_over_match_jax(tmp_path):
    """The 2-rank step against JAX's unsharded step on the rows path; then
    JAX's state after step 1 carried into each rank (its slab of u_rows and
    mech_b, the other fields whole) and stepped: JAX's step 2."""
    ref_states, ref_stats = _jax_run()
    Lz = pr.slab_layers(N_STEP, 2)
    for out in _sharded_runs(2, tmp_path, ref_states[1]):
        _assert_jax(out["initial"], None, ref_states[0], None)
        _assert_jax(out["step1"], out["stats1"], ref_states[1], ref_stats[0])
        assert out["carried_u_rows_shape"] == (Lz * 24, cm._width(N_STEP))
        _assert_jax(out["step2"], out["stats2"], ref_states[2], ref_stats[1])


# ---------------------------------------------------------------------------
# 5. the collectives of the mechanics CG
# ---------------------------------------------------------------------------

def _collectives_worker(rank, world, n, iters):
    """5 CG iterations through the sharded kit with the collectives
    counted: (kind, numel) of every message."""
    seen = []
    p2p, all_reduce, all_gather = (dist.batch_isend_irecv, dist.all_reduce,
                                   dist.all_gather)

    def count_p2p(ops):
        seen.extend(("p2p", op.tensor.numel()) for op in ops)
        return p2p(ops)

    def count_all_reduce(t, *a, **kw):
        seen.append(("all_reduce", t.numel()))
        return all_reduce(t, *a, **kw)

    def count_all_gather(parts, t, *a, **kw):
        seen.append(("all_gather", t.numel()))
        return all_gather(parts, t, *a, **kw)

    data = _data()
    disc = build_grid_discretization(data, cells_per_axis=n, multigrid="off",
                                     device="cpu")
    ro = pr.shard_production_discretization(disc, make_slab_group("cpu")) \
        .row_ops
    u = torch.as_tensor(np.random.default_rng(0).standard_normal(
        disc.n_udofs))
    b = ro.free_mask_rows * ro.to_rows(u)
    dist.batch_isend_irecv, dist.all_reduce, dist.all_gather = (
        count_p2p, count_all_reduce, count_all_gather)
    try:
        res = cg_solve(ro.constrained_apply, b, torch.zeros_like(b),
                       ro.diag_rows, tol=0.0, max_iter=iters,
                       apply_iter=ro.free_apply, dot=ro.dot, norm=ro.norm)
    finally:
        dist.batch_isend_irecv, dist.all_reduce, dist.all_gather = (
            p2p, all_reduce, all_gather)
    return {"seen": seen, "iterations": res.iterations,
            "slab": ro.free_mask_rows.numel()}


def test_mech_cg_collectives_are_halo_bands(tmp_path):
    """Every point-to-point message is one 24-row band (24*W values) and
    every all-reduce a scalar; nothing is gathered."""
    n, iters = 8, 5
    band = 24 * cm._width(n)
    for rank, out in enumerate(_spawn(_collectives_worker, 2, tmp_path, n,
                                      iters)):
        assert out["iterations"] == iters
        kinds = [k for k, _ in out["seen"]]
        assert "all_gather" not in kinds
        msgs = [m for k, m in out["seen"] if k == "p2p"]
        # one message each way per apply: the initial residual + iters
        assert len(msgs) == 2 * (iters + 1), msgs
        assert all(m == band for m in msgs)
        reduces = [m for k, m in out["seen"] if k == "all_reduce"]
        assert reduces and all(m == 1 for m in reduces)
        # 3 per iteration (p.Ap, r.z, |r|) + 2 at the start
        assert len(reduces) == 3 * iters + 2
        # an apply's traffic (one band each way) is interface-scaled: far
        # below the rank's slab of the vector
        assert 2 * band < out["slab"]


# ---------------------------------------------------------------------------
# 6. the runner
# ---------------------------------------------------------------------------

def _runner_data(tmp, sharding, **kw):
    """The 3D deck as written (8^3) for 2 steps, relative mechanics
    tolerance, output under ``tmp``."""
    data = read_input_file(DECK)
    return dataclasses.replace(
        data, mech_cg_relative=True, mech_cg_tol=1e-10,
        t_max=2 * data.time_step, output_directory=str(tmp),
        sharding=sharding, **kw)


def _runner_worker(rank, world, out_root):
    """Each rank reads the deck with its own output directory: only rank
    0's may receive files."""
    state = run_from_data(_runner_data(f"{out_root}/rank{rank}",
                                       "production"), device="cpu")
    return {"p": state.p, "u": state.u}


def _run_log(path):
    import json
    return [json.loads(line) for line in path.read_text().splitlines()]


def test_runner_runs_production_deck_on_two_ranks(tmp_path):
    outs = _spawn(_runner_worker, 2, tmp_path / "spawn", str(tmp_path))
    ref_state = run_from_data(_runner_data(tmp_path / "unsharded", "none"),
                              device="cpu")
    log = _run_log(tmp_path / "rank0" / "run_log.jsonl")
    ref = _run_log(tmp_path / "unsharded" / "run_log.jsonl")
    assert len(log) == len(ref) == 2
    for a, b in zip(log, ref):
        assert a["fss_iterations"] == b["fss_iterations"]
        assert a["pressure_iterations"] == b["pressure_iterations"]
        assert a["cg_iterations"]["pressure"] == b["cg_iterations"]["pressure"]
        assert abs(a["cg_iterations"]["mechanics"]
                   - b["cg_iterations"]["mechanics"]) <= 2
        np.testing.assert_allclose(a["pressure_error"], b["pressure_error"],
                                   rtol=1e-6)
    assert len(list((tmp_path / "rank0").glob("solution-*.vtk"))) == 3
    assert not (tmp_path / "rank1").exists()
    for o in outs:
        np.testing.assert_allclose(o["p"], ref_state.p, rtol=1e-9)
        assert _rel(o["u"], ref_state.u) <= 1e-8


BLOCKS = {"steps_per_dispatch": 2, "sync_every": 2, "output_vtk": False}


def _runner_blocks_worker(rank, world, out_root):
    """The production deck with two-step blocks and deferred syncs."""
    state = run_from_data(_runner_data(f"{out_root}/rank{rank}",
                                       "production", **BLOCKS), device="cpu")
    return {"p": state.p, "u": state.u}


def test_runner_blocks_and_deferred_syncs_on_two_ranks(tmp_path):
    """``Steps per dispatch = 2`` and ``Sync every = 2`` on two ranks: one
    block of both steps (``multi_step``), both ranks flush at the same
    step, and the run log is the unsharded default run's in step, time and
    counts (mechanics CG within 2: another order of the dots)."""
    outs = _spawn(_runner_blocks_worker, 2, tmp_path / "spawn", str(tmp_path))
    run_from_data(_runner_data(tmp_path / "unsharded", "none",
                               output_vtk=False), device="cpu")
    log = _run_log(tmp_path / "rank0" / "run_log.jsonl")
    ref = _run_log(tmp_path / "unsharded" / "run_log.jsonl")
    assert [(r["step"], r["time"]) for r in log] == \
        [(r["step"], r["time"]) for r in ref] == [(1, 60.0), (2, 120.0)]
    for a, b in zip(log, ref):
        assert a["fss_iterations"] == b["fss_iterations"]
        assert a["pressure_iterations"] == b["pressure_iterations"]
        assert a["cg_iterations"]["pressure"] == b["cg_iterations"]["pressure"]
        assert abs(a["cg_iterations"]["mechanics"]
                   - b["cg_iterations"]["mechanics"]) <= 2
        np.testing.assert_allclose(a["pressure_error"], b["pressure_error"],
                                   rtol=1e-6)
    assert not list((tmp_path / "rank0").glob("solution-*.vtk"))
    assert not (tmp_path / "rank1").exists()
    assert torch.equal(outs[0]["p"], outs[1]["p"])
    assert torch.equal(outs[0]["u"], outs[1]["u"])


CKPT = {"checkpoint_every": 1, "output_vtk": False}


def _runner_ckpt_worker(rank, world, out_root, resume_from, fmt):
    """The production deck with a checkpoint every step in format ``fmt``,
    each rank with its own output and checkpoint directories (only rank
    0's may receive files), from the start or resumed from
    ``resume_from``."""
    data = _runner_data(f"{out_root}/rank{rank}", "production",
                        checkpoint_directory=f"{out_root}/rank{rank}/ckpt",
                        checkpoint_format=fmt, **CKPT)
    state = run_from_data(data, resume_from=resume_from, device="cpu")
    return {"p": state.p, "u": state.u, "strains": state.strains}


@pytest.mark.parametrize("fmt", ["npz", "orbax"])
def test_runner_checkpoints_and_resumes_on_two_ranks(fmt, tmp_path):
    """A checkpointed production run on two ranks, in each checkpoint
    format (orbax: the port's asynchronous directories): rank 0 alone
    writes the whole state (the unsharded run's within 1e-9), and both
    ranks resumed from its step-1 checkpoint give the uninterrupted run's
    state bit for bit."""
    full = _spawn(_runner_ckpt_worker, 2, tmp_path / "spawn_full",
                  str(tmp_path / "full"), None, fmt)
    ckpt = tmp_path / "full" / "rank0" / "ckpt"
    ext = ".npz" if fmt == "npz" else ""
    assert sorted(p.name for p in ckpt.iterdir()) == \
        [f"ckpt-000001{ext}", f"ckpt-000002{ext}"]
    assert not (tmp_path / "full" / "rank1").exists()
    ref = SimulationRunner(_runner_data(tmp_path / "unsharded", "none",
                                        output_vtk=False), device="cpu")
    ref_state = ref.run()
    last = ckpt / f"ckpt-000002{ext}"
    with np.load(last if fmt == "npz" else last / "state.npz") as z:
        assert z["u"].shape == tuple(ref_state.u.shape)
        assert _rel(z["u"], ref_state.u) <= 1e-8
        np.testing.assert_allclose(z["p"], ref_state.p, rtol=1e-9)
    res = _spawn(_runner_ckpt_worker, 2, tmp_path / "spawn_res",
                 str(tmp_path / "res"), str(ckpt / f"ckpt-000001{ext}"), fmt)
    for a, b in zip(full, res):
        for k in ("p", "u", "strains"):
            assert torch.equal(a[k], b[k]), k
    log = _run_log(tmp_path / "res" / "rank0" / "run_log.jsonl")
    assert [r["step"] for r in log] == [2]


def test_runner_warns_and_runs_unsharded_on_one_process(tmp_path):
    data = dataclasses.replace(_runner_data(tmp_path, "production"),
                               initial_refinement_level=1,
                               t_max=read_input_file(DECK).time_step,
                               output_vtk=False)
    with pytest.warns(RuntimeWarning, match="single process"):
        runner = SimulationRunner(data, device="cpu")
    assert isinstance(runner.disc.row_ops, cm.ElasticityRowOps)
    state = runner.run()
    assert bool(torch.isfinite(state.u).all())


@pytest.mark.parametrize("mode", ["psum", "ghost", "gspmd"])
def test_runner_refuses_other_sharding_modes(mode, tmp_path):
    """psum, ghost and gspmd run: on one process each warns and runs
    unsharded (psum and ghost on the generic discretization of the deck's
    grid, gspmd on the grid)."""
    data = dataclasses.replace(_runner_data(tmp_path, mode),
                               initial_refinement_level=1,
                               t_max=read_input_file(DECK).time_step,
                               output_vtk=False)
    with pytest.warns(RuntimeWarning, match="single process"):
        runner = SimulationRunner(data, device="cpu")
    generic = mode in ("psum", "ghost")
    assert (runner.disc.row_ops is None) == generic
    assert (type(runner.disc).__name__ == "Discretization") == generic
    assert bool(torch.isfinite(runner.run().u).all())


def test_runner_refuses_production_on_2d_deck(tmp_path):
    """2D production (the y-slab parity form) runs: on one process the
    golden deck on the parity kit warns and runs unsharded."""
    data = dataclasses.replace(read_input_file("configs/golden_2d.data"),
                               sharding="production",
                               elasticity_backend="parity",
                               t_max=read_input_file(
                                   "configs/golden_2d.data").time_step,
                               output_vtk=False,
                               output_directory=str(tmp_path))
    with pytest.warns(RuntimeWarning, match="single process"):
        runner = SimulationRunner(data, device="cpu")
    assert type(runner.disc.row_ops).__name__ == "ElasticityParityOps"
    assert bool(torch.isfinite(runner.run().u).all())


def test_runner_refuses_devices_other_than_world_size(tmp_path):
    with pytest.raises(ValueError, match="Devices = 2"):
        SimulationRunner(_runner_data(tmp_path, "production", n_devices=2),
                         device="cpu")


# ---------------------------------------------------------------------------
# on the card: the slab kernel against its plain twin
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n_dev", [1, 2, 4])
@pytest.mark.parametrize("n", [7, 40])
def test_slab_kernel_matches_twin(cuda_dev, n, n_dev, dtype):
    """Every slab of an n_dev-way split (1: the shape a one-rank group
    launches, Lz = n+1, nv = n): the kernel against the plain twin
    (the kernel tests' tolerances) on inputs nonzero past nv and in the
    halo band, bitwise repeatable, and the slabs stitched as the kit does
    against the whole-grid apply (1e-12 / 2e-7 relative: only the sums of
    each slab's first z-half layer are split in two)."""
    twin_tol = {torch.float64: 1e-12, torch.float32: 1e-5}[dtype]
    tol = {torch.float64: 1e-12, torch.float32: 2e-7}[dtype]
    ke = torch.as_tensor(_random_ke(), dtype=dtype, device=cuda_dev)
    Lz, W = pr.slab_layers(n, n_dev), cm._width(n)
    rng = np.random.default_rng(n)
    xg = cm.to_rows(torch.as_tensor(rng.standard_normal(
        (2 * n + 1) ** 3 * 3), dtype=dtype, device=cuda_dev), n)
    full = torch.zeros(((n_dev * Lz + 1) * 24, W), dtype=dtype,
                       device=cuda_dev)
    full[:xg.shape[0]] = xg
    stitched = torch.zeros_like(full)
    cm.reset_launch_counts()
    for d in range(n_dev):
        nv = pr.real_layers(n, n_dev, d)
        x = full[d * Lz * 24:(d + 1) * Lz * 24 + 24].clone()
        noisy = x.clone()
        noisy[(nv + 1) * 24:] = torch.as_tensor(rng.standard_normal(
            noisy[(nv + 1) * 24:].shape), dtype=dtype, device=cuda_dev)
        got = cm.elasticity_rows_apply(noisy, None, ke, n, cm.UNMASKED,
                                       nz=Lz, nv=nv)
        ref = cm.elasticity_rows_apply_plain(noisy, None, ke, n, cm.UNMASKED,
                                             nz=Lz, nv=nv)
        assert torch.equal(got, cm.elasticity_rows_apply(
            noisy, None, ke, n, cm.UNMASKED, nz=Lz, nv=nv))
        scale = ref.abs().max().item() or 1.0
        assert (got - ref).abs().max().item() <= twin_tol * scale
        y = cm.elasticity_rows_apply(x, None, ke, n, cm.UNMASKED, nz=Lz,
                                     nv=nv)
        stitched[d * Lz * 24:(d + 1) * Lz * 24 + 24] += y
    assert cm.launch_counts()["slab"] == 3 * n_dev
    want = cm.elasticity_rows_apply(xg, None, ke, n, cm.UNMASKED)
    got = stitched[:xg.shape[0]]
    assert (got - want).abs().max().item() <= tol * want.abs().max().item()
    assert not stitched[xg.shape[0]:].any()


@pytest.mark.parametrize("Lz,nv", [(2, 1), (2, 2), (3, 0)])
def test_slab_library_yardstick_equals_twin(Lz, nv):
    """The slab form's library yardstick in chip_smoke.py (one CSR SpMV,
    ``tools/apply_bench.library_csr`` with ``nz``, ``nv``) computes what
    its plain twin computes."""
    from poroelasticity_dealii_torch.tools import apply_bench
    n = 3
    ke = torch.as_tensor(_random_ke())
    x = torch.as_tensor(np.random.default_rng(Lz + nv).standard_normal(
        ((Lz + 1) * 24, cm._width(n))))
    M = apply_bench.library_csr("elasticity_rows_apply[unmasked]", n, ke,
                                None, None, None, nz=Lz, nv=nv)
    got = torch.mv(M, x.reshape(-1)).view_as(x)
    want = cm.elasticity_rows_apply_plain(x, None, ke, n, cm.UNMASKED,
                                          nz=Lz, nv=nv)
    scale = want.abs().max().item() or 1.0
    assert (got - want).abs().max().item() <= 1e-13 * scale
