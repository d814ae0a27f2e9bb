"""The port's asynchronous directory checkpoints (``TPU / Checkpoint format =
orbax``, :mod:`poroelasticity_dealii_torch.utils.checkpoint`), on the CPU in
float64 unless stated:

* the counterpart of JAX's ``tests/test_utils.py::
  test_orbax_checkpoint_roundtrip_and_resume``: the directory checkpoint
  equals the ``.npz`` one bit for bit, and a resume from it gives the
  uninterrupted run bit for bit; JAX's orbax checkpoint of the same deck
  holds the same step within 1e-12, and JAX reads the port's directory;
* the snapshot is the state at the save, whatever happens after it; a
  writer's error surfaces at the wait, at the next save and out of the
  runner; the commit puts a whole directory under the final name and
  replaces an existing one; the file is ``np.savez``'s;
* a directory that orbax wrote for the JAX package is refused, and the
  conversion the refusal names reads back;
* on the card (skips here): the side-stream snapshot taken while the next
  steps run equals the synchronous save, and fields freed right after
  their save keep their blocks until the copy has read them.

The adaptive and two-rank counterparts are parametrised over both formats
in ``tests/test_torch_runner_options.py`` and
``tests/test_torch_rows_sharding.py``.  JAX is imported inside the tests
that compare with it, so the card's run of this file imports none.
"""

import dataclasses
import json
import os
import threading
import time
import zipfile

import numpy as np
import pytest
import torch

from poroelasticity_dealii_torch.cli import main as cli_main
from poroelasticity_dealii_torch.config import read_input_file
from poroelasticity_dealii_torch.interop import FIELDS, fields_to_host
from poroelasticity_dealii_torch.models.runner import SimulationRunner
from poroelasticity_dealii_torch.solvers.fss import FixedStressSolver, State
from poroelasticity_dealii_torch.solvers.structured import \
    build_grid_discretization
from poroelasticity_dealii_torch.utils import checkpoint as ck

GOLDEN = "configs/golden_2d.data"
DECK_3D = "configs/consolidation_3d.data"
FIELD_RTOL = 1e-12        # JAX vs port fields, relative to max |field|
WAIT_S = 30               # the longest a test waits on a writer thread


@pytest.fixture(autouse=True)
def _no_save_left_in_flight():
    """Every test collects its saves: a writer error a test leaves behind
    fails that test, not the next one."""
    yield
    ck.wait_for_checkpoints()


def _golden(tmp, name, fmt, **kw):
    """JAX's test deck: golden 2D to t = 360 (6 steps), a checkpoint every
    3.  The mechanics tolerance is relative (1e-12), as in
    ``test_torch_runner_options.py::_golden``: the deck's absolute 1e-12
    lies below the float64 roundoff of its right-hand side, where the
    packages' CG counts differ."""
    opts = dict(t_max=360.0, output_vtk=False, checkpoint_every=3,
                checkpoint_format=fmt, mech_cg_relative=True,
                mech_cg_tol=1e-12, output_directory=str(tmp / f"out_{name}"),
                checkpoint_directory=str(tmp / f"ck_{name}"))
    return dataclasses.replace(read_input_file(GOLDEN), **{**opts, **kw})


def _files_equal(a, b) -> bool:
    with np.load(a) as za, np.load(b) as zb:
        return za.files == zb.files and all(
            za[k].dtype == zb[k].dtype and np.array_equal(za[k], zb[k])
            for k in za.files)


@pytest.fixture(scope="module")
def golden_runs(tmp_path_factory):
    """The port's run with each backend and its resume from the directory
    at step 3: {name: final fields}, and the temporary directory."""
    tmp = tmp_path_factory.mktemp("golden")
    out = {"tmp": tmp}
    for fmt in ("npz", "orbax"):
        out[fmt] = SimulationRunner(_golden(tmp, fmt, fmt),
                                    device="cpu").run()
    out["resumed"] = SimulationRunner(_golden(tmp, "res", "orbax"),
                                      device="cpu").run(
        resume_from=str(tmp / "ck_orbax" / "ckpt-000003"))
    return out


def test_directory_checkpoint_equals_npz_and_resumes(golden_runs):
    tmp = golden_runs["tmp"]
    assert sorted(os.listdir(tmp / "ck_orbax")) == ["ckpt-000003",
                                                   "ckpt-000006"]
    assert os.listdir(tmp / "ck_orbax" / "ckpt-000003") == [ck.STATE_FILE]
    for s in (3, 6):
        assert _files_equal(tmp / "ck_npz" / f"ckpt-{s:06d}.npz",
                            tmp / "ck_orbax" / f"ckpt-{s:06d}" / "state.npz")
    st_d, t_d, k_d = ck.load_checkpoint_any(
        str(tmp / "ck_orbax" / "ckpt-000003"), device="cpu")
    st_n, t_n, k_n = ck.load_checkpoint_any(
        str(tmp / "ck_npz" / "ckpt-000003.npz"), device="cpu")
    assert (t_d, k_d) == (t_n, k_n) == (180.0, 3)
    for k in FIELDS:
        assert torch.equal(getattr(st_d, k), getattr(st_n, k)), k
        assert torch.equal(getattr(golden_runs["orbax"], k),
                           getattr(golden_runs["npz"], k)), k
        assert torch.equal(getattr(golden_runs["resumed"], k),
                           getattr(golden_runs["orbax"], k)), k


def test_directory_checkpoint_crosses_packages(golden_runs):
    """JAX's orbax checkpoint of the same deck, read by its
    ``load_checkpoint_any``, against the port's directory: time and step
    equal, fields within 1e-12; JAX's ``load_checkpoint`` reads the port's
    ``state.npz``."""
    import jax  # noqa: F401
    from poroelasticity_dealii_tpu.config import read_input_file as jread
    from poroelasticity_dealii_tpu.models.runner import \
        SimulationRunner as JRunner
    from poroelasticity_dealii_tpu.utils import checkpoint as jckpt
    tmp = golden_runs["tmp"]
    jdata = jread(GOLDEN)
    jdata = dataclasses.replace(
        jdata, t_max=360.0, output_vtk=False, checkpoint_every=3,
        checkpoint_format="orbax", mech_cg_relative=True, mech_cg_tol=1e-12,
        output_directory=str(tmp / "out_jax"),
        checkpoint_directory=str(tmp / "ck_jax"))
    os.makedirs(jdata.output_directory, exist_ok=True)
    JRunner(jdata).run()
    jst, jt, jk = jckpt.load_checkpoint_any(str(tmp / "ck_jax" /
                                                "ckpt-000003"))
    port_dir = tmp / "ck_orbax" / "ckpt-000003"
    tst, tt, tk = ck.load_checkpoint_any(str(port_dir), device="cpu")
    assert (jt, jk) == (tt, tk) == (180.0, 3)
    for k in FIELDS:
        want = np.asarray(getattr(jst, k))
        err = np.abs(getattr(tst, k).numpy() - want).max() \
            / np.abs(want).max()
        assert err <= FIELD_RTOL, (k, err)
    st, t, step = jckpt.load_checkpoint(str(port_dir / "state.npz"))
    assert (t, step) == (180.0, 3)
    for k in FIELDS:
        assert np.array_equal(np.asarray(getattr(st, k)),
                              getattr(tst, k).numpy()), k


def test_cli_resumes_from_a_directory(golden_runs, tmp_path, monkeypatch):
    """``run DECK --resume ckpt-000003`` on the deck file (its VTK output
    off): the run log holds steps 4 to the end only."""
    tmp = golden_runs["tmp"]
    deck = tmp_path / "deck.data"
    deck.write_text(open(GOLDEN).read() + "\nsubsection TPU\n"
                    "  set Output VTK = false\nend\n")
    monkeypatch.chdir(tmp_path)
    assert cli_main(["run", str(deck), "--device", "cpu", "--resume",
                     str(tmp / "ck_orbax" / "ckpt-000003")]) == 0
    data = read_input_file(str(deck))
    log = (tmp_path / data.output_directory / "run_log.jsonl").read_text()
    assert [json.loads(line)["step"] for line in log.splitlines()] == \
        list(range(4, round(data.t_max / data.time_step) + 1))


# ---------------------------------------------------------------------------
# the snapshot, the writer's errors and the commit
# ---------------------------------------------------------------------------

def _solver(device="cpu", n=2):
    data = read_input_file(DECK_3D)
    disc = build_grid_discretization(data, cells_per_axis=n, device=device)
    return FixedStressSolver(disc, data), data


def _steps(solver, data, state, k):
    for _ in range(k):
        state, _ = solver.time_step(state, data.time_step)
    return state


def _gated_writer(monkeypatch, gate=None, delay=0.0, error=None):
    """Make the directory saves' writer wait for ``gate`` (a
    ``threading.Event``) and ``delay`` seconds, then raise ``error`` or
    write.  Returns the list of paths it was given."""
    write, seen = ck._write_npz, []

    def writer(path, arrays):
        seen.append(path)
        if gate is not None:
            assert gate.wait(WAIT_S)
        time.sleep(delay)
        if error is not None:
            raise error
        write(path, arrays)

    monkeypatch.setattr(ck, "_write_npz", writer)
    return seen


def test_snapshot_is_the_state_at_the_save(tmp_path, monkeypatch):
    """A save at step 1 with a slowed writer, two more steps and the saved
    tensors overwritten in place meanwhile: the directory equals a
    synchronous save of step 1 bit for bit."""
    solver, data = _solver()
    state = _steps(solver, data, solver.initial_state(), 1)
    ck.save_checkpoint(str(tmp_path / "sync.npz"), state, 60.0, 1)
    _gated_writer(monkeypatch, delay=0.5)
    ck.save_checkpoint_orbax(str(tmp_path / "ckpt-000001"), state, 60.0, 1)
    _steps(solver, data, state, 2)
    for k in FIELDS:
        getattr(state, k).fill_(-1.0)
    ck.wait_for_checkpoints()
    assert _files_equal(tmp_path / "sync.npz",
                        tmp_path / "ckpt-000001" / "state.npz")


def test_writer_error_surfaces_at_wait_and_next_save(tmp_path, monkeypatch):
    solver, _ = _solver()
    state = solver.initial_state()
    _gated_writer(monkeypatch, error=OSError("disk full"))
    ck.save_checkpoint_orbax(str(tmp_path / "a"), state, 0.0, 0)
    with pytest.raises(OSError, match="disk full"):
        ck.wait_for_checkpoints()
    ck.save_checkpoint_orbax(str(tmp_path / "b"), state, 0.0, 0)
    with pytest.raises(OSError, match="disk full"):
        ck.save_checkpoint_orbax(str(tmp_path / "c"), state, 0.0, 0)
    ck.wait_for_checkpoints()             # the error was raised once
    # nothing committed, and no synchronous file in its place
    assert sorted(os.listdir(tmp_path)) == ["a.tmp", "b.tmp"]


def test_runner_fails_with_the_writer_error(tmp_path, monkeypatch):
    """A failing writer ends the run with its error (at the next save or at
    the run's end), and no checkpoint of any form is written."""
    seen = _gated_writer(monkeypatch, error=OSError("disk full"))
    data = _golden(tmp_path, "fail", "orbax", t_max=240.0,
                   checkpoint_every=1)
    with pytest.raises(OSError, match="disk full"):
        SimulationRunner(data, device="cpu").run()
    assert len(seen) == 1
    assert [p.name for p in (tmp_path / "ck_fail").iterdir()] == \
        ["ckpt-000001.tmp"]
    data = dataclasses.replace(data, t_max=60.0,
                               checkpoint_directory=str(tmp_path / "ck_end"))
    with pytest.raises(OSError, match="disk full"):
        SimulationRunner(data, device="cpu").run()
    assert len(seen) == 2


def test_commit_renames_a_whole_directory(tmp_path, monkeypatch):
    """No ``ckpt-NNNNNN`` before the write ends, no ``.tmp`` after it; a
    second save of the path replaces the directory (a file put in the old
    one is gone)."""
    solver, data = _solver()
    state = solver.initial_state()
    gate = threading.Event()
    _gated_writer(monkeypatch, gate=gate)
    path = tmp_path / "ckpt-000000"
    ck.save_checkpoint_orbax(str(path), state, 0.0, 0)
    time.sleep(0.2)
    assert not path.exists() and (tmp_path / "ckpt-000000.tmp").is_dir()
    gate.set()
    ck.wait_for_checkpoints()
    assert sorted(os.listdir(tmp_path)) == ["ckpt-000000"]
    (path / "stale").write_text("x")
    state = _steps(solver, data, state, 1)
    ck.save_checkpoint_orbax(str(path), state, 60.0, 1)
    ck.wait_for_checkpoints()
    assert sorted(os.listdir(tmp_path)) == ["ckpt-000000"]
    assert os.listdir(path) == [ck.STATE_FILE]
    got, t, step = ck.load_checkpoint_any(str(path), device="cpu")
    assert (t, step) == (60.0, 1) and torch.equal(got.u, state.u)


def test_load_waits_for_a_pending_save_of_its_path(tmp_path, monkeypatch):
    solver, _ = _solver()
    state = solver.initial_state()
    _gated_writer(monkeypatch, delay=0.3)
    ck.save_checkpoint_orbax(str(tmp_path / "ckpt-000000"), state, 0.0, 0)
    got, t, step = ck.load_checkpoint_any(str(tmp_path / "ckpt-000000"),
                                          device="cpu")
    assert (t, step) == (0.0, 0) and torch.equal(got.p, state.p)


def test_npz_writer_is_numpys(tmp_path):
    """``_write_npz`` against ``np.savez`` on what a checkpoint may hold:
    0-d, Fortran-ordered, empty, integer and string arrays, Python scalars,
    an array of several MiB; the same names, dtypes, shapes and values, and
    the zip's CRCs hold."""
    big = np.random.default_rng(0).standard_normal(3 << 17)
    arrays = {"version": 1, "time": 180.0, "step": np.int64(3),
              "f": np.asfortranarray(np.arange(12.0).reshape(3, 4)),
              "e": np.zeros((0, 3)), "i": np.arange(5, dtype=np.int32),
              "meta_s": "deck", "big": big}
    ck._write_npz(str(tmp_path / "a.npz"), arrays)
    np.savez(tmp_path / "b.npz", **arrays)
    assert _files_equal(tmp_path / "a.npz", tmp_path / "b.npz")
    with np.load(tmp_path / "a.npz") as z:
        assert z["f"].shape == (3, 4) and z["meta_s"] == "deck"
    with zipfile.ZipFile(tmp_path / "a.npz") as zf:
        assert zf.testzip() is None           # every entry's CRC holds


# ---------------------------------------------------------------------------
# a directory that orbax wrote for the JAX package
# ---------------------------------------------------------------------------

def test_orbax_directory_of_jax_is_refused(tmp_path):
    """The port refuses JAX's orbax directory by name, in every loader and
    on resume; the conversion the message names (JAX's
    ``load_checkpoint_any`` then ``save_checkpoint``) reads back equal."""
    import jax.numpy as jnp
    from poroelasticity_dealii_tpu.solvers.fss import State as JState
    from poroelasticity_dealii_tpu.utils import checkpoint as jckpt
    rng = np.random.default_rng(0)
    z = {k: rng.standard_normal(7) for k in ("p", "u", "eps_v", "eps_v0")}
    z["strains"] = rng.standard_normal((3, 7))
    path = str(tmp_path / "ckpt-000004")
    jckpt.save_checkpoint_orbax(path, JState(**{k: jnp.asarray(v)
                                                for k, v in z.items()}),
                                240.0, 4)
    jckpt.wait_for_checkpoints()
    data = dataclasses.replace(read_input_file(GOLDEN), output_vtk=False,
                               output_directory=str(tmp_path / "out"))
    for load in (lambda: ck.load_checkpoint_any(path, device="cpu"),
                 lambda: ck.load_checkpoint_forest_any(path),
                 lambda: SimulationRunner(data, device="cpu").run(
                     resume_from=path)):
        with pytest.raises(NotImplementedError,
                           match="orbax wrote for the JAX package"):
            load()
    st, t, step = jckpt.load_checkpoint_any(path)
    jckpt.save_checkpoint(str(tmp_path / "converted.npz"), st, t, step)
    got, t, step = ck.load_checkpoint_any(str(tmp_path / "converted.npz"),
                                          device="cpu")
    assert (t, step) == (240.0, 4)
    for k, v in z.items():
        assert np.array_equal(getattr(got, k).numpy(), v), k


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the side-stream snapshot")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_side_stream_snapshot_equals_sync_save(cuda_dev, dtype, tmp_path):
    """The 3D deck at 16^3 on the rows kit: a directory save of step 1
    whose copy waits behind a long kernel on the current stream, while the
    state is dropped and two more steps reuse the allocator's blocks; the
    directory equals the synchronous save of step 1 bit for bit, and the
    fields' host copy taken before it."""
    data = dataclasses.replace(read_input_file(DECK_3D), dtype=dtype)
    disc = build_grid_discretization(data, cells_per_axis=16,
                                     device=cuda_dev)
    solver = FixedStressSolver(disc, data)
    state = _steps(solver, data, solver.initial_state(), 1)
    host = fields_to_host(state)
    ck.save_checkpoint(str(tmp_path / "sync.npz"), state, 60.0, 1)
    torch.cuda._sleep(50_000_000)
    ck.save_checkpoint_orbax(str(tmp_path / "ckpt-000001"), state, 60.0, 1)
    st = state
    del state             # the fields' last references: the steps below
    for _ in range(2):    # may take their blocks once the copy has read them
        st, _ = solver.time_step(st, data.time_step)
    ck.wait_for_checkpoints()
    assert _files_equal(tmp_path / "sync.npz",
                        tmp_path / "ckpt-000001" / "state.npz")
    with np.load(tmp_path / "ckpt-000001" / "state.npz") as z:
        for k in FIELDS:
            assert np.array_equal(z[k], host[k]), k
    assert bool(torch.isfinite(st.p).all())


@pytest.mark.cuda
def test_freed_fields_are_not_reused_before_the_copy(cuda_dev, tmp_path):
    """Three saves in a row (the pinned buffer reused), each of fields
    that are freed at once while the copy still waits behind a long
    kernel, and whose blocks the next allocations of their sizes, filled
    with -1, would take (``record_stream`` keeps them): each directory
    holds its own fields bit for bit."""
    rng = np.random.default_rng(0)
    shapes = {"p": (9261,), "u": (107811,), "eps_v": (9261,),
              "eps_v0": (9261,), "strains": (6, 9261)}
    wants = {}
    for s in (1, 2, 3):
        host = {k: rng.standard_normal(v).astype(np.float32)
                for k, v in shapes.items()}
        st = State(**{k: torch.as_tensor(v, device=cuda_dev)
                      for k, v in host.items()})
        torch.cuda.synchronize()
        torch.cuda._sleep(50_000_000)
        ck.save_checkpoint_orbax(str(tmp_path / f"ckpt-{s:06d}"), st,
                                 60.0 * s, s)
        del st
        junk = [torch.full(v, -1.0, device=cuda_dev)  # noqa: F841
                for v in shapes.values()]
        wants[s] = host
    ck.wait_for_checkpoints()
    for s, host in wants.items():
        with np.load(tmp_path / f"ckpt-{s:06d}" / "state.npz") as z:
            assert (float(z["time"]), int(z["step"])) == (60.0 * s, s)
            for k, v in host.items():
                assert np.array_equal(z[k], v), (s, k)
