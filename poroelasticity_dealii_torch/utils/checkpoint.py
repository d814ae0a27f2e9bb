"""Checkpoint / resume (port of
``poroelasticity_dealii_tpu/utils/checkpoint.py``).

The reference has no restart capability (state lives in memory only;
SURVEY §5).  The minimal restart vector is exactly what its
``SolutionTransfer`` carries across mesh changes — {p, eps_v, eps_v0} —
plus u, strains, time and step (``PoroelasticityFSS.h:474-497``).  The
derived caches ``State.u_rows`` and ``State.mech_b`` are not part of it.

Two backends, as in the JAX package, with one payload: the JAX package's
``.npz`` file, key for key (``version``, ``p``, ``u``, ``eps_v``,
``eps_v0``, ``strains``, ``time``, ``step``, the adaptive run's
``forest_*`` arrays and ``meta_*``), so either package resumes from the
other's files.

* ``.npz`` (default): :func:`save_checkpoint` writes the file ``path``
  before it returns.
* ``orbax`` (``TPU / Checkpoint format = orbax``):
  :func:`save_checkpoint_orbax` writes the directory ``path`` holding
  ``state.npz`` (that same file) asynchronously: the host enqueues the
  save and keeps stepping.  In the port ``orbax`` names this asynchronous
  directory backend; no orbax is used (orbax imports JAX), and the deck
  value keeps the JAX package's name.  On the card the fields are copied
  on a side stream into a pinned host buffer after the work queued so far,
  and their blocks are kept from the caching allocator until the copy is
  done (``record_stream``); on the CPU the snapshot is a plain copy.  One
  writer thread waits for the copy, writes ``<path>.tmp/state.npz`` and
  renames ``<path>.tmp`` to ``<path>``, replacing an existing ``<path>``
  (orbax's commit: no half-written directory stands under the final
  name).  At most one save is in flight: a save first waits for the one
  before it, which re-raises a writer's error, as
  :func:`wait_for_checkpoints` does.

:func:`load_checkpoint_any` and :func:`load_checkpoint_forest_any` read
either form: a path ending in ``.npz`` as a file, any other as a directory
checkpoint.  A directory that orbax wrote for the JAX package raises
``NotImplementedError``: reading it needs orbax and JAX.
"""

from __future__ import annotations

import concurrent.futures
import functools
import os
import shutil
import threading
import zipfile
from typing import Tuple

import numpy as np
import torch

from .. import resolve_device
from ..interop import FIELDS, fields_to_host, forest_from_fields
from ..solvers.fss import State

FORMAT_VERSION = 1
STATE_FILE = "state.npz"          # a directory checkpoint's one file
ORBAX_MARKERS = ("_CHECKPOINT_METADATA", "manifest.ocdbt")


def _forest_payload(forest) -> dict:
    """Persistable arrays for any forest type (box quad/oct forests carry
    lower/upper; multi-root forests carry the coarse-mesh arrays)."""
    extra = {"forest_leaves": np.asarray(sorted(forest.leaves),
                                         dtype=np.int64)}
    if hasattr(forest, "root_cells"):       # MultiRootQuadForest
        extra["forest_mr_cells"] = np.asarray(forest.root_cells, np.int64)
        extra["forest_mr_coords"] = np.asarray(forest.root_coords, float)
        bids = sorted(forest.boundary_ids.items())
        extra["forest_mr_bids"] = np.asarray(
            [(r, s, i) for (r, s), i in bids], np.int64).reshape(-1, 3)
    else:
        extra["forest_lower"] = np.asarray(forest.lower)
        extra["forest_upper"] = np.asarray(forest.upper)
    return extra


def _forest_from_payload(z):
    """The forest of :func:`_forest_payload`'s arrays (its class from the
    arrays, :func:`..interop.forest_from_fields`)."""
    fields = {"leaves": np.asarray(z["forest_leaves"])}
    if "forest_mr_cells" in z:
        fields.update(
            root_cells=z["forest_mr_cells"], root_coords=z["forest_mr_coords"],
            boundary_ids={(int(r), int(s)): int(i)
                          for r, s, i in np.asarray(z["forest_mr_bids"])})
    else:
        fields.update(lower=z["forest_lower"], upper=z["forest_upper"])
    return forest_from_fields(fields)


def _payload(fields: dict, time_, step, meta=None, forest=None) -> dict:
    """The file's arrays in the JAX package's key order."""
    return {"version": FORMAT_VERSION, **fields, "time": time_, "step": step,
            **(_forest_payload(forest) if forest is not None else {}),
            **{f"meta_{k}": v for k, v in (meta or {}).items()}}


class _Gather:
    """An unseekable sink for ``zipfile`` that keeps what it is given, the
    arrays' memoryviews by reference, for one ``os.writev``."""

    def __init__(self):
        self.parts = []

    def write(self, data) -> int:
        view = memoryview(data).cast("B")
        self.parts.append(view)
        return view.nbytes

    def flush(self) -> None:
        pass


def _write_npz(path: str, arrays: dict) -> None:
    """``np.savez(path, **arrays)``'s arrays: an uncompressed zip of
    ``.npy`` entries (with data descriptors: the zip is built in memory
    with no seek), each array's bytes by reference, no copy.  The file
    goes out in one ``os.writev``: a writer thread takes the GIL back only
    after each entry's CRC and the one write, since each hand-off of the
    GIL costs the thread that steps a wake-up."""
    fmt = np.lib.format
    sink = _Gather()
    with zipfile.ZipFile(sink, "w", zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, value in arrays.items():
            a = np.asanyarray(value)
            with zf.open(key + ".npy", "w", force_zip64=True) as f:
                if a.dtype.hasobject:
                    fmt.write_array(f, a)
                    continue
                if not a.flags.c_contiguous:
                    a = a.copy(order="C")
                fmt.write_array_header_1_0(
                    f, fmt.header_data_from_array_1_0(a))
                f.write(a.reshape(-1).view(np.uint8))
    parts = sink.parts
    fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o666)
    try:
        while parts:                  # writev may write fewer bytes
            n = os.writev(fd, parts[:1024])
            while parts and n >= parts[0].nbytes:
                n -= parts.pop(0).nbytes
            if n:
                parts[0] = parts[0][n:]
    finally:
        os.close(fd)


def _require_u(state: State, what: str) -> None:
    if state.u is None:
        raise ValueError(f"{what} needs state.u: call "
                         "FixedStressSolver.materialize_u first")


def save_checkpoint(path: str, state: State, time_: float, step: int,
                    meta: dict | None = None, forest=None):
    """Write ``path`` (``.npz``, appended when missing, as ``np.savez``
    does).  ``state.u`` must be materialised
    (:meth:`..solvers.fss.FixedStressSolver.materialize_u`).  ``forest``
    (optional): an amr forest whose structure is persisted so adaptive
    runs resume on the refined mesh.  The fields come to the host in one
    copy."""
    _require_u(state, "save_checkpoint")
    path = os.fspath(path)
    if not path.endswith(".npz"):
        path += ".npz"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    _write_npz(path, _payload(fields_to_host(state), time_, step, meta,
                              forest))


def _commit(path: str, ready, arrays: dict) -> None:
    """The writer's half of a directory save: wait for the snapshot's copy
    (``ready``, a CUDA event, or None), write ``<path>.tmp/state.npz``,
    then put ``<path>.tmp`` in place of ``<path>``."""
    if ready is not None:
        ready.synchronize()
    tmp = path + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)     # an interrupted save's
    os.makedirs(tmp)
    _write_npz(os.path.join(tmp, STATE_FILE), arrays)
    if os.path.isdir(path):
        shutil.rmtree(path)
    os.replace(tmp, path)


class AsyncCheckpointer:
    """The directory backend's writer: one writer thread, at most one save
    in flight, and per device a side stream and per dtype a pinned host
    buffer for the snapshots (reused: a save starts after the one before
    it has ended)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._executor = None             # made by the first save
        self._pending = None              # (abspath, Future) in flight
        self._streams = {}
        self._buffers = {}

    def save(self, path: str, state: State, time_: float, step: int,
             forest=None) -> None:
        _require_u(state, "save_checkpoint_orbax")
        with self._lock:
            self._wait()
            fields, ready = self._snapshot(state)
            arrays = _payload(fields, time_, step, forest=forest)
            if self._executor is None:
                self._executor = concurrent.futures.ThreadPoolExecutor(
                    1, thread_name_prefix="checkpoint-writer")
            path = os.path.abspath(path)
            self._pending = (path, self._executor.submit(
                _commit, path, ready, arrays))

    def wait(self, path: str | None = None) -> None:
        """Block until the save in flight (only a save of ``path``, if
        given) is on disk; re-raise its writer's error."""
        with self._lock:
            if self._pending is not None and (
                    path is None
                    or self._pending[0] == os.path.abspath(path)):
                self._wait()

    def _wait(self) -> None:
        if self._pending is not None:
            future, self._pending = self._pending[1], None
            future.result()

    def _snapshot(self, state: State) -> tuple:
        """``(fields, ready)``: the restart fields as host arrays, and the
        CUDA event after which they hold the state (None: they already
        do)."""
        tensors = [getattr(state, k) for k in FIELDS]
        dev = tensors[0].device
        if dev.type != "cuda":
            return fields_to_host(state), None
        dtype = functools.reduce(torch.promote_types,
                                 (t.dtype for t in tensors))
        sizes = [t.numel() for t in tensors]
        buf = self._buffers.get((dev, dtype))
        if buf is None or buf.numel() < sum(sizes):
            buf = self._buffers[(dev, dtype)] = torch.empty(
                sum(sizes), dtype=dtype, pin_memory=True)
        side = self._streams.get(dev)
        if side is None:
            side = self._streams[dev] = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        parts = torch.split(buf[:sum(sizes)], sizes)
        with torch.cuda.stream(side):
            for t, part in zip(tensors, parts):
                part.copy_(t.reshape(-1), non_blocking=True)
                # the block may not go to the next step before the copy
                t.record_stream(side)
        ready = torch.cuda.Event()
        ready.record(side)
        return {k: part.numpy().reshape(t.shape)
                for k, part, t in zip(FIELDS, parts, tensors)}, ready


_CHECKPOINTER = AsyncCheckpointer()


def save_checkpoint_orbax(path: str, state: State, time_: float, step: int,
                          forest=None) -> None:
    """The directory checkpoint ``path`` (``path/state.npz``), written
    asynchronously: returns once the fields' copy is enqueued (and the
    forest's arrays are built); the writer thread commits it (call
    :func:`wait_for_checkpoints` before the state is read back or the
    process exits).  ``state.u`` must be materialised."""
    _CHECKPOINTER.save(path, state, time_, step, forest=forest)


def wait_for_checkpoints() -> None:
    """Block until the pending directory save is on disk; re-raises the
    writer's error."""
    _CHECKPOINTER.wait()


def save_step_checkpoint(fmt: str, directory: str, state: State,
                         time_: float, step: int, forest=None) -> None:
    """Step ``step``'s checkpoint through the deck's backend (``TPU /
    Checkpoint format``): ``directory/ckpt-NNNNNN`` (``orbax``) or
    ``directory/ckpt-NNNNNN.npz``."""
    name = os.path.join(directory, f"ckpt-{step:06d}")
    if fmt == "orbax":
        save_checkpoint_orbax(name, state, time_, step, forest=forest)
    else:
        save_checkpoint(name + ".npz", state, time_, step, forest=forest)


def load_checkpoint(path: str, dtype: torch.dtype = None,
                    device="cuda") -> Tuple[State, float, int]:
    """``(state, time, step)`` from an ``.npz`` checkpoint file, the fields
    on ``device`` (default the card) in ``dtype`` (default the file's)."""
    device = resolve_device(device)
    with np.load(path) as z:
        if int(z["version"]) != FORMAT_VERSION:
            raise ValueError(f"unsupported checkpoint version {z['version']}")
        state = State(**{k: torch.as_tensor(z[k]).to(device=device,
                                                      dtype=dtype)
                         for k in FIELDS})
        return state, float(z["time"]), int(z["step"])


def load_checkpoint_forest(path: str):
    """Restore the persisted forest of an adaptive run (QuadForest for 2D,
    OctForest for 3D — distinguished by the leaf-tuple width — or a
    multi-root forest when coarse-mesh arrays are present) from an
    ``.npz`` checkpoint file, or None."""
    with np.load(path) as z:
        if "forest_leaves" not in z:
            return None
        return _forest_from_payload(z)


def _state_file(path: str) -> str:
    """The ``.npz`` file of checkpoint ``path``: itself, or a directory
    checkpoint's ``state.npz`` once a pending save of it is on disk."""
    path = os.fspath(path)
    if path.endswith(".npz"):
        return path
    _CHECKPOINTER.wait(path)
    if any(os.path.exists(os.path.join(path, m)) for m in ORBAX_MARKERS):
        raise NotImplementedError(
            f"checkpoint {path!r} is a directory that orbax wrote for the "
            "JAX package: reading it needs orbax and JAX.  The JAX package "
            "turns it into an .npz (poroelasticity_dealii_tpu.utils."
            "checkpoint: load_checkpoint_any, then save_checkpoint), which "
            "this package reads")
    return os.path.join(path, STATE_FILE)


def load_checkpoint_any(path: str, dtype: torch.dtype = None,
                        device="cuda") -> Tuple[State, float, int]:
    """:func:`load_checkpoint` of either backend's checkpoint: a path
    ending in ``.npz`` is the file, any other a directory checkpoint."""
    return load_checkpoint(_state_file(path), dtype, device)


def load_checkpoint_forest_any(path: str):
    """:func:`load_checkpoint_forest` of either backend's checkpoint."""
    return load_checkpoint_forest(_state_file(path))
