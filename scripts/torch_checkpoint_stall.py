"""Where a directory checkpoint's background write costs the stepping loop
time: the 40^3 float32 rows run of ``chip_smoke.py::checkpoint_backends_check``
with a checkpoint every step, through variants of the writer.

    python3 scripts/torch_checkpoint_stall.py [N_STEPS] [ROUNDS] [VARIANT,...]

Variants (all by default), run in turns (forward, then backward,
``ROUNDS`` times):

* ``npz``: the synchronous ``.npz`` backend;
* ``orbax``: the asynchronous directory backend as it is;
* ``noop``: the directory backend with a writer that writes nothing (the
  snapshot, the side-stream copy and the thread alone);
* ``sleep``: a writer that sleeps, without the GIL, as long as the last
  ``npz`` write took (a thread that waits, and wakes once);
* ``zipfile``: a writer that lets ``zipfile`` write each array to the
  file (one write and one CRC per array, the local headers rewritten by
  seeking back: more hand-offs of the GIL, each call without it);
* ``chunked``: as ``zipfile``, each array in 1 MiB pieces;
* ``switch``: ``orbax`` with the interpreter's switch interval at 0.5 ms
  (the default is 5 ms);
* ``crc``: a writer that only computes the zip's CRC of each array (CPU
  work without the GIL, no file);
* ``rawio``: a writer that only writes each array's bytes to a file with
  ``os.write`` (the kernel's part of the write, no CRC, no zip);
* ``nice``: ``orbax`` with the writer thread at nice 19.

Each run prints one line ``CKPT_STALL {...}``: the variant, each step's
wall (the run log's, which ends at the step's synchronize), period (record
to record: the step and the save before it) and the stepping thread's CPU
ms over that period, each save's host block, each commit's and each
write's ms.  The first line gives the card (``nvidia-smi``), the CPUs the
process may run on and the cgroup's CPU limit.  Needs a CUDA device.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import sys
import threading
import tempfile
import time
import zipfile
import zlib
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402
from poroelasticity_dealii_torch.models import runner as runner_mod  # noqa
from poroelasticity_dealii_torch.models.runner import \
    SimulationRunner  # noqa: E402
from poroelasticity_dealii_torch.utils import checkpoint as ck  # noqa: E402

VARIANTS = ("npz", "orbax", "noop", "sleep", "zipfile", "chunked", "switch",
            "crc", "rawio", "nice")
PIECE = 1 << 20


def _zipfile_write(path, arrays, piece=None):
    """The arrays through ``zipfile`` straight to the file, each in one
    write (or in pieces of ``piece`` bytes)."""
    fmt = np.lib.format
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, value in arrays.items():
            a = np.ascontiguousarray(value) if np.ndim(value) \
                else np.asarray(value)
            with zf.open(key + ".npy", "w", force_zip64=True) as f:
                fmt.write_array_header_1_0(
                    f, fmt.header_data_from_array_1_0(a))
                data = memoryview(a.reshape(-1).view(np.uint8))
                step = piece or max(1, len(data))
                for i in range(0, len(data), step):
                    f.write(data[i:i + step])


def _crc_only(path, arrays):
    for value in arrays.values():
        zlib.crc32(memoryview(np.ascontiguousarray(value).reshape(-1)
                              .view(np.uint8)))


def _raw_io(path, arrays):
    fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC)
    try:
        for value in arrays.values():
            os.write(fd, memoryview(np.ascontiguousarray(value).reshape(-1)
                                    .view(np.uint8)))
    finally:
        os.close(fd)


def _niced(commit):
    def run(*args):
        os.setpriority(os.PRIO_PROCESS, threading.get_native_id(), 19)
        return commit(*args)
    return run


@contextlib.contextmanager
def _variant(name, sleep_s):
    write, commit = ck._write_npz, ck._commit
    switch = sys.getswitchinterval()
    if name == "crc":
        ck._write_npz = _crc_only
    elif name == "rawio":
        ck._write_npz = _raw_io
    elif name == "nice":
        ck._commit = _niced(commit)
    elif name == "noop":
        ck._write_npz = lambda path, arrays: None
    elif name == "sleep":
        ck._write_npz = lambda path, arrays: time.sleep(sleep_s)
    elif name == "zipfile":
        ck._write_npz = _zipfile_write
    elif name == "chunked":
        ck._write_npz = lambda path, arrays: _zipfile_write(path, arrays,
                                                            PIECE)
    elif name == "switch":
        sys.setswitchinterval(0.0005)
    try:
        yield
    finally:
        ck._write_npz, ck._commit = write, commit
        sys.setswitchinterval(switch)


class ThreadTimedLog(cs.TimedLog):
    """``TimedLog`` that also keeps the stepping thread's CPU clock."""

    def __init__(self):
        super().__init__()
        self.cpu = []

    def log_step(self, step, t, stats, wall_s, extra=None):
        self.cpu.append(time.thread_time())
        super().log_step(step, t, stats, wall_s, extra)


def _cpu_limit() -> str:
    try:
        return Path("/sys/fs/cgroup/cpu.max").read_text().strip()
    except OSError:
        return "unknown"


def run(name, tmp: Path, n_steps: int, sleep_s: float) -> dict:
    fmt = "npz" if name == "npz" else "orbax"
    data = cs._options_data(tmp, name, checkpoint_every=1,
                            checkpoint_format=fmt)
    data = dataclasses.replace(data, t_max=n_steps * data.time_step)
    log, blocked, commits, writes = ThreadTimedLog(), [], [], []
    r = SimulationRunner(data, device="cuda", logger=log)
    with _variant(name, sleep_s), \
            cs._timed(runner_mod, "save_step_checkpoint", blocked), \
            cs._timed(ck, "_commit", commits), \
            cs._timed(ck, "_write_npz", writes):
        r.run()
    return {"variant": name,
            "wall_ms": [s["wall_ms"] for s in log.steps],
            "period_ms": [(b - a) * 1e3
                          for a, b in zip(log.clock, log.clock[1:])],
            "thread_cpu_ms": [(b - a) * 1e3
                              for a, b in zip(log.cpu, log.cpu[1:])],
            "save_blocked_ms": blocked, "commit_ms": commits,
            "write_ms": writes}


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("torch_checkpoint_stall: needs a CUDA device")
    n_steps = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    rounds = int(sys.argv[2]) if len(sys.argv) > 2 else 1
    variants = tuple(sys.argv[3].split(",")) if len(sys.argv) > 3 \
        else VARIANTS
    print(cs.gpu_line(), "| cpus", sorted(os.sched_getaffinity(0)),
          "| cpu.max", _cpu_limit(), "| tmp", tempfile.gettempdir(),
          flush=True)
    sleep_s = 0.012
    with tempfile.TemporaryDirectory() as tmp:
        for k in range(rounds):
            for name in variants + variants[::-1]:
                rec = run(name, Path(tmp) / f"{name}{k}", n_steps, sleep_s)
                if name == "npz":
                    sleep_s = float(np.median(rec["write_ms"])) / 1e3
                print("CKPT_STALL " + json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
