"""The device group of the sharded paths (port of the device-mesh part of
``poroelasticity_dealii_tpu/parallel/sharding.py:41-56``).

JAX runs one controller over a 1D device mesh; the port runs one process
per device in a ``torch.distributed`` process group (NCCL on the card,
gloo on the CPU).  :class:`SlabGroup` is the counterpart of
``make_device_mesh``: a rank's place in the group and its device.  Nothing
of GSPMD is ported: the pressure side stays replicated on every rank.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch
import torch.distributed as dist

from .. import resolve_device


@dataclasses.dataclass(frozen=True)
class SlabGroup:
    """Rank ``rank`` of ``size`` in the default process group ``group``
    (None: one process and no group), computing on ``device``."""
    rank: int
    size: int
    group: Optional[object]
    device: torch.device


def make_slab_group(device="cuda") -> SlabGroup:
    """The slab group over the default process group when one is
    initialised, else one process (``size=1``, no group)."""
    device = resolve_device(device)
    if not (dist.is_available() and dist.is_initialized()):
        return SlabGroup(0, 1, None, device)
    return SlabGroup(dist.get_rank(), dist.get_world_size(), dist.group.WORLD,
                     device)


def init_from_env(device="cuda") -> tuple:
    """``(slab group, created)`` for a process started by ``torchrun``.

    An initialised default group is taken as it is.  Otherwise, when the
    environment names a world (``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``, as ``torchrun`` sets them), the default group is
    initialised from it: NCCL on CUDA, each rank on ``cuda:{LOCAL_RANK}``,
    gloo on the CPU; ``created`` says so, and the caller destroys the group
    at the end.  Without either, one process: ``size=1``, no group."""
    dev = resolve_device(device)
    created = False
    if not dist.is_initialized() and "WORLD_SIZE" in os.environ:
        if dev.type == "cuda":
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
            torch.cuda.set_device(dev)
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                init_method="env://")
        created = True
    return make_slab_group(dev), created
