"""poroelasticity_dealii_torch — the Biot fixed-stress solver on PyTorch/CUDA.

A port of ``poroelasticity_dealii_tpu`` (JAX/Pallas) to PyTorch with
hand-written CUDA kernels for NVIDIA Hopper.  The JAX package stays the
reference; this package imports ``torch`` and never ``jax``, and nothing of
the JAX package: it keeps its own copies of the host modules it needs (deck
parser ``config``, ``mesh/`` with the gmsh reader, ``ops/shape.py``,
``ops/quadrature.py``, ``utils/logging_utils.py``, ``utils/native.py``,
``models/terzaghi.py``, ``models/mandel.py``, ``models/cryer.py``) at the
same relative paths.

Precision policy: every float32 product runs in full IEEE float32, as the
reference computes its products at ``Precision.HIGHEST``.  TF32 is switched
off for matmuls and cuDNN at import.
"""

from __future__ import annotations

import torch

from .config import read_input_file  # noqa: F401

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"


def resolve_device(name="cuda") -> torch.device:
    """``"cuda"``/``"cuda:N"``/``"cpu"`` (or a :class:`torch.device`) ->
    :class:`torch.device`.  Every entry point of the port defaults to
    ``"cuda"`` and resolves its device here.

    Raises when a CUDA device is asked for and none is visible; never
    falls back to the CPU."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {name!r} requested but torch.cuda "
                           "reports no CUDA device")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {name!r} (use cuda or cpu)")
    return dev
