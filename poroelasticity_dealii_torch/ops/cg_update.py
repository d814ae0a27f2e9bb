"""The Jacobi-preconditioned CG iteration's vector update as two CUDA
kernels (``csrc/cg_update.cu``).

:func:`jacobi_step` -- after the apply ``ap = A p`` and ``alpha = rz /
(p . ap)``: ``x_out = x + alpha p`` and ``r_out = r - alpha ap`` where
``active`` (else ``x``, ``r``), and ``z = (r - alpha ap) * dinv``;
:func:`direction` -- after ``rz_new = r_out . z``: ``p_out = z + beta p``
where ``active`` (else ``p``).  A vector is one right-hand side or a batch
of lanes ``(n_rhs, n)``; ``alpha``, ``beta`` and ``active`` are 0-d device
tensors or one per lane, and ``dinv`` is the whole vector's shape or, for a
batch, one lane's, shared.  Each element is rounded as the plain twin
(``solvers/cg.py::_jacobi_update_plain``) rounds it, so the results are
bitwise the twin's.  The wrappers take contiguous CUDA tensors of what
:func:`check` admits, allocate the outputs, launch on the current stream
and count each launch under ``("launches", "cg_update")``
(:func:`.comp_major.launch_counts`).
"""

from __future__ import annotations

import torch

from . import _cuda
from .cell_products import sm_count
from ..utils.profiling import count

THREADS = 256           # kThreads in csrc/cg_update.cu
# resident blocks per SM across the lanes (2048 threads at 32 registers;
# 2, 4, 16 or one pack a thread within 1.5% on the H100 at 40^3 sizes)
BLOCKS_PER_SM = 8
PACK_BYTES = 16         # one double2 / float4 load or store


def check(b: torch.Tensor, dinv: torch.Tensor, batched: bool) -> None:
    """Raise ValueError unless the kernels take a Jacobi-CG solve of
    right-hand side ``b`` (``(n_rhs, n)`` if ``batched``) with the inverse
    diagonal ``dinv``: float32 or float64, ``dinv`` of ``b``'s dtype,
    device and shape (a batch: one lane's), fewer than 2^31 values a
    vector.  Strides do not matter: the update makes its vectors
    contiguous."""
    shape = b.shape[1:] if batched else b.shape
    if b.dtype not in (torch.float32, torch.float64):
        problem = f"{b.dtype} vectors"
    elif (dinv.dtype, dinv.device, dinv.shape) != (b.dtype, b.device,
                                                   shape):
        problem = (f"a {dinv.dtype} diagonal of shape {tuple(dinv.shape)} "
                   f"on {dinv.device}")
    elif b.numel() >= 2 ** 31:
        problem = f"{b.numel()} values"
    else:
        return
    raise ValueError(f"the CG update kernels do not take {problem} (right-"
                     f"hand side {b.dtype} {tuple(b.shape)} on {b.device})")


def _plan(vectors, lanes: int, lane_len: int) -> tuple:
    """(blocks per lane, 16-byte packs?) for ``vectors``."""
    pack = PACK_BYTES // vectors[0].element_size()
    vec = all(t.data_ptr() % PACK_BYTES == 0 for t in vectors) and (
        lanes == 1 or lane_len % pack == 0)
    per_thread = pack if vec else 1
    need = -(-lane_len // (per_thread * THREADS))
    cap = max(1, sm_count(vectors[0].device) * BLOCKS_PER_SM // lanes)
    return max(1, min(need, cap)), int(vec)


def _check_lanes(x, alpha, active):
    """(lanes, lane length) of ``x`` for ``alpha`` and ``active``, 0-d or
    one per lane of ``x``'s first axis; raises on what the kernels do not
    take."""
    _cuda.require_cuda(x)
    _cuda.check("active", active, x.shape[:active.dim()], torch.bool,
                x.device)
    _cuda.check("alpha", alpha, active.shape, x.dtype, x.device)
    return active.numel(), x.numel() // active.numel()


def jacobi_step(x, r, p, ap, dinv, alpha, active):
    """``(x_out, r_out, z)`` of one Jacobi-CG step (module docstring)."""
    lanes, lane_len = _check_lanes(x, alpha, active)
    for name, t in (("x", x), ("r", r), ("p", p), ("ap", ap)):
        _cuda.check(name, t, x.shape, x.dtype, x.device)
    _cuda.check("dinv", dinv, x.shape[active.dim():], x.dtype, x.device)
    x_out, r_out, z = (torch.empty_like(x) for _ in range(3))
    grid, vec = _plan((x, r, p, ap, dinv, x_out, r_out, z), lanes, lane_len)
    _cuda.launch("cg_jacobi_step", x, x, r, p, ap, dinv, alpha, active,
                 x_out, r_out, z, x.numel(), lane_len, grid, vec)
    count("launches", "cg_update")
    return x_out, r_out, z


def direction(z, p, beta, active):
    """``p_out`` of one Jacobi-CG step (module docstring)."""
    lanes, lane_len = _check_lanes(z, beta, active)
    _cuda.check("p", p, z.shape, z.dtype, z.device)
    p_out = torch.empty_like(z)
    grid, vec = _plan((z, p, p_out), lanes, lane_len)
    _cuda.launch("cg_direction", z, z, p, beta, active, p_out, z.numel(),
                 lane_len, grid, vec)
    count("launches", "cg_update")
    return p_out
