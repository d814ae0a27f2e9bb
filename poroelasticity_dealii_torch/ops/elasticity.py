"""The Q2 elasticity apply on flat node-grid vectors (counterpart of
``poroelasticity_dealii_tpu/ops/pallas_elasticity.py``).

``y = A u`` for the 3D structured Q2 grid with ``n`` cells per axis, ``u``
and ``y`` flat ``((2n+1)^3 * 3,)`` in ``[z][y][x][comp]`` order.  The JAX
package has two Pallas kernels for this function: ``_kernel`` here
(``make_pallas_elasticity``, input split into the 8 parity subgrids, one
halo cell layer recomputed per z-slab) and ``_kernel`` v1 of
``pallas_comp_major.py`` (``make_pallas_apply``, comp-major rows and a
host stitch).  Both layouts serve Mosaic; one hand-written CUDA kernel on
the flat layout, :func:`elasticity_grid_apply` (``csrc/comp_major.cu``: the
row-layout apply's cell product pass gathering from the flat vector, then a
flat node sum), stands for both, reached through
:func:`make_grid_elasticity` and :func:`.comp_major.make_flat_apply`.  On a
CUDA device the conv backend's elasticity apply is this kernel
(``solvers/structured.py``).

:func:`split_parities` and :func:`merge_parities` are the torch
counterparts of the JAX layout helpers; the flat kernel needs neither.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import _cuda
from . import dense
from .cell_products import rows_apply_plan, sm_count
from .stencil import StencilSpec, stencil_apply
from ..utils.profiling import count


def elasticity_element_matrix(data, n: int, dim: int = 3) -> np.ndarray:
    """(81, 81) Q2 element matrix of one cell of the uniform ``n^dim`` grid
    on ``data.domain_size``, rows and columns ``node * 3 + comp``."""
    from ..mesh.generator import hyper_rectangle
    from ..mesh.qk import build_fe_space
    h = [data.domain_size[d] / n for d in range(dim)]
    su1 = build_fe_space(hyper_rectangle(h, cells_per_axis=1), 2)
    return dense.elasticity_element_matrices(
        su1, data.lame_constant, data.shear_modulus)[0]


def split_parities(U: torch.Tensor, n: int) -> torch.Tensor:
    """(2n+1, 2n+1, 2n+1, 3) node grid -> (8, n+1, n+1, n+1, 3); parity
    q = px + 2 py + 4 pz; odd axes zero-padded to n+1."""
    parts = []
    for q in range(8):
        px, py, pz = q & 1, (q >> 1) & 1, (q >> 2) & 1
        P = U[pz::2, py::2, px::2, :]
        parts.append(F.pad(P, (0, 0, 0, n + 1 - P.shape[2],
                               0, n + 1 - P.shape[1], 0, n + 1 - P.shape[0])))
    return torch.stack(parts)


def merge_parities(parts: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of :func:`split_parities` -> (2n+1, 2n+1, 2n+1, 3)."""
    g = 2 * n + 1
    U = parts.new_zeros((g, g, g, parts.shape[-1]))
    for q in range(8):
        px, py, pz = q & 1, (q >> 1) & 1, (q >> 2) & 1
        nz, ny, nx = n + 1 - pz, n + 1 - py, n + 1 - px
        U[pz::2, py::2, px::2, :] = parts[q, :nz, :ny, :nx, :]
    return U


def elasticity_grid_apply_plain(u: torch.Tensor, ke: torch.Tensor,
                                n: int, nz: int = None) -> torch.Tensor:
    """Plain twin of :func:`elasticity_grid_apply`: the conv backend's
    stencil apply for Q2 -> Q2 with 3 components (a gather over the 27
    local node offsets, one (81, 81) product over all cells and a strided
    slice-add scatter; deterministic: no atomics), on ``nz`` cell layers
    along z (default n)."""
    return stencil_apply(u, ke.T, 2, 2, (n, n, n if nz is None else nz), 3,
                         3)


def elasticity_grid_apply(u: torch.Tensor, ke: torch.Tensor, n: int,
                          nz: int = None) -> torch.Tensor:
    """``y = A u`` on the flat Q2 grid with ``n`` cells per axis; ``ke``:
    the (81, 81) element matrix, x-fastest ``(node, comp)`` order.  CPU
    tensors take the plain twin; CUDA tensors launch the kernel: two CUDA
    launches, the cell product pass into an (81, n^2 nz) scratch (the
    row-layout apply's plan, :func:`.cell_products.rows_apply_plan`), then
    the node sums.

    The slab mode (``nz`` given; the gspmd z-slabs of
    :func:`..parallel.sharding.shard_grid_discretization`): ``u`` and the
    result are the ``(2n+1)^2 (2nz+1) * 3`` values of ``nz`` layers of
    n x n cells, every cell real; counted as ``"grid_slab"`` too."""
    slab = nz is not None
    nz = n if nz is None else nz
    if u.device.type == "cpu":
        return elasticity_grid_apply_plain(u, ke, n, nz)
    _cuda.require_cuda(u)
    if nz < 1:
        raise ValueError(f"slab depth nz={nz} < 1")
    _cuda.check("u", u, ((2 * n + 1) ** 2 * (2 * nz + 1) * 3,), u.dtype,
                u.device)
    _cuda.check("ke", ke, (81, 81), u.dtype, u.device)
    plan = rows_apply_plan(n, u.dtype, sm_count(u.device), nz=nz)
    y = torch.empty_like(u)
    ye = torch.empty(plan.scratch_numel, dtype=u.dtype, device=u.device)
    _cuda.launch("elasticity_grid_apply", u, u, ke, y, ye, n, nz,
                 plan.stride, plan.grid, plan.smem_bytes)
    count("launches", "elasticity_grid_apply")
    if slab:
        count("launches", "grid_slab")
    return y


def make_grid_elasticity(element_matrix: np.ndarray, n: int,
                         dtype: torch.dtype, device) -> callable:
    """``apply(u_flat) -> y_flat`` for a 3D structured Q2 grid with ``n``
    cells per axis and the given uniform-cell element matrix (counterpart
    of ``make_pallas_elasticity``, ``pallas_elasticity.py:154``)."""
    ke = torch.as_tensor(np.asarray(element_matrix, np.float64), dtype=dtype,
                         device=device).contiguous()

    def apply(u_flat):
        return elasticity_grid_apply(u_flat, ke, n)

    apply.spec = StencilSpec(element_matrix, 2, 2, 3, 3, (n, n, n), dtype,
                             device, flat_kernel=True)
    return apply
