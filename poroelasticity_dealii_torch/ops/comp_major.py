"""Comp-major row layout and the Q2 elasticity, coupling and projection
operators in it (port of ``poroelasticity_dealii_tpu/ops/pallas_comp_major.py``).

The (2n+1)^3 x 3 Q2 node grid is split into 24 parity-comp planes per
z-half-layer (2 parities per axis x 3 components); each plane is flattened
over (y-half, x-half) into one row of (n+1)^2 lanes, zero-padded to a
128-multiple W.  Row index = zh*24 + ((pz*2 + py)*2 + px)*3 + c, lane =
yh*(n+1) + xh.  The whole mechanics CG runs in this layout: dots, axpys,
norms and masks are layout-exact, so conversions happen once per solve.

Three operators reach a hand-written CUDA kernel (``csrc/comp_major.cu``):

* :func:`elasticity_rows_apply` — the Q2 elasticity apply in three masking
  modes (UNMASKED ``A x``, FREE ``m A x``, CONSTRAINED
  ``m A(m x) + (1-m) x``), and UNMASKED on one z-slab of the sharded
  production path (``nz``, ``nv``; :mod:`..parallel.rows`);
* :func:`coupling_rows` — the mechanics RHS ``C p`` from the Q1 pressure;
* :func:`projection_rows` — the all-Voigt strain-projection RHS from u.

Each wrapper takes its plain PyTorch twin (``*_plain``) for CPU tensors and
launches its kernel for CUDA tensors, counting its launches in the
recorder's registry (:func:`launch_counts`; one per call; the elasticity
apply is two CUDA launches, a product pass on tiles of cells and a node-sum
pass, planned by :func:`.cell_products.rows_apply_plan`; so is the
projection, which shares the product pass).  The plain twins are
vectorised over all cells: one advanced-index gather of the cells' local
values, one matmul with the element matrix, one ``index_add_`` over a
precomputed flat index.

:func:`make_flat_apply`, the counterpart of ``make_pallas_apply`` (flat u
in, flat y out), needs no row layout: it reaches the flat kernel of
:mod:`.elasticity`, whose product pass is the row-layout apply's.
:data:`KERNEL_WRAPPERS` lists every kernel wrapper of the port, those of
the generic path (:mod:`.generic_apply`) too.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from . import _cuda
from .cell_products import N_VOIGT, PROJECTION_ROWS, rows_apply_plan, \
    sm_count
from .elasticity import elasticity_grid_apply, make_grid_elasticity
from .generic_apply import generic_elasticity_apply, generic_q1_apply
from .node_blocks import elasticity_node_blocks
from .shape import node_lattice
from ..utils import profiling
from ..utils.profiling import count

UNMASKED, FREE, CONSTRAINED = 0, 1, 2


def _width(n: int) -> int:
    """Padded lane width: >= (n+1)^2 + max shift (n+2), 128-multiple."""
    need = (n + 1) * (n + 1) + (n + 2)
    return -(-need // 128) * 128


def to_rows(u_flat: torch.Tensor, n: int) -> torch.Tensor:
    """Flat dof vector ((2n+1)^3 * 3,) -> row layout ((n+1)*24, W)."""
    g = 2 * n + 1
    U = F.pad(u_flat.reshape(g, g, g, 3), (0, 0, 0, 1, 0, 1, 0, 1))
    V = U.reshape(n + 1, 2, n + 1, 2, n + 1, 2, 3)       # zh pz yh py xh px c
    V = V.permute(0, 1, 3, 5, 6, 2, 4)                   # zh pz py px c yh xh
    R = V.reshape((n + 1) * 24, (n + 1) * (n + 1))
    return F.pad(R, (0, _width(n) - R.shape[1]))


def from_rows(R: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of :func:`to_rows` -> flat dof vector."""
    g = 2 * n + 1
    V = R[:, :(n + 1) * (n + 1)].reshape(n + 1, 2, 2, 2, 3, n + 1, n + 1)
    V = V.permute(0, 1, 5, 2, 6, 3, 4)                   # zh pz yh py xh px c
    U = V.reshape(2 * n + 2, 2 * n + 2, 2 * n + 2, 3)
    return U[:g, :g, :g, :].reshape(-1)


def to_rows_np(v, n: int, fill: float = 0.0) -> np.ndarray:
    """Numpy :func:`to_rows` for setup-time constants (masks, diagonals);
    phantom nodes and padding lanes get ``fill``."""
    g = 2 * n + 1
    U = np.full((2 * n + 2,) * 3 + (3,), fill, dtype=np.float64)
    U[:g, :g, :g, :] = np.asarray(v, np.float64).reshape(g, g, g, 3)
    V = U.reshape(n + 1, 2, n + 1, 2, n + 1, 2, 3)
    V = V.transpose(0, 1, 3, 5, 6, 2, 4)
    R = V.reshape((n + 1) * 24, (n + 1) * (n + 1))
    out = np.full(((n + 1) * 24, _width(n)), fill, dtype=np.float64)
    out[:, :R.shape[1]] = R
    return out


def scalar_rows_np(v, n: int, fill: float = 0.0) -> np.ndarray:
    """Nodal scalar grid ((2n+1)^3,) -> scalar row layout ((n+1)*8, W):
    row = zh*8 + ((pz*2 + py)*2 + px), lane = yh*(n+1) + xh, the row
    layout with its component factor dropped, so rows viewed as
    ``(n+1, 8, 3, W)`` broadcast against it viewed as ``(n+1, 8, 1, W)``;
    phantom nodes and padding lanes get ``fill``."""
    g = 2 * n + 1
    U = np.full((2 * n + 2,) * 3, fill, dtype=np.float64)
    U[:g, :g, :g] = np.asarray(v, np.float64).reshape(g, g, g)
    V = U.reshape(n + 1, 2, n + 1, 2, n + 1, 2)          # zh pz yh py xh px
    V = V.transpose(0, 1, 3, 5, 2, 4)                    # zh pz py px yh xh
    R = V.reshape((n + 1) * 8, (n + 1) * (n + 1))
    out = np.full(((n + 1) * 8, _width(n)), fill, dtype=np.float64)
    out[:, :R.shape[1]] = R
    return out


def _slice_params(n: int):
    """Per local Q2 node a: (dz, row offset within the zh block, lane
    shift) of its value relative to the cell's base position."""
    lat = node_lattice(2, 3)                            # (27, 3) x-first
    out = []
    for a in range(27):
        ox, oy, oz = int(lat[a, 0]), int(lat[a, 1]), int(lat[a, 2])
        base = (((oz & 1) * 2 + (oy & 1)) * 2 + (ox & 1)) * 3
        out.append((oz >> 1, base, (oy >> 1) * (n + 1) + (ox >> 1)))
    return out


# ---------------------------------------------------------------------------
# flat gather indices of the plain twins (cells enumerated z, y, x; real
# cells only, so no phantom lane ever enters a product)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=16)
def _u_index(n: int, device: torch.device, nz: int) -> torch.Tensor:
    """(81, nz*n^2): flat row-layout index of local (node, comp) a*3+c of
    every cell of ``nz`` layers of n x n cells (nz = n: the grid)."""
    W = _width(n)
    iz, iy, ix = np.meshgrid(np.arange(nz), np.arange(n), np.arange(n),
                             indexing="ij")
    cell = (iz * 24 * W + iy * (n + 1) + ix).reshape(-1)
    off = [(dz * 24 + base + c) * W + shift
           for (dz, base, shift) in _slice_params(n) for c in range(3)]
    idx = np.asarray(off)[:, None] + cell[None, :]
    return torch.as_tensor(idx, dtype=torch.int64, device=device)


@functools.lru_cache(maxsize=16)
def _p_index(n: int, device: torch.device) -> torch.Tensor:
    """(8, n^3): flat Q1-grid index of local Q1 node i of every cell."""
    g1 = n + 1
    iz, iy, ix = np.meshgrid(*(np.arange(n),) * 3, indexing="ij")
    cell = ((iz * g1 + iy) * g1 + ix).reshape(-1)
    lat = node_lattice(1, 3)
    off = [(int(oz) * g1 + int(oy)) * g1 + int(ox) for (ox, oy, oz) in lat]
    idx = np.asarray(off)[:, None] + cell[None, :]
    return torch.as_tensor(idx, dtype=torch.int64, device=device)


def _rows_shape(n: int, nz: int = None):
    return (((n if nz is None else nz) + 1) * 24, _width(n))


def _slab_depth(n: int, mode: int, nz, nv) -> tuple:
    """(nz, nv) of an apply: the cell layers swept and the real ones among
    them.  The whole grid (nz = nv = n) unless the slab form is asked for,
    which is UNMASKED only (nz default n, nv default nz)."""
    if nz is None and nv is None:
        return n, n
    if mode != UNMASKED:
        raise ValueError("the slab form (nz, nv) takes UNMASKED mode only")
    nz = n if nz is None else int(nz)
    nv = nz if nv is None else int(nv)
    if nz < 1 or not 0 <= nv <= nz:
        raise ValueError(f"slab form needs nz >= 1 and 0 <= nv <= nz, got "
                         f"nz={nz}, nv={nv}")
    return nz, nv


# ---------------------------------------------------------------------------
# plain twins
# ---------------------------------------------------------------------------

def elasticity_rows_apply_plain(x, mask, ke, n: int, mode: int,
                                nz: int = None, nv: int = None):
    """Plain twin of :func:`elasticity_rows_apply`: the first ``nv`` of
    ``nz`` cell layers (both n on the whole grid)."""
    nz, nv = _slab_depth(n, mode, nz, nv)
    G = _u_index(n, x.device, nz)
    if nv < nz:
        G = G[:, :nv * n * n]
    xf = x.reshape(-1)
    xin = xf * mask.reshape(-1) if mode == CONSTRAINED else xf
    Ye = ke @ xin[G]                                    # (81, n^3)
    y = torch.zeros_like(xf).index_add_(0, G.reshape(-1), Ye.reshape(-1))
    y = y.view_as(x)
    if mode == FREE:
        return mask * y
    if mode == CONSTRAINED:
        return mask * y + (1.0 - mask) * x
    return y


def coupling_rows_plain(p, ce, n: int):
    """Plain twin of :func:`coupling_rows`."""
    Ye = ce @ p[_p_index(n, p.device)]                 # (81, n^3)
    y = torch.zeros(_rows_shape(n), dtype=p.dtype, device=p.device)
    y.view(-1).index_add_(0, _u_index(n, p.device, n).reshape(-1),
                          Ye.reshape(-1))
    return y


def projection_rows_plain(x, pe, n: int):
    """Plain twin of :func:`projection_rows`."""
    C = pe.shape[0] // 8
    g3 = (n + 1) ** 3
    Ye = pe @ x.reshape(-1)[_u_index(n, x.device, n)]  # (8*C, n^3)
    Gp = _p_index(n, x.device)                          # (8, n^3)
    tgt = Gp[:, None, :] + g3 * torch.arange(C, device=x.device)[None, :,
                                                                  None]
    out = torch.zeros(C * g3, dtype=x.dtype, device=x.device)
    out.index_add_(0, tgt.reshape(-1), Ye.reshape(-1))
    return out.view(C, g3)


# ---------------------------------------------------------------------------
# kernel wrappers: plain twin on CPU tensors, CUDA kernel on CUDA tensors
# ---------------------------------------------------------------------------

def elasticity_rows_apply(x, mask, ke, n: int, mode: int, nz: int = None,
                          nv: int = None):
    """Q2 elasticity apply in the row layout: UNMASKED ``A x``, FREE
    ``m * A x`` (x zero at constrained rows and padding) or CONSTRAINED
    ``m * A(m x) + (1 - m) x``.  ``ke``: (81, 81) element matrix, rows and
    columns (local node * 3 + comp), x-fastest local nodes.

    The slab form (counterpart of ``make_pallas_apply_rows(nz=...)`` with a
    run-time ``nv``; UNMASKED only): ``x`` and the result are
    ``((nz+1)*24, W)``, ``nz`` layers of n x n cells are swept and those at
    ``iz >= nv`` contribute nothing, whatever their input rows hold; ``n``
    keeps fixing the lane geometry.  Counted as ``"slab"``."""
    if x.device.type == "cpu":
        return elasticity_rows_apply_plain(x, mask, ke, n, mode, nz, nv)
    slab = nz is not None or nv is not None
    nz, nv = _slab_depth(n, mode, nz, nv)
    _cuda.require_cuda(x)
    rows = _rows_shape(n, nz)
    _cuda.check("x", x, rows, x.dtype, x.device)
    _cuda.check("ke", ke, (81, 81), x.dtype, x.device)
    if mode != UNMASKED:
        _cuda.check("mask", mask, rows, x.dtype, x.device)
    elif mask is not None:
        raise ValueError("UNMASKED mode takes no mask")
    plan = rows_apply_plan(n, x.dtype, sm_count(x.device), nz=nz)
    y = torch.empty_like(x)
    ye = torch.empty(plan.scratch_numel, dtype=x.dtype, device=x.device)
    _cuda.launch("elasticity_rows_apply", x, x, mask, ke, y, ye, n, nz, nv,
                 rows[1], plan.stride, plan.grid, plan.smem_bytes, mode)
    count("launches", "elasticity_rows_apply")
    count("launches", "slab" if slab else ("mode", mode))
    return y


def coupling_rows(p, ce, n: int):
    """Mechanics RHS ``C p`` in the row layout from the flat Q1 pressure
    ((n+1)^3,).  ``ce``: (81, 8), Biot coefficient folded in."""
    if p.device.type == "cpu":
        return coupling_rows_plain(p, ce, n)
    _cuda.require_cuda(p)
    _cuda.check("p", p, ((n + 1) ** 3,), p.dtype, p.device)
    _cuda.check("ce", ce, (81, 8), p.dtype, p.device)
    y = torch.empty(_rows_shape(n), dtype=p.dtype, device=p.device)
    _cuda.launch("coupling_rows", p, p, ce, y, n, _width(n))
    count("launches", "coupling_rows")
    return y


def projection_rows(x, pe, n: int):
    """All-Voigt strain-projection RHS (C, (n+1)^3) from u in the row
    layout.  ``pe``: (8*C, 81), rows (Q1 local node * C + Voigt c); the
    kernel takes the 3D count C = 6 only (pe of shape (48, 81)).  Two CUDA
    launches: the cell product pass into a (48, n^3) scratch
    (:func:`.cell_products.rows_apply_plan` with ``rows=PROJECTION_ROWS``),
    then the Q1 node sums."""
    if x.device.type == "cpu":
        return projection_rows_plain(x, pe, n)
    _cuda.require_cuda(x)
    _cuda.check("x", x, _rows_shape(n), x.dtype, x.device)
    _cuda.check("pe", pe, (PROJECTION_ROWS, 81), x.dtype, x.device)
    plan = rows_apply_plan(n, x.dtype, sm_count(x.device),
                           rows=PROJECTION_ROWS)
    out = torch.empty((N_VOIGT, (n + 1) ** 3), dtype=x.dtype,
                      device=x.device)
    ye = torch.empty(plan.scratch_numel, dtype=x.dtype, device=x.device)
    _cuda.launch("projection_rows", x, x, pe, out, ye, n, _width(n),
                 plan.stride, plan.grid, plan.smem_bytes)
    count("launches", "projection_rows")
    return out


# every kernel wrapper of the port (the generic path's in
# ops/generic_apply.py)
KERNEL_WRAPPERS = (elasticity_rows_apply, coupling_rows, projection_rows,
                   elasticity_grid_apply, generic_elasticity_apply,
                   generic_q1_apply)
# the launch counters (``"launches"`` in the recorder's registry): each
# wrapper's by its name, ``elasticity_rows_apply``'s on the whole grid by
# mode (UNMASKED = K5, FREE = K1, CONSTRAINED = K2) and of K5's slab form,
# the flat apply's slab mode's, and the Jacobi-CG update's two kernels'
# (:mod:`.cg_update`)
LAUNCH_KEYS = tuple(fn.__name__ for fn in KERNEL_WRAPPERS) + tuple(
    ("mode", m) for m in (UNMASKED, FREE, CONSTRAINED)) + (
        "slab", "grid_slab", "cg_update")


def reset_launch_counts() -> None:
    profiling.RECORDER.clear("launches")


def launch_counts() -> dict:
    """Every launch counter of the kernel wrappers (:data:`LAUNCH_KEYS`):
    each wrapper's by its name, ``elasticity_rows_apply``'s by mode
    (``("mode", m)``) and its slab form's (``"slab"``), the flat apply's
    slab mode's (``"grid_slab"``), and the CG update's (``"cg_update"``,
    two a fused iteration)."""
    c = profiling.RECORDER.counts
    return {k: c[("launches", k)] for k in LAUNCH_KEYS}


def add_launch_counts(delta: dict) -> None:
    """Add ``delta`` (keyed as :func:`launch_counts`; a key left out adds
    nothing) to the counters: a CUDA graph replay runs no wrapper, so the
    graph's owner adds the launches its capture recorded."""
    for k, v in delta.items():
        count("launches", k, v)


def make_flat_apply(element_matrix: np.ndarray, n: int, dtype: torch.dtype,
                    device) -> callable:
    """``apply(u_flat) -> y_flat``: the Q2 elasticity apply on flat
    ``((2n+1)^3 * 3,)`` vectors (counterpart of ``make_pallas_apply``,
    ``pallas_comp_major.py:1413``, whose ``_kernel`` v1 takes the flat
    vector through ``to_rows``, z-slab blocks and a host stitch of the slab
    overlaps).  Those are TPU layout steps: here the flat vector goes
    straight into the hand-written flat kernel
    (:func:`.elasticity.elasticity_grid_apply`), the same kernel that
    stands for ``make_pallas_elasticity``."""
    return make_grid_elasticity(element_matrix, n, dtype, device)


# ---------------------------------------------------------------------------
# node-block (3x3) Jacobi in the row layout (plain torch, as the JAX
# package's plain-jnp product)
# ---------------------------------------------------------------------------

def make_block_precond(block_inv: np.ndarray, n: int, dtype: torch.dtype,
                       device, nz_pad: int = None, layers: slice = None):
    """``R -> B^{-1} R`` nodewise in the row layout (counterpart of
    ``make_block_precond``, ``pallas_comp_major.py:213-257``).

    ``block_inv``: (g^3, 3, 3) inverted blocks of
    :func:`.node_blocks.elasticity_node_blocks` (symmetric: six planes
    are kept).  Phantom rows and lanes carry the identity, so z is zero
    wherever r is and the free-subspace apply stays exact.  ``nz_pad``
    (default n+1): z-half layers of the padded vectors, the extra ones
    identity (the z-slab kit pads to ``n_dev * Lz``); ``layers``: the
    z-half layers of those the vectors hold (a rank's slab; default all)."""
    if nz_pad is None:
        nz_pad = n + 1
    planes = []
    for c, d in ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)):
        fill = 1.0 if c == d else 0.0
        plane = scalar_rows_np(block_inv[:, c, d], n, fill)
        if nz_pad > n + 1:
            plane = np.concatenate([plane, np.full(
                ((nz_pad - (n + 1)) * 8, plane.shape[1]), fill)])
        planes.append(plane.reshape(nz_pad, 8, -1))
    M = np.stack(planes)
    if layers is not None:
        M = M[:, layers]
    M = torch.as_tensor(np.ascontiguousarray(M), dtype=dtype, device=device)
    m00, m01, m02, m11, m12, m22 = M
    W = _width(n)

    def block_precond(R):
        R4 = R.reshape(M.shape[1], 8, 3, W)
        r0, r1, r2 = R4[:, :, 0], R4[:, :, 1], R4[:, :, 2]
        z0 = m00 * r0 + m01 * r1 + m02 * r2
        z1 = m01 * r0 + m11 * r1 + m12 * r2
        z2 = m02 * r0 + m12 * r1 + m22 * r2
        return torch.stack([z0, z1, z2], dim=2).reshape(R.shape)

    return block_precond


def lazy_block_precond(element_matrix: np.ndarray, n: int, free_mask_u,
                       dtype: torch.dtype, device, nz_pad: int = None,
                       layers: slice = None):
    """:func:`make_block_precond` built on first use (counterpart of
    ``lazy_block_precond``, ``pallas_comp_major.py:1340``): the host
    set-up (the 27-point block assembly and a 3x3 inverse per node, seconds
    at 40^3) is paid only by ``Mechanics preconditioner = block`` runs.
    ``.build()`` builds it ahead, outside any captured CUDA graph."""
    cache = []

    def build():
        if not cache:
            blocks = elasticity_node_blocks(element_matrix, n, free_mask_u)
            cache.append(make_block_precond(np.linalg.inv(blocks), n, dtype,
                                            device, nz_pad, layers))
        return cache[0]

    def block_precond(R):
        return build()(R)

    block_precond.build = build
    return block_precond


# ---------------------------------------------------------------------------
# the persistent-row-layout solve kit
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ElasticityRowOps:
    """The comp-major row layout as the mechanics DOF-vector format, with
    the operators the FSS step applies in it.

    ``plain=True`` routes every operator to its plain twin even for CUDA
    tensors (for comparing a run against the kernels); otherwise each
    operator goes through its kernel wrapper."""
    n: int
    ke: torch.Tensor              # (81, 81) elasticity element matrix
    ce: torch.Tensor              # (81, 8) coupling element matrix
    pe: torch.Tensor              # (8*C, 81) strain-projection matrix
    free_mask_rows: torch.Tensor  # Dirichlet mask in rows (padding = 0)
    diag_rows: torch.Tensor       # Jacobi diagonal in rows (padding = 1)
    plain: bool = False
    # node-block Jacobi, rows -> rows (:func:`lazy_block_precond`)
    block_precond: Callable = None

    def to_rows(self, u_flat):
        return to_rows(u_flat, self.n)

    def from_rows(self, R):
        return from_rows(R, self.n)

    def _apply(self, x, mask, mode):
        fn = elasticity_rows_apply_plain if self.plain \
            else elasticity_rows_apply
        return fn(x, mask, self.ke, self.n, mode)

    def apply_rows(self, x):
        """Unconstrained ``A x``."""
        return self._apply(x, None, UNMASKED)

    def constrained_apply(self, x):
        """``m * A(m x) + (1 - m) x``: identity on constrained dofs."""
        return self._apply(x, self.free_mask_rows, CONSTRAINED)

    def free_apply(self, x):
        """``m * A x`` for x already in the free subspace (zero at
        constrained rows and padding): equals :meth:`constrained_apply`
        there, one input mask cheaper."""
        return self._apply(x, self.free_mask_rows, FREE)

    def coupling_rows(self, p):
        fn = coupling_rows_plain if self.plain else coupling_rows
        return fn(p, self.ce, self.n)

    def projection_rows(self, x):
        fn = projection_rows_plain if self.plain else projection_rows
        return fn(x, self.pe, self.n)

    def local_rows(self, R):
        """The part of full rows ``R`` this kit holds: all of it (the
        sharded kit, :class:`..parallel.rows.ShardedRowOps`, holds a
        slab)."""
        return R


def make_row_ops(element_matrix: np.ndarray, n: int, free_mask_u,
                 diag_elasticity, coupling_matrix: np.ndarray,
                 projection_matrix: np.ndarray, dtype: torch.dtype,
                 device: torch.device, plain: bool = False
                 ) -> ElasticityRowOps:
    """Build the row-layout mechanics kit for a 3D structured Q2 grid with
    ``n`` cells per axis; constants are built in numpy and moved once."""
    dev = lambda a: torch.as_tensor(np.asarray(a, np.float64),  # noqa: E731
                                    dtype=dtype, device=device).contiguous()
    return ElasticityRowOps(
        n=n, ke=dev(element_matrix), ce=dev(coupling_matrix),
        pe=dev(projection_matrix),
        free_mask_rows=dev(to_rows_np(free_mask_u, n, fill=0.0)),
        diag_rows=dev(to_rows_np(diag_elasticity, n, fill=1.0)),
        plain=plain, block_precond=lazy_block_precond(
            element_matrix, n, free_mask_u, dtype, device))
