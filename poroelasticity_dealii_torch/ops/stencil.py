"""Operator applies on uniform structured grids (port of
``poroelasticity_dealii_tpu/ops/stencil.py``).

On a uniform grid every cell has the same element matrix, so an operator
apply is a gather of every cell's local values, one product with the
element matrix over all cells, and a scatter back onto the node grid.
The JAX package writes the general case as two XLA convolutions
(``conv_cellwise``, a strided gather conv, and ``conv_scatter``, a one-hot
transposed conv).  Here the same two steps are strided slices: the gather
stacks one strided slice of the node grid per local node, and the scatter
adds each local node's outputs back at its strided slice.  Each slice-add
touches every grid position at most once, so the result has no atomics and
no cuDNN algorithm choice in it: it is bitwise repeatable, which the
mechanics skip-if-unchanged rule needs (it compares right-hand sides
bitwise).  The product runs in full IEEE float32 (TF32 is off, see the
package ``__init__``), as the reference's ``Precision.HIGHEST``.

The scalar Q1 case keeps its own shifted-slice form
(:func:`make_q1_slices_apply`, ``_make_q1_slices_apply`` in the reference),
which carries the pressure mass, Laplace and fused-Jacobian applies and
the pressure multigrid level operators.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .shape import node_lattice


@dataclasses.dataclass(frozen=True)
class StencilSpec:
    """What an apply of :func:`make_stencil_apply` (or the flat elasticity
    kernel's, ``flat_kernel``) computes: its element matrix, degrees and
    components in and out, and its grid ``ns`` (cells per axis, (x, y, z)
    order).  The gspmd slabs (:mod:`..parallel.sharding`) rebuild the same
    operator on sub-grids from it (:meth:`on_cells`)."""
    element_matrix: np.ndarray
    k_in: int
    k_out: int
    n_comp_in: int
    n_comp_out: int
    ns: tuple
    dtype: torch.dtype
    device: torch.device
    flat_kernel: bool = False

    def on_cells(self, ns) -> callable:
        """The same operator on a grid of ``ns`` cells per axis: the flat
        kernel's slab mode (``nz`` cell layers along z, the other counts
        this spec's) or :func:`make_stencil_apply`."""
        ns = tuple(ns)
        if self.flat_kernel:
            from .elasticity import elasticity_grid_apply
            if ns[:2] != self.ns[:2]:
                raise ValueError(f"the flat kernel's slab mode keeps x and "
                                 f"y: {self.ns} -> {ns}")
            ke = torch.as_tensor(np.asarray(self.element_matrix, np.float64),
                                 dtype=self.dtype,
                                 device=self.device).contiguous()
            return lambda u: elasticity_grid_apply(u, ke, ns[0], nz=ns[2])
        return make_stencil_apply(self.element_matrix, self.k_in, self.k_out,
                                  self.n_comp_in, self.n_comp_out, len(ns),
                                  ns, self.dtype, self.device)


def _node_slices(k: int, ns):
    """Per local node of a degree-``k`` cell (x-fastest lattice): the
    (z, y, x) strided slices of the node grid that hold that node of every
    cell.  ``ns``: cells per axis in (x, y, z) order."""
    dim = len(ns)
    lat = node_lattice(k, dim)                        # (n_nodes, dim) x-first
    out = []
    for off in lat:
        out.append(tuple(slice(int(off[a]), int(off[a]) + k * (ns[a] - 1) + 1,
                               k)
                         for a in reversed(range(dim))))
    return out


def cell_gather(x: torch.Tensor, k: int, ns, n_comp: int) -> torch.Tensor:
    """Flat dof vector ``[z][y][x][comp]`` on the degree-``k`` node grid ->
    per-cell local values ``(cells, n_local * n_comp)``, cells z-major,
    columns ``node * n_comp + comp`` (the element-matrix order).  Leading
    batch dimensions of ``x`` are kept."""
    batch = tuple(x.shape[:-1])
    lead = (slice(None),) * len(batch)
    grid = tuple(k * n + 1 for n in reversed(ns))
    X = x.reshape(batch + grid + (n_comp,))
    U = torch.stack([X[lead + s] for s in _node_slices(k, ns)], dim=-2)
    return U.reshape(batch + (-1, U.shape[-2] * n_comp))


def cell_scatter(ye: torch.Tensor, k: int, ns, n_comp: int) -> torch.Tensor:
    """Inverse placement of :func:`cell_gather`: per-cell local values
    ``(cells, n_local * n_comp)`` summed onto the degree-``k`` node grid,
    returned as a flat ``[z][y][x][comp]`` vector.  One strided slice-add
    per local node, in local-node order.  Leading batch dimensions of
    ``ye`` are kept."""
    batch = tuple(ye.shape[:-2])
    lead = (slice(None),) * len(batch)
    rev = tuple(reversed(ns))
    grid = tuple(k * n + 1 for n in rev)
    slices = _node_slices(k, ns)
    Ye = ye.reshape(batch + rev + (len(slices), n_comp))
    Y = torch.zeros(batch + grid + (n_comp,), dtype=ye.dtype,
                    device=ye.device)
    for a, s in enumerate(slices):
        Y[lead + s] += Ye[..., a, :]
    return Y.reshape(batch + (-1,))


def make_stencil_apply(element_matrix: np.ndarray, k_in: int, k_out: int,
                       n_comp_in: int, n_comp_out: int, dim: int, n_cells,
                       dtype, device) -> callable:
    """``apply(x) -> y`` for one operator on a uniform grid.

    ``element_matrix``: (N_out_nodes * n_comp_out, N_in_nodes * n_comp_in),
    rows and columns ``(node * n_comp + comp)`` with x-fastest local nodes;
    ``k_in``/``k_out``: the input/output polynomial degrees; ``n_cells``:
    int or per-axis counts in (x, y, z) order.  Flat vectors are
    ``[z][y][x][comp]``, with any leading batch dimensions (the batched
    projection solves)."""
    ns = (n_cells,) * dim if np.ndim(n_cells) == 0 else tuple(n_cells)
    if k_in == k_out == 1 and n_comp_in == n_comp_out == 1:
        apply = make_q1_slices_apply(element_matrix, dim, ns, dtype, device)
    else:
        KT = torch.as_tensor(np.asarray(element_matrix, np.float64).T,
                             dtype=dtype, device=device)

        def apply(x):
            return stencil_apply(x, KT, k_in, k_out, ns, n_comp_in,
                                 n_comp_out)

    apply.spec = StencilSpec(element_matrix, k_in, k_out, n_comp_in,
                             n_comp_out, ns, dtype, device)
    return apply


def stencil_apply(x: torch.Tensor, KT: torch.Tensor, k_in: int, k_out: int,
                  ns, n_comp_in: int, n_comp_out: int) -> torch.Tensor:
    """One apply of :func:`make_stencil_apply`: gather the cells' local
    values, one product with ``KT`` (the transposed element matrix) and
    the slice-add scatter; ``ns``: cells per axis in (x, y, z) order."""
    return cell_scatter(cell_gather(x, k_in, ns, n_comp_in) @ KT, k_out, ns,
                        n_comp_out)


def make_q1_slices_apply(element_matrix: np.ndarray, dim: int, ns, dtype,
                         device) -> callable:
    """``apply(x)`` for a scalar Q1 -> Q1 operator with the uniform cell
    matrix ``element_matrix`` (2^dim x 2^dim, x-fastest local nodes) on a
    grid of ``ns`` cells per axis ((x, y[, z]) order).

    Each cell-local node is a shifted full-grid slice: the 2^dim slices are
    stacked, multiplied by the element matrix in one product, and each
    output slice is added back at its shift.  ``x`` may carry leading batch
    dimensions (the batched projection solves)."""
    K = torch.as_tensor(np.asarray(element_matrix, np.float64), dtype=dtype,
                        device=device)
    n_loc = 2 ** dim
    offsets = [tuple((a >> d) & 1 for d in range(dim)) for a in range(n_loc)]
    rev = tuple(reversed(tuple(ns)))                  # grid is (z, y, x)
    grid = tuple(r + 1 for r in rev)

    def cell_slice(off):
        # tensor axes are (z, y, x); the offset tuple is (x, y, z)
        return tuple(slice(off[dim - 1 - a], off[dim - 1 - a] + rev[a])
                     for a in range(dim))

    slices = [cell_slice(off) for off in offsets]

    def apply(x):
        batch = x.shape[:-1]
        X = x.reshape(batch + grid)
        ell = (Ellipsis,)
        U = torch.stack([X[ell + s] for s in slices], dim=-1)
        V = U @ K.T                                    # (..., cells, n_loc)
        Y = torch.zeros_like(X)
        for ao, s in enumerate(slices):
            Y[ell + s] += V[..., ao]
        return Y.reshape(x.shape)

    return apply
