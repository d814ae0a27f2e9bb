"""Per-apply times of the flat Q2 elasticity apply at bench size (the
counterpart of ``scripts/pallas_apply_bench.py``):

    python -m poroelasticity_dealii_torch.tools.apply_bench [n]

prints CUDA-event times per apply at ``n`` cells per axis (default 40,
float32) of the conv backend's plain stencil (``disc.elasticity`` built
with ``kernels="plain"``), ``to_rows`` and ``from_rows``, the hand-written
flat kernel through its two entry points (``make_flat_apply``, the K6
counterpart, and ``make_grid_elasticity``, the K7 counterpart; on the card
the conv backend's ``disc.elasticity`` is this kernel), its plain twin, and
the FLOP count (2 per nonzero of the element matrix per cell,
:func:`nonzeros`).  It needs a CUDA device; :func:`run` also takes the CPU
for tests, with no times.

:func:`library_csr` and :func:`spmv_ms` give every kernel's library
yardstick (``library_ms`` in ``chip_smoke.py``): one cuSPARSE CSR
matrix-vector product over the assembled operator, as the reference
deal.II program applies its assembled matrices.  The port never calls
them.
"""

from __future__ import annotations

import dataclasses
import sys
import time
from pathlib import Path

import numpy as np
import torch

DECK = (Path(__file__).resolve().parents[2] / "configs"
        / "consolidation_3d.data")
# an element-matrix entry below this share of the largest is quadrature
# roundoff of an exact zero (at most 7e-17 of it in the bench deck's ke, ce
# and pe; the smallest other entry is 1.7e-4): work counts take the others
NONZERO_RTOL = 1e-12


def nonzeros(a) -> int:
    """Entries of element matrix ``a`` that are not roundoff zeros."""
    a = np.abs(np.asarray(a))
    return int((a > NONZERO_RTOL * a.max()).sum())


def device_and_host_ms(fn, reps: int = 20, calls: int = 10) -> tuple:
    """(median device ms, median host ms) of one ``fn()``.

    Each of ``reps`` windows enqueues ``calls`` back-to-back calls between
    two CUDA events behind a sleep kernel that holds the stream until the
    host has enqueued the whole window, so the device time excludes host
    launch overhead (one call's events would measure the slower of the
    two); the host time is the enqueue time per call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host0 = time.perf_counter() - t0
    torch.cuda.synchronize()
    cycles = int(min(4e9 * calls * host0 + 2e6, 4e9))   # ~2x at ~2 GHz
    dev, host = [], []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        a.record()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        host.append((time.perf_counter() - t0) * 1e3 / calls)
        b.record()
        b.synchronize()
        dev.append(a.elapsed_time(b) / calls)
    return float(np.median(dev)), float(np.median(host))


def cuda_time_ms(fn, reps: int = 20) -> float:
    """Median device time of one ``fn()`` (:func:`device_and_host_ms`)."""
    return device_and_host_ms(fn, reps)[0]


# every function a kernel wrapper computes, by the name chip_smoke.py gives
# its case: each is linear, so one CSR SpMV computes it
LIBRARY_CASES = ("elasticity_rows_apply[unmasked]",
                 "elasticity_rows_apply[free]",
                 "elasticity_rows_apply[constrained]",
                 "coupling_rows", "projection_rows", "elasticity_grid_apply")


def _flat_index(n: int, device) -> torch.Tensor:
    """(81, n^3): flat Q2 dof index (((z*g + y)*g + x)*3 + c) of local
    (node, comp) a*3+c of every cell, cells in z, y, x order."""
    from ..ops.shape import node_lattice
    g = 2 * n + 1
    iz, iy, ix = np.meshgrid(*(np.arange(n),) * 3, indexing="ij")
    cell = ((2 * iz * g + 2 * iy) * g + 2 * ix).reshape(-1)
    off = [((int(oz) * g + int(oy)) * g + int(ox)) * 3 + c
           for (ox, oy, oz) in node_lattice(2, 3) for c in range(3)]
    idx = np.asarray(off)[:, None] + 3 * cell[None, :]
    return torch.as_tensor(idx, dtype=torch.int64, device=device)


def _cell_entries(R, C, V, rscale=None, cscale=None):
    """Flat (rows, cols, vals) of every cell's V[a][b] at (R[a, cell],
    C[b, cell]), times rscale[a, cell] and cscale[b, cell] if given."""
    a, b = V.shape
    cells = R.shape[1]
    v = V[:, :, None]
    if rscale is not None:
        v = v * rscale[:, None, :]
    if cscale is not None:
        v = v * cscale[None, :, :]
    return (R[:, None, :].expand(a, b, cells).reshape(-1),
            C[None, :, :].expand(a, b, cells).reshape(-1),
            v.expand(a, b, cells).reshape(-1))


def library_csr(name: str, n: int, ke, ce, pe, mask_rows, nz: int = None,
                nv: int = None) -> torch.Tensor:
    """The function of kernel case ``name`` (:data:`LIBRARY_CASES`) at grid
    size ``n`` as one sparse CSR matrix ``M``: ``M @ input.view(-1)`` equals
    the case's output, flattened (input: x in the row layout, p, or flat u).
    Assembled on ``ke``'s device from every cell's element-matrix entries at
    their flat indices, the masks of the FREE and CONSTRAINED modes folded
    in (CONSTRAINED adds the identity on the constrained rows), zero entries
    left out, duplicates summed (COO coalesce).  ``nz``, ``nv``: the slab
    form of the UNMASKED apply (``((nz+1)*24, W)`` rows, the first ``nv``
    of ``nz`` cell layers)."""
    from ..ops import comp_major as cm
    dev = ke.device
    if nz is not None or nv is not None:
        if name != "elasticity_rows_apply[unmasked]":
            raise ValueError("the slab form is the UNMASKED apply's")
        nz, nv = cm._slab_depth(n, cm.UNMASKED, nz, nv)
    else:
        nz = nv = n
    N = int(np.prod(cm._rows_shape(n, nz)))
    g3 = (n + 1) ** 3
    G = cm._u_index(n, dev, nz)[:, :nv * n * n]        # (81, nv*n^2)
    diag = None
    if name.startswith("elasticity_rows_apply"):
        mode = name[len("elasticity_rows_apply["):-1]
        mG = None if mode == "unmasked" else mask_rows.reshape(-1)[G]
        rows, cols, vals = _cell_entries(
            G, G, ke, rscale=None if mode == "unmasked" else mG,
            cscale=mG if mode == "constrained" else None)
        if mode == "constrained":
            diag = 1.0 - mask_rows.reshape(-1)
        shape = (N, N)
    elif name == "coupling_rows":
        rows, cols, vals = _cell_entries(G, cm._p_index(n, dev), ce)
        shape = (N, g3)
    elif name == "projection_rows":
        C = pe.shape[0] // 8                           # pe rows ip*C + c
        Gp = cm._p_index(n, dev)                       # (8, n^3)
        R = (Gp.repeat_interleave(C, dim=0)
             + g3 * torch.arange(C, device=dev).repeat(8)[:, None])
        rows, cols, vals = _cell_entries(R, G, pe)
        shape = (C * g3, N)
    elif name == "elasticity_grid_apply":
        F = _flat_index(n, dev)
        rows, cols, vals = _cell_entries(F, F, ke)
        shape = (3 * (2 * n + 1) ** 3,) * 2
    else:
        raise ValueError(f"no library operator for {name!r}")
    keep = vals != 0
    idx = torch.stack([rows[keep], cols[keep]])
    vals = vals[keep]
    del rows, cols, keep
    if diag is not None:
        i = torch.nonzero(diag).reshape(-1)
        idx = torch.cat([idx, torch.stack([i, i])], dim=1)
        vals = torch.cat([vals, diag[i]])
    A = torch.sparse_coo_tensor(idx, vals, shape,
                                check_invariants=False).coalesce()
    return A.to_sparse_csr()


def spmv_ms(M: torch.Tensor, inp: torch.Tensor, reps: int = 20):
    """(median ms, flat result) of the CSR product ``M @ inp.view(-1)``
    (``torch.mv``: cuSPARSE SpMV)."""
    xf = inp.reshape(-1)
    return cuda_time_ms(lambda: torch.mv(M, xf), reps), torch.mv(M, xf)


def _rel_err(got, ref) -> float:
    scale = ref.abs().max().item()
    return (got - ref).abs().max().item() / (scale if scale > 0 else 1.0)


def run(n: int = 40, dtype=torch.float32, device="cuda", reps: int = 20,
        deck=DECK) -> dict:
    """Apply every variant once to the same random u (launch counts reset
    just before, read just after), compare them with the conv backend's
    plain stencil, then time them on a CUDA device.  Returns the record
    that :func:`main` prints."""
    from ..config import read_input_file
    from ..ops import comp_major as cm
    from ..ops import elasticity as eg
    from ..solvers.structured import build_grid_discretization

    device = torch.device(device)
    data = dataclasses.replace(read_input_file(str(deck)),
                               dtype=str(dtype).split(".")[-1])
    disc = build_grid_discretization(data, cells_per_axis=n,
                                     multigrid="off",
                                     elasticity_backend="conv", device=device,
                                     kernels="plain")
    k6 = cm.make_flat_apply(disc.element_ke, n, dtype, device)
    k7 = eg.make_grid_elasticity(disc.element_ke, n, dtype, device)
    ke = torch.as_tensor(disc.element_ke, dtype=dtype, device=device)
    rng = np.random.default_rng(0)
    u = torch.as_tensor(rng.standard_normal(disc.n_udofs), dtype=dtype,
                        device=device)

    cm.reset_launch_counts()
    y6 = k6(u)
    launches_k6 = eg.elasticity_grid_apply.launches
    y7 = k7(u)
    launches_k7 = eg.elasticity_grid_apply.launches - launches_k6
    y_conv = disc.elasticity(u)
    y_plain = eg.elasticity_grid_apply_plain(u, ke, n)
    y_again = k7(u)
    g = 2 * n + 1
    item = u.element_size()
    rec = {
        "n": n, "dtype": str(dtype).split(".")[-1], "dofs": disc.n_udofs,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "launches": {"make_flat_apply": launches_k6,
                     "make_grid_elasticity": launches_k7},
        "rel_err_vs_conv": {"make_flat_apply": _rel_err(y6, y_conv),
                            "make_grid_elasticity": _rel_err(y7, y_conv)},
        "rel_err_vs_plain": _rel_err(y7, y_plain),
        "max_abs_err_vs_plain": (y7 - y_plain).abs().max().item(),
        "bitwise_repeat": bool(torch.equal(y7, y_again)),
        "flop": 2 * nonzeros(disc.element_ke) * n ** 3,
        "bytes": (2 * g ** 3 * 3 + 81 * 81) * item,
    }
    if device.type == "cuda":
        R = cm.to_rows(u, n)
        rec["ms"] = {
            "conv plain stencil": cuda_time_ms(lambda: disc.elasticity(u),
                                               reps),
            "to_rows": cuda_time_ms(lambda: cm.to_rows(u, n), reps),
            "from_rows": cuda_time_ms(lambda: cm.from_rows(R, n), reps),
            "kernel via make_flat_apply": cuda_time_ms(lambda: k6(u), reps),
            "kernel via make_grid_elasticity": cuda_time_ms(lambda: k7(u),
                                                            reps),
            "plain twin": cuda_time_ms(
                lambda: eg.elasticity_grid_apply_plain(u, ke, n), reps),
        }
    return rec


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    n = int(argv[0]) if argv else 40
    if not torch.cuda.is_available():
        raise SystemExit("apply_bench: needs a CUDA device "
                         "(torch.cuda.is_available() is False)")
    rec = run(n)
    print(f"# {rec['device']} n={n} {rec['dtype']} dofs={rec['dofs']}")
    for name, ms in rec["ms"].items():
        print(f"{name:34s} {ms:8.4f} ms")
    print(f"# rel err vs conv: {rec['rel_err_vs_conv']}, vs plain twin "
          f"{rec['rel_err_vs_plain']:.3e}, bitwise repeat "
          f"{rec['bitwise_repeat']}")
    print(f"# flop/apply = {rec['flop'] / 1e9:.3f} GFLOP, compulsory bytes "
          f"= {rec['bytes'] / 1e6:.2f} MB")
    return 0


if __name__ == "__main__":
    sys.exit(main())
