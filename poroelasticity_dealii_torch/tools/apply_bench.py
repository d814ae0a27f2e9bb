"""Per-apply times of the flat Q2 elasticity apply at bench size (the
counterpart of ``scripts/pallas_apply_bench.py``):

    python -m poroelasticity_dealii_torch.tools.apply_bench [n] [generic]
    python -m poroelasticity_dealii_torch.tools.apply_bench 40 cg_update

prints CUDA-event times per apply at ``n`` cells per axis (default 40,
float32) of the conv backend's plain stencil (``disc.elasticity`` built
with ``kernels="plain"``), ``to_rows`` and ``from_rows``, the hand-written
flat kernel through its two entry points (``make_flat_apply``, the K6
counterpart, and ``make_grid_elasticity``, the K7 counterpart; on the card
the conv backend's ``disc.elasticity`` is this kernel), its plain twin, and
the FLOP count (2 per nonzero of the element matrix per cell,
:func:`nonzeros`).  With ``generic`` it times instead the six applies of
the generic discretization (:func:`generic_run`: mass, Laplace, the
pressure Jacobian and elasticity, which the hand-written generic kernels
compute on the card, and the plain-torch coupling and projection, on the
distorted hex mesh of ``profile_step.generic_mesh``, float32 and
float64), each beside its plain twin, its bound, the share of the twin's
time spent in the plan scatter, the flat kernel at the same ``n`` and the
kernels' CSR yardstick, and each kernel pass's device ms (the product
pass and the plan sum, from ``torch.profiler``; calls back to back and
calls after an L2 flush) and its least host enqueue per call.  To
compare two trees on one card, run it in each checkout, parent, change,
change, parent, in one command (an older checkout with this file copied
into its ``tools/``).  With ``cg_update`` it times the Jacobi-CG
iteration's update, plain against fused, at the benchmark's vector sizes,
after an L2 flush and back to back (:func:`cg_update_run`).  It needs a
CUDA device; :func:`run` and :func:`generic_run` also take the CPU for
tests, with no times.

:func:`library_csr` (structured grids), :func:`generic_library_csr`
(generic meshes), :func:`spmv_ms` and :func:`spmm_ms` give every
kernel's library yardstick (``library_ms`` in ``chip_smoke.py``): one
cuSPARSE CSR matrix-vector product over the assembled operator (a
matrix-matrix product over the lanes of a batched call), as the
reference deal.II program applies its assembled matrices.  The port
never calls them.
"""

from __future__ import annotations

import dataclasses
import json
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


def device_and_host_ms(fn, reps: int = 20, calls: int = 10,
                       host_stat=np.median) -> tuple:
    """(median device ms, ``host_stat`` (median) host ms) of one ``fn()``.

    Each of ``reps`` windows enqueues ``calls`` back-to-back calls between
    two CUDA events behind a sleep kernel that holds the stream until the
    host has enqueued the whole window, so the device time excludes host
    launch overhead (one call's events would measure the slower of the
    two); the host time is the enqueue time per call (``np.min``: the
    window least disturbed by other work on the host's cores)."""
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
    return float(np.median(dev)), float(host_stat(host))


def kernel_passes_ms(fn, calls: int = 20, flush: bool = False) -> dict:
    """{kernel: device ms per call} of every generic kernel launch that
    ``fn`` makes (the product pass and the plan sum of a generic kernel
    wrapper, by template instance), from ``torch.profiler`` over ``calls``
    calls after one warm-up call: back to back, or with ``flush`` each
    call after a read of :data:`FLUSH_BYTES` of other data, so that it
    starts from an L2 that holds none of its operands."""
    import re
    from torch.profiler import ProfilerActivity, profile
    other = torch.ones(FLUSH_BYTES // 4, device="cuda") if flush else None
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            if flush:
                other.sum()
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = ev.cuda_time_total
        m = re.search(r"(generic_\w+_kernel|plan_sum_kernel)<[^>]*>", ev.key)
        if us > 0 and m:
            out[m.group(0)] = out.get(m.group(0), 0.0) + us / 1e3 / calls
    return out


def cuda_time_ms(fn, reps: int = 20) -> float:
    """Median device time of one ``fn()`` (:func:`device_and_host_ms`)."""
    return device_and_host_ms(fn, reps)[0]


# every function a kernel wrapper computes, by the name chip_smoke.py gives
# its case: each is linear, so one CSR SpMV computes it
LIBRARY_CASES = ("elasticity_rows_apply[unmasked]",
                 "elasticity_rows_apply[free]",
                 "elasticity_rows_apply[constrained]",
                 "coupling_rows", "projection_rows", "elasticity_grid_apply")


def _flat_index(n: int, device, nz: int = None) -> torch.Tensor:
    """(81, n^2 nz): flat Q2 dof index (((z*g + y)*g + x)*3 + c) of local
    (node, comp) a*3+c of every cell of nz layers (default n) of n x n
    cells, cells in z, y, x order."""
    from ..ops.shape import node_lattice
    g = 2 * n + 1
    iz, iy, ix = np.meshgrid(np.arange(n if nz is None else nz),
                             np.arange(n), np.arange(n), indexing="ij")
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
    of ``nz`` cell layers), or the flat apply's slab mode (``nz`` layers
    of n x n cells, ``(2n+1)^2 (2nz+1) * 3`` values in and out)."""
    from ..ops import comp_major as cm
    dev = ke.device
    if name == "elasticity_grid_apply":
        F = _flat_index(n, dev, nz)
        shape = (3 * (2 * n + 1) ** 2 * (2 * (n if nz is None else nz)
                                         + 1),) * 2
        return _csr(list(_cell_entries(F, F, ke)), shape)
    if nz is not None or nv is not None:
        if name != "elasticity_rows_apply[unmasked]":
            raise ValueError("the slab form is the UNMASKED apply's or the "
                             "flat apply's")
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
    else:
        raise ValueError(f"no library operator for {name!r}")
    entries = [rows, cols, vals]
    del rows, cols, vals
    return _csr(entries, shape, diag)


def _csr(entries: list, shape, diag=None) -> torch.Tensor:
    """CSR of the ``[rows, cols, vals]`` entries (the list is emptied, so
    the caller's references go as they are used), zeros left out,
    duplicates summed, plus ``diag`` on the diagonal where it is
    nonzero."""
    rows, cols, vals = entries
    entries.clear()
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


def spmm_ms(M: torch.Tensor, x: torch.Tensor, reps: int = 20):
    """(median ms, (B, n) result) of the CSR product over the B lanes of
    ``x`` (B, n) at once: ``M @ x.T`` (cuSPARSE SpMM, the dense operand
    made (n, B) before the timing)."""
    xt = x.T.contiguous()
    return cuda_time_ms(lambda: M @ xt, reps), (M @ xt).T


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
    launches_k6 = cm.launch_counts()["elasticity_grid_apply"]
    y7 = k7(u)
    launches_k7 = cm.launch_counts()["elasticity_grid_apply"] - launches_k6
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


# the generic discretization's applies (solvers/discretization.py);
# "pressure" is the generic pressure Jacobian alpha M + beta L in one call
GENERIC_APPLIES = ("mass", "laplace", "pressure", "elasticity", "coupling",
                   "projection")
# the applies a hand-written kernel computes on the card, by kernel wrapper
# (ops/generic_apply.py); coupling and projection stay plain torch
GENERIC_KERNELS = {"mass": "generic_q1_apply", "laplace": "generic_q1_apply",
                   "pressure": "generic_q1_apply",
                   "elasticity": "generic_elasticity_apply"}
# the batched Q1 calls of the 3D path, by record label: the projection's
# mass CG on its six strain lanes (solvers/fss.py) and the pressure
# Jacobian on as many
GENERIC_BATCHED = {"mass[6]": ("mass", 6), "pressure[6]": ("pressure", 6)}
# the yardstick's operator of each kernel apply (an assembled CSR matrix:
# one cuSPARSE SpMV, or one SpMM over the lanes of a batched call)
GENERIC_LIBRARY = {"mass": "generic_q1_apply", "pressure": "generic_q1_apply",
                   "elasticity": "generic_elasticity_apply"}
# bytes read between calls to empty the H100's 50 MB L2 of a call's
# operands (kernel_passes_ms)
FLUSH_BYTES = 256 << 20
# published H100 SXM peaks at 700 W: HBM3 bytes/s; operations/s outside
# the tensor cores (float32 67 TFLOP/s, float64 34) and float64 on them
# (DMMA, the elasticity kernel's products)
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}
PEAK_DMMA = 67e12
# flop of the Q1 map rebuilt at one quadrature point from the corner
# offsets, by dimension: J (2 per multiply-add over the 2^dim - 1
# offsets), the cofactors, det, 1 / det, J^-1 and JxW
MAP_FLOP = {2: 2 * 3 * 4 + 3 + 1 + 4 + 2 + 1,
            3: 2 * 7 * 9 + 9 * 3 + 5 + 1 + 9 + 1}
# multiply-adds of the float32 elasticity kernel's sum-factorised
# gradients for one column (component of a cell), by dimension: per axis
# stage, its lines of 3 times its outputs times 3 (3D 162 + 243 + 243, 2D
# 54 + 54); the back products are as many
SUMFAC_FMA = {2: 108, 3: 648}
# flop of the Q1 kernel's tensor-product element (Q1Tensor and Gauss2 in
# csrc/generic.cu) for one cell and lane, both threads of the cell, by
# dimension and apply: the forward to the points (values for the mass,
# reference gradients for the Laplacian), the pointwise weights (alpha det
# J v; beta K r), the adjoint back to the nodes and the pair's node sums
# (3D mass 2 x (36 + 8 + 32 + 4), Laplacian 2 x (64 + 72 + 76 + 4),
# both 2 x (88 + 80 + 100 + 4))
Q1_TENSOR_FLOP = {2: {"mass": 56, "laplace": 116, "pressure": 148},
                  3: {"mass": 160, "laplace": 432, "pressure": 544}}
# flop of that kernel's map for one cell, once for all lanes: J by the same
# forward from the offsets, det J at the points and, with the Laplacian,
# the cofactors, 1 / det and K = J^-1 J^-T / det (3D 2 x (192 + 4 x 14),
# with the Laplacian 2 x (192 + 4 x 69))
Q1_MAP_FLOP = {2: {"mass": 84, "laplace": 136},
               3: {"mass": 496, "laplace": 936}}


# per generic apply: its input ("p" or "u"), gather connectivity, scatter
# plan and the geometry tensors it reads (attributes of the discretization)
GENERIC_OPERANDS = {
    "mass": ("p", "conn_p", "plan_p", ("jxw_p",)),
    "laplace": ("p", "conn_p", "plan_p", ("jinv_p", "jxw_p")),
    "pressure": ("p", "conn_p", "plan_p", ("jinv_p", "jxw_p")),
    "elasticity": ("u", "conn_u", "plan_u", ("jinv_u", "jxw_u")),
    "coupling": ("p", "conn_p", "plan_u", ("jinv_u", "jxw_u")),
    "projection": ("u", "conn_u", "plan_p", ("jinv_p", "jxw_p")),
}


BIOT = 0.9     # the coupling's Biot coefficient in the timings (the deck's)


def pressure_coefficients(data) -> tuple:
    """(alpha, beta) of the generic pressure Jacobian ``alpha M + beta L``
    at the deck's time step: (1 / (M dt), k / mu), as the fixed-stress
    solver computes them."""
    return 1.0 / data.m_modulus / data.time_step, data.perm / data.visc


def _generic_apply(d, name: str, coeffs=(1.0, 1.0)):
    """(the apply as ``d`` runs it, its plain twin, the twin's
    gather-and-product part: input -> the cell values it scatters, or None
    for the pressure Jacobian, whose twin scatters twice) of generic apply
    ``name``; ``coeffs``: the pressure Jacobian's (alpha, beta)."""
    from ..ops import generic_apply as ga
    from ..ops import operators as ops
    N, dim, E = d.dref_u_at_uq.shape[1], d.dim, d.n_cells
    q1 = (d.conn_p, d.psi_p_at_pq, d.dref_p_at_pq, d.jinv_p, d.jxw_p)
    if name in ("mass", "laplace", "pressure"):
        a, b = {"mass": (1.0, 0.0), "laplace": (0.0, 1.0),
                "pressure": coeffs}[name]
        core = {"mass": lambda x: ops.mass_core(x[..., d.conn_p],
                                                d.psi_p_at_pq, d.jxw_p),
                "laplace": lambda x: ops.laplace_core(
                    x[..., d.conn_p], d.dref_p_at_pq, d.jinv_p, d.jxw_p),
                "pressure": None}[name]
        return (lambda x: d.pressure_operator(x, a, b),
                lambda x: ga.generic_q1_apply_plain(x, *q1, a, b, d.plan_p),
                core)
    if name == "elasticity":
        return d.elasticity, lambda x: ga.generic_elasticity_apply_plain(
            x, d.conn_u, d.dref_u_at_uq, d.jinv_u, d.jxw_u, d.lam, d.mu,
            d.plan_u), lambda x: ops.elasticity_core(
                x[d.conn_u].reshape(N, dim, E), d.dref_u_at_uq, d.jinv_u,
                d.jxw_u, d.lam, d.mu)
    if name == "coupling":
        fn = lambda x: d.coupling_rhs(x, BIOT)  # noqa: E731
        return fn, fn, lambda x: ops.coupling_core(
            x[d.conn_p], d.psi_p_at_uq, d.dref_u_at_uq, d.jinv_u, d.jxw_u,
            BIOT)
    if name == "projection":
        return d.strain_projection_rhs, d.strain_projection_rhs, \
            lambda x: ops.projection_core(
                x[d.conn_u].reshape(N, dim, E), d.psi_p_at_pq,
                d.dref_u_at_pq, d.jinv_p, d.jxw_p).transpose(0, 1)
    raise ValueError(f"no generic apply {name!r}")


def generic_work(d, name: str, lanes: int = 1,
                 geometry: str = "stored") -> tuple:
    """(bytes, flop, DMMA flop) of one generic apply ``name`` on ``d``, on
    ``lanes`` input vectors at once.  Bytes: each input read once and the
    output written once: the input vectors, the gather connectivity, the
    geometry it reads, the shape tables, the scatter plan and the output
    vectors.  ``geometry`` "stored": the design that reads the Jacobian
    factors and weights (the plain twins, the coupling and projection RHS,
    the kernels' former design) and computes the element densely.  Flop,
    per lane: the shape-table products (2 per multiply-add), the pointwise
    geometric algebra and the scatter's additions (one per cell entry);
    the pressure Jacobian's are the mass's and the Laplacian's and one
    combining add per cell entry.  DMMA flop: the part a float64 kernel
    runs on the tensor cores (the elasticity products).  "offsets": the
    least work of the kernels' design, which reads the corner offsets
    ((2^dim - 1) dim values a cell) and rebuilds the map from them: the
    Q1 applies in tensor-product form (:data:`Q1_TENSOR_FLOP` a lane and
    :data:`Q1_MAP_FLOP` once), the elasticity products sum-factorised in
    both dtypes (:data:`SUMFAC_FMA`, all outside the tensor cores; the
    float64 kernel's dense DMMA products do more) and its map rebuilt at
    each point (:data:`MAP_FLOP`)."""
    from ..ops.operators import VOIGT_PAIRS
    dim, E = d.dim, d.n_cells
    Qu, Nu = d.dref_u_at_uq.shape[:2]
    Qp, Np = d.psi_p_at_pq.shape
    C = len(VOIGT_PAIRS[dim])
    inp, conn, plan, geo = GENERIC_OPERANDS[name]
    item = d.jxw_p.element_size()
    offsets = geometry == "offsets"
    if offsets:
        if name not in GENERIC_KERNELS:
            raise ValueError(f"{name} reads stored geometry only")
        geo = ()
    n_in = d.n_udofs if inp == "u" else d.n_pdofs
    n_out = {"mass": d.n_pdofs, "laplace": d.n_pdofs, "pressure": d.n_pdofs,
             "elasticity": d.n_udofs, "coupling": d.n_udofs,
             "projection": C * d.n_pdofs}
    tensors = [getattr(d, conn), getattr(d, plan).table] + [
        getattr(d, g) for g in geo] + [
        d.psi_p_at_pq, d.dref_p_at_pq, d.psi_p_at_uq, d.dref_u_at_uq,
        d.dref_u_at_pq]
    nbytes = (n_in + n_out[name]) * lanes * item + sum(
        t.numel() * t.element_size() for t in tensors)
    if offsets:
        nbytes += (2 ** dim - 1) * dim * E * item
        if name == "elasticity":
            products = 2 * 2 * dim * SUMFAC_FMA[dim] * E
        else:
            q1 = Q1_TENSOR_FLOP[dim][name] + Np
            return nbytes, (q1 * lanes + Q1_MAP_FLOP[dim][
                "mass" if name == "mass" else "laplace"]) * E, 0
    else:
        products = 4 * Qu * dim * Nu * dim * E
    m2 = dim * dim
    flop = {
        "mass": 4 * Qp * Np * E + Qp * E + Np * E,
        "laplace": (4 * Qp * dim * Np * E + 2 * Qp * dim * (2 * dim - 1) * E
                    + Qp * dim * E + Np * E),
        "elasticity": (products
                       + 2 * Qu * m2 * (2 * dim - 1) * E
                       + (dim - 1) * Qu * E + 6 * Qu * m2 * E + Qu * E
                       + Nu * dim * E),
        "coupling": (2 * Qu * Np * E + 2 * Qu * E + Qu * m2 * E
                     + 2 * Nu * Qu * dim * dim * E + Nu * dim * E),
        "projection": (2 * Qp * dim * Nu * dim * E
                       + Qp * m2 * (2 * dim - 1) * E + 2 * Qp * m2 * E
                       + Qp * C * E + 2 * Np * Qp * C * E + Np * C * E),
    }
    flop["pressure"] = flop["mass"] + flop["laplace"] + 2 * Np * E
    total = flop[name] * lanes
    if offsets:
        return nbytes, total + MAP_FLOP[dim] * Qu * E, 0
    dmma = products if name == "elasticity" and item == 8 else 0
    return nbytes, total, dmma


def generic_bound(d, name: str, lanes: int = 1,
                  geometry: str = "stored") -> tuple:
    """(ms, "bytes" or "operations") the card needs at least for
    :func:`generic_work`: the larger of the bytes over the HBM rate and
    the operations over their peaks (DMMA flop at :data:`PEAK_DMMA`, the
    rest at :data:`PEAK_FLOPS` of ``d``'s dtype)."""
    nbytes, flop, dmma = generic_work(d, name, lanes, geometry)
    t_bytes = nbytes / PEAK_BYTES
    t_flop = dmma / PEAK_DMMA + (flop - dmma) / PEAK_FLOPS[d.jxw_p.dtype]
    return max(t_bytes, t_flop) * 1e3, \
        "bytes" if t_bytes >= t_flop else "operations"


def _cast(d, dtype):
    """``d`` with its floating tensors cast to ``dtype``."""
    return dataclasses.replace(d, dtype=dtype, **{
        f.name: getattr(d, f.name).to(dtype) for f in dataclasses.fields(d)
        if isinstance(getattr(d, f.name), torch.Tensor)
        and getattr(d, f.name).is_floating_point()})


def generic_library_csr(d, name: str, alpha: float = 1.0,
                        beta: float = 0.0) -> torch.Tensor:
    """The function of generic kernel wrapper ``name`` on discretization
    ``d`` as one sparse CSR matrix ``M`` (``M @ x`` equals the apply):
    ``generic_elasticity_apply`` (K) or ``generic_q1_apply`` (alpha M +
    beta L).  Every cell's element matrix is the plain core applied to the
    unit vectors of its local values (on ``d``'s device, in ``d``'s
    dtype), each entry placed at its connectivity's indices; zero entries
    left out (bucketing's phantom cells), duplicates summed.  The
    yardstick of :func:`library_csr` for the generic mesh."""
    from ..ops import operators as ops
    E = d.n_cells
    if name == "generic_elasticity_apply":
        N, dim = d.dref_u_at_uq.shape[1], d.dim
        conn, n = d.conn_u.long(), d.n_udofs

        def column(b):
            ue = torch.zeros(N * dim, E, dtype=d.dtype, device=d.device)
            ue[b] = 1.0
            return ops.elasticity_core(ue.view(N, dim, E), d.dref_u_at_uq,
                                       d.jinv_u, d.jxw_u, d.lam, d.mu)
    elif name == "generic_q1_apply":
        conn, n = d.conn_p.long(), d.n_pdofs

        def column(b):
            pe = torch.zeros(conn.shape[0], E, dtype=d.dtype,
                             device=d.device)
            pe[b] = 1.0
            return alpha * ops.mass_core(pe, d.psi_p_at_pq, d.jxw_p) + \
                beta * ops.laplace_core(pe, d.dref_p_at_pq, d.jinv_p,
                                        d.jxw_p)
    else:
        raise ValueError(f"no generic library operator for {name!r}")
    a = conn.shape[0]
    vals = torch.stack([column(b) for b in range(a)], dim=1)   # (a, b, E)
    entries = [conn[:, None, :].expand(a, a, E).reshape(-1),
               conn[None, :, :].expand(a, a, E).reshape(-1),
               vals.reshape(-1)]
    del vals
    return _csr(entries, (n, n))


# small generic cases each kernel is held to its plain twin on
# (chip_smoke.py's generic kernel phase, tests/test_torch_generic_kernels.py
# on the card): distorted 2D and 3D grids, the gmsh hex mesh, bucketed AMR
# meshes (phantom cells) and geometry shared by every cell (cell axis 1)
GENERIC_CASES = ("perturbed_2d_6", "perturbed_3d_3", "perturbed_3d_4",
                 "irregular_3d_msh", "amr_2d", "amr_3d", "shared_geometry")
DECK_2D = DECK.parent / "golden_2d.data"
MSH_3D = DECK.parent / "irregular_3d.msh"
# the pressure Jacobian's coefficients in the small cases, and their lanes
CASE_COEFFS = (0.7, 1.3)
CASE_LANES = (None, 3, 6)


def generic_case(name: str):
    """The float64 CPU discretization of small case ``name``
    (:data:`GENERIC_CASES`)."""
    from ..amr.bucketing import pad_amr_discretization
    from ..amr.driver import build_amr_discretization
    from ..amr.forest import QuadForest
    from ..amr.octforest import OctForest
    from ..config import read_input_file
    from ..mesh import hyper_rectangle, read_msh
    from ..mesh.generator import perturb_interior
    from ..solvers.discretization import build_discretization

    f64 = torch.float64
    if name.startswith("perturbed"):
        dim, n = int(name[-4]), int(name[-1])
        data = read_input_file(str(DECK if dim == 3 else DECK_2D))
        mesh = perturb_interior(hyper_rectangle([10.0] * dim,
                                                cells_per_axis=n), 0.2,
                                seed=n)
        return build_discretization(mesh, data, dtype=f64, device="cpu")
    if name == "irregular_3d_msh":
        return build_discretization(read_msh(str(MSH_3D), dim=3),
                                    read_input_file(str(DECK)), dtype=f64,
                                    device="cpu")
    if name == "shared_geometry":
        d = build_discretization(hyper_rectangle([10.0] * 3,
                                                 cells_per_axis=3),
                                 read_input_file(str(DECK)), dtype=f64,
                                 device="cpu")
        return dataclasses.replace(d, **{
            k: getattr(d, k)[..., :1].contiguous()
            for k in ("jinv_u", "jxw_u", "jinv_p", "jxw_p",
                      "cell_offsets")})
    if name in ("amr_2d", "amr_3d"):
        if name == "amr_2d":
            data = read_input_file(str(DECK_2D))
            forest = QuadForest.uniform([-5, -5], [5, 5], 2)
        else:
            data = read_input_file(str(DECK))
            forest = OctForest.uniform([0, 0, 0], [10, 10, 10], 1)
        forest.refine_and_coarsen([leaf for leaf in forest.leaves
                                   if all(c == 0 for c in leaf[1:])], [])
        return pad_amr_discretization(build_amr_discretization(
            forest, data, device="cpu"))
    raise ValueError(f"no generic case {name!r}")


def on_device(d, dtype, device):
    """``d`` on ``device`` with its floating tensors in ``dtype``."""
    return _cast(d.to(device), dtype)


def generic_pairs(d, seed: int = 11) -> list:
    """[(label, the discretization's apply, its plain twin)] of every
    generic kernel call on ``d`` for seeded inputs: the elasticity apply,
    and the mass, the Laplacian and the pressure Jacobian
    (:data:`CASE_COEFFS`) on :data:`CASE_LANES` lanes."""
    from ..ops import generic_apply as ga
    rng = np.random.default_rng(seed)
    u = torch.as_tensor(rng.standard_normal(d.n_udofs), dtype=d.dtype,
                        device=d.device)
    out = [("elasticity", lambda: d.elasticity(u),
            lambda: ga.generic_elasticity_apply_plain(
                u, d.conn_u, d.dref_u_at_uq, d.jinv_u, d.jxw_u, d.lam, d.mu,
                d.plan_u))]
    q1 = (d.conn_p, d.psi_p_at_pq, d.dref_p_at_pq, d.jinv_p, d.jxw_p)
    for lanes in CASE_LANES:
        shape = (d.n_pdofs,) if lanes is None else (lanes, d.n_pdofs)
        x = torch.as_tensor(rng.standard_normal(shape), dtype=d.dtype,
                            device=d.device)
        for label, (a, b) in (("mass", (1.0, 0.0)), ("laplace", (0.0, 1.0)),
                              ("pressure", CASE_COEFFS)):
            out.append((f"{label}[{lanes or 1}]",
                        lambda x=x, a=a, b=b: d.pressure_operator(x, a, b),
                        lambda x=x, a=a, b=b: ga.generic_q1_apply_plain(
                            x, *q1, a, b, d.plan_p)))
    return out


def ghost_window_pairs(dtype, device, seed: int = 4) -> list:
    """[(label, window apply, its plain twin)] of rank 1 of a 2-way ghost
    split of the golden deck's 8 x 8 grid on ``device`` (window-local
    connectivity and plans over C + 2H values): the elasticity apply and
    the pressure Jacobian on 3 lanes."""
    from ..config import read_input_file
    from ..mesh import hyper_rectangle
    from ..ops import generic_apply as ga
    from ..parallel import ghost as gh
    from ..parallel.sharding import SlabGroup
    from ..solvers.discretization import build_discretization
    data = read_input_file(str(DECK_2D))
    d = build_discretization(hyper_rectangle(data.domain_size, 3), data,
                             dtype=dtype, device=device)
    r = gh.shard_renumbered(gh.renumber_discretization(d),
                            SlabGroup(1, 2, None, torch.device(device)))
    assert r.H_u > 0 and r.H_p > 0
    rng = np.random.default_rng(seed)
    wu = torch.as_tensor(rng.standard_normal(r.C_u + 2 * r.H_u),
                         dtype=dtype, device=device)
    wp = torch.as_tensor(rng.standard_normal((3, r.C_p + 2 * r.H_p)),
                         dtype=dtype, device=device)
    a, b = CASE_COEFFS
    return [("ghost window elasticity",
             lambda: r.window_apply("elasticity", wu),
             lambda: ga.generic_elasticity_apply_plain(
                 wu, r.conn_u, r.dref_u_at_uq, r.jinv_u, r.jxw_u, r.lam,
                 r.mu, r.plan_u)),
            ("ghost window pressure[3]",
             lambda: r.window_apply("pressure_operator", wp, a, b),
             lambda: ga.generic_q1_apply_plain(
                 wp, r.conn_p, r.psi_p_at_pq, r.dref_p_at_pq, r.jinv_p,
                 r.jxw_p, a, b, r.plan_p))]


def generic_run(n: int = 40, device="cuda", reps: int = 20,
                deck=DECK, library: bool = True,
                passes: bool = False) -> list:
    """The six generic applies at ``n`` cells per axis on the distorted
    mesh, and the batched Q1 calls of :data:`GENERIC_BATCHED`, float32 and
    float64 (one float64 build, cast for float32), each applied twice to
    the same random input (bitwise repeat, the launches of its kernel
    wrapper counted) and held against its plain twin (the
    mass, Laplacian, pressure Jacobian and elasticity reach the
    hand-written kernels on a CUDA device; coupling and projection are
    plain torch, their own twins); then timed on a CUDA device beside the
    plain twin, the twin's gather-and-product part and scatter alone, its
    bound (:func:`generic_bound`: the kernels' corner-offset design where
    a kernel computes the apply, the stored-geometry design beside it),
    the host enqueue per call, the flat kernel K6 at the same ``n`` and,
    with ``library``, the kernel's yardstick (:func:`generic_library_csr`:
    the assembled operator, float64 assembled once, its values cast for
    float32; one cuSPARSE SpMV, or one SpMM over a batched call's lanes)
    and, with ``passes``, each kernel pass's device ms
    (:func:`kernel_passes_ms`, back to back and from an emptied L2) and
    the least host enqueue per call over ``5 reps`` windows.  Returns one
    record per (apply or batched label, dtype)."""
    from ..config import read_input_file
    from ..ops import comp_major as cm
    from ..ops import operators as ops
    from ..solvers.discretization import build_discretization
    from ..solvers.structured import build_grid_discretization
    from .profile_step import generic_mesh

    device = torch.device(device)
    cuda = device.type == "cuda"
    data = read_input_file(str(deck))
    coeffs = pressure_coefficients(data)
    d64 = build_discretization(generic_mesh(n), data, dtype=torch.float64,
                               device=device)
    ke = build_grid_discretization(data, cells_per_axis=n, multigrid="off",
                                   elasticity_backend="conv", device="cpu",
                                   kernels="plain").element_ke
    rng = np.random.default_rng(0)
    xs = {"u": rng.standard_normal(d64.n_udofs),
          "p": rng.standard_normal(d64.n_pdofs),
          "flat": rng.standard_normal(3 * (2 * n + 1) ** 3)}
    xs["p6"] = rng.standard_normal((6, d64.n_pdofs))
    gpu = torch.cuda.get_device_name(device) if cuda else "cpu"
    csr = {}
    if cuda and library:
        for name, kernel in GENERIC_LIBRARY.items():
            t0 = time.perf_counter()
            csr[name] = generic_library_csr(
                d64, kernel, *(coeffs if name == "pressure" else (1.0, 0.0)))
            torch.cuda.synchronize()
            csr[name + "_assembly_s"] = time.perf_counter() - t0
    out = []
    for dtype in (torch.float32, torch.float64):
        d = d64 if dtype == torch.float64 else _cast(d64, dtype)
        k6_ms = None
        if cuda:
            k6 = cm.make_flat_apply(ke, n, dtype, device)
            uf = torch.as_tensor(xs["flat"], dtype=dtype, device=device)
            k6_ms = cuda_time_ms(lambda: k6(uf), reps)
        calls = [(name, name, 1) for name in GENERIC_APPLIES] + [
            (label, name, lanes)
            for label, (name, lanes) in GENERIC_BATCHED.items()]
        for label, name, lanes in calls:
            inp = GENERIC_OPERANDS[name][0]
            x = torch.as_tensor(xs[inp if lanes == 1 else f"{inp}{lanes}"],
                                dtype=dtype, device=device)
            fn, plain, core = _generic_apply(d, name, coeffs)
            if lanes > 1:
                core = None
            plan = getattr(d, GENERIC_OPERANDS[name][2])
            kernel = GENERIC_KERNELS.get(name) if cuda else None
            cm.reset_launch_counts()
            y1, y2 = fn(x), fn(x)
            launches = cm.launch_counts()
            ref = plain(x)
            nbytes, flop, _ = generic_work(d, name, lanes)
            stored_ms, stored_by = generic_bound(d, name, lanes)
            bound_ms, bound_by = generic_bound(
                d, name, lanes, "offsets" if name in GENERIC_KERNELS
                else "stored")
            rec = {"apply": label, "lanes": lanes, "n": n,
                   "dtype": str(dtype).split(".")[-1],
                   "cells": d.n_cells, "device": gpu, "kernel": kernel,
                   "launches": {k: v for k, v in launches.items() if v},
                   "bitwise_repeat": bool(torch.equal(y1, y2)),
                   "finite": bool(torch.isfinite(y1).all()),
                   "max_abs_err": (y1 - ref).abs().max().item(),
                   "max_rel_err": _rel_err(y1, ref),
                   "bytes": nbytes, "flop": flop,
                   # the kernel's design (corner offsets) where a kernel
                   # computes the apply; the stored-geometry design beside
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "stored_bound_ms": stored_ms,
                   "stored_bound_by": stored_by,
                   "scatter_valence": plan.table.shape[1]}
            if name in GENERIC_KERNELS:
                rec["bytes_offsets"] = generic_work(d, name, lanes,
                                                    "offsets")[0]
            if name == "pressure":
                rec["coefficients"] = list(coeffs)
            if cuda:
                ms, host_ms = device_and_host_ms(lambda: fn(x), reps)
                rec.update({"ms": ms, "host_ms": host_ms,
                            "plain_ms": cuda_time_ms(lambda: plain(x), reps)
                            if kernel else ms, "k6_ms": k6_ms})
                if core is not None:
                    ye = core(x)
                    rec["gather_product_ms"] = cuda_time_ms(
                        lambda: core(x), reps)
                    rec["scatter_ms"] = cuda_time_ms(
                        lambda: ops.scatter_sum(ye, plan), reps)
                    del ye
                rec["times_bound"] = ms / rec["bound_ms"]
                if passes and kernel:
                    rec["host_min_ms"] = device_and_host_ms(
                        lambda: fn(x), 5 * reps, host_stat=np.min)[1]
                    rec["passes_ms"] = kernel_passes_ms(lambda: fn(x), reps)
                    rec["passes_cold_ms"] = kernel_passes_ms(
                        lambda: fn(x), reps, flush=True)
                if name in csr:
                    M = csr[name] if dtype == torch.float64 else \
                        torch.sparse_csr_tensor(
                            csr[name].crow_indices(),
                            csr[name].col_indices(),
                            csr[name].values().to(dtype), csr[name].shape)
                    rec["library_ms"], y_lib = (spmv_ms if lanes == 1
                                                else spmm_ms)(M, x, reps)
                    rec["library_rel_err_vs_kernel"] = _rel_err(y_lib, y1)
                    rec["library_nnz"] = M._nnz()
                    rec["library_assembly_s"] = csr[name + "_assembly_s"]
                    del M, y_lib
            out.append(rec)
            del y1, y2, ref
    return out


# the Jacobi-CG update's vectors in the benchmark's 40^3 cells: the row
# layout's mechanics vector (14.1 MB in float64), the distorted mesh's flat
# one (12.75 MB) and the projection's batch of six Q1 vectors
CG_UPDATE_SHAPES = {"rows": (984, 1792), "flat": (1_594_323,),
                    "batched": (6, 68_921)}


def flushed_ms(fn, reps: int = 10, calls: int = 10) -> float:
    """Median device ms of one ``fn()`` that starts from an L2 holding none
    of its operands: each call follows a read of :data:`FLUSH_BYTES` of
    other data, outside the call's pair of CUDA events; a sleep kernel
    holds the stream until the host has enqueued the window, as in
    :func:`device_and_host_ms`."""
    other = torch.ones(FLUSH_BYTES // 4, device="cuda")
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    other.sum()
    fn()
    host0 = time.perf_counter() - t0
    torch.cuda.synchronize()
    cycles = int(min(4e9 * calls * host0 + 2e6, 4e9))
    dev = []
    for _ in range(reps):
        events = [(torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True))
                  for _ in range(calls)]
        torch.cuda._sleep(cycles)
        for a, b in events:
            other.sum()
            a.record()
            fn()
            b.record()
        events[-1][1].synchronize()
        dev += [a.elapsed_time(b) for a, b in events]
    return float(np.median(dev))


def cg_update_run(dtype=torch.float64, device="cuda", reps: int = 20):
    """Per-call device ms of the Jacobi-CG iteration's update after its
    apply (:data:`CG_UPDATE_SHAPES`), each call from an L2 that holds none
    of its operands (:func:`flushed_ms`; ``warm_ms``: back to back, the
    vectors partly in L2): the plain body
    (``solvers/cg.py::_jacobi_update_plain``) against the fused one
    (``_jacobi_update_cuda``: two kernels, the dots and the norm), each
    whole; each kernel alone and its plain torch twin (the same outputs in
    plain torch), its least bytes (every vector it reads or writes once:
    eight and three vectors, the batch's diagonal one lane), the bound
    bytes / :data:`PEAK_BYTES` and GB/s; whether the two bodies agree
    bitwise.  Yields one record per shape."""
    from ..ops import cg_update
    from ..solvers import cg as tcg
    for name, shape in CG_UPDATE_SHAPES.items():
        g = torch.Generator().manual_seed(3)

        def vec(sh=shape):
            return torch.randn(sh, generator=g, dtype=torch.float64).to(
                dtype).to(device)
        batched = name == "batched"
        x, r, p, ap = vec(), vec(), vec(), vec()
        d = vec(shape[1:] if batched else shape).abs() + 0.5
        if batched:
            dot, norm = tcg.LocalReductions.lane_dot, tcg.lane_norm
        else:
            dot, norm = tcg.LocalReductions.dot, torch.linalg.norm
        active = torch.ones(shape[:1] if batched else (), dtype=torch.bool,
                            device=device)
        lane = (lambda t: t[:, None]) if batched else (lambda t: t)
        rz, rnorm = dot(r, r * d), norm(r)
        args = (x, r, p, ap, rz, rnorm, d, active, dot, norm)
        alpha = rz / dot(p, ap)
        _, _, z = cg_update.jacobi_step(x, r, p, ap, d, alpha, active)

        def step_plain():
            r_new = r - lane(alpha) * ap
            return (torch.where(lane(active), x + lane(alpha) * p, x),
                    torch.where(lane(active), r_new, r), r_new * d)
        calls = {
            "plain": lambda: tcg._jacobi_update_plain(*args),
            "fused": lambda: tcg._jacobi_update_cuda(*args),
            "step_kernel": lambda: cg_update.jacobi_step(
                x, r, p, ap, d, alpha, active),
            "step_plain": step_plain,
            "direction_kernel": lambda: cg_update.direction(
                z, p, alpha, active),
            "direction_plain": lambda: torch.where(
                lane(active), z + lane(alpha) * p, p)}
        ms = {k: flushed_ms(fn, reps // 2) for k, fn in calls.items()}
        warm = {k: cuda_time_ms(fn, reps) for k, fn in calls.items()}
        size = x.element_size()
        nbytes = {"step_kernel": (7 * x.numel() + d.numel()) * size,
                  "direction_kernel": 3 * x.numel() * size}
        gbs = {k: nbytes[k] / ms[k] / 1e6 for k in nbytes}
        same = all(torch.equal(u, v) for u, v in zip(
            tcg._jacobi_update_plain(*args), tcg._jacobi_update_cuda(*args)))
        yield {"case": name, "shape": list(shape), "dtype": str(dtype),
               "vector_mb": x.numel() * size / 1e6,
               "device": torch.cuda.get_device_name(x.device),
               "ms": ms, "warm_ms": warm, "bytes": nbytes,
               "bound_ms": {k: v / PEAK_BYTES * 1e3
                            for k, v in nbytes.items()},
               "gb_per_s": gbs,
               "peak_share": {k: v * 1e9 / PEAK_BYTES
                              for k, v in gbs.items()},
               "kernels_ms": ms["step_kernel"] + ms["direction_kernel"],
               "bitwise": same}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    n = int(argv[0]) if argv else 40
    if not torch.cuda.is_available():
        raise SystemExit("apply_bench: needs a CUDA device "
                         "(torch.cuda.is_available() is False)")
    if argv[1:] == ["generic"]:
        for rec in generic_run(n, passes=True):
            print(json.dumps(rec), flush=True)
        return 0
    if argv[1:] == ["cg_update"]:
        for dtype in (torch.float64, torch.float32):
            for rec in cg_update_run(dtype):
                print(json.dumps(rec), flush=True)
        return 0
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
