"""Per-apply times of the flat Q2 elasticity apply at bench size (the
counterpart of ``scripts/pallas_apply_bench.py``):

    python -m poroelasticity_dealii_torch.tools.apply_bench [n]

prints CUDA-event times per apply at ``n`` cells per axis (default 40,
float32) of the conv-backend ``disc.elasticity`` (plain torch stencil),
``to_rows`` and ``from_rows``, the hand-written flat kernel through its
two entry points (``make_flat_apply``, the K6 counterpart, and
``make_grid_elasticity``, the K7 counterpart), its plain twin, and the
FLOP count.  It needs a CUDA device; :func:`run` also takes the CPU for
tests, with no times.

:func:`rows_free_csr` and :func:`rows_spmv_ms` give the row-layout
kernel's library yardstick (``library_ms`` in ``chip_smoke.py``): one
cuSPARSE CSR matrix-vector product over the assembled operator, as the
reference deal.II program applies its assembled matrices.  The port never
calls them.
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


def rows_free_csr(ke: torch.Tensor, mask_rows: torch.Tensor,
                  n: int) -> torch.Tensor:
    """The Q2 elasticity operator on the row layout as one sparse CSR
    matrix with the FREE mask folded into its rows: ``M @ x.view(-1)``
    equals ``m * A x``.  Assembled on ``ke``'s device: every cell's 81 x 81
    entries at their flat row-layout indices, zero entries (the rows the
    mask zeroes among them) left out, duplicates summed (COO coalesce)."""
    from ..ops import comp_major as cm
    G = cm._u_index(n, ke.device)                      # (81, n^3)
    m = mask_rows.reshape(-1)
    rows = G[:, None, :].expand(81, 81, -1).reshape(-1)
    cols = G[None, :, :].expand(81, 81, -1).reshape(-1)
    vals = (ke[:, :, None] * m[G][:, None, :]).reshape(-1)
    keep = vals != 0
    N = m.numel()
    A = torch.sparse_coo_tensor(torch.stack([rows[keep], cols[keep]]),
                                vals[keep], (N, N),
                                check_invariants=False).coalesce()
    return A.to_sparse_csr()


def rows_spmv_ms(M: torch.Tensor, x: torch.Tensor, reps: int = 20):
    """(median ms, result) of the CSR product ``M @ x`` on the row layout
    (``torch.mv``: cuSPARSE SpMV)."""
    xf = x.reshape(-1)
    return cuda_time_ms(lambda: torch.mv(M, xf), reps), \
        torch.mv(M, xf).view_as(x)


def _rel_err(got, ref) -> float:
    scale = ref.abs().max().item()
    return (got - ref).abs().max().item() / (scale if scale > 0 else 1.0)


def run(n: int = 40, dtype=torch.float32, device="cuda", reps: int = 20,
        deck=DECK) -> dict:
    """Apply every variant once to the same random u (launch counts reset
    just before, read just after), compare them, then time them on a CUDA
    device.  Returns the record that :func:`main` prints."""
    from ..config import read_input_file
    from ..ops import comp_major as cm
    from ..ops import elasticity as eg
    from ..solvers.structured import build_grid_discretization

    device = torch.device(device)
    data = dataclasses.replace(read_input_file(str(deck)),
                               dtype=str(dtype).split(".")[-1])
    disc = build_grid_discretization(data, cells_per_axis=n,
                                     multigrid="off",
                                     elasticity_backend="conv", device=device)
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
        "flop": 2 * 81 * 81 * n ** 3,
        "bytes": (2 * g ** 3 * 3 + 81 * 81) * item,
    }
    if device.type == "cuda":
        R = cm.to_rows(u, n)
        rec["ms"] = {
            "conv disc.elasticity": cuda_time_ms(lambda: disc.elasticity(u),
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
