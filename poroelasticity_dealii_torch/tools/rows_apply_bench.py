"""Device time of the kernels alone: the row-layout elasticity apply
(K1/K2/K5), the coupling right-hand side (K3), the projection right-hand
side (K4) and the flat elasticity apply (K6/K7):

    python -m poroelasticity_dealii_torch.tools.rows_apply_bench [n] [label]

prints one JSON line per dtype (float32, float64) and case (the apply in
modes unmasked, free, constrained; ``coupling_rows``; ``projection_rows``;
``flat``) at ``n`` cells per axis (default 40): the wrapper's device and
host-enqueue ms per call (``apply_bench.device_and_host_ms``) and, from
``torch.profiler`` over ten calls, the device ms per call of each CUDA
kernel it launched (for the applies and the projection: the product pass
and the sum pass).  It uses only the wrappers' public interface
(``elasticity_rows_apply``, ``coupling_rows``, ``projection_rows``,
``elasticity_grid_apply``, ``to_rows``, ``to_rows_np``), so the same file
also times an older tree of the port on the same card (``label`` tags the
lines).
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch


def _profile_split(fn, wrapper: str, calls: int = 10) -> dict:
    """Device ms per call of each CUDA kernel of ``wrapper`` that ``fn``
    launches."""
    from torch.profiler import ProfilerActivity, profile

    from .profile_step import device_summary
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = device_summary(prof)[wrapper]["by_kernel"]
    return {k: v["ms"] / calls for k, v in rows.items()}


def run(n: int = 40, label: str = "", device="cuda") -> list:
    from ..ops import comp_major as cm
    from ..ops import elasticity as eg
    from ..solvers.structured import build_grid_discretization
    from .apply_bench import device_and_host_ms
    from .profile_step import bench_data

    d = build_grid_discretization(bench_data(), cells_per_axis=n,
                                  multigrid="off", device="cpu")
    rng = np.random.default_rng(n)
    u = rng.standard_normal(d.n_udofs)
    p_np = rng.standard_normal(d.n_pdofs)
    out = []
    for dtype in (torch.float32, torch.float64):
        dev = lambda a: torch.as_tensor(a, dtype=dtype,  # noqa: E731
                                        device=device)
        uf = dev(u)
        x = cm.to_rows(uf, n)
        m = dev(cm.to_rows_np(d.free_mask_u.numpy(), n))
        xf = x * m                                  # free-subspace input
        K, Ce, Pe, p = (dev(a) for a in (d.element_ke, d.element_ce,
                                         d.element_pe, p_np))
        apply = cm.elasticity_rows_apply
        cases = {
            "unmasked": ("elasticity_rows_apply",
                         lambda: apply(x, None, K, n, cm.UNMASKED)),
            "free": ("elasticity_rows_apply",
                     lambda: apply(xf, m, K, n, cm.FREE)),
            "constrained": ("elasticity_rows_apply",
                            lambda: apply(x, m, K, n, cm.CONSTRAINED)),
            "coupling_rows": ("coupling_rows",
                              lambda: cm.coupling_rows(p, Ce, n)),
            "projection_rows": ("projection_rows",
                                lambda: cm.projection_rows(x, Pe, n)),
            "flat": ("elasticity_grid_apply",
                     lambda: eg.elasticity_grid_apply(uf, K, n)),
        }
        for case, (wrapper, fn) in cases.items():
            ms, host_ms = device_and_host_ms(fn)
            rec = {"label": label, "n": n,
                   "dtype": str(dtype).split(".")[-1], "mode": case,
                   "ms": ms, "host_ms": host_ms,
                   "kernels_ms": _profile_split(fn, wrapper),
                   "gpu": torch.cuda.get_device_name()}
            print(json.dumps(rec), flush=True)
            out.append(rec)
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        raise SystemExit("rows_apply_bench: needs a CUDA device "
                         "(torch.cuda.is_available() is False)")
    run(int(argv[0]) if argv else 40, argv[1] if len(argv) > 1 else "")
    return 0


if __name__ == "__main__":
    sys.exit(main())
