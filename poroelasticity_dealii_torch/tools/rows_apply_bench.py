"""Device time of the row-layout elasticity apply (K1/K2/K5) alone:

    python -m poroelasticity_dealii_torch.tools.rows_apply_bench [n] [label]

prints one JSON line per dtype (float32, float64) and mode (unmasked,
free, constrained) at ``n`` cells per axis (default 40): the wrapper's
device and host-enqueue ms per call (``apply_bench.device_and_host_ms``)
and, from ``torch.profiler`` over ten calls, the device ms per call of
each CUDA kernel it launched.  It uses only the wrapper's public interface
(``elasticity_rows_apply``, ``to_rows``, ``to_rows_np``), so the same file
also times an older tree of the port on the same card (``label`` tags the
lines).
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch


def _profile_split(fn, calls: int = 10) -> dict:
    """Device ms per call of each elasticity kernel ``fn`` launches."""
    from torch.profiler import ProfilerActivity, profile

    from .profile_step import device_summary
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = device_summary(prof)["elasticity_rows_apply"]["by_kernel"]
    return {k: v["ms"] / calls for k, v in rows.items()}


def run(n: int = 40, label: str = "", device="cuda") -> list:
    from ..ops import comp_major as cm
    from ..solvers.structured import build_grid_discretization
    from .apply_bench import device_and_host_ms
    from .profile_step import bench_data

    d = build_grid_discretization(bench_data(), cells_per_axis=n,
                                  multigrid="off", device="cpu")
    rng = np.random.default_rng(n)
    u = rng.standard_normal(d.n_udofs)
    out = []
    for dtype in (torch.float32, torch.float64):
        x = cm.to_rows(torch.as_tensor(u, dtype=dtype, device=device), n)
        m = torch.as_tensor(cm.to_rows_np(d.free_mask_u.numpy(), n),
                            dtype=dtype, device=device)
        K = torch.as_tensor(d.element_ke, dtype=dtype, device=device)
        cases = {"unmasked": (x, None, cm.UNMASKED),
                 "free": (x * m, m, cm.FREE),
                 "constrained": (x, m, cm.CONSTRAINED)}
        for mode, (xi, mi, code) in cases.items():
            def fn(xi=xi, mi=mi, code=code):
                return cm.elasticity_rows_apply(xi, mi, K, n, code)
            ms, host_ms = device_and_host_ms(fn)
            rec = {"label": label, "n": n,
                   "dtype": str(dtype).split(".")[-1], "mode": mode,
                   "ms": ms, "host_ms": host_ms,
                   "kernels_ms": _profile_split(fn),
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
