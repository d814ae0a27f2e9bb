"""The readings that set the limits of ``correct`` (not run by the
benchmark's own runs):

    python3 portbench/control.py readings <workload> <seconds> <seed>...
    python3 portbench/control.py control <workload> <seconds> <seed>...

``readings``: the program as the configuration states it, one short run
of the cell per seed, all in this process (the lower readings).
``control``: the same runs with the program's own float32 path switched
on in place of the configuration's float64, the precision a later change
would be tempted to take (the upper readings); each must read not
correct.  Each run is a whole run of the cell at its own size and load
(a warm episode, then whole episodes for ``seconds``), judged against the
cell's limits.  One JSON line per seed.
"""

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def runs(workload: str, seconds: float, seeds, dtype: str = None,
         device="cuda", root=ROOT) -> list:
    """One run of the cell per seed (``dtype`` replacing the deck's
    precision): its numbers beside their limits, ``correct``, its counts
    and its end-to-end metrics."""
    from portbench import harness
    out = []
    for seed in seeds:
        t = time.perf_counter()
        result, _ = harness.run(root, workload, seed, seconds, False, device,
                                dtype=dtype)
        rec = {"workload": workload, "dtype": dtype or "as configured",
               "seed": seed, "run_s": time.perf_counter() - t,
               "correct": result["correct"], "failed": result["failed"],
               "attempted": result["attempted"],
               **{k: v["value"] for k, v in result["checks"].items()},
               "limits": {k: v["limit"] for k, v in
                          result["checks"].items()},
               **{k: v["value"] for k, v in result["metrics"].items()}}
        print(json.dumps(rec), flush=True)
        out.append(rec)
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    here = Path(__file__).resolve().parent
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != here]
    sys.path.insert(0, str(ROOT))
    if len(argv) < 4 or argv[0] not in ("readings", "control"):
        raise SystemExit(__doc__)
    mode, workload, seconds = argv[0], argv[1], float(argv[2])
    runs(workload, seconds, [int(s) for s in argv[3:]],
         "float32" if mode == "control" else None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
