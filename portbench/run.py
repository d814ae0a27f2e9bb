"""Run one cell of the port's benchmark once:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout (``python -m portbench.run`` works too).  The
last line of standard output is the result (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and
last ``checks``: each number compared with the reference beside its
limit); the last lines of standard error repeat the checks.  Exits with
another code than 0, and prints no result, when there is no CUDA card,
when the program is not in the checkout, or when JAX or the JAX package
was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
PROGRAM = "poroelasticity_dealii_torch"


def _fail(msg: str, code: int) -> int:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)
    return code


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # the script's own folder would shadow modules of the standard library
    here = Path(__file__).resolve().parent
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != here]
    if not (ROOT / PROGRAM / "__init__.py").is_file():
        return _fail(f"the program {PROGRAM} is not in {ROOT}", 2)
    # keep a library that would load JAX by itself from doing so
    os.environ.setdefault("USE_FLAX", "0")
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import torch
    from portbench import harness, spec

    # one process with one host thread: the window's work is on the card,
    # and idle torch threads would take host cores from the loop
    torch.set_num_threads(1)

    try:
        chips = spec.load(ROOT, args.workload).chips
    except (KeyError, FileNotFoundError, ValueError) as e:
        return _fail(str(e), 2)
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < chips:
        return _fail(f"needs {chips} CUDA card(s), torch sees {cards}", 2)
    result, lines = harness.run(ROOT, args.workload, args.seed,
                                args.seconds, bool(args.trace), "cuda", T0)
    found = harness.forbidden_modules()
    if found:
        return _fail("the run loaded " + ", ".join(found), 3)
    print(json.dumps(result), flush=True)
    print("\n".join(lines), file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
