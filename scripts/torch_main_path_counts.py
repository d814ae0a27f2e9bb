"""Print the main path's kernel launches, graph captures and replays, counts
and step times of one tree of the PyTorch port, on the card.

Runs ``chip_smoke.main_path`` (the 40^3 float32 bench configuration, 5
evolving + 3 steady captured steps) of the tree whose root is the first
argument, after building that tree's kernels, and prints one line
``MAIN_PATH_COUNTS {...}``.  To compare two commits on one card, unpack
the older one with ``git archive`` into ``build/parent`` and run, in one
command, in the order parent, change, change, parent:

    S=$PWD/scripts/torch_main_path_counts.py
    for t in $PWD/build/parent $PWD $PWD $PWD/build/parent; do
        (cd $t && PYTHONPATH=$t python3 $S $t)
    done
"""

import json
import sys


def main(tree: str) -> None:
    sys.path.insert(0, tree)
    import torch

    import chip_smoke as cs
    from poroelasticity_dealii_torch.ops import _cuda
    from poroelasticity_dealii_torch.ops import comp_major as cm
    _cuda.library()
    launches, states, stats, ms, solver = cs.main_path(torch.device("cuda"))
    modes = cm.elasticity_rows_apply.mode_launches
    print("MAIN_PATH_COUNTS " + json.dumps({
        "tree": tree, "gpu": cs.gpu_line(), "launches": launches,
        "modes": {"unmasked": modes[cm.UNMASKED], "free": modes[cm.FREE],
                  "constrained": modes[cm.CONSTRAINED]},
        "captures": dict(solver.graphs.captures),
        "replays": dict(solver.graphs.replays),
        "counts": [cs._counts(s) for s in stats], "ms": ms}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1])
