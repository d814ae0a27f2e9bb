"""The share of the CG iterations that ran the fused Jacobi-CG update (the
program's ``fused_steps``) among all the iterations its CG chunks ran
(``chunk_steps``, frozen ones included, every call site), in %, over the
window's steps after its traced episodes
(:func:`portbench.spans.unprofiled`).  A program without the fused update
reads nothing."""

import importlib.util

from portbench import spans


def read(ctx):
    if importlib.util.find_spec(
            "poroelasticity_dealii_torch.ops.cg_update") is None:
        return None
    recs = spans.unprofiled(ctx)
    if recs is None:
        return None
    steps = sum(r.total("chunk_steps") for r in recs)
    if not steps:
        return None
    return 100.0 * sum(r.total("fused_steps") for r in recs) / steps
