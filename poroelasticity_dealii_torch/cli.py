"""Command-line interface of the port.

``python -m poroelasticity_dealii_torch run DECK [--device cuda|cpu] [--x64]
[--resume CKPT] [--profile LOGDIR]`` runs a 2D or 3D deck on its
structured grid (e.g. ``configs/golden_2d.data``,
``configs/consolidation_3d.data``) or on its gmsh mesh (``Mesh / Mesh file``,
e.g. ``configs/irregular_2d.data``, read relative to the working
directory); a deck with ``TPU / AMR = true`` (e.g.
``configs/golden_2d_adaptive.data``) runs the adaptive loop, remeshing
every ``TPU / Refine every`` steps.  ``--resume`` continues from a
checkpoint (``TPU / Checkpoint every``): an ``.npz`` file (either
package's) or a ``ckpt-NNNNNN`` directory that ``TPU / Checkpoint format
= orbax`` wrote (this package's asynchronous backend; a directory that
orbax wrote for the JAX package is refused), and
``--profile`` writes a ``torch.profiler`` Chrome trace of the run into
LOGDIR.  ``check DECK`` parses and prints it; ``devices`` lists the
visible CUDA devices.

A deck with ``TPU / Sharding = psum``, ``gspmd`` or ``production`` runs
sharded under ``torchrun`` (one process per device; rank 0 writes the
output; an adaptive deck with psum only), e.g. on the CPU::

    torchrun --standalone --nproc-per-node 2 -m poroelasticity_dealii_torch \
        run DECK --device cpu

and unsharded, with a warning, as one process.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="poroelasticity_dealii_torch",
        description="Biot poroelasticity solver on PyTorch/CUDA")
    sub = parser.add_subparsers(dest="command", required=True)
    run_p = sub.add_parser("run", help="run a simulation from a deck file")
    run_p.add_argument("deck", help="parameter deck (.data/.prm)")
    run_p.add_argument("--device", default="cuda",
                       help="cuda, cuda:N or cpu (default cuda)")
    run_p.add_argument("--x64", action="store_true",
                       help="force float64 (overrides deck TPU/Dtype)")
    run_p.add_argument("--resume", default=None,
                       help="checkpoint to resume from: an .npz file or a "
                       "ckpt-NNNNNN directory (Checkpoint format = orbax)")
    run_p.add_argument("--profile", default=None, metavar="LOGDIR",
                       help="write a torch.profiler trace of the run")
    chk = sub.add_parser("check", help="parse + validate a deck, print it")
    chk.add_argument("deck")
    sub.add_parser("devices", help="list visible CUDA devices")
    args = parser.parse_args(argv)

    from .config import format_deck, read_input_file

    if args.command == "check":
        data = read_input_file(args.deck)
        sys.stdout.write(format_deck(data))
        print(f"# derived: lambda={data.lame_constant:.6g} "
              f"G={data.shear_modulus:.6g} K={data.bulk_modulus:.6g} "
              f"Ks={data.grain_bulk_modulus:.6g} N={data.n_modulus:.6g} "
              f"M={data.m_modulus:.6g}")
        return 0

    import torch

    if args.command == "devices":
        for i in range(torch.cuda.device_count()):
            print(f"cuda:{i} {torch.cuda.get_device_name(i)}")
        return 0

    from . import resolve_device
    from .models.runner import run_from_data
    data = read_input_file(args.deck)
    if args.x64:
        data = dataclasses.replace(data, dtype="float64")
    device = resolve_device(args.device)
    if args.profile:
        from .utils.profiling import device_trace
        with device_trace(args.profile):
            run_from_data(data, resume_from=args.resume, device=device)
    else:
        run_from_data(data, resume_from=args.resume, device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
