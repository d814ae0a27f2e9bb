"""Print the JAX package's adaptive runs that the PyTorch port is held to.

Runs ``poroelasticity_dealii_tpu``'s ``AMRSimulationRunner`` on the CPU in
float64 on three adaptive configurations and prints, for each, one
``(n_cells, n_pdofs, fss_iterations, pressure_iterations,
pressure_error)`` tuple per step, as the Python literals that
``chip_smoke.py`` (``AMR_IRREGULAR_2D_PIN``, ``AMR_IRREGULAR_3D_PIN``) and
``tests/test_torch_amr.py`` (``AMR_BOX_3D_PIN``) hold:

* ``configs/irregular_2d.data`` with AMR on, levels 0 -> 2, refine every
  2, 6 steps (the gmsh-rooted quad forest);
* ``configs/consolidation_3d.data`` on ``configs/irregular_3d.msh``, AMR
  on, levels 0 -> 1, refine every 2, 4 steps (the gmsh-rooted hex forest);
* ``configs/consolidation_3d.data`` on its box, AMR on, levels 2 -> 3,
  refine every 2, 4 steps (the octree).

Usage (from the repository root, about two minutes on one CPU):

    python scripts/torch_amr_pins.py
"""

import dataclasses
import os
import sys

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from poroelasticity_dealii_tpu.amr.driver import \
    AMRSimulationRunner  # noqa: E402
from poroelasticity_dealii_tpu.config import read_input_file  # noqa: E402


def configurations():
    irr2d = read_input_file("configs/irregular_2d.data")
    deck3d = read_input_file("configs/consolidation_3d.data")
    return {
        "AMR_IRREGULAR_2D_PIN": dataclasses.replace(
            irr2d, amr=True, initial_refinement_level=0,
            max_refinement_level=2, refine_every=2,
            t_max=6 * irr2d.time_step),
        "AMR_IRREGULAR_3D_PIN": dataclasses.replace(
            deck3d, amr=True, mesh_file="configs/irregular_3d.msh",
            initial_refinement_level=0, max_refinement_level=1,
            refine_every=2, t_max=4 * deck3d.time_step),
        "AMR_BOX_3D_PIN": dataclasses.replace(
            deck3d, amr=True, initial_refinement_level=2,
            max_refinement_level=3, refine_every=2,
            t_max=4 * deck3d.time_step),
    }


def main() -> int:
    for name, data in configurations().items():
        data = dataclasses.replace(data, output_vtk=False)
        _, history = AMRSimulationRunner(data).run()
        print(f"{name} = [")
        for h in history:
            print(f"    ({h['n_cells']}, {h['n_pdofs']}, {h['fss']}, "
                  f"{h['press']}, {h['err']!r}),")
        print("]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
