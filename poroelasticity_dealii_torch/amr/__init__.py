"""Adaptive mesh refinement (2D quadtree / 3D octree, and forests rooted on
gmsh meshes): port of ``poroelasticity_dealii_tpu/amr``.

The reference's AMR pipeline (``PoroelasticityFSS.h:448-498``): Kelly error
estimation on the pressure solution, fixed-*error*-fraction refine/coarsen
marking with level clamps, 1-irregular forest conformity, hanging-node
constraints for the Q1/Q2 spaces, and nodal solution transfer of {p, eps_v,
eps_v0}.  The forests, the Kelly indicator and the transfer are copies of
the reference's numpy modules; the constraint tables apply on torch
tensors (:mod:`.constraints`), and :mod:`.driver` runs the adaptive time
loop: host-side remesh, a new discretization and solver on the device.
"""

from .forest import QuadForest  # noqa: F401
from .kelly import kelly_estimate, kelly_estimate_3d  # noqa: F401
from .octforest import OctForest  # noqa: F401
from .transfer import transfer_nodal  # noqa: F401
