"""Immutable SoA mesh data model + generators + gmsh ingestion."""

from .core import Mesh, FESpace  # noqa: F401
from .generator import hyper_rectangle  # noqa: F401
from .qk import build_fe_space  # noqa: F401
from .gmsh_io import read_msh  # noqa: F401
