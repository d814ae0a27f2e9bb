"""Immutable SoA mesh data model and generators (gmsh ingestion is not
ported yet: ROADMAP item 8)."""

from .core import Mesh, FESpace  # noqa: F401
from .generator import hyper_rectangle  # noqa: F401
from .qk import build_fe_space  # noqa: F401
