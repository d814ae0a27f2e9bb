"""What the fixed-stress systems share: the program's deck from the
configuration's, the solver, and an episode's states as the judge reads
them."""

from __future__ import annotations

import dataclasses

from ..meshes import HexMesh


def deck_text(deck: dict) -> str:
    """A deck file's text from ``{subsection: {key: value}}``."""
    lines = []
    for sub, entries in deck.items():
        lines.append(f"subsection {sub}")
        lines += [f"  set {k} = {v}" for k, v in entries.items()]
        lines.append("end")
    return "\n".join(lines) + "\n"


def domain(deck: dict) -> list:
    """The deck's box size per axis."""
    return [float(v) for v in deck["Mesh"]["Domain size"].split(",")]


def program_data(deck: dict):
    """The program's parsed deck (its own parser and checks)."""
    from poroelasticity_dealii_torch.config import from_entries, parse_deck
    return from_entries(parse_deck(deck_text(deck)))


@dataclasses.dataclass
class System:
    """One configuration built on the program, and the mesh arrays and
    numbering the reference builds on."""
    solver: object                 # FixedStressSolver
    dt: float
    mesh: HexMesh                  # what the reference builds on
    numbering: str                 # its Q2 output order (reference/fem.py)
    dtype: str                     # the deck's

    def fields(self, state) -> dict:
        """A state's fields as the program wrote them (u filled from the
        mechanics layout if the step left it there)."""
        s = self.solver.materialize_u(state)
        return {"p": s.p, "u": s.u, "eps_v": s.eps_v,
                "eps_v0": s.eps_v0, "strains": s.strains}


def solver(disc, data):
    """The fixed-stress solver with its CG chunks captured as CUDA graphs
    (on the card; the CPU runs them eagerly)."""
    from poroelasticity_dealii_torch.solvers.fss import FixedStressSolver
    return FixedStressSolver(disc, data, cuda_graphs=True)
