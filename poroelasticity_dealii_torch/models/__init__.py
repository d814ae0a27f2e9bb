"""Host-side simulation drivers."""

from .runner import SimulationRunner, run_from_deck  # noqa: F401
