"""The plain reference: finite elements, the judge of a run's states, and
a plain fixed-stress episode."""
