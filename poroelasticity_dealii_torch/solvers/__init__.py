"""Solvers: CG, pressure multigrid, the structured discretization and the
fixed-stress-split time step."""
