"""Solvers: CG, multigrid, the structured and the generic discretizations
and the fixed-stress-split time step."""
