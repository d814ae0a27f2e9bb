"""Host setup (shape and quadrature tables, geometry, element matrices,
diagonals) and the operator applies: the stencils, the comp-major
row-layout kernels and the flat elasticity kernel."""
