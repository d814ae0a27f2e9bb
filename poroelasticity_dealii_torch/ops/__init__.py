"""Host setup (element matrices, geometry, diagonals) and the operator
applies: the Q1 slice stencils and the comp-major row-layout kernels."""
