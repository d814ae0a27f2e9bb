"""The benchmark of the PyTorch/CUDA port ``poroelasticity_dealii_torch``
(see README.md)."""
