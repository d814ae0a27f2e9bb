"""Builders of the program's systems, one module per kind named in a
configuration's ``system``."""
