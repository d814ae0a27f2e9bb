"""Host-side utilities: VTK output."""
