"""Host-side utilities: the JSONL run log and VTK output."""
