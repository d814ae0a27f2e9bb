"""Host-side simulation drivers."""
