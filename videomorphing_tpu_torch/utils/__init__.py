"""Host utilities of the port (profiling phases)."""
