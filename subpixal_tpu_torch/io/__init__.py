"""Host I/O carried into the port (numpy only)."""
