"""Host-side NumPy utilities of the port: union-find and graph search."""
