"""Host-side NumPy utilities of the port: union-find, graph search, min-cost
flow and maxflow."""
