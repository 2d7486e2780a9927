"""Model families of the port: the dense Potts grid and the generic MRF constructor."""
