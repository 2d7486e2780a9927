"""Factor types of the port: simplex (unary, pairwise, ternary), compact Potts and multicut."""
