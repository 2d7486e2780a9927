"""Factor types of the port: simplex (unary, pairwise, ternary) and compact Potts."""
