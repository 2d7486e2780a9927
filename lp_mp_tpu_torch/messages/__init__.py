"""Message types of the port: unary-pairwise and pairwise-triplet marginalization."""
