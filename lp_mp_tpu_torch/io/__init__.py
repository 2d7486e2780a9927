"""Input and output of the port: the UAI and Torresani readers, the LP
export of the local polytope (``lp_export``) and the exact ILP oracle over
it (``ilp``)."""
