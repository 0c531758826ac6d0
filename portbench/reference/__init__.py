"""The plain reference that decides `correct`: SHRiMP2's scoring,
posteriors and mapping qualities written out again in NumPy, which
judges the SAM records the timed path produced.  It imports nothing of
the program, of the JAX package or of JAX."""
