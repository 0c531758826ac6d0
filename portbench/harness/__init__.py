"""The harness of the port's benchmark: cells found by name, their
inputs made from the seed, a window of whole batches, the trace, and
the result line."""
