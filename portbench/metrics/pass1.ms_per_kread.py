"""Milliseconds a thousand reads of pass 1 (`ops/sw_vector.py`, with its
host finish): stage `pass1`, from the program's `Mapper.tel` timers over
the window."""

STAGES = ('pass1',)


def read(r):
    secs = sum(r["stages"].get(s, 0.0) for s in STAGES)
    return 1e6 * secs / r["reads"]
