"""Reads mapped per second: the reads of every batch completed in the
window (both mates of a pair) over all of the window's time, on the
harness's clock."""


def read(r):
    return r["reads"] / r["window_s"]
