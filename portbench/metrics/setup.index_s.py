"""Seconds to attach the program's saved index (`GenomeIndex.load_mmap`;
on a checkout's first run, its build and save as well)."""


def read(r):
    return r["setup"]["index_s"]
