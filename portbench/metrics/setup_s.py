"""Seconds from the process's start to the window's opening: imports,
the genome and the program's index (built on a checkout's first run,
attached after), the mapper and its kernels, the read pool, and the
warm-up batches."""


def read(r):
    return r["setup_s"]
