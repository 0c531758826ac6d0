"""Seconds to construct the mapper (`Mapper` / `PairedMapper`, with its
`DeviceIndex` planes) and load its kernels."""


def read(r):
    return r["setup"]["mapper_s"]
