"""Milliseconds a thousand reads of SAM formatting (`Mapper.sam_records`,
`PairedMapper.sam_records_pair`), on the harness's clock around it."""


def read(r):
    return 1e6 * r["sam_s"] / r["reads"]
