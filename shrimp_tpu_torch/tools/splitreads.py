"""splitreads — shard a read file N reads per chunk (utils/splitreads.py).

Paired-aware: with --paired, chunks hold an even number of reads so mates
never straddle a shard boundary.

Usage:
    python -m shrimp_tpu_torch.tools.splitreads [--paired] N reads.fq [prefix]
"""

from __future__ import annotations

import sys


def main(argv=None) -> int:
    argv = list(sys.argv if argv is None else argv)
    args = argv[1:]
    paired = False
    if args and args[0] == "--paired":
        paired = True
        args = args[1:]
    if len(args) < 2:
        sys.stderr.write(
            "usage: splitreads [--paired] N reads.fq [out_prefix]\n")
        return 1
    n = int(args[0])
    path = args[1]
    prefix = args[2] if len(args) > 2 else path
    if paired and n % 2:
        n += 1

    from shrimp_tpu_torch.io import fastx

    shard_no = 0
    fh = None
    count = 0
    fastq = fastx.detect_fastq(path)
    for rec in fastx.iter_reads(path, fastq=fastq):
        if fh is None or count >= n:
            if fh:
                fh.close()
            shard_no += 1
            fh = open(f"{prefix}.{shard_no}", "w")
            count = 0
        if fastq:
            fh.write(f"@{rec.name}\n{rec.seq}\n+\n{rec.qual or ''}\n")
        else:
            fh.write(f">{rec.name}\n{rec.seq}\n")
        count += 1
    if fh:
        fh.close()
    sys.stderr.write(f"wrote {shard_no} shards\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
