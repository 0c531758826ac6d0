"""fasta2fastq — csfasta + qual -> fastq converter (mergesam/fasta2fastq.c).

Pairs each read in a (cs)fasta file with the space-separated integer quality
line of the matching record in the .qual file and emits FASTQ whose quality
chars are offset+qv (the reference uses 34 for SOLiD data,
fasta2fastq.c:24-49,196).

Usage:
    python -m shrimp_tpu_torch.tools.fasta2fastq [--qv-offset N] reads.csfasta \
        reads.qual > reads.fq
"""

from __future__ import annotations

import getopt
import sys


def records(path, sep=""):
    name = None
    parts: list[str] = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            if line.startswith(">"):
                if name is not None:
                    yield name, sep.join(parts)
                name = line[1:].split()[0]
                parts = []
            else:
                parts.append(line)
    if name is not None:
        yield name, sep.join(parts)


def main(argv=None) -> int:
    argv = list(sys.argv if argv is None else argv)
    try:
        opts, files = getopt.gnu_getopt(argv[1:], "?", ["qv-offset=", "help"])
    except getopt.GetoptError as exc:
        sys.stderr.write(f"error: {exc}\n")
        return 1
    offset = 34
    for o, a in opts:
        if o == "--qv-offset":
            offset = int(a)
        else:
            sys.stderr.write(__doc__)
            return 0
    if len(files) != 2:
        sys.stderr.write("usage: fasta2fastq [--qv-offset N] "
                         "reads.csfasta reads.qual\n")
        return 1
    quals = records(files[1], sep=" ")
    out = sys.stdout
    for (name, seq), (qname, qline) in zip(records(files[0]), quals):
        if name != qname:
            sys.stderr.write(f"error: read/qual name mismatch "
                             f"{name!r} vs {qname!r}\n")
            return 1
        # qual lines hold one integer per colour, whitespace-separated
        qv = "".join(chr(offset + int(t)) for t in qline.split())
        out.write(f"@{name}\n{seq}\n+\n{qv}\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
