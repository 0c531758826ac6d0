"""Small workflow utilities — ports of the reference `utils/` scripts.

Subcommands (python -m shrimp_tpu_torch.tools.utils <cmd> ...):

  cs2ls FILE            colour-space lines -> letter space (cs2ls.py)
  colourise FILE        letter-space lines -> colour space (colourise.py)
  revcmpl FILE          reverse-complement a FASTA file (revcmpl.py)
  fastq2fasta FILE      FASTQ -> FASTA (fastq_to_fasta)
  extractseq FILE N     print sequence of read/contig named N (extractseq.py)
  subsequence FILE NAME START END   1-based inclusive slice
                        (extract-subsequence.py)
  getcontigs FILE       list contig names + lengths (get_contigs.py)
  splittigs FILE        write each contig to its own .fa (splittigs.py)
  mergepairfiles [-Q] F1 F2    interleave two mate files (mergepairfiles.py)
  findpairs [-Q] SUF1 SUF2 FILE   split an interleaved/unsorted file into
                        pairable reads by suffix (findpairs.py flavour)
  extractunmapped FILE  reads after "#UNMAPPED READS:" (extractunmapped.py)
  basicstats FILE       legacy-output mapping stats (basic-stats-unpaired)
  tophits N FILE...     global top-N legacy records per read
                        (mappings-top-hits.py)
  findseq FILE SEQ      1-based overlapping occurrences of SEQ in a
                        single-contig FASTA (findseq.py)
  clippedmappings       SAM on stdin -> FASTQ of hard-clipped mappings
                        from their tag columns (get_clipped_mappings.py)
"""

from __future__ import annotations

import sys

_CS2LS = {
    "A": {"0": "A", "1": "C", "2": "G", "3": "T"},
    "C": {"0": "C", "1": "A", "2": "T", "3": "G"},
    "G": {"0": "G", "1": "T", "2": "A", "3": "C"},
    "T": {"0": "T", "1": "G", "2": "C", "3": "A"},
}
_LS2CS = {
    a: {b: c for b, d in _CS2LS[a].items() for c0, c in [(d, b)]
        for d2 in [d]}
    for a in "ACGT"
}
# letter pair -> colour
_PAIR2COL = {}
for a in "ACGT":
    for col, b in _CS2LS[a].items():
        _PAIR2COL[a + b] = col

_RC = str.maketrans("ACGTacgtNnXx", "TGCAtgcaNnXx")


def _open(path):
    import gzip
    if path == "-":
        return sys.stdin
    with open(path, "rb") as probe:
        if probe.read(2) == b"\x1f\x8b":
            return gzip.open(path, "rt")
    return open(path)


def cmd_cs2ls(args):
    for line in _open(args[0]):
        line = line.strip()
        if not line or line[0] not in "ACGT":
            continue
        out = [line[0]]
        last = line[0]
        ok = True
        for c in line[1:]:
            if c not in "0123":
                ok = False
                break
            last = _CS2LS[last][c]
            out.append(last)
        if ok:
            print("".join(out[1:]))
    return 0


def cmd_colourise(args):
    init = "T"
    for line in _open(args[0]):
        line = line.strip()
        if not line:
            continue
        if line.startswith(">"):
            print(line)
            continue
        seq = init + line.upper()
        cols = []
        for a, b in zip(seq, seq[1:]):
            cols.append(_PAIR2COL.get(a + b, "."))
        print(seq[0] + "".join(cols))
    return 0


def cmd_revcmpl(args):
    from shrimp_tpu_torch.io import fastx
    for rec in fastx.iter_reads(args[0], fastq=False):
        print(f">{rec.name}")
        rc = rec.seq.translate(_RC)[::-1]
        for i in range(0, len(rc), 50):
            print(rc[i:i + 50])
    return 0


def cmd_fastq2fasta(args):
    from shrimp_tpu_torch.io import fastx
    for rec in fastx.iter_reads(args[0], fastq=True):
        print(f">{rec.name}\n{rec.seq}")
    return 0


def cmd_extractseq(args):
    from shrimp_tpu_torch.io import fastx
    path, name = args[0], args[1]
    for rec in fastx.iter_reads(path):
        if rec.name == name:
            print(f">{rec.name}\n{rec.seq}")
            return 0
    sys.stderr.write(f"error: sequence [{name}] not found\n")
    return 1


def cmd_subsequence(args):
    from shrimp_tpu_torch.io import fastx
    path, name = args[0], args[1]
    start, end = int(args[2]), int(args[3])
    for rec in fastx.iter_reads(path, fastq=False):
        if rec.name == name:
            print(f">{name}:{start}-{end}")
            print(rec.seq[start - 1:end])
            return 0
    sys.stderr.write(f"error: contig [{name}] not found\n")
    return 1


def cmd_getcontigs(args):
    from shrimp_tpu_torch.io import fastx
    for rec in fastx.iter_reads(args[0], fastq=False):
        print(f"{rec.name}\t{len(rec.seq)}")
    return 0


def cmd_splittigs(args):
    from shrimp_tpu_torch.io import fastx
    for rec in fastx.iter_reads(args[0], fastq=False):
        with open(rec.name + ".fa", "w") as fh:
            fh.write(f">{rec.name}\n")
            for i in range(0, len(rec.seq), 70):
                fh.write(rec.seq[i:i + 70] + "\n")
        sys.stderr.write(f"wrote {rec.name}.fa\n")
    return 0


def cmd_mergepairfiles(args):
    fastq = False
    if args and args[0] == "-Q":
        fastq = True
        args = args[1:]
    f1, f2 = _open(args[0]), _open(args[1])
    n = 4 if fastq else 2
    while True:
        r1 = [f1.readline() for _ in range(n)]
        r2 = [f2.readline() for _ in range(n)]
        if not r1[0] or not r2[0]:
            break
        sys.stdout.write("".join(r1) + "".join(r2))
    return 0


def cmd_findpairs(args):
    fastq = False
    if args and args[0] == "-Q":
        fastq = True
        args = args[1:]
    suf1, suf2, path = args[0], args[1], args[2]
    from shrimp_tpu_torch.io import fastx
    by_root: dict[str, dict[str, object]] = {}
    order: list[str] = []
    for rec in fastx.iter_reads(path, fastq=fastq):
        root = None
        side = None
        if rec.name.endswith(suf1):
            root, side = rec.name[:-len(suf1)], 0
        elif rec.name.endswith(suf2):
            root, side = rec.name[:-len(suf2)], 1
        else:
            continue
        slot = by_root.setdefault(root, {})
        if not slot:
            order.append(root)
        slot[side] = rec
    for root in order:
        slot = by_root[root]
        if 0 in slot and 1 in slot:
            for rec in (slot[0], slot[1]):
                if fastq:
                    print(f"@{rec.name}\n{rec.seq}\n+\n{rec.qual or ''}")
                else:
                    print(f">{rec.name}\n{rec.seq}")
    return 0


def cmd_extractunmapped(args):
    seen = False
    for line in _open(args[0]):
        if line.startswith("#UNMAPPED READS:"):
            seen = True
        if seen and not line.startswith("#"):
            print(line.strip())
    return 0


def cmd_basicstats(args):
    from shrimp_tpu_torch.io import legacy
    n = 0
    matched = set()
    scores = []
    for rec in legacy.iter_records(args[0]):
        if isinstance(rec, str):
            continue
        n += 1
        matched.add(rec.read)
        scores.append(rec.score)
    print(f"alignments: {n}")
    print(f"reads with alignments: {len(matched)}")
    if scores:
        print(f"mean score: {sum(scores) / len(scores):.2f}")
    return 0


def cmd_tophits(args):
    from shrimp_tpu_torch.io import legacy
    k = int(args[0])
    best: dict[str, list] = {}
    order: list[str] = []
    for path in args[1:]:
        for rec in legacy.iter_records(path):
            if isinstance(rec, str):
                continue
            lst = best.setdefault(rec.read, [])
            if not lst:
                order.append(rec.read)
            lst.append(rec)
    print(legacy.format_line())
    for name in order:
        lst = sorted(best[name], key=lambda r: -r.score)[:k]
        for rec in lst:
            print(f">{rec.read}\t{rec.contig}\t"
                  f"{'-' if rec.revcmpl else '+'}\t{rec.genome_start}\t"
                  f"{rec.genome_end}\t{rec.read_start}\t{rec.read_end}\t"
                  f"{rec.read_length}\t{rec.score}\t{rec.edit}\t")
    return 0


def cmd_findseq(args):
    """findseq.py: 1-based overlapping matches in a one-contig FASTA."""
    contig_lines = []
    seen = False
    for line in _open(args[0]):
        if line.startswith(">"):
            if seen:
                sys.stderr.write(
                    "ERROR: this only supports one contig per file\n")
                return 1
            seen = True
        else:
            contig_lines.append(line.strip())
    contig = "".join(contig_lines).upper()
    token = args[1].upper()
    positions = []
    start = 0
    while start < len(contig):
        pos = contig.find(token, start)
        if pos == -1:
            break
        positions.append(pos + 1)
        start = pos + 1
    if not positions:
        print("Sequence Not Found.")
    else:
        print("Sequence Found at Positions:")
        for pos in positions:
            print("    " + str(pos))
    return 0


def cmd_clippedmappings(args):
    """get_clipped_mappings.py: for SAM records whose CIGAR hard-clips,
    rebuild a FASTQ record from the 15th column (seq tag) and the 14th
    column (quals tag), exactly as the reference indexes them."""
    for line in sys.stdin:
        cols = line.split()
        if line[0] == "@":
            continue
        if "H" in cols[5]:
            print("@" + cols[0])
            print(":".join(cols[14].split(":")[2:]) + "\n+")
            print(":".join(cols[13].split(":")[2:]))
    return 0


_COMMANDS = {
    "cs2ls": cmd_cs2ls,
    "colourise": cmd_colourise,
    "revcmpl": cmd_revcmpl,
    "fastq2fasta": cmd_fastq2fasta,
    "extractseq": cmd_extractseq,
    "subsequence": cmd_subsequence,
    "getcontigs": cmd_getcontigs,
    "splittigs": cmd_splittigs,
    "mergepairfiles": cmd_mergepairfiles,
    "findpairs": cmd_findpairs,
    "extractunmapped": cmd_extractunmapped,
    "basicstats": cmd_basicstats,
    "tophits": cmd_tophits,
    "findseq": cmd_findseq,
    "clippedmappings": cmd_clippedmappings,
}


def main(argv=None) -> int:
    argv = list(sys.argv if argv is None else argv)
    if len(argv) < 2 or argv[1] not in _COMMANDS:
        sys.stderr.write(__doc__)
        return 1
    return _COMMANDS[argv[1]](argv[2:])


if __name__ == "__main__":
    sys.exit(main())
