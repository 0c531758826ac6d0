"""shrimp2sam — legacy SHRiMP output -> SAM converter (shrimp2sam/shrimp2sam.c).

Synthesises CIGAR strings from editstrings (edit2cigar, common/util.c:
1178-1250), reverse-complements the read text for '-' strand hits, and emits
minimal SAM records with AS tags.

Usage:
    python -m shrimp_tpu_torch.tools.shrimp2sam shrimp_output reads.fa genome.fa...
"""

from __future__ import annotations

import sys

VERSION = "0.1.0"

START, MATCH, MISMATCH, REF_GAP, READ_GAP = range(5)


def _finish(mode: int, count: int) -> str:
    if mode in (MATCH, MISMATCH):
        return f"{count}M"
    if mode == REF_GAP:
        return f"{count}I"
    if mode == READ_GAP:
        return f"{count}D"
    return ""


def edit2cigar(edit: str, read_start: int, read_end: int,
               read_length: int) -> str:
    """Port of edit2cigar (common/util.c:1178-1250); read_start/end are the
    0-based values stored by input_parseline."""
    res = []
    if read_start != 0:
        res.append(f"{read_start}S")
    mode = START
    count = 0
    last = 0
    for ch in edit:
        if ch.isdigit():
            if mode != MATCH:
                if mode == MISMATCH:
                    last += count
                else:
                    res.append(_finish(mode, count + last))
                    last = 0
                count = 0
            count = count * 10 + int(ch)
            mode = MATCH
        elif ch == "(":
            res.append(_finish(mode, count + last))
            count = last = 0
            mode = REF_GAP
        elif ch in "GATC":
            if mode == REF_GAP:
                count += 1
            else:
                if mode != MISMATCH:
                    if mode == MATCH:
                        last += count
                    else:
                        res.append(_finish(mode, count + last))
                        last = 0
                    count = 0
                count += 1
                mode = MISMATCH
        elif ch == ")":
            res.append(_finish(mode, count + last))
            count = last = 0
            mode = START
        elif ch == "-":
            if mode != READ_GAP:
                res.append(_finish(mode, count + last))
                count = last = 0
            count += 1
            mode = READ_GAP
        elif ch == "x":
            last += count
            count = 0
    res.append(_finish(mode, count + last))
    if read_end + 1 != read_length:
        res.append(f"{read_length - read_end - 1}S")
    return "".join(res)


def reverse_cigar(cigar: str) -> str:
    """Reverse the op order of a CIGAR string (shrimp2sam.c:105-128)."""
    parts = []
    num = ""
    for ch in cigar:
        num += ch
        if not ch.isdigit():
            parts.append(num)
            num = ""
    return "".join(reversed(parts))


def revcomp(s: str) -> str:
    return s.translate(str.maketrans("ACGTacgtNn", "TGCAtgcaNn"))[::-1]


def main(argv=None) -> int:
    argv = list(sys.argv if argv is None else argv)
    args = argv[1:]
    if len(args) < 3:
        sys.stderr.write("usage: shrimp2sam shrimp_output_file reads_file "
                         "genome_file1 [genome_file2 ...]\n")
        return 1
    shrimp_file, reads_file = args[0], args[1]
    genome_files = args[2:]

    from shrimp_tpu_torch.io import fastx, legacy

    out = sys.stdout
    out.write("@HD\tVN:1\tSO:unsorted\n")
    contigs = []
    for gf in genome_files:
        for rec in fastx.iter_reads(gf, fastq=False):
            contigs.append((rec.name, len(rec.seq)))
    for nm, ln in contigs:
        out.write(f"@SQ\tSN:{nm}\tLN:{ln}\n")
    out.write(f"@PG\tID:shrimp2sam\tVN:{VERSION}\n")

    # the reference loads reads with its FASTA reader, so fastq reads are
    # simply absent from the cache and SEQ falls back to '*'
    reads = {}
    try:
        if not fastx.detect_fastq(reads_file):
            for rec in fastx.iter_reads(reads_file, fastq=False):
                reads[rec.name] = rec.seq
    except Exception:
        pass

    for rec in legacy.iter_records(shrimp_file):
        if isinstance(rec, str):
            continue
        seq = reads.get(rec.read, "*")
        if rec.revcmpl and seq != "*":
            seq = revcomp(seq)
        cigar = edit2cigar(rec.edit, rec.read_start - 1, rec.read_end - 1,
                           rec.read_length)
        if rec.revcmpl:
            cigar = reverse_cigar(cigar)
        out.write("\t".join([
            rec.read, "16" if rec.revcmpl else "0", rec.contig,
            str(rec.genome_start), "255", cigar, "*",
            str(rec.read_start - 1), "0", seq, "*",
            f"AS:i:{rec.score}"]) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
