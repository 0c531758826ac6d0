"""SAM record construction and emission.

Mirrors `gmapper/output.c`: `make_cigar` (:16-65), coordinate conversion for
reverse-strand hits (:625-640), seq/qual orientation fixes (:544-566), FLAG
assembly (:663-675), and the AS/Z*/NM optional-field block (:686-716) that the
distributed merge (mergesam) consumes.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from shrimp_tpu_torch import mapq

_COMPL = str.maketrans("ACGTacgtNnRrYySsWwKkMmBbVvDdHh.-",
                       "TGCAtgcaNnYyRrSsWwMmKkVvBbHhDd.-")


def revcomp_text(s: str) -> str:
    """reverse() (output.c:165-220): IUPAC-aware reverse complement."""
    return s.translate(_COMPL)[::-1]


def clean_seq_text(seq: str) -> str:
    """IUPAC codes (except N) become N; lowercase uppercased
    (output.c:316-345)."""
    out = []
    for c in seq.upper():
        out.append(c if c in "ACGTN" else "N")
    return "".join(out)


def make_cigar(read_start_1: int, read_end_1: int, read_length: int,
               qralign: str, dbalign: str) -> list[tuple[int, str]]:
    """CIGAR from alignment strings (make_cigar, output.c:16-65).
    read_start_1/read_end_1 are 1-based inclusive."""
    cig: list[tuple[int, str]] = []
    if read_start_1 > 1:
        cig.append((read_start_1 - 1, "S"))
    i, n = 0, len(qralign)
    while i < n:
        if qralign[i] == "-":
            length = 0
            while i + length < n and qralign[i + length] == "-":
                length += 1
            op = "D"
        elif dbalign[i] == "-":
            length = 0
            while i + length < n and dbalign[i + length] == "-":
                length += 1
            op = "I"
        else:
            length = 0
            while (i + length < n and dbalign[i + length] != "-"
                   and qralign[i + length] != "-"):
                length += 1
            op = "M"
        cig.append((length, op))
        i += length
    if read_end_1 != read_length:
        cig.append((read_length - read_end_1, "S"))
    return cig


def cigar_string(cig: list[tuple[int, str]]) -> str:
    return "".join(f"{n}{op}" for n, op in cig) if cig else "*"


def cigar_from_ops(ops, read_start_1: int, read_end_1: int,
                   read_length: int) -> list[tuple[int, str]]:
    """CIGAR from a traceback op array (sw_full.OP_*): OP_MATCH->M,
    OP_INS (genome char vs read gap)->D, OP_DEL (read char vs genome
    gap)->I — the same mapping make_cigar derives from alignment strings."""
    cig: list[tuple[int, str]] = []
    if read_start_1 > 1:
        cig.append((read_start_1 - 1, "S"))
    op_char = {0: "M", 1: "D", 2: "I"}
    run_op = None
    run_len = 0
    for o in ops:
        c = op_char[int(o)]
        if c == run_op:
            run_len += 1
        else:
            if run_op is not None:
                cig.append((run_len, run_op))
            run_op, run_len = c, 1
    if run_op is not None:
        cig.append((run_len, run_op))
    if read_end_1 != read_length:
        cig.append((read_length - read_end_1, "S"))
    return cig


@dataclass
class SamRecord:
    qname: str
    flag: int = 4
    rname: str = "*"
    pos: int = 0
    mapq: int = 0
    cigar: str = "*"
    rnext: str = "*"
    pnext: int = 0
    tlen: int = 0
    seq: str = "*"
    qual: str = "*"
    tags: list[str] = field(default_factory=list)

    def line(self) -> str:
        base = (f"{self.qname}\t{self.flag}\t{self.rname}\t{self.pos}\t"
                f"{self.mapq}\t{self.cigar}\t{self.rnext}\t{self.pnext}\t"
                f"{self.tlen}\t{self.seq}\t{self.qual}")
        if self.tags:
            base += "\t" + "\t".join(self.tags)
        return base


def unaligned_record(name: str, seq: str, qual: str | None,
                     qual_delta: int = 33) -> SamRecord:
    """Unmapped-read record.  NB: the reference prints the quality string RAW
    (no +33 rescale) for unmapped records (hit_output, output.c:417-421) —
    qual_delta is accepted for signature parity but unused."""
    rec = SamRecord(qname=name, flag=0x4, seq=clean_seq_text(seq))
    if qual is not None:
        rec.qual = qual
    return rec


def rescale_qual(qual: str, qual_delta: int) -> str:
    """Requantize quality string to PHRED+33 (output.c:560-566)."""
    if qual_delta == 33:
        return qual
    return "".join(chr(ord(c) - qual_delta + 33) for c in qual)


def sam_header(contig_names: list[str], contig_lens: list[int],
               cmdline: str = "", extra: list[str] | None = None) -> list[str]:
    """SAM header block (gmapper.c:2967-3012)."""
    lines = ["@HD\tVN:1.0\tSO:unsorted"]
    for name, length in zip(contig_names, contig_lens):
        lines.append(f"@SQ\tSN:{name}\tLN:{length}")
    pg = "@PG\tID:shrimp_tpu\tVN:0.1.0"
    if cmdline:
        pg += f"\tCL:{cmdline}"
    lines.append(pg)
    if extra:
        lines.extend(extra)
    return lines


def aligned_record_from_ops(*, name: str, seq_text: str, qual: str | None,
                            contig_name: str, contig_len: int,
                            genome_start0: int, read_start0: int,
                            rmapped: int, gmapped: int,
                            insertions: int, deletions: int, mismatches: int,
                            ops, reverse_strand: bool,
                            score_full: int, mapq_v: int,
                            z0: float | None = None, z1: float | None = None,
                            qual_delta: int = 33,
                            read_len: int | None = None) -> SamRecord:
    """aligned_record built from a traceback op array instead of alignment
    strings (fast path — no string rendering)."""
    read_length = read_len if read_len is not None else len(seq_text)
    read_start_1 = read_start0 + 1
    read_end_1 = read_start_1 + rmapped - 1
    cig = cigar_from_ops(ops, read_start_1, read_end_1, read_length)
    seq = clean_seq_text(seq_text)
    if not reverse_strand:
        pos = genome_start0 + 1
    else:
        right_most = contig_len - genome_start0
        pos = right_most - (gmapped - 1)
        seq = revcomp_text(seq)
        cig = cig[::-1]
    qual_out = "*"
    if qual is not None:
        qual_out = qual[::-1] if reverse_strand else qual
        qual_out = rescale_qual(qual_out, qual_delta)
    flag = 0x10 if reverse_strand else 0
    tags = [f"AS:i:{score_full}"]
    if z0 is not None and z1 is not None:
        tags.append(f"Z0:i:{mapq.double_to_neglog(z0)}")
        tags.append(f"Z1:i:{mapq.double_to_neglog(z1)}")
    tags.append(f"NM:i:{mismatches + deletions + insertions}")
    return SamRecord(
        qname=name, flag=flag, rname=contig_name, pos=pos, mapq=mapq_v,
        cigar=cigar_string(cig), seq=seq, qual=qual_out, tags=tags)


def unaligned_record_cs(name: str, seq_text: str,
                        qual_raw: str | None) -> SamRecord:
    """Unmapped colour-space record: SEQ/QUAL are '*'; the raw colour read
    and its qualities ride in CS:Z / CQ:Z (hit_output, output.c:441-451)."""
    rec = SamRecord(qname=name, flag=0x4)
    rec.tags.append(f"CQ:Z:{qual_raw if qual_raw is not None else '*'}")
    rec.tags.append(f"CS:Z:{seq_text}")
    return rec


def bfast_quals(qual_raw: str, qralign: str, read_start0: int,
                rmapped: int, reverse_strand: bool) -> str:
    """Bflag colour-quality blend (hit_output, output.c:585-615): adjacent
    colour qvs combine into base qvs, lowercase (crossover) columns zeroing
    or differencing their contribution; clamped to ['"', '`']."""
    rl = rmapped
    qual = [ord(qual_raw[i + read_start0]) for i in range(rl)]
    for i in range(rl - 1):
        first_mm = qralign[i] > "`"
        second_mm = qralign[i + 1] > "`"
        if first_mm and second_mm:
            bq = 0
        elif first_mm:
            bq = qual[i + 1] - qual[i]
        elif second_mm:
            bq = qual[i] - qual[i + 1] + 33
        else:
            bq = qual[i] + qual[i + 1] + 10 - 33
        bq = min(ord("`"), max(bq, ord('"')))
        qual[i] = bq
    out = "".join(chr(c) for c in qual)
    if reverse_strand:
        out = out[::-1]
    return out


def aligned_record_cs(*, name: str, seq_text: str, qual_raw: str | None,
                      contig_name: str, contig_len: int,
                      genome_start0: int, read_start0: int,
                      rmapped: int, gmapped: int,
                      insertions: int, deletions: int, mismatches: int,
                      ops, qralign: str, qual33: str | None,
                      crossovers: int, reverse_strand: bool,
                      bfast: bool = False,
                      score_full: int, mapq_v: int,
                      z0: float | None = None, z1: float | None = None,
                      read_len: int | None = None) -> SamRecord:
    """One mapped colour-space SAM record (hit_output, output.c:478-730).

    SEQ is the called letter sequence (qralign sans gaps, upper-cased);
    clipped colours are hard-clipped (S->H, :578-585); QUAL is the posterior
    base-quality string from post_sw (already PHRED+33), plainly reversed on
    the reverse strand; CQ/CS carry the raw colour data and CM/XX the
    crossover count and raw alignment string."""
    read_start_1 = read_start0 + 1
    read_end_1 = read_start_1 + rmapped - 1
    cig = cigar_from_ops([int(o) & 3 for o in ops], read_start_1, read_end_1,
                         read_len)
    cig = [(n, "H" if op == "S" else op) for n, op in cig]
    seq = "".join(c for c in qralign.upper() if c != "-")
    qual_out = "*"
    if bfast and qual_raw is not None:
        # bfast mode applies its own reversal inside the helper
        qual_out = bfast_quals(qual_raw, qralign, read_start0, rmapped,
                               reverse_strand)
    elif qual33 is not None:
        qual_out = qual33
    if not reverse_strand:
        pos = genome_start0 + 1
    else:
        right_most = contig_len - genome_start0
        pos = right_most - (gmapped - 1)
        seq = revcomp_text(seq)
        cig = cig[::-1]
        if qual_out != "*" and not bfast:
            qual_out = qual_out[::-1]
    tags = [f"AS:i:{score_full}"]
    if z0 is not None and z1 is not None:
        tags.append(f"Z0:i:{mapq.double_to_neglog(z0)}")
        tags.append(f"Z1:i:{mapq.double_to_neglog(z1)}")
    tags.append(f"NM:i:{mismatches + deletions + insertions}")
    if qual_raw is not None:
        tags.append(f"CQ:Z:{qual_raw}")
    tags.append(f"CS:Z:{seq_text}")
    tags.append(f"CM:i:{crossovers}")
    tags.append(f"XX:Z:{qralign}")
    flag = 0x10 if reverse_strand else 0
    return SamRecord(
        qname=name, flag=flag, rname=contig_name, pos=pos, mapq=mapq_v,
        cigar=cigar_string(cig), seq=seq, qual=qual_out, tags=tags)


def aligned_record(*, name: str, seq_text: str, qual: str | None,
                   contig_name: str, contig_len: int,
                   genome_start0: int, read_start0: int,
                   rmapped: int, gmapped: int,
                   insertions: int, deletions: int, mismatches: int,
                   qralign: str, dbalign: str, reverse_strand: bool,
                   score_full: int, mapq_v: int,
                   z0: float | None = None, z1: float | None = None,
                   qual_delta: int = 33,
                   read_len: int | None = None) -> SamRecord:
    """One mapped unpaired letter-space SAM record (hit_output SAM branch,
    output.c:297-776).

    genome_start0/read_start0 are 0-based window/contig-frame coordinates;
    when reverse_strand, genome_start0 is in the reverse-complement frame and
    gets converted (output.c:625-634).
    """
    read_length = read_len if read_len is not None else len(seq_text)
    read_start_1 = read_start0 + 1
    read_end_1 = read_start_1 + rmapped - 1

    cig = make_cigar(read_start_1, read_end_1, read_length, qralign, dbalign)

    # seq: cleaned read text with the aligned region replaced by qralign
    # letters (output.c:447-543); qralign letters come from the read itself,
    # so the net effect is clean_seq_text of the read
    seq = clean_seq_text(seq_text)

    if not reverse_strand:
        pos = genome_start0 + 1
    else:
        right_most = contig_len - genome_start0
        pos = right_most - (gmapped - 1)
        seq = revcomp_text(seq)
        cig = cig[::-1]

    qual_out = "*"
    if qual is not None:
        qual_out = qual[::-1] if reverse_strand else qual
        qual_out = rescale_qual(qual_out, qual_delta)

    flag = 0x10 if reverse_strand else 0

    tags = [f"AS:i:{score_full}"]
    if z0 is not None and z1 is not None:
        tags.append(f"Z0:i:{mapq.double_to_neglog(z0)}")
        tags.append(f"Z1:i:{mapq.double_to_neglog(z1)}")
    tags.append(f"NM:i:{mismatches + deletions + insertions}")

    return SamRecord(
        qname=name, flag=flag, rname=contig_name, pos=pos, mapq=mapq_v,
        cigar=cigar_string(cig), seq=seq, qual=qual_out, tags=tags)
