"""Legacy SHRiMP output format — writer + parser (common/output.c, input.c).

The legacy record is a tab-separated line

    >readname contigname strand contigstart contigend readstart readend
    readlength score editstring [readsequence] [normodds pgenome pchance]

with Phil Edit Strings (output.c:44-58): <number> run of matches, letter =
mismatch (tag letter), (letters) = gap in the reference, '-' = one-base gap
in the tag, 'x' = crossover.
"""

from __future__ import annotations

from dataclasses import dataclass


def alignment_edit_string(dbalign: str, qralign: str) -> str:
    """Port of alignment_edit_string (common/output.c:60-122)."""
    out: list[str] = []
    consec = 0
    refgap = False
    n = len(dbalign)
    for i in range(n + 1):
        dc = dbalign[i] if i < n else "\0"
        if i != n and dc == qralign[i] and dc != "-":
            consec += 1
            continue
        if refgap and (consec != 0 or dc != "-"):
            out.append(")")
            refgap = False
        if consec != 0:
            out.append(str(consec))
            consec = 0
        if i == n:
            break
        if dc == "-":
            if qralign[i].islower():
                out.append("x")
            if not refgap:
                out.append("(")
            out.append(qralign[i].upper())
            refgap = True
            continue
        if qralign[i] == "-":
            out.append("-")
        else:
            if dbalign[i] == qralign[i].upper():
                out.append("x")
                consec += 1
            elif qralign[i].islower():
                out.append("x")
                out.append(qralign[i].upper())
            else:
                out.append(qralign[i])
    return "".join(out)


@dataclass
class EditCounts:
    matches: int = 0
    mismatches: int = 0
    insertions: int = 0
    deletions: int = 0
    crossovers: int = 0


def reverse_alignment_edit_string(editstr: str) -> str:
    """Reverse + complement an edit string (reverse_alignment_edit_string,
    gmapper/output.c:84-122): digit runs keep their order, letters
    complement, parens flip, '-'/'x' pass through."""
    comp = {"A": "T", "C": "G", "G": "C", "T": "A",
            "(": ")", ")": "(", "-": "-", "x": "x"}
    n = len(editstr)
    out = []
    i = 0
    while i < n:
        c = editstr[n - 1 - i]
        if c.isdigit():
            j = i + 1
            while j < n and editstr[n - 1 - j].isdigit():
                j += 1
            j -= 1
            out.append(editstr[n - 1 - j:n - i])
            i = j + 1
        else:
            out.append(comp[c])
            i += 1
    return "".join(out)


def editstr_to_counts(editstr: str) -> EditCounts:
    """Port of editstr_to_sfr (common/input.c:58-137).

    NB the reference's field naming swaps relative to SAM: its "insertions"
    are '-' columns (gap in the tag) and "deletions" the parenthesised
    reference-gap letters."""
    c = EditCounts()
    num = ""
    inparen = False
    for ch in editstr + "\0":
        if inparen:
            if ch == ")":
                inparen = False
            elif ch != "\0":
                c.deletions += 1
            continue
        if not ch.isdigit() and num:
            c.matches += int(num)
            num = ""
        if ch == "-":
            c.insertions += 1
        elif ch == "(":
            inparen = True
        elif ch in "Xx":
            c.crossovers += 1
        elif ch in "ACGTNacgtn":
            c.mismatches += 1
        elif ch.isdigit():
            num += ch
    return c


def edit_to_alignment(editstr: str, reference_window: str | None = None
                      ) -> tuple[str, str]:
    """Reconstruct (dbalign-shape, qralign-shape) column classes from an
    editstring; letters unknown without the reference are left as the
    editstring letters / '?'.  Used by shrimp_var-style consumers."""
    db: list[str] = []
    qr: list[str] = []
    num = ""
    i = 0
    while i <= len(editstr):
        ch = editstr[i] if i < len(editstr) else "\0"
        if ch.isdigit():
            num += ch
            i += 1
            continue
        if num:
            db.extend("=" * int(num))
            qr.extend("=" * int(num))
            num = ""
        if ch == "\0":
            break
        if ch == "(":
            j = editstr.index(")", i)
            for letter in editstr[i + 1:j]:
                db.append("-")
                qr.append(letter)
            i = j + 1
            continue
        if ch == "-":
            db.append("?")
            qr.append("-")
        elif ch in "Xx":
            pass            # crossover marker: no column of its own
        else:
            db.append("?")
            qr.append(ch)
        i += 1
    return "".join(db), "".join(qr)


@dataclass
class LegacyRecord:
    read: str
    contig: str
    revcmpl: bool
    genome_start: int          # 1-based
    genome_end: int
    read_start: int            # 1-based
    read_end: int
    read_length: int
    score: int
    edit: str
    read_seq: str | None = None
    normodds: float | None = None
    pgenome: float | None = None
    pchance: float | None = None


DEFAULT_FIELDS = ["readname", "contigname", "strand", "contigstart",
                  "contigend", "readstart", "readend", "readlength",
                  "score", "editstring"]


def parse_format_line(line: str) -> list[str]:
    assert line.startswith("#FORMAT:")
    return line[len("#FORMAT:"):].split()


def parse_line(line: str, fields: list[str] | None = None) -> LegacyRecord:
    """input_parseline (common/input.c:150-280) for one record line."""
    fields = fields or DEFAULT_FIELDS
    vals = line.rstrip("\n").split("\t")
    if len(vals) == 1:
        vals = line.rstrip("\n").split()
    d = dict(zip(fields, vals))
    name = d["readname"]
    if name.startswith(">"):
        name = name[1:]
    rec = LegacyRecord(
        read=name,
        contig=d.get("contigname", ""),
        revcmpl=d.get("strand", "+") == "-",
        genome_start=int(d.get("contigstart", 0)),
        genome_end=int(d.get("contigend", 0)),
        read_start=int(d.get("readstart", 0)),
        read_end=int(d.get("readend", 0)),
        read_length=int(d.get("readlength", 0)),
        score=int(d.get("score", 0)),
        edit=d.get("editstring", ""))
    if "readsequence" in d:
        rec.read_seq = d["readsequence"]
    for k in ("normodds", "pgenome", "pchance"):
        if k in d:
            setattr(rec, k, float(d[k]))
    return rec


def iter_records(path: str):
    """Yield (LegacyRecord | unmapped name str) from a legacy output file."""
    import gzip
    op = gzip.open if path.endswith(".gz") else open
    fields = DEFAULT_FIELDS
    with op(path, "rt") as fh:
        for line in fh:
            line = line.rstrip("\n")
            if not line:
                continue
            if line.startswith("#FORMAT:"):
                fields = parse_format_line(line)
                continue
            if line.startswith("#"):
                continue
            if "\t" not in line and line.startswith(">"):
                yield line[1:]           # unmapped read marker
                continue
            yield parse_line(line, fields)


def format_line(include_read: bool = False) -> str:
    s = ("#FORMAT: readname contigname strand contigstart contigend "
         "readstart readend readlength score editstring")
    if include_read:
        s += " readsequence"
    return s


def output_pretty(*, genome_plane, genome_len: int, genome_start0: int,
                  gmapped: int, read_start0: int, rmapped: int,
                  read_len: int, dbalign: str, qralign: str,
                  revcmpl: bool, colour_space: bool,
                  read_text_cs: str | None = None) -> str:
    """Port of output_pretty (common/output.c:125-267): the G/match/R (or
    G/match/T/R in colour space) block with flanking genome context.

    genome_plane: int8 codes of the strand-appropriate contig plane;
    read_text_cs: primer+colours text for the CS R: line."""
    from shrimp_tpu_torch import dna

    genome_start = genome_start0
    genome_end = genome_start0 + gmapped - 1
    if revcmpl:
        idx_start = genome_len - genome_end - 1
        idx_end = genome_len - genome_start - 1
    else:
        idx_start = genome_start
        idx_end = genome_end
    read_start = read_start0
    read_end = read_start0 + rmapped - 1

    gpre = lspre = mpre = ""
    gpost = lspost = ""
    if read_start > 0:
        chars = []
        for j in range(read_start):
            if genome_start + j > read_start:
                chars.append(chr(dna.LS_CHARS[
                    int(genome_plane[genome_start - read_start + j]) & 15]))
            else:
                chars.append("-")
        gpre = "".join(chars)
        lspre = "-" * read_start
        mpre = " " * read_start
    if read_end < read_len - 1:
        chars = []
        for j in range(read_len - read_end - 1):
            if genome_end + 1 + j < genome_len:
                chars.append(chr(dna.LS_CHARS[
                    int(genome_plane[genome_end + 1 + j]) & 15]))
            else:
                chars.append("-")
        gpost = "".join(chars)
        lspost = "-" * (read_len - read_end - 1)

    lines = []
    g_first = idx_end + 1 if revcmpl else idx_start + 1
    g_last = idx_start + 1 if revcmpl else idx_end + 1
    lines.append(f"G: {g_first:10d}    {gpre}{dbalign}{gpost}    "
                 f"{g_last:<10d}")
    marks = []
    for dc, qc in zip(dbalign, qralign):
        if dc == qc and dc != "-":
            marks.append("|")
        elif dc == qc.upper():
            marks.append("X")
        elif qc.islower():
            marks.append("x")
        else:
            marks.append(" ")
    lines.append(f"{'':16s} {mpre}" + "".join(marks))
    if colour_space:
        lines.append(f"T: {'':10s}    {lspre}{qralign}{lspost}")
        rchars = [read_text_cs[0]]
        rest = read_text_cs[1:]
        ri = 0
        for j in range(read_start):
            rchars.append(rest[ri])
            ri += 1
        j = 0
        while ri < len(rest):
            if j < len(qralign) and qralign[j] == "-":
                rchars.append("-")
            else:
                rchars.append(rest[ri])
                ri += 1
            if j < len(qralign):
                j += 1
        lines.append(f"R: {read_start + 1:10d}   " + "".join(rchars)
                     + f"    {read_end + 1:<10d}")
    else:
        lines.append(f"R: {read_start + 1:10d}    {lspre}{qralign}{lspost}"
                     f"    {read_end + 1:<10d}")
    return "\n".join(lines) + "\n"


def output_normal(readname: str, contigname: str, *, genome_start0: int,
                  gmapped: int, read_start0: int, rmapped: int,
                  read_length: int, score: int, dbalign: str, qralign: str,
                  genome_len: int, revcmpl: bool,
                  read_seq: str | None = None) -> str:
    """Port of output_normal (common/output.c:285-352); coordinates arrive
    0-based in the reverse frame for revcmpl hits and are flipped here."""
    genome_end = genome_start0 + gmapped - 1
    if revcmpl:
        idx_start = genome_len - genome_end - 1
        idx_end = genome_len - genome_start0 - 1
    else:
        idx_start = genome_start0
        idx_end = genome_end
    edit = alignment_edit_string(dbalign, qralign)
    line = (f">{readname}\t{contigname}\t{'-' if revcmpl else '+'}"
            f"\t{idx_start + 1}\t{idx_end + 1}\t{read_start0 + 1}"
            f"\t{read_start0 + rmapped - 1 + 1}\t{read_length}\t{score}"
            f"\t{edit}")
    # the reference always emits the readsequence column separator, with an
    # empty value when -R is off (output.c:343-345)
    line += f"\t{read_seq if read_seq is not None else ''}"
    return line
