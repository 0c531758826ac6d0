"""shrimp_var — SNV/indel/crossover variant lister (shrimp_var/shrimp_var.c).

Walks editstrings of legacy SHRiMP/probcalc output and emits per-alignment
variant records:

    readname <TAB> editstring <TAB> contigstart <TAB> nsnp nins ndel <TAB>
    s-<base>-<pos> / i-<bases>-<pos> / d-<len>-<pos> entries (tab-separated)

Reverse-strand alignments are walked right-to-left with complemented bases
(editstr_to_stats, shrimp_var.c:347-483), reproducing the reference
character-for-character — including its quirk that a trailing deletion at
the end of the walk is not flushed.

Usage:
    python -m shrimp_tpu_torch.tools.shrimp_var (-v|-p|-r) [-R] [-o out] files...
"""

from __future__ import annotations

import sys

_COMP = {"A": "T", "T": "A", "C": "G", "G": "C"}


def editstr_to_stats(editstr: str, readloc: int, is_forward: bool) -> str:
    """Direct transliteration of editstr_to_stats (shrimp_var.c:347-483),
    including its fallthrough quirks (deletions finalize on the next
    non-'-' character, trailing deletions are never flushed, SNPs fire
    before the deletion state machine).  Returns the
    '\\t<n> <n> <n>\\t<entries>' tail."""
    inins = indel = 0
    num = ""
    nr_snps = nr_ins = nr_dels = 0
    delsize = 0
    ins: list[str] = []
    out: list[str] = []
    slen = len(editstr)
    for i in range(slen):
        ech = editstr[i] if is_forward else editstr[slen - i - 1]
        if ech.isdigit():
            num += ech
        elif num:
            readloc += int(num) if is_forward else int(num[::-1])
            num = ""

        isnuc = ech in "ACTG"

        # SNP (note: fires regardless of a pending deletion, as in the C)
        if not inins and isnuc:
            nr_snps += 1
            base = ech if is_forward else _COMP[ech]
            out.append(f"s-{base}-{readloc}\t")
            readloc += 1
            continue

        # deletions ('-' runs = gaps in the tag)
        if ech == "-" and indel:
            delsize += 1
            continue
        elif ech == "-":
            indel = 1
            delsize = 1
        elif indel:
            indel = 0
            out.append(f"d-{delsize}-{readloc}\t")
            nr_dels += 1
            readloc += delsize
            delsize = 0

        # insertions (parenthesised reference-gap letters)
        if (is_forward and ech == "(") or (not is_forward and ech == ")"):
            inins = 1
            ins = []
        elif isnuc and inins:
            ins.append(ech)
            continue
        elif (is_forward and ech == ")") or (not is_forward and ech == "("):
            nr_ins += 1
            letters = "".join(ins) if is_forward \
                else "".join(_COMP[c] for c in ins)
            out.append(f"i-{letters}-{readloc - 1}\t")
            inins = 0
            continue

    return f"\t{nr_snps} {nr_ins} {nr_dels}\t" + "".join(out)


def main(argv=None) -> int:
    import getopt
    argv = list(sys.argv if argv is None else argv)
    try:
        opts, files = getopt.gnu_getopt(argv[1:], "Ro:rpv")
    except getopt.GetoptError as exc:
        sys.stderr.write(f"error: {exc}\n")
        return 1
    out = sys.stdout
    rflag = False
    input_type = None
    for o, a in opts:
        if o == "-R":
            rflag = True
        elif o == "-o":
            out = open(a, "w")
        elif o in ("-r", "-p", "-v"):
            input_type = o
    if input_type is None or not files:
        sys.stderr.write("usage: shrimp_var (-v|-p|-r) [-R] [-o outfile] "
                         "results_file...\n")
        return 1
    sys.stderr.write(
        "#assuming format:\n>readname contigname strand contigstart "
        "contigend readstart readend readlength score editstring "
        f"{'readsequence ' if rflag else ''}normodds pgenome pchance\n")
    for path in files:
        fh = sys.stdin if path == "-" else open(path)
        for line in fh:
            if line.startswith("#"):
                continue
            f = line.rstrip("\n").split("\t")
            if len(f) < 10:
                continue
            readname = f[0]
            strand = f[2]
            contigstart = int(f[3])
            edit = f[9]
            out.write(f"{readname}\t{edit}\t{contigstart}")
            out.write(editstr_to_stats(edit, contigstart, strand == "+"))
            out.write("\n")
        if fh is not sys.stdin:
            fh.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
