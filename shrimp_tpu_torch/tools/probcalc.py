"""probcalc — legacy post-processor: pchance / pgenome / normodds
(probcalc/probcalc.c).

Per alignment of each read:
  * pchance — probability an equal-or-better alignment arises by chance in a
    genome of the given length (p_chance, :278-334): counts equally-scoring
    words via substitution/indel combinatorics (subCount/maxCount/minCount,
    :1225-1247) against 4^k, with a binomial approximation for small values.
  * pgenome — likelihood a true genomic source would diverge this much under
    estimated per-base rates (p_thissource, :391-436).
  * normodds = pgenome / pchance, normalised over the read's alignments.

Rates default to being estimated from each read's best alignment
(calc_rates, :337-389); -r/-g supply them; -G emits them.  Output ordering
replicates the reference's dynhash iteration (prepend chains, doubling
table, java-style string hash) so files are byte-comparable.

Usage:
    python -m shrimp_tpu_torch.tools.probcalc [-n cut] [-o cut] [-p cut]
        [-r e,s,i,m] [-s field] [-t top] [-m matches] [-G] [-R] [-S]
        total_genome_len results_file...
"""

from __future__ import annotations

import math
import sys

ALMOST_ZERO = 0.000000001
ALMOST_ONE = 0.999999999

SORT_PCHANCE, SORT_PGENOME, SORT_NORMODDS = 0, 1, 2

_FACT = [1.0, 1.0, 2.0, 6.0, 24.0, 120.0, 720.0, 5040.0, 40320.0, 362880.0,
         3628800.0, 39916800.0, 479001600.0, 6227020800.0, 87178291200.0,
         1307674368000.0, 20922789888000.0, 355687428096000.0,
         6402373705728000.0, 121645100408832000.0, 2432902008176640000.0]


def ls_factorial(n: int) -> float:
    if n <= 20:
        return math.log(_FACT[n])
    return math.log(math.sqrt(2 * math.pi * n)) + n * math.log(n / math.e)


def ls_choose(n: int, k: int) -> float:
    if k < 0 or k > n:
        return 0.0
    return ls_factorial(n) - (ls_factorial(k) + ls_factorial(n - k))


def fastlchoose(n: int, m: int) -> float:
    if m > n:
        return 0.0
    return math.lgamma(n + 1) - math.lgamma(n - m + 1) - math.lgamma(m + 1)


def fastchoose(n: int, m: int) -> float:
    if m > n:
        return 0.0
    return math.exp(fastlchoose(n, m))


def fastfact(n: int) -> float:
    return math.exp(math.lgamma(n + 1))


class Stats:
    """objBinsTable (probcalc.c:1186-1219): #ways to distribute obj objects
    into exactly bins non-empty ordered bins."""

    def __init__(self):
        self.maxlen = -1
        self.table: list[list[float]] = []

    def init(self, maxlen: int) -> None:
        if maxlen <= self.maxlen:
            return
        self.maxlen = maxlen
        t = [[0.0] * (maxlen + 1) for _ in range(maxlen + 1)]
        for obj in range(maxlen + 1):
            for bins in range(maxlen + 1):
                if obj < bins:
                    t[obj][bins] = 0.0
                elif obj == bins or bins == 1:
                    t[obj][bins] = 1.0
                else:
                    t[obj][bins] = sum(t[obj - bins][i]
                                       for i in range(1, bins + 1))
        self.table = t


STATS = Stats()


def editstr_indel_freqs(editstr: str, readlen: int):
    """probcalc's editstr_to_stats (:1300-1349): '-' runs -> insFreq,
    parenthesised letters -> delFreq."""
    del_freq = [0] * (readlen + 1)
    ins_freq = [0] * (readlen + 1)
    inins = indel = 0
    inssize = delsize = 0
    for ch in editstr:
        isnuc = ch in "ACTG"
        if ch == "-" and inins:
            inssize += 1
        elif ch == "-":
            inins = 1
            inssize = 1
        elif inins:
            inins = 0
            ins_freq[inssize] += 1
            inssize = 0
        if ch == "(":
            indel = 1
            delsize = 0
        elif isnuc and indel:
            delsize += 1
        elif ch == ")":
            indel = 0
            del_freq[delsize] += 1
            delsize = 0
    if indel:
        del_freq[delsize] += 1
    if inins:
        ins_freq[inssize] += 1
    return del_freq, ins_freq


def read_indel_stats(readlen: int, editstr: str):
    del_freq, ins_freq = editstr_indel_freqs(editstr, readlen)
    delev = insev = 0.0
    deln = insn = 1.0
    for i in range(readlen + 1):
        if del_freq[i]:
            delev += del_freq[i]
            deln *= fastfact(del_freq[i])
        if ins_freq[i]:
            insev += ins_freq[i]
            insn *= fastfact(ins_freq[i])
    return delev, insev, deln, insn


def max_count(ins, dels, length, delev, deln, insev, insn):
    return (fastfact(int(delev)) / deln) * (fastfact(int(insev)) / insn) * \
        fastchoose(length, int(insev)) * \
        STATS.table[dels][int(delev)] * \
        fastchoose(int(length + delev - ins), int(delev)) * \
        math.pow(3.0, float(dels))


def min_count(ins, dels, length, delev, deln, insev, insn):
    if ins == 0:
        return (fastfact(int(delev)) / deln) * \
            fastchoose(int(length + delev), int(delev)) * \
            math.pow(3.0, float(dels))
    return (fastfact(int(delev)) / deln) * STATS.table[dels][int(delev)] * \
        fastchoose(int(length + delev - ins), int(delev)) * \
        math.pow(3.0, float(dels))


def sub_count(subs, length):
    return math.exp(fastlchoose(length, subs) + subs * math.log(3.0))


def p_chance(glen, k, nsubs, nerrors, origlen, ins, dels, editstr):
    """p_chance (probcalc.c:278-334)."""
    corr_fact = origlen - k + 1
    delev, insev, deln, insn = read_indel_stats(origlen, editstr)
    r = math.log(sub_count(nsubs + nerrors, k))
    r += math.log(0.5 * (max_count(ins, dels, k, delev, deln, insev, insn)
                         + min_count(ins, dels, k, delev, deln, insev,
                                     insn)))
    r += math.log(float(corr_fact))
    if r <= k * math.log(4.0):
        r -= k * math.log(4.0)
    else:
        return 1.0
    r = math.exp(r)
    if 1 - r == 1:
        r = (2.0 * glen) * r
    else:
        r = 1 - r
        r = 2 * glen * math.log(r)
        r = 1.0 - math.exp(r)
    if r < ALMOST_ZERO:
        r = ALMOST_ZERO
    return r


def p_thissource(k, nerrors, erate, nsubs, subrate, nindels, indelrate):
    """p_thissource (probcalc.c:391-436)."""
    p_err = 0.0
    for i in range(nerrors):
        p_err += math.exp(ls_choose(k - 1, i) + i * math.log(erate)
                          + (k - 1 - i) * math.log(1 - erate))
    p_err = 1 - p_err
    p_sub = 0.0
    for i in range(nsubs):
        p_sub += math.exp(ls_choose(k - 2 - nerrors, i)
                          + i * math.log(subrate)
                          + (k - 2 - nerrors - i) * math.log(1 - subrate))
    p_sub = 1 - p_sub
    p_indel = 0.0
    for i in range(nindels):
        p_indel += math.exp(ls_choose(k - 1, i) + i * math.log(indelrate)
                            + (k - 1 - i) * math.log(1 - indelrate))
    p_indel = 1 - p_indel
    r = p_err * p_sub * p_indel
    if r < ALMOST_ZERO:
        r = ALMOST_ZERO
    if r > ALMOST_ONE:
        r = ALMOST_ONE
    return r


def hash_string(s: str) -> int:
    h = 0
    for ch in s:
        h = (31 * h + ord(ch)) & 0xFFFFFFFF
    return h


class DynHash:
    """common/dynhash.c replica: prepend chains, doubling at count==length,
    bucket-ascending head-first iteration (iteration order is the
    reference's output order)."""

    INIT = 1024

    def __init__(self):
        self.table: list[list] = [[] for _ in range(self.INIT)]
        self.length = self.INIT
        self.count = 0
        self.index: dict = {}

    def add(self, key, val):
        if key in self.index:
            return False
        if self.count == self.length:
            self._expand()
        self.table[hash_string(key) % self.length].insert(0, key)
        self.index[key] = val
        self.count += 1
        return True

    def _expand(self):
        new_len = self.length * 2
        new_table: list[list] = [[] for _ in range(new_len)]
        for bucket in self.table:
            for key in bucket:           # head -> tail, prepend into new
                new_table[hash_string(key) % new_len].insert(0, key)
        self.table = new_table
        self.length = new_len

    def get(self, key):
        return self.index.get(key)

    def iterate(self):
        for bucket in self.table:
            for key in bucket:
                yield key, self.index[key]


class ReadInfo:
    __slots__ = ("name", "matches")

    def __init__(self, name, number_matches):
        self.name = name
        # slot 0 carries the capacity; slots 1..m the min-heap by score
        self.matches = [None] * (number_matches + 1)
        self.matches[0] = ("", number_matches)
        for i in range(1, number_matches + 1):
            self.matches[i] = _dummy(-0x80000000 + i)


def _dummy(score):
    class D:
        pass

    d = D()
    d.score = score
    return d


def reheap(stats, node):
    left = node * 2
    right = left + 1
    mx = node
    cap = stats[0][1]
    if left <= cap and stats[left].score < stats[node].score:
        mx = left
    if right <= cap and stats[right].score < stats[mx].score:
        mx = right
    if mx != node:
        stats[node], stats[mx] = stats[mx], stats[node]
        reheap(stats, mx)


def save_match(ri, rec):
    stats = ri.matches
    if rec.score < stats[1].score:
        return
    stats[1] = rec
    reheap(stats, 1)


def main(argv=None) -> int:
    import getopt
    from shrimp_tpu_torch.io import legacy

    argv = list(sys.argv if argv is None else argv)
    try:
        opts, args = getopt.gnu_getopt(argv[1:], "n:o:p:g:r:s:t:m:BGRS", [])
    except getopt.GetoptError as exc:
        sys.stderr.write(f"error: {exc}\n")
        return 1
    normodds_cutoff = 0.0
    pgenome_cutoff = 0.0
    pchance_cutoff = 0.001
    top_matches = 10
    number_matches = 10
    sort_field = SORT_PCHANCE
    gflag = rflag = False
    rates_string = None
    rates_file = None
    for o, a in opts:
        if o == "-n":
            normodds_cutoff = float(a)
        elif o == "-o":
            pgenome_cutoff = float(a)
        elif o == "-p":
            pchance_cutoff = float(a)
        elif o == "-g":
            rates_file = a
        elif o == "-r":
            rates_string = a
        elif o == "-s":
            sort_field = {"pchance": SORT_PCHANCE, "pgenome": SORT_PGENOME,
                          "normodds": SORT_NORMODDS}.get(a, SORT_PCHANCE)
        elif o == "-t":
            top_matches = int(a)
        elif o == "-m":
            number_matches = int(a)
        elif o == "-G":
            gflag = True
        elif o == "-R":
            rflag = True
        elif o == "-S":
            pass                  # single/double pass is a memory knob only
    if len(args) < 2:
        sys.stderr.write(
            "usage: probcalc [-g rates_file] [-n normodds_cutoff] "
            "[-o pgenome_cutoff] [-p pchance_cutoff] [-r e,s,i,m] "
            "[-s field] [-t top] [-m matches] [-G] [-R] [-S] "
            "total_genome_len results_file...\n")
        return 1
    genome_len = int(args[0])
    files = args[1:]

    read_list = DynHash()
    max_read_len = 0
    total_alignments = 0
    for path in files:
        for rec in legacy.iter_records(path):
            if isinstance(rec, str):
                continue
            # input_parseline stores 0-based coordinates
            rec.genome_start -= 1
            rec.genome_end -= 1
            rec.read_start -= 1
            rec.read_end -= 1
            c = legacy.editstr_to_counts(rec.edit)
            rec.matches = c.matches
            rec.mismatches = c.mismatches
            rec.insertions = c.insertions
            rec.deletions = c.deletions
            rec.crossovers = c.crossovers
            total_alignments += 1
            ri = read_list.get(rec.read)
            if ri is None:
                ri = ReadInfo(rec.read, number_matches)
                read_list.add(rec.read, ri)
                save_match(ri, rec)
            elif rec.score > ri.matches[1].score:
                save_match(ri, rec)
            max_read_len = max(max_read_len, rec.read_length)
    STATS.init(max_read_len)

    # rates (calc_rates over each read's best hit)
    class Rates:
        samples = total_len = insertions = deletions = 0
        matches = mismatches = crossovers = 0
        erate = srate = irate = mrate = 0.0

    rates = Rates()
    if rates_string is None and rates_file is None:
        for _name, ri in read_list.iterate():
            best = 0
            cap = ri.matches[0][1]
            for i in range(1, cap + 1):
                if best == 0 or ri.matches[i].score > ri.matches[best].score:
                    best = i
            rs = ri.matches[best]
            if not hasattr(rs, "edit"):
                continue
            rlen = rs.matches + rs.mismatches + rs.deletions
            d = p_chance(genome_len, rlen, rs.mismatches, rs.crossovers,
                         rs.read_length, rs.insertions, rs.deletions,
                         rs.edit)
            if d < pchance_cutoff:
                rates.samples += 1
                rates.total_len += rs.matches + rs.mismatches
                rates.insertions += rs.insertions
                rates.deletions += rs.deletions
                rates.matches += rs.matches
                rates.mismatches += rs.mismatches
                rates.crossovers += rs.crossovers
        if gflag:
            print(f">{total_alignments} {read_list.count} {rates.samples} "
                  f"{rates.total_len} {rates.insertions} {rates.deletions} "
                  f"{rates.matches} {rates.mismatches} {rates.crossovers}")
            return 0
        tl = float(rates.total_len) if rates.total_len else 1.0
        rates.erate = rates.crossovers / tl
        rates.srate = rates.mismatches / tl
        rates.irate = (rates.insertions + rates.deletions) / tl
        rates.mrate = rates.matches / tl
    elif rates_file is not None:
        with open(rates_file) as fh:
            for line in fh:
                if not line.startswith(">"):
                    continue
                v = [int(x) for x in line[1:].split()]
                rates.samples += v[2]
                rates.total_len += v[3]
                rates.insertions += v[4]
                rates.deletions += v[5]
                rates.matches += v[6]
                rates.mismatches += v[7]
                rates.crossovers += v[8]
        tl = float(rates.total_len) if rates.total_len else 1.0
        rates.erate = rates.crossovers / tl
        rates.srate = rates.mismatches / tl
        rates.irate = (rates.insertions + rates.deletions) / tl
        rates.mrate = rates.matches / tl
    else:
        e, s_, i_, m_ = rates_string.split(",")
        rates.erate, rates.srate = float(e), float(s_)
        rates.irate, rates.mrate = float(i_), float(m_)
    for f in ("erate", "srate", "irate", "mrate"):
        if getattr(rates, f) == 0.0:
            setattr(rates, f, ALMOST_ZERO)

    out = sys.stdout
    out.write("#FORMAT: readname contigname strand contigstart contigend "
              "readstart readend readlength score editstring "
              f"{'readsequence ' if rflag else ''}"
              "normodds pgenome pchance\n")

    sort_keys = {
        SORT_PCHANCE: lambda r: r[1],
        SORT_PGENOME: lambda r: -r[2],
        SORT_NORMODDS: lambda r: -r[3],
    }
    for _name, ri in read_list.iterate():
        rspv = []
        norm = 0.0
        cap = ri.matches[0][1]
        for i in range(1, cap + 1):
            rs = ri.matches[i]
            if rs.score < 0 or not hasattr(rs, "edit"):
                continue
            rlen = rs.matches + rs.mismatches + rs.deletions
            s = p_chance(genome_len, rlen, rs.mismatches, rs.crossovers,
                         rs.read_length, rs.insertions, rs.deletions,
                         rs.edit)
            if s < ALMOST_ZERO or math.isnan(s):
                s = ALMOST_ZERO
            if s > pchance_cutoff:
                continue
            rlen = rs.matches + rs.mismatches
            pg = p_thissource(rlen, rs.crossovers, rates.erate,
                              rs.mismatches, rates.srate,
                              rs.insertions + rs.deletions, rates.irate)
            no = pg / s
            norm += no
            rspv.append([rs, s, pg, no])
        for r in rspv:
            r[3] = r[3] / norm
        rspv.sort(key=sort_keys[sort_field])
        for i, (rs, pc, pg, no) in enumerate(rspv):
            if i >= top_matches:
                break
            if no < normodds_cutoff:
                if sort_field == SORT_NORMODDS:
                    break
                continue
            if pg < pgenome_cutoff:
                if sort_field == SORT_PGENOME:
                    break
                continue
            if pc > pchance_cutoff:
                if sort_field == SORT_PCHANCE:
                    break
                continue
            readseq = ""
            if rflag:
                readseq = (rs.read_seq if getattr(rs, "read_seq", None)
                           else " ") + "\t"
            out.write(f">{rs.read}\t{rs.contig}"
                      f"\t{'-' if rs.revcmpl else '+'}"
                      f"\t{rs.genome_start + 1}\t{rs.genome_end + 1}"
                      f"\t{rs.read_start + 1}\t{rs.read_end + 1}"
                      f"\t{rs.read_length}\t{rs.score}\t{rs.edit}"
                      f"\t{readseq}{no:e}\t{pg:e}\t{pc:e}\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
