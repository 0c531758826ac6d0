"""probcalc_mp — mate-pair post-processor for probcalc output
(probcalc_mp/probcalc_mp.c).

Two passes over the (read-sorted) probcalc output: pass 1 estimates the
insert-distance mean/stddev/histogram from reads with exactly one "good"
pairing (same strand, correct order, distance < M — good_mp_dst,
probcalc_mp.c:752-790); pass 2 scores every fwd x rev combination with a
distance-aware pgenome (via the cumulative distance histogram) and pchance
(add_p_stats, :817-880), normalises, sorts, and prints the top pairs.

Usage:
    python -m shrimp_tpu_torch.tools.probcalc_mp -m mapping_file -f fwd_suffix
        -b rev_suffix -g genome_length -M distance_cutoff
        [-L n] [-T max] [-C pchance_cut] [-G pgenome_cut] [-R]
        [-d] [-u] [-q] [-s nr_stdev] [-c]
"""

from __future__ import annotations

import math
import sys

HIST_BINS = 2000
ALMOST_ZERO = 0.000000001
ALMOST_ONE = 0.999999999

SORT_PGENOME = 1


class Cfg:
    def __init__(self):
        self.fwd_suffix = ""
        self.rev_suffix = ""
        self.rflag = False
        self.distcutoff = 0
        self.hist_distcutoff = 0
        self.genome_length = 0
        self.discordant = False
        self.do_unique = False
        self.quickmode = False
        self.allow_diff_chr = True
        self.print_max = 20
        self.mean_nr = 50000
        self.pgenome_cutoff = 0.95
        self.pchance_cutoff = 0.05
        self.nr_stdev = 2.0


class Mapping:
    __slots__ = ("readname", "contigname", "strand", "contigstart",
                 "contigend", "readstart", "readend", "readlength", "score",
                 "editstring", "normodds", "pgenome", "pchance")


def parse_line(line: str, rflag: bool) -> Mapping | None:
    if line.startswith("#"):
        return None
    f = line.rstrip("\n").split("\t")
    if len(f) < 10:
        return None
    m = Mapping()
    m.readname = f[0]
    m.contigname = f[1]
    m.strand = f[2][0]
    m.contigstart = int(f[3])
    m.contigend = int(f[4])
    m.readstart = int(f[5])
    m.readend = int(f[6])
    m.readlength = int(f[7])
    m.score = int(float(f[8]))
    m.editstring = f[9]
    off = 1 if rflag else 0
    m.normodds = float(f[10 + off]) if len(f) > 10 + off else 0.0
    m.pgenome = float(f[11 + off]) if len(f) > 11 + off else 0.0
    m.pchance = float(f[12 + off]) if len(f) > 12 + off else 0.0
    return m


class Stats:
    def __init__(self):
        self.mean = 0.0
        self.stdev = 0.0
        self.good_mps = 0
        self.hist = [0] * HIST_BINS
        self.cumsum = [0.0] * HIST_BINS
        self.done_mean = False


def good_mp_dst(cfg: Cfg, fwd: Mapping, rev: Mapping) -> int:
    """good_mp_dst (probcalc_mp.c:752-790)."""
    if fwd.contigstart < rev.contigstart:
        cs_fwd, cs_rev = fwd.contigstart, rev.contigend
    else:
        cs_fwd, cs_rev = fwd.contigend, rev.contigstart
    dist = abs(cs_fwd - cs_rev)
    if dist >= cfg.distcutoff:
        return 0
    plus = fwd.strand == rev.strand == "+"
    minus = fwd.strand == rev.strand == "-"
    if (plus and cs_rev < cs_fwd) or (minus and cs_fwd < cs_rev):
        return dist
    return 0


def increment_stats(cfg: Cfg, st: Stats, dist: int) -> None:
    st.good_mps += 1
    prev = st.mean
    st.mean = st.mean + (dist - st.mean) / st.good_mps
    st.stdev = st.stdev + (dist - prev) * (dist - st.mean)
    binnr = int(math.floor((dist * 1.0 / cfg.hist_distcutoff) * HIST_BINS))
    st.hist[binnr] += 1
    if cfg.mean_nr != 0 and st.good_mps >= cfg.mean_nr and \
            abs(prev - st.mean) < 1.0:
        st.done_mean = True


def _cdiv(a: float, b: float) -> float:
    """C float division semantics: x/0 -> +-inf, 0/0 -> nan."""
    if b != 0:
        return a / b
    if a == 0:
        return float("nan")
    return math.copysign(math.inf, a)


def compute_cumsum(cfg: Cfg, st: Stats) -> None:
    st.cumsum[0] = 1.0
    mean_bin = int(math.floor((st.mean * 1.0 / cfg.hist_distcutoff)
                              * HIST_BINS))
    for i in range(1, HIST_BINS):
        sub = 0
        if mean_bin + (i - 1) < HIST_BINS:
            sub += st.hist[mean_bin + (i - 1)]
        if mean_bin - (i - 1) > 0 and (i - 1) != 0:
            sub += st.hist[mean_bin - (i - 1)]
        v = st.cumsum[i - 1] - _cdiv(sub * 1.0, st.good_mps)
        # C MAX macro: (a > b ? a : b) — nan compares false, yielding 0
        st.cumsum[i] = v if v > 0.0 else 0.0


def add_p_stats(cfg: Cfg, st: Stats, fwd: Mapping, rev: Mapping, mp_set,
                tot):
    """add_p_stats (probcalc_mp.c:817-880)."""
    if not cfg.allow_diff_chr and fwd.contigname != rev.contigname:
        return tot
    if fwd.contigstart < rev.contigstart:
        cs_fwd, cs_rev = fwd.contigstart, rev.contigend
    else:
        cs_fwd, cs_rev = fwd.contigend, rev.contigstart
    dist = abs(cs_fwd - cs_rev)
    if cfg.discordant:
        pgenome = fwd.pgenome * rev.pgenome
    else:
        pg_bin = int(math.floor((abs(dist - st.mean) * 1.0
                                 / cfg.hist_distcutoff) * HIST_BINS))
        cum = 0.0 if pg_bin >= HIST_BINS else st.cumsum[pg_bin]
        pgenome = fwd.pgenome * rev.pgenome * cum
    pgenome = min(ALMOST_ONE, pgenome)
    if pgenome < cfg.pgenome_cutoff:
        return tot
    if cfg.discordant or cfg.quickmode:
        pchance = fwd.pchance * rev.pchance
    else:
        frac = abs(dist - st.mean + 1) * 1.0 / cfg.genome_length
        alt_f = 1 - (1 - fwd.pchance) ** frac
        alt_r = 1 - (1 - rev.pchance) ** frac
        pchance = (fwd.pchance * alt_r + rev.pchance * alt_f) / 2
    pchance = max(ALMOST_ZERO, pchance)
    if pchance > cfg.pchance_cutoff:
        return tot
    no = pgenome / pchance
    mp_set.append([fwd, rev, pchance, pgenome, no, dist])
    return tot + no


def main(argv=None) -> int:
    import getopt
    argv = list(sys.argv if argv is None else argv)
    cfg = Cfg()
    mapping_file = None
    try:
        opts, _ = getopt.gnu_getopt(argv[1:], "m:x:Rf:b:M:g:duL:T:D:C:G:qs:cei:")
    except getopt.GetoptError as exc:
        sys.stderr.write(f"error: {exc}\n")
        return 1
    for o, a in opts:
        if o == "-m":
            mapping_file = a
        elif o == "-f":
            cfg.fwd_suffix = a
        elif o == "-b":
            cfg.rev_suffix = a
        elif o == "-g":
            cfg.genome_length = int(a)
        elif o == "-M":
            cfg.distcutoff = int(a)
            cfg.hist_distcutoff = int(a)
        elif o == "-L":
            cfg.mean_nr = int(a)
        elif o == "-T":
            cfg.print_max = int(a)
        elif o == "-C":
            cfg.pchance_cutoff = float(a)
        elif o == "-G":
            cfg.pgenome_cutoff = float(a)
        elif o == "-R":
            cfg.rflag = True
        elif o == "-d":
            cfg.discordant = True
        elif o == "-u":
            cfg.do_unique = True
        elif o == "-q":
            cfg.quickmode = True
        elif o == "-s":
            cfg.nr_stdev = float(a)
        elif o == "-c":
            cfg.allow_diff_chr = False
    if mapping_file is None or not cfg.fwd_suffix or not cfg.rev_suffix \
            or not cfg.genome_length or not cfg.distcutoff:
        sys.stderr.write(
            "usage: probcalc_mp -m mapping_file -f fwd_suffix -b rev_suffix "
            "-g genome_length -M distance_cutoff [options]\n")
        return 1

    st = Stats()
    out = sys.stdout
    printed = [0]
    header_done = [False]

    def groups(path):
        """Yield (fwd_maps, rev_maps) per read root, plus unique-mode
        suppression (filepass, probcalc_mp.c:311-500)."""
        cur = None
        fwd: list[Mapping] = []
        rev: list[Mapping] = []
        do_analysis = True
        with open(path) as fh:
            for line in fh:
                m = parse_line(line, cfg.rflag)
                if m is None:
                    continue
                name = m.readname
                if name.endswith(cfg.fwd_suffix) and cfg.fwd_suffix:
                    is_fwd = True
                    root = name[:len(name) - len(cfg.fwd_suffix)]
                elif name.endswith(cfg.rev_suffix) and cfg.rev_suffix:
                    is_fwd = False
                    root = name[:len(name) - len(cfg.rev_suffix)]
                else:
                    sys.stderr.write(
                        "error: read is neither forward nor reverse\n")
                    sys.exit(1)
                if root != cur:
                    if cur is not None and fwd and rev and do_analysis:
                        yield fwd, rev
                    cur = root
                    fwd, rev = [], []
                    do_analysis = True
                if cfg.do_unique and ((is_fwd and len(fwd) >= 1)
                                      or (not is_fwd and len(rev) >= 1)):
                    do_analysis = False
                if not do_analysis:
                    continue
                (fwd if is_fwd else rev).append(m)
        # NB the reference never flushes the final read group at EOF
        # (filepass analyses a group only when the next one begins) — the
        # last read's pairings are silently dropped; quirk preserved.

    # pass 1: mean/stddev/histogram from unique good pairings
    for fwd, rev in groups(mapping_file):
        good = 0
        good_dist = 0
        for f in fwd:
            for r in rev:
                d = good_mp_dst(cfg, f, r)
                if d > 0:
                    good_dist = d
                    good += 1
                if good > 1:
                    break
            if good > 1:
                break
        if good == 1:
            increment_stats(cfg, st, good_dist)
        if st.done_mean:
            break
    stdev_sq = _cdiv(st.stdev, st.good_mps)
    stdev = math.sqrt(stdev_sq) if stdev_sq >= 0 else float("nan")
    sys.stderr.write(f"Mean: {st.mean:.2f}. STDev: {stdev:.2f} "
                     f"(from {st.good_mps} good pairs)\n")
    compute_cumsum(cfg, st)
    new_cut = st.mean + cfg.nr_stdev * stdev
    cfg.distcutoff = (int(math.ceil(new_cut)) if not math.isnan(new_cut)
                      else 1 << 63)
    sys.stderr.write(f"new M cutoff: {cfg.distcutoff}\n")

    # pass 2: score + output
    for fwd, rev in groups(mapping_file):
        good = 0
        if cfg.discordant:
            for f in fwd:
                for r in rev:
                    if good_mp_dst(cfg, f, r) > 0:
                        good += 1
        if cfg.discordant and good > 0:
            continue
        mp_set: list = []
        tot = 0.0
        for f in fwd:
            for r in rev:
                tot = add_p_stats(cfg, st, f, r, mp_set, tot)
        for row in mp_set:
            # C semantics: totnormodds == 0 gives 0/0 = -nan in the output
            row[4] = (row[4] / tot) if tot != 0 else float("-nan")
        mp_set.sort(key=lambda r: -r[3])      # SORT_PGENOME, big first
        if not header_done[0] and mp_set:
            out.write(
                "#FORMAT: fwd_name fwd_chr fwd_editstring fwd_strand "
                "fwd_start fwd_end fwd_pgrev_name rev_chr rev_editstring "
                "rev_strand rev_start rev_end rev_pgdistance normodds "
                "pgenome pchance\n")
            header_done[0] = True
        for i, (f, r, pc, pg, no, dist) in enumerate(mp_set):
            if i >= cfg.print_max:
                prev = mp_set[i - 1]
                if prev[3] != pg:
                    break
            out.write(f"{printed[0]}\t")
            printed[0] += 1
            out.write(f"{f.readname[1:]}\t{f.contigname}\t{f.editstring}\t"
                      f"{f.strand}\t{f.contigstart}\t{f.contigend}\t"
                      f"{f.pgenome:1.3f}\t")
            out.write(f"{r.readname[1:]}\t{r.contigname}\t{r.editstring}\t"
                      f"{r.strand}\t{r.contigstart}\t{r.contigend}\t"
                      f"{r.pgenome:1.3f}\t")
            no_s = "-nan" if math.isnan(no) else f"{no:1.3f}"
            out.write(f"{dist}\t{no_s}\t{pg:1.3f}\t{pc:1.10f}\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
