"""The comparison that decides `correct`.

For a sample of the reads the window completed, the reference works out
again, from the genome and the reads the benchmark made, what each SAM
record of the timed path states, and counts:

- record_errors: records that state something the reference does not
  reproduce exactly: the read's own bases and qualities (or colours),
  an alignment path that lies on the genome, its score and the
  threshold it must clear, NM, the colour-space crossovers (CM), the
  posterior score (AS) and base qualities (QUAL), Z0 / Z1 and the MAPQ
  of every hit of the read, the order and number of hits, the mate
  fields of a pair (with SHRiMP2's window slack on the insert), and a
  pair's MAPQ and Z fields (SHRiMP2's paired MQV, `pairmqv.py`).
  In letter space a record's score must also be the best alignment of
  its read inside the record's own genome span.
- lost_pct: of the sampled reads that the reference aligns at their
  true locus at or above the threshold, the share the timed path left
  without any record (colour space) or without a record scoring at
  least that (letter space).
- below_best_pct (colour space): the share of records that score below
  the best alignment of their read, in the four-letter model, inside
  their own genome span (`Judge.suboptimal_cs`).

`restate` is the control: the reference in the program's place at a
lower precision (8-bit saturating scores, float32 posteriors), which
restates the program's alignments with the fields it computes, drops
those it scores under the threshold, as the program would, and prints
the records that are left.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from reference import dp, pairmqv, params, posterior
from reference.sam import Record, codes, parse, revcomp

TRUTH_PAD = 8
MAX_HITS = 10                  # -o, DEF_NUM_OUTPUTS
THRESHOLD_PCT = 50.0           # -h, DEF_SW_FULL_THRESHOLD


@dataclass
class Item:
    """One sampled read (or pair) with what the benchmark knows of it."""

    reads: list                  # [(name, seq, qual)] (two for a pair)
    truth: int                   # true start of the (first) read
    lines: list                  # the program's SAM lines for it


@dataclass(frozen=True)
class Precision:
    sat: bool = False            # 8-bit saturating scores
    dtype: type = np.float64     # posteriors, z sums


FULL = Precision()
LOW = Precision(sat=True, dtype=np.float32)
LOW_FLOAT = Precision(sat=False, dtype=np.float32)


@dataclass
class Tally:
    records: int = 0
    record_errors: int = 0
    suboptimal: int = 0
    below_best: int = 0
    cs: bool = False
    alignable: int = 0
    lost: int = 0
    reads: int = 0
    bad_items: int = 0
    notes: list = field(default_factory=list)

    def note(self, msg: str) -> None:
        if len(self.notes) < 8:
            self.notes.append(msg)

    def numbers(self) -> dict:
        out = {"record_errors": self.record_errors + self.suboptimal,
               "lost_pct": (100.0 * self.lost / self.alignable
                            if self.alignable else 0.0)}
        if self.cs:
            out["below_best_pct"] = (100.0 * self.below_best / self.records
                                     if self.records else 0.0)
        return out


class Judge:
    def __init__(self, genome, mode: str, paired: dict | None,
                 qual_delta: int):
        self.g = genome
        self.cs = mode == "cs"
        self.scores = params.COLOUR if self.cs else params.LETTER
        self.paired = paired
        self.qual_delta = qual_delta
        self.contig = {n: i for i, n in enumerate(genome.names)}

    def threshold(self, read_len: int) -> float:
        return read_len * self.scores.match * THRESHOLD_PCT / 100.0

    def genome_span(self, rec: Record, span: int):
        """The contig's bases under the record, or None off its ends."""
        ci = self.contig.get(rec.rname)
        if ci is None:
            return None
        c = self.g.contig(ci)
        if rec.pos < 1 or rec.pos - 1 + span > len(c):
            return None
        return np.asarray(c[rec.pos - 1:rec.pos - 1 + span], np.int64)

    @staticmethod
    def posterior_score(post: float, rmapped: int, pr) -> int:
        ps = int(round(float(pr.alpha) * math.log(post) / math.log(2.0)
                       + rmapped * (2.0 * float(pr.alpha)
                                    + float(pr.beta))))
        return max(ps, 0)

    # -- what one record states, worked out again --------------------------
    def fields(self, rec: Record, read, prec: Precision):
        """The record's fields as the reference computes them from its
        alignment, or a string saying why the alignment itself is
        wrong."""
        return (self.cs_fields if self.cs else self.ls_fields)(rec, read,
                                                               prec)

    def ls_fields(self, rec: Record, read, prec: Precision):
        name, seq, qual = read
        if not rec.mapped or not {op for _, op in rec.cigar} <= set("MID"):
            return f"flag / CIGAR {rec.flag} {rec.cigar}"
        want = revcomp(seq) if rec.reverse else seq
        q = qual[::-1] if rec.reverse else qual
        want_q = "".join(chr(ord(c) - self.qual_delta + 33) for c in q)
        span = sum(n for n, op in rec.cigar if op in "MD")
        g = self.genome_span(rec, span)
        if g is None:
            return "outside its contig"
        p = dp.path_score(codes(want), g, rec.cigar, self.scores,
                          sat=prec.sat)
        if p is None or p["read_used"] != len(seq):
            return "path does not cover the read"
        rmapped = p["read_used"]
        pr = params.probs(self.scores, False, prec.dtype)
        f = prec.dtype
        post = float(f(2.0) ** ((f(p["score"]) - f(rmapped)
                                 * (f(2.0) * pr.alpha + pr.beta))
                                / pr.alpha))
        return {"SEQ": want, "QUAL": want_q, "raw": p["score"],
                "post": post, "AS": self.posterior_score(post, rmapped, pr),
                "NM": p["mismatches"] + p["ins"] + p["dels"],
                "thr": self.threshold(len(seq))}

    def cs_fields(self, rec: Record, read, prec: Precision):
        name, seq, qual = read
        if not rec.mapped or not {op for _, op in rec.cigar} <= set("MIDH"):
            return "flag / CIGAR"
        cig = rec.cigar[::-1] if rec.reverse else rec.cigar
        lead = cig[0][0] if cig and cig[0][1] == "H" else 0
        n_col = len(seq) - 1
        if sum(n for n, op in cig if op in "MIH") != n_col:
            return "CIGAR length"
        g = self.genome_span(rec, sum(n for n, op in cig if op in "MD"))
        if g is None:
            return "outside its contig"
        if rec.reverse:
            g = (3 - g)[::-1]
        qr = rec.tags.get("XX", "")
        db, gi, qi = [], 0, 0
        for n, op in cig:
            if op == "H":
                continue
            for _ in range(n):
                if qi >= len(qr) or (qr[qi] == "-") != (op == "D"):
                    return "XX does not follow the CIGAR"
                if op == "I":
                    db.append("-")
                else:
                    db.append("ACGT"[g[gi]])
                    gi += 1
                qi += 1
        if qi != len(qr):
            return "XX length"
        dbalign = "".join(db)
        called = "".join(c for c in qr.upper() if c != "-")
        # the called letters' score on the genome, and the crossovers:
        # colours the called letters imply that the read does not have,
        # each scored from its quality
        colours = [int(c) for c in seq[1:]]
        initbp = "ACGT".index(seq[0])
        prev = initbp
        for c in colours[:lead]:
            prev ^= c
        sc = self.scores
        pr = params.probs(sc, True, prec.dtype)
        xpen = self.crossover_scores(qual, len(colours), pr)
        if lead == 0:
            # at the first colour the DP starts from the primer's letter
            # at no cost or from another letter at -x (sw-full-cs.c's
            # top row), and crosses over at the colour's own score
            xpen[0] = max(sc.crossover, xpen[0])
        xo = mism = raw = 0
        k = lead
        run_i = run_d = 0
        for a, b in zip(qr, dbalign):
            if a == "-":
                step = sc.del_extend + (0 if run_d else sc.del_open)
                run_d, run_i = run_d + 1, 0
            else:
                letter = "ACGT".index(a.upper())
                if (prev ^ letter) != colours[k]:
                    xo += 1
                    raw = int(dp._clip(raw + xpen[k], prec.sat))
                prev = letter
                k += 1
                if b == "-":
                    step = sc.ins_extend + (0 if run_i else sc.ins_open)
                    run_i, run_d = run_i + 1, 0
                else:
                    run_i = run_d = 0
                    same = letter == "ACGT".index(b)
                    mism += not same
                    step = sc.match if same else sc.mismatch
            raw = int(dp._clip(raw + step, prec.sat))
        n_gap = sum(n for n, op in cig if op in "ID")
        post, q33 = posterior.posterior(colours, initbp, qual,
                                        self.qual_delta, lead, dbalign, qr,
                                        pr, dtype=prec.dtype)
        rmapped = n_col - sum(n for n, op in cig if op == "H")
        return {"SEQ": revcomp(called) if rec.reverse else called,
                "QUAL": q33[::-1] if rec.reverse else q33,
                "CS": seq, "CQ": qual, "CM": xo, "raw": raw, "post": post,
                "AS": self.posterior_score(post, rmapped, pr),
                "NM": mism + n_gap, "thr": self.threshold(n_col),
                "span": (colours, initbp, xpen, g, lead)}

    def crossover_scores(self, qual, n: int, pr) -> list:
        """The score of a crossover at each colour: from the colour's
        quality, alpha x log2(Pr[error] / 3) truncated, kept within
        [2 x crossover, -1] (gmapper.c); the flat -x without qualities."""
        if qual is None:
            return [self.scores.crossover] * n
        out = []
        for ch in qual[:n]:
            p = posterior.pr_err_from_qv(ord(ch) - self.qual_delta)
            v = math.trunc(float(pr.alpha) * math.log(p / 3.0)
                           / math.log(2.0))
            out.append(min(max(v, 2 * self.scores.crossover), -1))
        return out

    @staticmethod
    def differs(rec: Record, f: dict, unpaired: bool) -> str | None:
        if rec.seq != f["SEQ"] or rec.qual != f["QUAL"]:
            return "SEQ / QUAL"
        for k in ("AS", "NM", "CM", "CS", "CQ"):
            if k in f and rec.tags.get(k) != f[k]:
                return f"{k} {rec.tags.get(k)} vs {f[k]}"
        # a mate of a pair clears the pair's threshold, not its own
        if unpaired and (f["raw"] < f["thr"] or f["AS"] < f["thr"]):
            return f"under the threshold ({f['raw']}, AS {f['AS']})"
        return None

    @staticmethod
    def hit_set(posts: list, dtype) -> tuple[list, list, int]:
        """MAPQ and Z0 of each hit and Z1 of the read, from the hits'
        posteriors in their order (compute_unpaired_mqv).  Z1 is summed
        as the JAX package sums it, with Python's `sum`, which since
        Python 3.12 compensates the rounding of each addition; SHRiMP2's
        C adds in order, which can differ in the last bit and, for a
        read whose best hit all but owns Z1, move its MAPQ by one."""
        f = dtype
        if f is np.float64:
            z1 = f(sum(float(p) for p in posts))
        else:
            z1 = f(0)
            for p in posts:
                z1 = f(z1 + f(p))
        mq = []
        for p in posts:
            q = posterior.qv_from_pr_err(float(f(1) - f(p) / z1))
            mq.append(0 if q < 4 else q)
        return mq, [int(1000 * -math.log(p)) for p in posts], \
            int(1000 * -math.log(float(z1)))

    # -- judging ------------------------------------------------------------
    def read_hits(self, recs: list, read, t: Tally, unpaired: bool) -> list:
        """Judge the records of one read; returns (record, its fields as
        the reference computes them) of each one that is right."""
        out, posts, ok = [], [], len(recs) <= MAX_HITS
        for rec in recs:
            t.records += 1
            f = self.fields(rec, read, FULL)
            why = f if isinstance(f, str) else self.differs(rec, f, unpaired)
            if why:
                t.record_errors += 1
                t.note(f"{rec.qname}: {why}")
                ok = False
                continue
            out.append((rec, f))
            posts.append(f["post"])
        if ok and unpaired and recs:
            mq, z0, z1 = self.hit_set(posts, np.float64)
            prev = None
            for (rec, _), m, z in zip(out, mq, z0):
                if (rec.mapq != m or rec.tags.get("Z0") != z
                        or rec.tags.get("Z1") != z1
                        or (prev is not None and rec.tags["AS"] > prev)):
                    t.record_errors += 1
                    t.note(f"{rec.qname}: MAPQ / Z0 / Z1 / order")
                prev = rec.tags["AS"]
        return out

    def suboptimal(self, hits: list, t: Tally) -> None:
        """Each record's score against the best alignment of its read
        inside the record's own genome span.  The program's pass-2
        window holds that span, so a correct DP never scores less; a
        better alignment just past the span may lie outside the window,
        and is no fault."""
        if not hits:
            return
        if self.cs:
            self.suboptimal_cs(hits, t)
            return
        wins, rows = [], []
        for rec, _ in hits:
            span = sum(n for n, op in rec.cigar if op in "MD")
            wins.append(self.genome_span(rec, span))
            rows.append(codes(rec.seq))
        win = np.full((len(wins), max(map(len, wins))), -1, np.int64)
        rd = np.full((len(rows), max(map(len, rows))), -2, np.int64)
        for i, (g, r) in enumerate(zip(wins, rows)):
            win[i, :len(g)] = g
            rd[i, :len(r)] = r
        best = dp.best_semiglobal(rd, np.array([len(r) for r in rows]), win,
                                  np.array([len(g) for g in wins]),
                                  self.scores)
        for (rec, f), b in zip(hits, best):
            raw = f["raw"]
            if b > raw:
                t.suboptimal += 1
                t.note(f"{rec.qname}: score {raw} < {int(b)} in its span")

    def suboptimal_cs(self, hits: list, t: Tally) -> None:
        """Colour space: against the best of the four-letter model
        (`dp.best_colour`) over the span, for the global alignments of
        the whole read (no colour clipped) that the configuration
        runs.  SHRiMP2 aligns inside a band around the seed's anchor,
        which the records do not state, and the four letters open more
        paths off that band than letter space has: a sound run puts a
        few records below the best of their span.  So these are counted
        apart, as `below_best_pct` of the records, which has a limit of
        its own, and not as record errors."""
        spans = [(rec, f) for rec, f in hits if f["span"][4] == 0]
        if not spans:
            return
        n = len(spans)
        R = max(len(f["span"][0]) for _, f in spans)
        W = max(len(f["span"][3]) for _, f in spans)
        col = np.zeros((n, R), np.int64)
        xo = np.full((n, R), self.scores.crossover, np.int64)
        win = np.full((n, W), -1, np.int64)
        init = np.zeros(n, np.int64)
        rlen, wlen = np.zeros(n, np.int64), np.zeros(n, np.int64)
        for k, (_, f) in enumerate(spans):
            colours, initbp, xpen, g, _ = f["span"]
            col[k, :len(colours)] = colours
            xo[k, :len(colours)] = xpen
            win[k, :len(g)] = g
            init[k], rlen[k], wlen[k] = initbp, len(colours), len(g)
        best = dp.best_colour(col, init, xo, rlen, win, wlen, self.scores)
        for (rec, f), b in zip(spans, best):
            if b > f["raw"]:
                t.below_best += 1
                t.note(f"{rec.qname}: score {f['raw']} < {int(b)} in its "
                       f"span")

    def truth_score(self, seq: str, lo: int, hi: int, both: bool) -> float:
        """The best score of the read (colour space: of its decoded
        letters) in genome[lo:hi] of the whole genome; -inf where that
        stretch crosses a contig's end."""
        L = len(self.g.codes)
        lo, hi = max(lo, 0), min(hi, L)
        ends = np.concatenate([self.g.offsets[1:], [L]])
        if hi > ends[np.searchsorted(ends, lo, side="right")]:
            return -math.inf
        win = np.asarray(self.g.codes[lo:hi], np.int64)
        if self.cs:
            prev, letters = "ACGT".index(seq[0]), []
            for c in seq[1:]:
                prev ^= int(c)
                letters.append(prev)
            r = np.array(letters, np.int64)
        else:
            r = codes(seq).astype(np.int64)
        rd = np.stack([r] + ([(3 - r)[::-1]] if both else []))
        wins = np.broadcast_to(win, (len(rd), len(win)))
        b = dp.best_semiglobal(rd, np.full(len(rd), len(r)), wins,
                               np.full(len(rd), len(win)), self.scores)
        return float(b.max())

    def lost(self, seq: str, lo: int, hi: int, hits: list, both: bool,
             t: Tally) -> None:
        s = self.truth_score(seq, lo, hi, both)
        if s < self.threshold(len(seq) - (1 if self.cs else 0)):
            return
        t.alignable += 1
        if not hits or (not self.cs and max(f["raw"] for _, f in hits) < s):
            t.lost += 1

    def item(self, it: Item, t: Tally) -> None:
        recs = [parse(ln) for ln in it.lines]
        t.reads += len(it.reads)
        before = t.record_errors + t.suboptimal
        rl = len(it.reads[0][1])
        if self.paired is None:
            hits = self.read_hits(recs, it.reads[0], t, unpaired=True)
            self.suboptimal(hits, t)
            self.lost(it.reads[0][1], it.truth - TRUTH_PAD,
                      it.truth + rl + 6 + TRUTH_PAD, hits, not self.cs, t)
        else:
            mates = [[r for r in recs if r.flag & 0x40],
                     [r for r in recs if r.flag & 0x80]]
            if len(mates[0]) + len(mates[1]) != len(recs):
                t.record_errors += len(recs)
                t.note("pair: a record without its mate bit")
                return
            hits = []
            for m in (0, 1):
                hits.append(self.read_hits([r for r in mates[m] if r.mapped],
                                           it.reads[m], t, unpaired=False))
                self.suboptimal(hits[m], t)
            self.pair_fields(recs, t)
            if t.record_errors + t.suboptimal == before:
                self.pair_mqv(recs, hits, it.reads, t)
            lo_i, hi_i = self.paired["insert"]
            self.lost(it.reads[0][1], it.truth - TRUTH_PAD,
                      it.truth + rl + 6 + TRUTH_PAD, hits[0], False, t)
            self.lost(it.reads[1][1], it.truth + lo_i - rl - TRUTH_PAD,
                      it.truth + hi_i + 6 + TRUTH_PAD, hits[1], True, t)
        t.bad_items += (t.record_errors + t.suboptimal) > before

    def pair_fields(self, recs: list, t: Tally) -> None:
        """Mate fields.  Records come two by two: the two mates of a
        paired hit, or a mapped mate beside its unmapped one.  SHRiMP2
        holds the mates' candidate windows, not their alignments, to the
        -I limits (readpair_compute_mp_ranges), so a proper pair's 5'-5'
        insert may pass them by a window's slack: it lies in
        [min - w1 - w2, max + (w1 - r1) + (w2 - r2)] for reads of r bases
        and windows of w = 140% of r (-w, DEF_WINDOW_LEN)."""
        lo_i, hi_i = self.paired["limits"]

        def end(r):
            return r.pos + sum(n for n, op in r.cigar if op in "MD") - 1

        for a, b in zip(recs[0::2], recs[1::2]):
            if a.flag & 0x2:
                bad = not (b.flag & 0x2 and a.mapped and b.mapped)
                if not bad:
                    same = a.rname == b.rname
                    for s_, m_ in ((a, b), (b, a)):
                        bad |= s_.rnext != ("=" if same else m_.rname)
                        bad |= s_.pnext != m_.pos
                        bad |= bool(s_.flag & 0x20) != m_.reverse
                    fa = end(a) if a.reverse else a.pos - 1
                    fb = end(b) if b.reverse else b.pos - 1
                    bad |= same and (a.tlen != fb - fa or b.tlen != -a.tlen)
                    bad |= not same or a.reverse == b.reverse
                    if not bad:
                        fwd, rev = (b, a) if a.reverse else (a, b)
                        r1, r2 = len(fwd.seq), len(rev.seq)
                        w1, w2 = int(r1 * 1.4), int(r2 * 1.4)
                        ins = end(rev) + 1 - fwd.pos
                        bad |= not (lo_i - w1 - w2 <= ins
                                    <= hi_i + (w1 - r1) + (w2 - r2))
            else:
                mapped, unm = (a, b) if a.mapped else (b, a)
                bad = (not mapped.mapped or unm.mapped
                       or unm.rnext != mapped.rname
                       or unm.pnext != mapped.pos)
            if bad:
                t.record_errors += 1
                t.note(f"{a.qname}: mate fields")

    def pair_mqv(self, recs: list, hits: list, reads: list,
                 t: Tally) -> None:
        """MAPQ and the Z fields of every mapped record of a pair, from
        the feet's posteriors (SHRiMP2's compute_paired_mqv)."""
        want = self.pair_expected(recs, hits, reads, np.float64)
        for j, (mq, tags) in want.items():
            r = recs[j]
            bad = [k for k, v in tags.items() if r.tags.get(k) != v]
            if r.mapq != mq or bad:
                t.record_errors += 1
                t.note(f"{r.qname}: paired MAPQ {r.mapq} vs {mq}, "
                       f"{' '.join(f'{k} {r.tags.get(k)} vs {tags[k]}' for k in bad)}")

    def pair_expected(self, recs: list, hits: list, reads: list,
                      dtype) -> dict:
        post, score = {}, {}
        for rec, f in hits[0] + hits[1]:
            key = pairmqv.foot_key(rec)
            post[key], score[key] = f["post"], f["AS"]
        return pairmqv.expected(
            recs, post, score, (len(reads[0][1]), len(reads[1][1])),
            len(self.g.codes), self.paired["mode"], self.scores.match,
            abs(self.scores.mismatch - self.scores.match), dtype)

    # -- the control --------------------------------------------------------
    def restate(self, it: Item, prec: Precision) -> list:
        """The item's lines as the reference would print them in the
        program's place at precision `prec`: the program's alignments
        with the fields computed at that precision, those under the
        threshold dropped."""
        recs = [parse(ln) for ln in it.lines]
        if self.paired is not None:
            out, hits = [], ([], [])
            for rec in recs:
                m = 0 if rec.flag & 0x40 else 1
                if rec.mapped:
                    f = self.fields(rec, it.reads[m], prec)
                    if isinstance(f, dict):
                        # the pair's threshold on the two mates' sum
                        if f["raw"] < f["thr"] / 2:
                            continue
                        rec.tags["AS"] = f["AS"]
                        hits[m].append((rec, f))
                out.append(rec)
            # a pair whose mate went is no pair: keep only whole twos
            if len(out) != len(recs):
                return []
            if len(hits[0]) + len(hits[1]) == sum(r.mapped for r in out):
                want = self.pair_expected(out, list(hits), it.reads,
                                          prec.dtype)
                for j, (mq, tags) in want.items():
                    out[j].mapq = mq
                    out[j].tags.update(tags)
            return [_line(r) for r in out]
        kept, posts = [], []
        for rec in recs:
            f = self.fields(rec, it.reads[0], prec)
            if isinstance(f, str):
                kept.append(rec)
                posts.append(None)
                continue
            if min(f["raw"], f["AS"]) < f["thr"]:
                continue
            for k in ("AS", "NM", "CM"):
                if k in f:
                    rec.tags[k] = f[k]
            rec.qual = f["QUAL"]
            kept.append(rec)
            posts.append(f["post"])
        if kept and all(p is not None for p in posts):
            mq, z0, z1 = self.hit_set(posts, prec.dtype)
            for rec, m, z in zip(kept, mq, z0):
                rec.mapq, rec.tags["Z0"], rec.tags["Z1"] = m, z, z1
        return [_line(r) for r in kept]


def _line(r: Record) -> str:
    tags = []
    for k, v in r.tags.items():
        tags.append(f"{k}:i:{v}" if isinstance(v, int) else f"{k}:Z:{v}")
    cig = "".join(f"{n}{op}" for n, op in r.cigar) or "*"
    return "\t".join(map(str, (r.qname, r.flag, r.rname, r.pos, r.mapq, cig,
                               r.rnext, r.pnext, r.tlen, r.seq, r.qual,
                               *tags)))


def judge(genome, mode: str, paired, qual_delta: int, items: list) -> Tally:
    j = Judge(genome, mode, paired, qual_delta)
    t = Tally(cs=j.cs)
    for it in items:
        j.item(it, t)
    return t


def control(genome, mode: str, paired, qual_delta: int, items: list,
            prec: Precision = LOW) -> Tally:
    """The control's readings: the items restated by the reference at
    `prec` in the program's place, judged as the program is."""
    j = Judge(genome, mode, paired, qual_delta)
    restated = [Item(reads=it.reads, truth=it.truth,
                     lines=j.restate(it, prec)) for it in items]
    t = Tally(cs=j.cs)
    for it in restated:
        j.item(it, t)
    return t
