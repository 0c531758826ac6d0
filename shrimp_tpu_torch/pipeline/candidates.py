"""Candidate generation: read kmers → anchors → candidate mapping windows.

Mirrors `gmapper/mapping.c`:
  * `read_get_mapidxs` (:95) — spaced-kmer extraction per strand,
  * `read_get_anchor_list_per_strand` (:877) — k-way merge of posting lists
    into a genome-position-sorted anchor list with colinear collapse,
  * `read_get_hit_list_per_strand` (:1052) — pair each anchor with its best
    predecessor inside the window, score optimistically, emit windows.

This host-side version is vectorized NumPy for the gathers and a compact
sequential pass for collapse/pairing (the reference's own structure); the
device path (L3-on-TPU) replaces it batch-wise later without changing
semantics.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from shrimp_tpu_torch import dna
from shrimp_tpu_torch.index import GenomeIndex, compute_mapidx
from shrimp_tpu_torch.pipeline.options import (HitListOptions, MapperConfig,
                                         abs_or_pct)


@dataclass
class ReadEntry:
    """Per-read working state (read_entry, gmapper-definitions.h:88-136)."""

    name: str
    seq: str
    qual: str | None
    read: list[np.ndarray]        # [fw codes, rc codes]
    read_len: int
    window_len: int
    max_n_kmers: int
    min_kmer_pos: int = 0
    initbp: int = -1              # colour space only
    is_rna: bool = False
    crossover_score: np.ndarray | None = None  # per-colour qv-derived penalty
    read_ls4: np.ndarray | None = None         # CS: 4 letter decodings [4, R]
    read_ls4_rc: np.ndarray | None = None      # lazy, for input_strand == 1
    sqf: list | None = None       # --enable-seed-qual-filter: per-seed
    #                               bool[n_kmer_slots], True = skip slot at
    #                               anchor generation (mapping.c:936)
    sqf_mapidx: list | None = None  # per-seed bool[n_kmer_slots], True =
    #                               slot's mapidx was zeroed (mapping.c:78)


@dataclass
class Anchors:
    """Column arrays of anchors for one (read, strand)."""

    x: np.ndarray          # int64 global genome pos of anchor start
    y: np.ndarray          # int32 read pos
    length: np.ndarray     # int32 span covered on the diagonal
    weight: np.ndarray     # int32 merged kmer count
    cn: np.ndarray         # int32 contig number

    @property
    def n(self) -> int:
        return len(self.x)


@dataclass
class HitList:
    """Candidate mapping windows for one (read, strand) — read_hit columns."""

    cn: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))
    g_off: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    w_len: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))
    score_window_gen: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))
    matches: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))
    anchor_x: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    anchor_y: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    anchor_length: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))
    anchor_width: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))

    @property
    def n(self) -> int:
        return len(self.g_off)


def cs_read_ls4(colours: np.ndarray, initbp: int) -> np.ndarray:
    """The 4 letter-space decodings of a colour read (sw_full_cs,
    common/sw-full-cs.c:1195-1211); layer k starts at letter (initbp+k)%4 and
    an N colour resets the decoding chain to the layer's initial letter.

    Vectorized: within each segment between N colours the letters are the
    layer initial XOR the segment-relative colour prefix-XOR."""
    colours = np.asarray(colours, dtype=np.int8)
    read_len = len(colours)
    is_n = (colours < 0) | (colours > 3)
    cx = np.where(is_n, np.int8(0), colours)
    px = np.bitwise_xor.accumulate(cx)
    # prefix XOR at the most recent N position (the reset points)
    idx = np.arange(read_len)
    last_n = np.maximum.accumulate(np.where(is_n, idx, -1))
    base = np.where(last_n >= 0, px[np.maximum(last_n, 0)], np.int8(0))
    rel = (px ^ base).astype(np.int8)
    inits = np.array([(k + initbp) % 4 for k in range(4)], np.int8)
    out = inits[:, None] ^ rel[None, :]
    out[:, is_n] = dna.BASE_N
    return out.astype(np.int8)


def get_read_ls4(e: "ReadEntry", st: int) -> np.ndarray:
    """Letter decodings for the requested read strand (lazy; caches may be
    swapped/None after pair-mode read_reverse normalization;
    initbp[1] == initbp[0], gmapper.c:487)."""
    if st == 0:
        if e.read_ls4 is None:
            e.read_ls4 = cs_read_ls4(e.read[0], e.initbp)
        return e.read_ls4
    if e.read_ls4_rc is None:
        e.read_ls4_rc = cs_read_ls4(e.read[1], e.initbp)
    return e.read_ls4_rc


def prepare_read(name: str, seq: str, qual: str | None,
                 cfg: MapperConfig, min_seed_span: int) -> ReadEntry:
    """Per-read prep (launch_scan_threads, gmapper.c:478-533)."""
    crossover_score = None
    read_ls4 = None
    if cfg.colour_space:
        initbp = int(dna.CHAR_TO_CODE[ord(seq[0])])
        if not 0 <= initbp <= 3:
            # no ACGT primer base: unusable read (fasta_sequence_to_bitfield
            # returns NULL, fasta.c:623-634)
            return ReadEntry(name=name, seq=seq, qual=qual,
                             read=[np.zeros(0, np.int8)] * 2, read_len=0,
                             window_len=0, max_n_kmers=0, min_kmer_pos=1,
                             initbp=-1)
        colours = dna.encode(seq[1:])
        read_len = len(colours)
        fw = colours
        rc = dna.reverse_complement_read_cs(colours, initbp, initbp)
        max_n_kmers = max(read_len - min_seed_span + 1 - 2, 0)
        min_kmer_pos = 1
        # position-based crossover scores from qvs (gmapper.c:533-546)
        if qual is not None and not cfg.ignore_qvs:
            from shrimp_tpu_torch.ops.params import ScoreProbs
            probs = ScoreProbs.from_scores(cfg.params, True)
            q = (np.frombuffer(qual[:read_len].encode("latin1"),
                               dtype=np.uint8).astype(np.int32)
                 - cfg.qual_delta)
            # pr_err_from_qv clamps (common/util.h:286-297)
            pr = np.where(q <= 0, 0.99999999,
                          np.where(q >= 250, 1e-25,
                                   10.0 ** (-q / 10.0)))
            v = np.trunc(probs.alpha * np.log(pr / 3.0)
                         / np.log(2.0)).astype(np.int32)
            two_x = 2 * cfg.params.crossover
            crossover_score = np.where(
                v > -1, -1, np.where(v < two_x, two_x, v)).astype(np.int32)
        read_ls4 = cs_read_ls4(colours, initbp)
    else:
        initbp = -1
        fw = dna.encode(seq)
        rc = dna.reverse_complement(fw)
        read_len = len(fw)
        max_n_kmers = max(read_len - min_seed_span + 1, 0)
        min_kmer_pos = 0
    return ReadEntry(
        name=name, seq=seq, qual=qual, read=[fw, rc], read_len=read_len,
        window_len=int(abs_or_pct(cfg.window_len, read_len)),
        max_n_kmers=max_n_kmers, min_kmer_pos=min_kmer_pos, initbp=initbp,
        crossover_score=crossover_score, read_ls4=read_ls4)


def prepare_reads(reads: list[tuple[str, str, str | None]],
                  cfg: MapperConfig, min_seed_span: int) -> list[ReadEntry]:
    """Batch prepare_read: one vectorized codec pass over all letter-space
    reads (colour-space reads keep the per-read path — they carry per-read
    decode chains and crossover arrays)."""
    if cfg.colour_space:
        return [prepare_read(nm, sq, ql, cfg, min_seed_span)
                for nm, sq, ql in reads]
    blob = "".join(sq for _, sq, _ in reads).encode("ascii")
    raw = np.frombuffer(blob, dtype=np.uint8)
    codes_all = dna.CHAR_TO_CODE[raw]
    if np.any(codes_all < 0):
        # rare invalid characters: fall back for exact error behaviour
        return [prepare_read(nm, sq, ql, cfg, min_seed_span)
                for nm, sq, ql in reads]
    lens = np.array([len(sq) for _, sq, _ in reads], np.int64)
    offs = np.zeros(len(reads) + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    comp_all = dna.COMPLEMENT[codes_all]
    wl = cfg.window_len
    out = []
    for i, (nm, sq, ql) in enumerate(reads):
        fw = codes_all[offs[i]:offs[i + 1]]
        rc = comp_all[offs[i]:offs[i + 1]][::-1]
        rl = int(lens[i])
        out.append(ReadEntry(
            name=nm, seq=sq, qual=ql, read=[fw, rc], read_len=rl,
            window_len=int(abs_or_pct(wl, rl)),
            max_n_kmers=max(rl - min_seed_span + 1, 0),
            min_kmer_pos=0, initbp=-1))
    return out


def apply_seed_qual_filter(entries: list[ReadEntry], seed_set,
                           qual_delta: int) -> None:
    """--enable-seed-qual-filter kmer discard masks
    (read_quality_filter_preprocess + is_low_quality_read_subsequence,
    gmapper.h:408-447; call sites mapping.c:78,936).

    Preprocess clamps each quality to [0, 10]: >= TOP_QUALITY_CUTOFF(10)
    -> 10, < INDIVIDUAL_QUALITY_THRESHOLD(3) -> UNTRUSTED(0).  A kmer slot
    is discarded when the summed trusted quality over the seed's care
    positions is >= AVERAGE_QUALITY_THRESHOLD(6) * weight — the shipped
    binary's literal behaviour (the comparison discards HIGH-quality
    kmers; we replicate it for byte parity).  The reference indexes the
    forward-strand filter quals for both strands' slot columns, so one
    mask per (read, seed) serves both strands.

    The two call sites index differently: read_get_mapidxs passes the
    absolute kmer start r_idx = min_kmer_pos + slot (mapping.c:78) while
    the anchor-list loop passes the bare slot index (mapping.c:936).  In
    letter space these coincide (min_kmer_pos = 0); in colour space they
    are off by one, so a slot can be zeroed to mapidx 0 without being
    skipped from anchors (and vice versa).  `sqf` carries the anchor-site
    mask and `sqf_mapidx` the mapidx-site mask.  An all-untrusted
    subsequence makes the reference exit(1) (gmapper.h:448-455); we raise
    the equivalent error.
    """
    for e in entries:
        if e.qual is None:
            e.sqf = e.sqf_mapidx = None
            continue
        q = np.frombuffer(e.qual.encode("latin-1"), np.uint8) \
            .astype(np.int64) - qual_delta
        fq = np.where(q >= 10, 10, np.where(q < 3, 0, q))

        def window_sums(starts, seed):
            s = np.zeros(len(starts), np.int64)
            for j in seed.ones_idx:
                pos = np.minimum(starts + int(j), len(fq) - 1)
                s += fq[pos]
            if np.any(s <= 0):
                raise ValueError(
                    f"seed-qual-filter: all-untrusted seed subsequence in "
                    f"read [{e.name}] (the reference exits here, "
                    f"gmapper.h:448-455)")
            return s

        m_anchor, m_mapidx = [], []
        for seed in seed_set.seeds:
            n = e.read_len - seed.span + 1 - e.min_kmer_pos
            if n <= 0:
                m_anchor.append(np.zeros(0, bool))
                m_mapidx.append(np.zeros(0, bool))
                continue
            slots = np.arange(n)
            thr = 6 * seed.weight
            s_map = window_sums(slots + e.min_kmer_pos, seed)
            m_mapidx.append(s_map >= thr)
            if e.min_kmer_pos == 0:
                m_anchor.append(m_mapidx[-1])
            else:
                m_anchor.append(window_sums(slots, seed) >= thr)
        e.sqf = m_anchor
        e.sqf_mapidx = m_mapidx


def read_mapidxs(re: ReadEntry, idx: GenomeIndex, st: int) -> list[np.ndarray]:
    """Spaced-kmer indices per seed for one strand (read_get_mapidxs,
    mapping.c:38-95).  Returns, per seed, uint32[n_kmer_starts] with -1
    (0xFFFFFFFF) marking invalid slots."""
    codes = re.read[st]
    out = []
    for seed in idx.seed_set.seeds:
        n = re.read_len - seed.span + 1 - re.min_kmer_pos
        if n <= 0:
            out.append(np.full(0, 0, np.uint32))
            continue
        starts = np.arange(re.min_kmer_pos, re.min_kmer_pos + n, dtype=np.int64)
        if seed.positions is not None:
            keep = np.isin(starts, seed.positions + re.min_kmer_pos)
            starts = starts[keep]
        if idx.seed_set.use_hashing:
            from shrimp_tpu_torch.index import hash_mapidx
            mi = hash_mapidx(codes, starts, seed.span, seed.ones_idx,
                             max(sd.span for sd in idx.seed_set.seeds))
        else:
            mi = compute_mapidx(codes, starts, seed.ones_idx)
        full = np.full(n, 0xFFFFFFFF, np.uint32)
        full[starts - re.min_kmer_pos] = mi
        out.append(full)
    return out


def build_anchor_list(re: ReadEntry, idx: GenomeIndex, st: int,
                      mapidxs: list[np.ndarray],
                      collapse: bool = True,
                      list_cutoff: int = 0xFFFFFFFF) -> Anchors:
    """Merged, x-sorted, collapsed anchors (mapping.c:877-1035).

    The reference merges posting lists via a k-way min-heap and collapses
    colinear anchors through a diag-modulo cache; an x-stable sort plus the
    same cache walk reproduces the identical output order and merges.
    """
    xs_parts, y_parts, span_parts = [], [], []
    for sn, seed in enumerate(idx.seed_set.seeds):
        mi = mapidxs[sn]
        off = idx.offsets[sn]
        for k in range(len(mi)):
            m = mi[k]
            if m == 0xFFFFFFFF:
                continue
            lo, hi = off[m], off[m + 1]
            if hi - lo > list_cutoff:
                continue
            if hi > lo:
                xs_parts.append(idx.positions[sn][lo:hi])
                y_parts.append(np.full(hi - lo, re.min_kmer_pos + k, np.int64))
                span_parts.append(np.full(hi - lo, seed.span, np.int32))
    if not xs_parts:
        z64 = np.zeros(0, np.int64)
        z32 = np.zeros(0, np.int32)
        return Anchors(z64, z32, z32, z32, z32)

    x = np.concatenate(xs_parts).astype(np.int64)
    y = np.concatenate(y_parts)
    ln = np.concatenate(span_parts)
    order = np.argsort(x, kind="stable")
    x, y, ln = x[order], y[order], ln[order]
    cn = idx.contig_of(x).astype(np.int32)
    weight = np.ones(len(x), np.int32)

    if not collapse:
        return Anchors(x, y.astype(np.int32), ln, weight, cn)

    # colinear collapse via the diag-modulo cache (mapping.c:997-1013)
    R = re.read_len
    cache = np.full(R, -1, np.int64)
    keep = np.ones(len(x), bool)
    diag_true = x - y
    out_idx = np.arange(len(x))
    # sequential walk (anchor counts are small post-cutoff)
    kept_rows: list[int] = []
    for i in range(len(x)):
        diag_slot = int((x[i] + R - y[i]) % R)
        j = int(cache[diag_slot])
        if (j >= 0 and cn[j] == cn[i] and diag_true[j] == diag_true[i]):
            # anchor_uw_join (anchors.c:98-118): same diagonal, extend
            if x[i] + ln[i] > x[j] + ln[j]:
                ln[j] = np.int32(x[i] - x[j] + ln[i])
            weight[j] += weight[i]
            keep[i] = False
        else:
            cache[diag_slot] = i
    x, y, ln, weight, cn = x[keep], y[keep], ln[keep], weight[keep], cn[keep]
    return Anchors(x, y.astype(np.int32), ln, weight, cn)


def build_hit_list(re: ReadEntry, idx: GenomeIndex, anchors: Anchors,
                   options: HitListOptions, cfg: MapperConfig) -> HitList:
    """Candidate-window generation (read_get_hit_list_per_strand,
    mapping.c:1052-1264)."""
    n = anchors.n
    if n == 0:
        return HitList()
    p = cfg.params
    match = p.match
    contig_offsets = idx.contig_offsets
    contig_len = idx.contig_len

    out_cn, out_goff, out_wlen = [], [], []
    out_score, out_matches = [], []
    out_ax, out_ay, out_al, out_aw = [], [], [], []

    x, y, ln, wt, cn = (anchors.x, anchors.y, anchors.length,
                        anchors.weight, anchors.cn)

    for i in range(n):
        c = int(cn[i])
        glen_c = int(contig_len[c])
        coff = int(contig_offsets[c])
        w_len = re.window_len
        if w_len > glen_c:
            w_len = glen_c

        gend = (int(x[i]) - coff) + re.read_len - 1 - int(y[i])
        if gend > glen_c - 1:
            gend = glen_c - 1
        gstart = gend - re.window_len if gend >= re.window_len else 0

        max_idx = i
        max_score = int(ln[i]) * match

        if not options.gapless:
            if options.match_mode == 2 and wt[i] == 1:
                max_score = -1
            j = i - 1
            while j >= 0 and x[j] >= coff + gstart:
                if y[j] >= y[i]:
                    j -= 1
                    continue
                diag_i = int(x[i]) - coff - int(y[i])
                diag_j = int(x[j]) - coff - int(y[j])
                if diag_i > diag_j:   # deletion in read
                    short_len = int(y[i] - y[j]) + int(ln[i])
                    long_len = int(x[i] - x[j]) + int(ln[i])
                else:                 # insertion in read
                    short_len = int(x[i] - x[j]) + int(ln[i])
                    long_len = int(y[i] - y[j]) + int(ln[i])
                # NB: reference always applies b-gap penalties here
                # (mapping.c:1155-1160), despite computing a/b selection
                if long_len > short_len:
                    tmp_score = (short_len * match + p.b_gap_open
                                 + (long_len - short_len) * p.b_gap_extend)
                else:
                    tmp_score = short_len * match
                if tmp_score > max_score:
                    max_idx = j
                    max_score = tmp_score
                j -= 1

        base = min(re.read_len, w_len) * match
        if (options.gapless or options.match_mode == 1
                or max_score >= int(abs_or_pct(options.threshold, base))):
            x_len = int(x[i] - x[max_idx]) + int(ln[i])
            if (re.window_len - x_len) // 2 < int(x[max_idx]) - coff:
                goff = (int(x[max_idx]) - coff) - (re.window_len - x_len) // 2
            else:
                goff = 0
            if goff + w_len > glen_c:
                goff = glen_c - w_len

            # join anchors i and max_idx relative to the window
            # (mapping.c:1210-1219 via anchor_join)
            if max_idx < i:
                pts = [(int(x[k]) - coff - goff, int(y[k]), int(ln[k]))
                       for k in (i, max_idx)]
                nw = min(px + py for px, py, _ in pts)
                sw = min(px - py for px, py, _ in pts)
                ne = max(px - py for px, py, _ in pts)
                se = max(px + py + 2 * (pl - 1) for px, py, pl in pts)
                if (nw + sw) % 2 != 0:
                    nw -= 1
                ax = (nw + sw) // 2
                ay = nw - ax
                if (ne - sw) % 2 != 0:
                    ne += 1
                aw = (ne - sw) // 2 + 1
                if (se - nw) % 2 != 0:
                    se += 1
                al = (se - nw) // 2 + 1
                n_matches = int(wt[i] + wt[max_idx])
            else:
                ax = int(x[i]) - coff - goff
                ay = int(y[i])
                al = int(ln[i])
                aw = 1
                n_matches = int(wt[i])

            out_cn.append(c)
            out_goff.append(goff)
            out_wlen.append(w_len)
            out_score.append(max_score)
            out_matches.append(n_matches)
            out_ax.append(ax)
            out_ay.append(ay)
            out_al.append(al)
            out_aw.append(aw)

    if not out_cn:
        return HitList()

    hl = HitList(
        cn=np.array(out_cn, np.int32),
        g_off=np.array(out_goff, np.int64),
        w_len=np.array(out_wlen, np.int32),
        score_window_gen=np.array(out_score, np.int32),
        matches=np.array(out_matches, np.int32),
        anchor_x=np.array(out_ax, np.int64),
        anchor_y=np.array(out_ay, np.int64),
        anchor_length=np.array(out_al, np.int32),
        anchor_width=np.array(out_aw, np.int32),
    )
    # stable insertion sort by (cn, g_off) — reference fixes minor inversions
    # from goff centering (mapping.c:1236-1249) with a stable shift
    order = np.lexsort((hl.g_off, hl.cn))
    # emulate stability: lexsort is stable on equal keys
    for f in ("cn", "g_off", "w_len", "score_window_gen", "matches",
              "anchor_x", "anchor_y", "anchor_length", "anchor_width"):
        setattr(hl, f, getattr(hl, f)[order])
    return hl
