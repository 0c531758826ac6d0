"""Paired-end mapping (L5) — handle_readpair, batched; the counterpart of
`shrimp_tpu/pipeline/paired.py`.

Replicates `gmapper/mapping.c:handle_readpair` (:2468-2601) and its stages:
mate-range computation (:2283-2412), hit pairing by insert interval
(:285-340), paired vector-hit selection (:1895-1955), paired pass2 with
per-foot full SW + pair threshold (:2174-2280), dominant-single-hit dedup
(:2060-2170), the half-paired unpaired fallback rounds (:2572-2576), paired
Bayesian mapping qualities (`gmapper/output.c:812-942`), and paired SAM
emission (`readpair_output`, output.c:1071-1291).

Pair modes and read normalization (gmapper-defaults.h:175-191): opp-out
reverses both reads, col-fw the second, col-bw the first — after which the
machinery treats every mode like opposing-strands-inwards with mode-specific
delta windows.  A reversed mate's rows are framed at input strand 1.

The host logic is the JAX package's, line for line.  The device work goes
through the unpaired Mapper's kernels: pass 1 is one launch of the vector
score (K1 in letter space, the K2-CS gather in colour space) for both
mates' fresh rows and the half-paired fallback's prefetched rows
(`_score_windows_sides`); pass 2 is one launch of the packed full SW
(K3+K4, or K7+K8) for both mates' feet (`_run_full_sw_sides`, through
`Mapper._pass2_dispatch`).  Where the JAX package switches to its unbanded
kernels (the band as wide as the window, or no band), the packed kernel
runs over the full band, as on the unpaired path.  Candidates are made on
the host (the mate-pair region filter runs there).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from shrimp_tpu_torch import mapq
from shrimp_tpu_torch.io import sam
from shrimp_tpu_torch.pipeline import candidates as cand
from shrimp_tpu_torch.pipeline import candidates_batch as cb
from shrimp_tpu_torch.pipeline.mapper import FinalHit, Mapper, _round_up
from shrimp_tpu_torch.pipeline.options import (MapperConfig, abs_or_pct,
                                               is_absolute)

PAIR_NONE = 0
PAIR_OPP_IN = 1
PAIR_OPP_OUT = 2
PAIR_COL_FW = 3
PAIR_COL_BW = 4

PAIR_MODE_NAMES = ["none", "opp-in", "opp-out", "col-fw", "col-bw"]

# which feet get reverse-complemented on input (DEF_PAIR_REVERSE)
PAIR_REVERSE = [(0, 0), (0, 0), (1, 1), (0, 1), (1, 0)]


@dataclass
class PairedConfig:
    pair_mode: int = PAIR_OPP_IN
    min_insert_size: int = 0          # DEF_MIN_INSERT_SIZE
    max_insert_size: int = 1000       # DEF_MAX_INSERT_SIZE
    insert_size_mean: float = 200.0   # DEF_INSERT_SIZE_MEAN
    insert_size_stddev: float = 100.0
    match_mode: int = 4               # DEF_MATCH_MODE_PAIRED


@dataclass
class PairResult:
    """Final output for one read pair."""

    re: list                       # [ReadEntry, ReadEntry]
    paired_hits: list = field(default_factory=list)   # [(FinalHit, FinalHit, insert_size)]
    unpaired_hits: list = field(default_factory=list) # [(nip, FinalHit)]


def compute_mp_deltas(pair_mode: int, rlen1: int, wlen1: int,
                      rlen2: int, wlen2: int,
                      min_ins: int, max_ins: int):
    """delta_g_off ranges (readpair_compute_mp_ranges, mapping.c:2283-2412).

    Returns (d1, d2) where d[st] = (min, max) allowed re2.g_off - re1.g_off
    when re1's hit is on strand st (and the mate on 1-st).
    """
    d1 = {}
    if pair_mode == PAIR_OPP_IN:
        d1[0] = (min_ins - wlen2,
                 max_ins + (wlen1 - rlen1) - rlen2)
        d1[1] = (-max_ins + rlen1 + (rlen2 - wlen2),
                 -min_ins + wlen1)
    elif pair_mode == PAIR_OPP_OUT:
        base0 = (min_ins - wlen2, max_ins + (wlen1 - rlen1) - rlen2)
        d1[0] = (base0[0] + rlen1 + rlen2, base0[1] + rlen1 + rlen2)
        base1 = (-max_ins + rlen1 + (rlen2 - wlen2), -min_ins + wlen1)
        d1[1] = (base1[0] - rlen1 - rlen2, base1[1] - rlen1 - rlen2)
    elif pair_mode == PAIR_COL_FW:
        base0 = (min_ins - wlen2, max_ins + (wlen1 - rlen1) - rlen2)
        d1[0] = (base0[0] + rlen2, base0[1] + rlen2)
        base1 = (-max_ins + rlen1 + (rlen2 - wlen2), -min_ins + wlen1)
        d1[1] = (base1[0] - rlen2, base1[1] - rlen2)
    elif pair_mode == PAIR_COL_BW:
        base0 = (min_ins - wlen2, max_ins + (wlen1 - rlen1) - rlen2)
        d1[0] = (base0[0] + rlen1, base0[1] + rlen1)
        base1 = (-max_ins + rlen1 + (rlen2 - wlen2), -min_ins + wlen1)
        d1[1] = (base1[0] - rlen1, base1[1] - rlen1)
    else:
        raise ValueError(f"bad pair mode {pair_mode}")

    d2 = {}
    if pair_mode in (PAIR_OPP_IN, PAIR_OPP_OUT):
        d2[0] = (-d1[1][1], -d1[1][0])
        d2[1] = (-d1[0][1], -d1[0][0])
    else:  # colinear modes swap differently (mapping.c:2348-2352,2378-2382)
        d2[0] = (-d1[0][1], -d1[0][0])
        d2[1] = (-d1[1][1], -d1[1][0])
    return d1, d2


def _suppress_scan_flags(hb, idxs, order, sc, thr, need, saved_mask,
                         window_overlap, wlen_cfg) -> np.ndarray:
    """Window-overlap suppression over participating hits with the
    paired-round flags (read_pass1_per_strand, mapping.c:1299-1356):
    saved hits become last_good unconditionally and are never
    suppressed; hits with a persisted score (need == 0) never update
    last_good.  Native C scan (pass1_suppress_flags) with a Python
    fallback; returns the suppressed bool mask over idxs order."""
    ovl_r = np.array([int(abs_or_pct(window_overlap, w))
                      for w in wlen_cfg], np.int64)
    from shrimp_tpu_torch import native as _native
    _clib = _native.load_candidates()
    if _clib is not None and hasattr(_clib, "pass1_suppress_flags"):
        import ctypes as _ct
        _sup = np.zeros(len(idxs), np.uint8)

        def _p(a, t):
            return np.ascontiguousarray(a).ctypes.data_as(_ct.POINTER(t))
        _clib.pass1_suppress_flags(
            _p(order.astype(np.int64), _ct.c_longlong), len(idxs),
            _p(hb.rid[idxs].astype(np.int32), _ct.c_int32),
            _p(hb.st[idxs].astype(np.int8), _ct.c_int8),
            _p(hb.cn[idxs].astype(np.int32), _ct.c_int32),
            _p(hb.g_off[idxs].astype(np.int64), _ct.c_longlong),
            _p(np.ascontiguousarray(sc, np.int64), _ct.c_longlong),
            # thr may arrive float (absolute-threshold branch); ints
            # compare sc >= thr exactly via ceil (thr >= 0 always)
            _p(np.ceil(thr).astype(np.int64), _ct.c_longlong),
            _p(ovl_r, _ct.c_longlong),
            _p(np.ascontiguousarray(wlen_cfg, np.int64), _ct.c_longlong),
            _p(saved_mask.astype(np.uint8), _ct.c_uint8),
            _p(need.astype(np.uint8), _ct.c_uint8),
            _sup.ctypes.data_as(_ct.POINTER(_ct.c_uint8)))
        return _sup.astype(bool)
    sup = np.zeros(len(idxs), bool)
    lg = -1
    prev = None
    for n in order:
        r, s = hb.rid[idxs[n]], hb.st[idxs[n]]
        if (r, s) != prev:
            lg = -1
            prev = (r, s)
        if saved_mask[n]:
            lg = n
            continue
        if lg >= 0 and hb.cn[idxs[n]] == hb.cn[idxs[lg]] \
           and (hb.g_off[idxs[n]] + ovl_r[r]
                <= hb.g_off[idxs[lg]] + wlen_cfg[r]):
            sup[n] = True
            continue
        if not need[n]:
            continue                # persisted > 0: no last_good update
        if sc[n] >= thr[n]:
            lg = n
    return sup


def common_qname(name1: str, name2: str) -> str:
    """Common-prefix qname trimming of a pair's read names — the SAM
    QNAME both mates share (hit_output, output.c:371-387)."""
    i = 0
    while i < min(len(name1), len(name2)) and name1[i] == name2[i]:
        i += 1
    if i > 0 and i <= len(name1) and name1[i - 1] in ":/":
        i -= 1
    return name1[:i]


def get_insert_size(fh1: FinalHit, fh2: FinalHit, contig_len1: int,
                    contig_len2: int, cn_equal: bool) -> int:
    """5'-to-5' insert size (get_insert_size, mapping.c:421-474)."""
    if not cn_equal:
        return 0

    def fivep(fh: FinalHit, contig_len: int) -> int:
        read_start = fh.read_start + 1
        read_end = read_start + fh.rmapped - 1
        if fh.gen_st == 0:
            gstart = fh.g_off + fh.genome_start + 1
        else:
            right_most = contig_len - (fh.g_off + fh.genome_start)
            gstart = right_most - (read_end - read_start
                                   - fh.deletions + fh.insertions)
        gend = gstart + fh.gmapped - 1
        return gend if fh.gen_st == 1 else gstart - 1

    return fivep(fh2, contig_len2) - fivep(fh1, contig_len1)


class PairedMapper(Mapper):
    """Paired-end mapper; delegates per-stage machinery to Mapper."""

    def __init__(self, index, cfg: MapperConfig | None = None,
                 pcfg: PairedConfig | None = None, device="cuda"):
        super().__init__(index, cfg, device=device)
        self.pcfg = pcfg or PairedConfig()

    # ------------------------------------------------------------------
    def map_pair_batch(self, pairs, option_sets=None) -> list[PairResult]:
        """Map a batch of read pairs through the option-set rounds
        (handle_readpair's do/while, mapping.c:2486-2568).

        pairs: list of ((name, seq, qual), (name, seq, qual)).
        option_sets: list of popts dicts (see `_popts_from` /
        `default_paired_sets`); None = the default single set.
        """
        cfg = self.cfg
        pcfg = self.pcfg
        sets = (option_sets if option_sets is not None
                else self.default_paired_sets())
        rev1, rev2 = PAIR_REVERSE[pcfg.pair_mode]

        with self.tel.stage("readparse"):
            entries1, entries2 = [], []
            for (n1, s1, q1), (n2, s2, q2) in pairs:
                e1 = cand.prepare_read(n1, s1, q1, cfg, self.min_seed_span)
                e2 = cand.prepare_read(n2, s2, q2, cfg, self.min_seed_span)
                if rev1:
                    e1.read = [e1.read[1], e1.read[0]]
                    e1.read_ls4, e1.read_ls4_rc = \
                        e1.read_ls4_rc, e1.read_ls4
                if rev2:
                    e2.read = [e2.read[1], e2.read[0]]
                    e2.read_ls4, e2.read_ls4_rc = \
                        e2.read_ls4_rc, e2.read_ls4
                entries1.append(e1)
                entries2.append(e2)
        if cfg.seed_qual_filter:
            # same slot-column mask regardless of mate reversal — the
            # reference's filter_qual is never reversed (mapping.c:48-51)
            cand.apply_seed_qual_filter(entries1, self.index.seed_set,
                                        cfg.qual_delta)
            cand.apply_seed_qual_filter(entries2, self.index.seed_set,
                                        cfg.qual_delta)
        input_strand1 = 1 if rev1 else 0
        input_strand2 = 1 if rev2 else 0

        P = len(pairs)
        results = [PairResult(re=[entries1[i], entries2[i]])
                   for i in range(P)]

        # pairs still falling through the option sets (done == false)
        alive = np.ones(P, bool)
        hits: dict[int, cb.HitBatch | None] = {0: None, 1: None}
        saved_rows: dict[int, set] = {0: set(), 1: set()}
        sv = {0: None, 1: None}
        sv_true = {0: None, 1: None}
        # per-side raw vector-score cache for the current hit-list
        # generation (-1 = unscored); scores are deterministic per hit
        # row, so paired rounds + the half-paired fallback share one
        # kernel launch instead of rescoring
        sv_cache: dict[int, np.ndarray | None] = {0: None, 1: None}
        # single default set + half_paired: the fallback round's rows are
        # known up front — prefetch them inside the paired pass1 dispatch
        prefetch_ok = len(sets) == 1 and cfg.half_paired

        for popts in sets:
            if not alive.any():
                break
            pairing = popts["pairing"]
            rsides = popts["read"]

            # ---- candidates per side (restricted to alive pairs) ----
            fresh = {0: False, 1: False}
            mp_ctx = None
            for side, entries in ((0, entries1), (1, entries2)):
                ro = rsides[side]
                if hits[side] is not None and not ro["recompute_candidates"]:
                    continue
                fresh[side] = True
                live_idx = np.flatnonzero(alive)
                live = [entries[i] for i in live_idx]
                per = []
                for st in (0, 1):
                    if not (cfg.strand_mask >> st) & 1:
                        continue
                    mp_mode = (ro.get("use_mp_region_counts", 0)
                               if ro["use_region_counts"] else 0)
                    hl_mode3 = ro["hit_list"].match_mode == 3
                    heavy = None
                    if mp_mode or hl_mode3:
                        if mp_ctx is None:
                            with self.tel.stage("mp_region_counts"):
                                mp_ctx = self._mp_region_ctx(
                                    entries1, entries2, live_idx, pairing)
                        dmn = mp_ctx["dmin"][side][:, st]
                        dmx = mp_ctx["dmax"][side][:, st]
                        own = mp_ctx["visits"][(side, st)]
                        mate = mp_ctx["visits"][(1 - side, 1 - st)]
                    with self.tel.stage("anchor_list"):
                        if mp_mode:
                            ab = cb.anchors_batch(
                                live, self.index, st,
                                collapse=ro["collapse"],
                                list_cutoff=self.index.list_cutoff,
                                postings=mp_ctx["postings"][(side, st)],
                                region_filter=lambda rid, x:
                                    cb.region_mp_filter(
                                        rid, x, own, mate, dmn, dmx,
                                        mp_mode))
                        else:
                            ab = cb.anchors_batch(
                                live, self.index, st,
                                collapse=ro["collapse"],
                                list_cutoff=self.index.list_cutoff,
                                use_region_counts=ro["use_region_counts"])
                    with self.tel.stage("hit_list"):
                        if hl_mode3:
                            heavy = cb.mp_heavy_flags(ab.rid, ab.x, mate,
                                                      dmn, dmx)
                        per.append(cb.hit_list_batch(live, self.index, ab,
                                                     ro["hit_list"], cfg,
                                                     heavy_mp=heavy))
                hb = cb.HitBatch(**{
                    f: np.concatenate([getattr(h, f) for h in per])
                    for f in ("rid", "st", "cn", "g_off", "w_len",
                              "score_window_gen", "matches", "score_max",
                              "anchor_x", "anchor_y", "anchor_length",
                              "anchor_width")})
                hb.rid = live_idx[hb.rid].astype(np.int32)  # full-rid space
                hits[side] = hb
                # a recomputed hit list frees the previous rounds' saved
                # flags (read_free_hit_list, mapping.c:2516-2524) and
                # invalidates the score cache
                saved_rows[side] = set()
                sv_cache[side] = np.full(hb.n, -1, np.int64)

            # ---- pair up hits under this set's insert range ----
            with self.tel.stage("pair_up"):
                pair_rows = self._pair_up(entries1, entries2, hits,
                                          pcfg.pair_mode,
                                          pairing["min_insert"],
                                          pairing["max_insert"], alive)

            # ---- pass1 vector scores for hits participating in pairs.
            # pass1.recompute=false keeps the previous round's per-hit
            # scores (read_pass1 skipped, mapping.c:2528-2533); a fresh hit
            # list forces recomputation regardless (stale scores would be
            # uninitialized in the reference) ----
            p1_ctx: dict[int, dict | None] = {0: None, 1: None}
            with self.tel.stage("pass1"):
                for side, entries, istrand in ((0, entries1, input_strand1),
                                               (1, entries2,
                                                input_strand2)):
                    if (sv[side] is not None and not fresh[side]
                            and not rsides[side].get("recompute_pass1",
                                                     True)):
                        continue
                    prev = (None if fresh[side] or sv[side] is None
                            else (sv[side], sv_true[side]))
                    ctx = self._paired_pass1_begin(
                        entries, istrand, hits[side],
                        pair_rows[f"in_pair_{side}"], rsides[side],
                        prev=prev, saved_rows=saved_rows[side])
                    ctx["cache"] = sv_cache[side]
                    if prefetch_ok and ctx["done"] is None:
                        hb = hits[side]
                        pm = ((hb.matches >= 2) & alive[hb.rid]
                              & (sv_cache[side] < 0))
                        if ctx["nrows"] is not None:
                            pm[ctx["nrows"]] = False
                        ctx["prefetch_rows"] = np.flatnonzero(pm)
                    p1_ctx[side] = ctx
                # one device dispatch covers both mates' fresh windows
                # (paired rows + the prefetched fallback rows)
                self._score_windows_sides([p1_ctx[0], p1_ctx[1]])
                for side in (0, 1):
                    ctx = p1_ctx[side]
                    if ctx is None:
                        continue
                    sv[side], sv_true[side] = (
                        ctx["done"] if ctx["done"] is not None
                        else self._paired_pass1_end(ctx))

            # ---- paired vector-hit selection + paired pass2 ----
            with self.tel.stage("get_vector_hits"):
                sel_pairs = self._select_vector_pairs(
                    hits, sv, pair_rows, popts, saved_rows=saved_rows)
            with self.tel.stage("pass2"):
                paired_final, saved, attempted = self._paired_pass2(
                    entries1, entries2, input_strand1, input_strand2,
                    hits, sv_true, sel_pairs, popts)
            saved_rows[0] |= saved[0]
            saved_rows[1] |= saved[1]
            # hit_run_full_sw re-runs the vector kernel and OVERWRITES the
            # persisted score_vector for every foot attempted in pass2
            # (mapping.c:400-404) — pass1 suppression on those rows is undone
            for side in (0, 1):
                if attempted[side]:
                    rows = np.fromiter(attempted[side], np.int64)
                    sv[side][rows] = sv_true[side][rows]

            # ---- accumulate outputs + stop condition (readpair_pass2 tail,
            # mapping.c:2264-2278) ----
            for r, lst in paired_final.items():
                results[r].paired_hits.extend(lst)
            if pairing["stop_count"] == 0:
                alive[:] = False
            else:
                for r in np.flatnonzero(alive):
                    cnt = 0
                    for fh0, fh1, _ in paired_final.get(int(r), []):
                        smax = fh0.score_max + fh1.score_max
                        if fh0.score_full + fh1.score_full >= \
                           int(abs_or_pct(pairing["stop_threshold"], smax)):
                            cnt += 1
                    if cnt >= pairing["stop_count"]:
                        alive[r] = False

        # ---- half-paired unpaired rounds for fell-through pairs
        # (mapping.c:2572-2576) ----
        unpaired_final = {0: {}, 1: {}}
        if cfg.half_paired and alive.any():
            fb = self._fallback_ropts()
            with self.tel.stage("hp_pass1"):
                hp_ctx = []
                for side, entries, istrand in (
                        (0, entries1, input_strand1),
                        (1, entries2, input_strand2)):
                    ctx = self._halfpaired_begin(
                        entries, istrand, hits[side], sv[side],
                        saved_rows[side], fb, alive)
                    ctx["cache"] = sv_cache[side]
                    hp_ctx.append(ctx)
                # both mates' fresh windows in one device dispatch —
                # normally zero rows: the paired pass1 prefetched them
                self._score_windows_sides(hp_ctx)
            with self.tel.stage("hp_pass2"):
                # both mates' fallback feet in one full-SW dispatch
                hp_tasks = [self._halfpaired_select(hp_ctx[side])
                            for side in (0, 1)]
                hp_res = self._run_full_sw_sides(hp_tasks)
                for side in (0, 1):
                    unpaired_final[side] = self._halfpaired_finish(
                        hp_tasks[side], hp_res[side])

        # ---- assemble + MQV + package ----
        with self.tel.stage("paired_mqv"):
            for pi in range(P):
                pr = results[pi]
                for side in (0, 1):
                    for fh in unpaired_final[side].get(pi, []):
                        pr.unpaired_hits.append((side, fh))
                if cfg.compute_mapping_qualities:
                    self._paired_mqv(pr)
        return results

    # ------------------------------------------------------------------
    def _mp_region_ctx(self, entries1, entries2, live_idx, pairing):
        """Shared state for mate-pair region-count pruning: raw postings +
        region visit counts for all 4 (side, strand) streams, and the
        per-pair delta_region windows (readpair_compute_mp_ranges tail:
        floor(dmin/2^bits), ceil(dmax/2^bits))."""
        postings = {}
        visits = {}
        live = {0: [entries1[i] for i in live_idx],
                1: [entries2[i] for i in live_idx]}
        for side in (0, 1):
            sqf_on = any(e.sqf is not None for e in live[side])
            for st in (0, 1):
                p = cb.expand_postings(live[side], self.index, st,
                                       self.index.list_cutoff)
                postings[(side, st)] = p
                extra = (cb.sqf_region_extras(live[side], self.index, st,
                                              self.index.list_cutoff)
                         if sqf_on else None)
                visits[(side, st)] = cb.region_visits(p[0], p[1],
                                                      extra=extra)
        L = len(live_idx)
        R = 1 << cb.REGION_BITS
        dmin = {0: np.zeros((L, 2), np.int64), 1: np.zeros((L, 2), np.int64)}
        dmax = {0: np.zeros((L, 2), np.int64), 1: np.zeros((L, 2), np.int64)}
        for li in range(L):
            e1 = entries1[live_idx[li]]
            e2 = entries2[live_idx[li]]
            d1, d2 = compute_mp_deltas(
                self.pcfg.pair_mode, e1.read_len, e1.window_len,
                e2.read_len, e2.window_len,
                pairing["min_insert"], pairing["max_insert"])
            for st in (0, 1):
                for s, d in ((0, d1), (1, d2)):
                    lo, hi = d[st]
                    dmin[s][li, st] = lo // R
                    dmax[s][li, st] = -((-hi) // R)
        return {"postings": postings, "visits": visits,
                "dmin": dmin, "dmax": dmax}

    # ------------------------------------------------------------------
    def map_pair_stream(self, pairs_iter, batch_size: int = 1024,
                        option_sets=None):
        """Pipelined paired mapping: up to two `map_pair_batch` calls in
        flight on worker threads, results yielded in input order.

        One batch's host work (read prep, candidates, pairing) overlaps
        the other's device DP waits — the OpenMP-overlap analogue of
        `Mapper.map_stream` for the paired flow, whose host/device phases
        interleave too finely for an explicit dispatch/finish split."""
        from concurrent.futures import ThreadPoolExecutor

        ex = ThreadPoolExecutor(max_workers=2)
        try:
            futs = []
            batch = []
            for p in pairs_iter:
                batch.append(p)
                if len(batch) >= batch_size:
                    futs.append(ex.submit(self.map_pair_batch, batch,
                                          option_sets))
                    batch = []
                    if len(futs) > 2:
                        yield from futs.pop(0).result()
            if batch:
                futs.append(ex.submit(self.map_pair_batch, batch,
                                      option_sets))
            for f in futs:
                yield from f.result()
        finally:
            ex.shutdown(wait=True)

    # ------------------------------------------------------------------
    def default_paired_sets(self):
        """Default single paired option set (gmapper.c:2634-2716): with
        half_paired the stop threshold is an unattainable 101%, so every
        pair falls through to the unpaired rounds."""
        cfg = self.cfg
        mm = self.pcfg.match_mode
        sw_vect_threshold = cfg.vect_threshold()
        sw_full_threshold = cfg.sw_full_threshold
        from shrimp_tpu_torch.pipeline.options import HitListOptions
        hl = HitListOptions(
            gapless=cfg.gapless,
            match_mode=(2 if mm == 4 else 3 if mm == 3 else 1),
            threshold=cfg.window_gen_threshold)
        # gmapper.c:2656-2661 (use_mp_region_counts construction)
        use_mp = 0
        if cfg.use_regions:
            use_mp = (1 if mm == 4 and not cfg.half_paired
                      else 2 if mm == 3 and cfg.half_paired
                      else 3 if mm == 3 and not cfg.half_paired
                      else 0)
        rd = {
            "recompute_candidates": True,
            "recompute_pass1": True,
            "collapse": True,
            "use_region_counts": cfg.use_regions and mm != 2,
            "use_mp_region_counts": use_mp,
            "hit_list": hl,
            "pass1_threshold": sw_vect_threshold,
            "pass1_min_matches": 2 if mm == 4 else 1,
            "pass2_threshold": sw_full_threshold * 0.5,
            "window_overlap": cfg.window_overlap,
        }
        return [{
            "pairing": {
                "min_insert": self.pcfg.min_insert_size,
                "max_insert": self.pcfg.max_insert_size,
                "pass1_threshold": sw_vect_threshold,
                "pass2_threshold": sw_full_threshold,
                "pass1_num_outputs": 3 * cfg.num_outputs,
                "pass2_num_outputs": cfg.num_outputs,
                "strata": cfg.strata,
                "stop_count": 1 if cfg.half_paired else 0,
                "stop_threshold": 101.0,
            },
            "read": (rd, rd),
        }]

    def _popts_from(self, rpo):
        """Convert a parsed ReadPairMappingOptions (--paired-options string)
        into the internal popts dict."""
        def rd(ro):
            return {
                "recompute_candidates": (ro.anchor_list.recompute
                                         or ro.hit_list.recompute),
                "recompute_pass1": ro.pass1.recompute,
                "collapse": ro.anchor_list.collapse,
                "use_region_counts": ro.anchor_list.use_region_counts,
                "use_mp_region_counts": ro.anchor_list.use_mp_region_counts,
                "hit_list": ro.hit_list,
                "pass1_threshold": ro.pass1.threshold,
                "pass1_min_matches": ro.pass1.min_matches,
                "pass2_threshold": ro.pass2.threshold,
                "window_overlap": ro.pass1.window_overlap,
            }
        return {
            "pairing": {
                "min_insert": rpo.pairing.min_insert_size,
                "max_insert": rpo.pairing.max_insert_size,
                "pass1_threshold": rpo.pairing.pass1_threshold,
                "pass2_threshold": rpo.pairing.pass2_threshold,
                "pass1_num_outputs": rpo.pairing.pass1_num_outputs,
                "pass2_num_outputs": rpo.pairing.pass2_num_outputs,
                "strata": rpo.pairing.strata,
                "stop_count": rpo.pairing.stop_count,
                "stop_threshold": rpo.pairing.stop_threshold,
            },
            "read": (rd(rpo.read[0]), rd(rpo.read[1])),
        }

    def _fallback_ropts(self):
        """Options for the half-paired unpaired fallback rounds
        (gmapper.c:2684-2712: min_matches 2, vector threshold, reuse of the
        last paired round's hit lists)."""
        return {
            "pass1_threshold": self.cfg.vect_threshold(),
            "pass1_min_matches": 2,
            "window_overlap": self.cfg.window_overlap,
        }

    # ------------------------------------------------------------------
    def _pair_up(self, entries1, entries2, hits, pair_mode, min_insert,
                 max_insert, alive=None):
        """Vectorized readpair_pair_up_hits: for each re1 hit on strand st,
        the mate candidates are re2 hits on strand 1-st within
        [g_off + dmin, g_off + dmax], same contig.  Rows of pairs not in
        `alive` get no mate range (they are no longer being mapped)."""
        h0, h1 = hits[0], hits[1]
        n0 = h0.n
        pair_min = np.full(n0, -1, np.int64)
        pair_max = np.full(n0, -1, np.int64)
        in_pair_1 = np.zeros(h1.n, bool)

        # per-pair deltas
        P = len(entries1)
        dmin = np.zeros((P, 2), np.int64)
        dmax = np.zeros((P, 2), np.int64)
        for pi in range(P):
            d1, _ = compute_mp_deltas(
                pair_mode,
                entries1[pi].read_len, entries1[pi].window_len,
                entries2[pi].read_len, entries2[pi].window_len,
                min_insert, max_insert)
            dmin[pi, 0], dmax[pi, 0] = d1[0]
            dmin[pi, 1], dmax[pi, 1] = d1[1]

        # sort h1 into (rid, st, cn, g_off) order and pack a comparable
        # int64 key rid*2+st | cn | g_off+1 with bit widths sized to the
        # genome: scaffold-heavy draft assemblies have many SMALL contigs,
        # so cn and g_off bits trade off inside the 63-bit budget
        # (g_off offset by +1 keeps the key monotone for g_off == -1)
        cn_bits = max(int(self.index.num_contigs).bit_length(), 1)
        max_clen = int(self.index.contig_len.max()) if \
            self.index.num_contigs else 1
        goff_bits = max((max_clen + 2).bit_length(), 2)
        rid_bits = (2 * max(len(entries1), 1) + 1).bit_length()
        if cn_bits + goff_bits + rid_bits > 63:
            raise NotImplementedError(
                f"pair-up key overflow: {self.index.num_contigs} contigs x "
                f"{max_clen}bp x {len(entries1)} reads")
        order1 = np.lexsort((h1.g_off, h1.cn, h1.st, h1.rid))

        def pack(rid, st, cn, goff):
            return (((rid.astype(np.int64) * 2 + st)
                     << (cn_bits + goff_bits))
                    | (cn.astype(np.int64) << goff_bits)
                    | (np.clip(goff + 1, 0, (1 << goff_bits) - 1)))

        skey = pack(h1.rid[order1], h1.st[order1].astype(np.int64),
                    h1.cn[order1], h1.g_off[order1].astype(np.int64))

        r0 = h0.rid.astype(np.int64)
        st0 = h0.st.astype(np.int64)
        mate_st = 1 - st0
        lo_t = pack(r0, mate_st, h0.cn, h0.g_off + dmin[r0, st0])
        hi_t = pack(r0, mate_st, h0.cn, h0.g_off + dmax[r0, st0])
        lo = np.searchsorted(skey, lo_t, side="left")
        hi = np.searchsorted(skey, hi_t, side="right")
        has = hi > lo
        if alive is not None:
            has &= alive[h0.rid]
        pair_min = np.where(has, lo, -1)
        pair_max = np.where(has, hi - 1, -1)
        # mark mate rows that participate (range-union via diff array)
        if has.any():
            marks = np.zeros(h1.n + 1, np.int64)
            np.add.at(marks, pair_min[has], 1)
            np.add.at(marks, pair_max[has] + 1, -1)
            in_pair_1[order1] = np.cumsum(marks[:-1]) > 0

        return {
            "pair_min": pair_min, "pair_max": pair_max,
            "order1": order1,
            "in_pair_0": has,
            "in_pair_1": in_pair_1,
        }

    # ------------------------------------------------------------------
    def _paired_pass1_begin(self, entries, istrand, hb, in_pair, ropts,
                            prev=None, saved_rows=()):
        """First half of the paired pass 1, vector SW scores + suppression
        for hits participating in pairs (read_pass1 with only_paired=true,
        mapping.c:1282-1360): everything up to (but not including) the
        vector scoring of hits that need fresh scores, which
        `_score_windows_sides` does for both mates at once.  Returns a ctx
        dict, with ctx["nrows"] = hit rows to score (None when done
        already — ctx["done"] carries the result).

        The result, (eff_scores, true_scores): eff has suppressed windows
        zeroed (drives pair keys); true is the raw vector score (pass2
        re-runs the vector kernel per foot — hit_run_full_sw,
        mapping.c:400-415).  Multi-round semantics: `prev` = (eff, true)
        from the previous round over the SAME hit list; persisted > 0
        scores are not rescored and never update last_good; saved hits
        update last_good unconditionally; suppression zeroes
        permanently."""
        if prev is not None:
            scores = prev[0].copy()
            true_scores = prev[1].copy()
        else:
            scores = np.full(hb.n, -1, np.int64)
            true_scores = np.full(hb.n, -1, np.int64)
        keep = in_pair & (hb.matches >= ropts["pass1_min_matches"])
        idxs = np.flatnonzero(keep)
        if not len(idxs):
            return {"done": (scores, true_scores), "nrows": None}
        saved_mask = np.zeros(len(idxs), bool)
        if saved_rows:
            saved_mask = np.isin(idxs, np.fromiter(saved_rows, np.int64))
        prev_eff = scores[idxs]
        need = (prev_eff <= 0) & ~saved_mask if prev is not None \
            else ~saved_mask
        sc = prev_eff.copy()
        sc_true = true_scores[idxs].copy()
        nrows = idxs[need] if need.any() else None
        return {"done": None, "entries": entries, "istrand": istrand,
                "hb": hb, "ropts": ropts, "scores": scores,
                "true_scores": true_scores, "idxs": idxs,
                "saved_mask": saved_mask, "need": need, "sc": sc,
                "sc_true": sc_true, "nrows": nrows}

    def _score_windows_sides(self, tasks):
        """One vector-SW launch covering every pending side's windows
        (both mates, each row framed at its side's input strand).
        tasks: list of ctx dicts from `_paired_pass1_begin`-style
        precursors with `nrows` set.  Fills each task's "fresh" array.

        Two optional ctx keys drive the per-side score cache:
          * "cache": int64 [hb.n] array (-1 = unscored) shared across the
            batch's rounds for one hit-list generation.  Vector scores
            are deterministic per hit row, so rows already in the cache
            are never sent again (the reference recomputes them —
            hit_run_full_sw / the fallback round's rescore — with
            identical values; f1 telemetry still counts the reference's
            invocations, not our launches).
          * "prefetch_rows": extra uncached rows to score in the SAME
            launch (map_pair_batch prefetches the half-paired fallback
            round's rows during paired pass1, so the fallback needs no
            launch of its own).

        The kernel's scores come back to the host once, for all sides,
        where the cache is written."""
        live = []
        for t in tasks:
            if t is None:
                continue
            cache = t.get("cache")
            nrows = t.get("nrows")
            parts = []
            if nrows is not None:
                parts.append(nrows if cache is None
                             else nrows[cache[nrows] < 0])
            pre = t.get("prefetch_rows")
            if pre is not None and len(pre):
                parts.append(pre)
            disp = (np.concatenate(parts) if len(parts) > 1
                    else parts[0] if parts else np.zeros(0, np.int64))
            t["_disp"] = disp
            if len(disp):
                live.append(t)
        if live:
            entries_comb = []
            rid_p, st_p, cn_p, goff_p, wlen_p, istr_p = \
                [], [], [], [], [], []
            for t in live:
                off = len(entries_comb)
                entries_comb.extend(t["entries"])
                hb, nrows = t["hb"], t["_disp"]
                rid_p.append(hb.rid[nrows].astype(np.int64) + off)
                st_p.append(hb.st[nrows])
                cn_p.append(hb.cn[nrows])
                goff_p.append(hb.g_off[nrows])
                wlen_p.append(hb.w_len[nrows])
                istr_p.append(np.full(len(nrows), t["istrand"], np.int8))
            rid = np.concatenate(rid_p)
            wlen = np.concatenate(wlen_p)
            G = _round_up(max(1, int(wlen.max())), 128)
            R = _round_up(max(e.read_len for e in entries_comb), 8)
            _t0 = time.time()
            dev = self._vector_scores(
                entries_comb, rid, np.concatenate(st_p),
                np.concatenate(cn_p), np.concatenate(goff_p), wlen,
                np.concatenate(istr_p), G, R)
            out = dev.cpu().numpy().astype(np.int64)
            self.tel.f1.add(0, 0, time.time() - _t0)
            pos = 0
            for t in live:
                n = len(t["_disp"])
                sc = out[pos:pos + n]
                pos += n
                cache = t.get("cache")
                if cache is not None:
                    cache[t["_disp"]] = sc
                t["_disp_scores"] = sc
        for t in tasks:
            if t is None or t.get("nrows") is None:
                continue
            cache = t.get("cache")
            if cache is not None:
                t["fresh"] = cache[t["nrows"]]
            else:
                t["fresh"] = t["_disp_scores"]

    def _paired_pass1_end(self, ctx):
        """Second half of the paired pass 1 (`_paired_pass1_begin`): apply
        fresh scores, run the suppression scan, persist."""
        entries = ctx["entries"]
        hb = ctx["hb"]
        ropts = ctx["ropts"]
        scores, true_scores = ctx["scores"], ctx["true_scores"]
        idxs, saved_mask, need = ctx["idxs"], ctx["saved_mask"], ctx["need"]
        sc, sc_true = ctx["sc"], ctx["sc_true"]
        if ctx["nrows"] is not None:
            fresh_sc = ctx["fresh"]
            sc[need] = fresh_sc
            sc_true[need] = fresh_sc

        # suppression scan per (rid, st) over participating hits in order
        score_max = hb.score_max[idxs].astype(np.int64)
        thr = ((score_max * (ropts["pass1_threshold"] / 100.0)).astype(
                   np.int64)
               if ropts["pass1_threshold"] >= 0
               else np.full(len(idxs), -ropts["pass1_threshold"]))
        wlen_cfg = np.array([e.window_len for e in entries], np.int64)
        order = np.lexsort((np.arange(len(idxs)), hb.st[idxs], hb.rid[idxs]))
        eff = sc.copy()
        sup = _suppress_scan_flags(hb, idxs, order, sc, thr, need,
                                   saved_mask, ropts["window_overlap"],
                                   wlen_cfg)
        eff[sup] = 0
        scores[idxs] = eff
        true_scores[idxs] = sc_true
        # f1 accounting: freshly-scored, non-suppressed participants
        # (read_pass1_per_strand's invocation counter; cells = glen*rlen)
        _live = need & ~sup
        if _live.any():
            _rl = np.array([entries[r].read_len for r in hb.rid[idxs]],
                           np.int64)
            self.tel.f1.add(int(_live.sum()),
                            int((hb.w_len[idxs][_live].astype(np.int64)
                                 * _rl[_live]).sum()))
        return scores, true_scores

    # ------------------------------------------------------------------
    def _select_vector_pairs(self, hits, sv, pair_rows, popts,
                             saved_rows=None):
        """readpair_get_vector_hits: enumerate candidate pairs, threshold on
        summed vector score, keep top pass1_num_outputs per read pair.
        Hits saved by an earlier option-set round are skipped on both sides
        (mapping.c:1911-1916)."""
        h0, h1 = hits[0], hits[1]
        pm, px = pair_rows["pair_min"], pair_rows["pair_max"]
        order1 = pair_rows["order1"]
        live0 = (pm >= 0) & (sv[0] >= 0)
        if saved_rows is not None and saved_rows[0]:
            live0 &= ~np.isin(np.arange(h0.n),
                              np.fromiter(saved_rows[0], np.int64))
        rows0 = np.flatnonzero(live0)
        if not len(rows0):
            return {}
        counts = (px[rows0] - pm[rows0] + 1)
        total = int(counts.sum())
        starts = np.zeros(len(rows0) + 1, np.int64)
        np.cumsum(counts, out=starts[1:])
        i0 = np.repeat(rows0, counts)
        within = np.arange(total) - np.repeat(starts[:-1], counts)
        j1 = order1[np.repeat(pm[rows0], counts) + within]

        s0 = sv[0][i0]
        s1 = sv[1][j1]
        ok = (s0 >= 0) & (s1 >= 0)
        if saved_rows is not None and saved_rows[1]:
            ok &= ~np.isin(j1, np.fromiter(saved_rows[1], np.int64))
        i0, j1 = i0[ok], j1[ok]
        s0, s1 = s0[ok], s1[ok]
        score = s0 + s1
        smax = h0.score_max[i0].astype(np.int64) + \
            h1.score_max[j1].astype(np.int64)
        pct = (100000 * score) // smax
        thr_pct = popts["pairing"]["pass1_threshold"]
        thr = (smax * (thr_pct / 100.0) if thr_pct >= 0
               else np.full(len(i0), -thr_pct))
        live = score >= thr
        i0, j1 = i0[live], j1[live]
        score, smax, pct = score[live], smax[live], pct[live]
        key = score if is_absolute(thr_pct) else pct

        rid = h0.rid[i0]
        K = popts["pairing"]["pass1_num_outputs"]
        # reference min-heap selection; heap ARRAY order drives pass2 and
        # downstream tie-breaks (readpair_get_vector_hits + extheap)
        from shrimp_tpu_torch.utils import extheap
        by_read: dict[int, list[int]] = {}
        for n in range(len(i0)):          # stream order preserved
            by_read.setdefault(int(rid[n]), []).append(n)
        out = {}
        for r in sorted(by_read):
            chosen = extheap.topk_select(by_read[r], key, K)
            out[r] = [(int(i0[n]), int(j1[n]), int(key[n])) for n in chosen]
        return out

    # ------------------------------------------------------------------
    def _run_full_sw_sides(self, tasks):
        """Batched hit_run_full_sw across BOTH mates in ONE launch of the
        packed full-SW kernel (the pass-2 analogue of
        `_score_windows_sides`), through `Mapper._pass2_dispatch` with
        each row's input strand: the band and W as the JAX package
        computes them, and where it switches to its unbanded kernel (the
        band as wide as G, or no band) the same packed kernel over the
        full band.  R comes from the longer mate.

        tasks: list of dicts {entries, istrand, hb, rows, thr,
        score_vectors}; returns one dict row -> (FinalHit | None) per
        task.  A row yields None when its vector score misses the
        per-foot threshold (score_full == 0).  score_vectors: per-row
        raw vector scores (for --extra-sam-fields' ZV,
        hit_run_full_sw's recomputed score_vector)."""
        cfg = self.cfg
        outs = [{} for _ in tasks]
        live = [(ti, t) for ti, t in enumerate(tasks)
                if len(t["rows"])]
        if not live:
            return outs
        entries_comb = []
        cols = {k: [] for k in ("rid", "st", "cn", "g_off", "w_len",
                                "anchor_x", "anchor_y", "anchor_length",
                                "anchor_width", "istrand", "score_max")}
        for _, t in live:
            hb = t["hb"]
            rows = np.asarray(t["rows"], np.int64)
            t["rows"] = rows
            if t.get("score_vectors") is None:
                t["score_vectors"] = np.zeros(len(rows), np.int64)
            cols["rid"].append(hb.rid[rows].astype(np.int64)
                               + len(entries_comb))
            entries_comb.extend(t["entries"])
            for k in ("st", "cn", "g_off", "w_len", "anchor_x", "anchor_y",
                      "anchor_length", "anchor_width", "score_max"):
                cols[k].append(getattr(hb, k)[rows])
            cols["istrand"].append(np.full(len(rows), t["istrand"],
                                           np.int8))
        sel = {k: np.concatenate(v) for k, v in cols.items()}

        _t0 = time.time()
        ctx = self._pass2_dispatch(entries_comb, sel)
        N = ctx["N"]
        stats = ctx["stats_d"].cpu().numpy()[:N]
        ops_all = ctx["ops_d"].cpu().numpy()[:N]
        self.tel.f2.add(N, int(ctx["f2_cells_rows"].sum()),
                        time.time() - _t0)
        cn, gen_st = ctx["cn"], ctx["gen_st"]
        g_off, w_len = ctx["g_off"], ctx["w_len"]
        crossovers = stats[:, 10] if cfg.colour_space else None
        gb_np, qr4 = ctx["gb"], ctx["qr4"]

        k0 = 0
        for ti, t in live:
            entries, istrand, hb = t["entries"], t["istrand"], t["hb"]
            rows = t["rows"]
            score_vectors = t["score_vectors"]
            pass2_threshold = t["thr"]
            out = outs[ti]
            score_max = hb.score_max[rows].astype(np.int64)
            for kk in range(len(rows)):
                k = k0 + kk
                row = int(rows[kk])
                s = int(stats[k, 0])
                thresh = abs_or_pct(pass2_threshold, score_max[kk])
                # per-foot gate: vector score must reach the foot
                # threshold for the full SW to count (hit_run_full_sw,
                # mapping.c:400-415)
                if s <= 0:
                    out[row] = None
                    continue
                rmapped = int(stats[k, 7])
                ops_k = ops_all[k, :stats[k, 9]].copy()
                dbal = qral = ""
                qual33 = None
                if cfg.colour_space:
                    # sw_full_cs itself gates on the raw-score threshold
                    if s < thresh:
                        out[row] = None
                        continue
                    from shrimp_tpu_torch.ops import post_sw as post_sw_mod
                    from shrimp_tpu_torch.ops import sw_full_cs
                    e = entries[hb.rid[row]]
                    dbal, qral = sw_full_cs.render_alignment_cs(
                        ops_k, gb_np[k], qr4[k],
                        int(stats[k, 2]), int(stats[k, 1]))
                    if cfg.compute_mapping_qualities:
                        q_in = (None if (e.qual is None or cfg.ignore_qvs)
                                else e.qual)
                        posterior, qual33 = post_sw_mod.post_sw(
                            e.read[istrand], e.initbp, q_in,
                            int(stats[k, 1]), dbal, qral, self.probs,
                            qual_delta=cfg.qual_delta,
                            qual_vector_offset=cfg.qual_vector_offset)
                        score_full = mapq.posterior_score(
                            posterior, rmapped, self.probs)
                    else:
                        posterior = 0.0
                        score_full = s
                else:
                    posterior = mapq.ls_posterior(s, rmapped, self.probs)
                    ps = mapq.posterior_score(posterior, rmapped,
                                              self.probs)
                    score_full = ps if cfg.compute_mapping_qualities else s
                fh = FinalHit(
                    cn=int(cn[k]), gen_st=int(gen_st[k]),
                    g_off=int(g_off[k]),
                    w_len=int(w_len[k]), score_full=score_full,
                    sw_score=s,
                    pass2_key=0, posterior=posterior,
                    read_start=int(stats[k, 1]),
                    genome_start=int(stats[k, 2]),
                    rmapped=rmapped, gmapped=int(stats[k, 8]),
                    matches=int(stats[k, 3]), mismatches=int(stats[k, 4]),
                    insertions=int(stats[k, 5]),
                    deletions=int(stats[k, 6]),
                    ops=ops_k,
                    crossovers=(int(crossovers[k])
                                if crossovers is not None else 0),
                    dbalign=dbal, qralign=qral, qual33=qual33)
                fh.score_max = int(score_max[kk])
                fh.kmer_matches = int(hb.matches[row])
                fh.score_window_gen = int(hb.score_window_gen[row])
                fh.score_vector = int(score_vectors[kk])
                out[row] = fh
            k0 += len(rows)
        return outs

    # ------------------------------------------------------------------
    def _paired_pass2(self, entries1, entries2, istrand1, istrand2,
                      hits, sv, sel_pairs, popts):
        """readpair_pass2 + dedup + final selection."""
        cfg = self.cfg
        pcfg = self.pcfg
        # unique feet needing full SW, per side, gated by foot vector thresh
        need = {0: set(), 1: set()}
        for r, lst in sel_pairs.items():
            for i0, j1, _ in lst:
                need[0].add(i0)
                need[1].add(j1)
        # foot-level vector gate: score_vector >= per-side pass2
        # threshold; BOTH sides' feet run in one kernel dispatch
        fsw_tasks = []
        rows_side = {}
        for side, entries, istrand in ((0, entries1, istrand1),
                                       (1, entries2, istrand2)):
            foot_thr = popts["read"][side]["pass2_threshold"]
            hb = hits[side]
            rows = sorted(need[side])
            rows_side[side] = rows
            gated = [row for row in rows
                     if sv[side][row] >= abs_or_pct(
                         foot_thr, int(hb.score_max[row]))]
            fsw_tasks.append({
                "entries": entries, "istrand": istrand, "hb": hb,
                "rows": gated, "thr": foot_thr,
                "score_vectors": np.array([sv[side][row]
                                           for row in gated], np.int64)})
        res_sides = self._run_full_sw_sides(fsw_tasks)
        feet = {side: {row: res_sides[side].get(row)
                       for row in rows_side[side]} for side in (0, 1)}

        paired_final = {}
        saved = {0: set(), 1: set()}
        pair_thr = popts["pairing"]["pass2_threshold"]
        for r, lst in sel_pairs.items():
            cand_pairs = []
            for i0, j1, _ in lst:
                fh0 = feet[0].get(i0)
                fh1 = feet[1].get(j1)
                if fh0 is None or fh1 is None:
                    continue
                if fh0.score_full == 0 or fh1.score_full == 0:
                    continue
                smax = fh0.score_max + fh1.score_max
                total = fh0.score_full + fh1.score_full
                if total < int(abs_or_pct(pair_thr, smax)):
                    continue
                pct = (100000 * total) // smax
                key = total if is_absolute(pair_thr) else pct
                cand_pairs.append([i0, j1, fh0, fh1, key])

            cand_pairs = self._dedup_pairs(cand_pairs)
            cand_pairs.sort(key=lambda t: -t[4])
            cand_pairs = cand_pairs[:popts["pairing"]["pass2_num_outputs"]]
            if popts["pairing"]["strata"] and cand_pairs:
                top = cand_pairs[0][2].score_full + cand_pairs[0][3].score_full
                cand_pairs = [t for t in cand_pairs
                              if t[2].score_full + t[3].score_full == top]
            if cand_pairs and cfg.max_alignments \
               and len(cand_pairs) > cfg.max_alignments:
                cand_pairs = []

            if cand_pairs:
                out = []
                for i0, j1, fh0, fh1, key in cand_pairs:
                    saved[0].add(i0)
                    saved[1].add(j1)
                    cn_eq = fh0.cn == fh1.cn
                    isz = get_insert_size(
                        fh0, fh1,
                        int(self.index.contig_len[fh0.cn]),
                        int(self.index.contig_len[fh1.cn]), cn_eq)
                    # signed insert (readpair_compute_paired_hit,
                    # mapping.c:2014-2034)
                    if pcfg.pair_mode in (PAIR_OPP_IN, PAIR_COL_FW):
                        sign = 1 if fh0.gen_st == 0 else -1
                    else:
                        sign = 1 if fh0.gen_st == 1 else -1
                    out.append((fh0, fh1, sign * isz))
                paired_final[r] = out
        return paired_final, saved, need

    # ------------------------------------------------------------------
    def _dedup_pairs(self, cand_pairs):
        """readpair_remove_duplicate_hits: 4 dominant-single passes then
        identity dedup (mapping.c:2060-2170)."""
        if not cand_pairs:
            return cand_pairs

        def push_dominant(pairs, foot, keyf):
            pairs = sorted(pairs, key=lambda t: keyf(t[2 + foot]))
            i = 0
            while i < len(pairs):
                j = i
                best = i
                while j < len(pairs) and \
                        keyf(pairs[j][2 + foot]) == keyf(pairs[i][2 + foot]):
                    if pairs[j][2 + foot].score_full > \
                            pairs[best][2 + foot].score_full:
                        best = j
                    j += 1
                for k in range(i, j):
                    if k != best:
                        pairs[k][foot] = pairs[best][foot]
                        pairs[k][2 + foot] = pairs[best][2 + foot]
                        f0, f1 = pairs[k][2], pairs[k][3]
                        smax = f0.score_max + f1.score_max
                        total = f0.score_full + f1.score_full
                        pairs[k][4] = (100000 * total) // smax
                i = j
            return pairs

        def start_key(fh):
            return (fh.cn, fh.gen_st, fh.g_off + fh.genome_start)

        def end_key(fh):
            return (fh.cn, fh.gen_st,
                    -(fh.g_off + fh.genome_start) - fh.rmapped
                    + fh.deletions - fh.insertions)

        pairs = [list(t) for t in cand_pairs]
        pairs = push_dominant(pairs, 0, start_key)
        pairs = push_dominant(pairs, 0, end_key)
        pairs = push_dominant(pairs, 1, start_key)
        pairs = push_dominant(pairs, 1, end_key)
        # identity dedup by (foot0 row, foot1 row)
        seen = set()
        out = []
        for t in sorted(pairs, key=lambda t: (t[0], t[1])):
            if (t[0], t[1]) in seen:
                continue
            seen.add((t[0], t[1]))
            out.append(t)
        return out

    # ------------------------------------------------------------------
    def _halfpaired_begin(self, entries, istrand, hb, sv_paired,
                          saved_rows, ropts, alive=None):
        """First half of the unpaired fallback round: select hits and
        find those needing fresh vector scores (ctx["nrows"])."""
        # vector scores for all hits with matches >= min_matches (2)
        keep = hb.matches >= ropts["pass1_min_matches"]
        if alive is not None:
            keep &= alive[hb.rid]
        idxs = np.flatnonzero(keep)
        # hits already scored > 0 in the paired rounds are NOT rescored and
        # do NOT update last_good (read_pass1_per_strand's rescore branch,
        # mapping.c:1316-1356); suppressed/unscored hits are scored fresh
        saved_mask = np.zeros(len(idxs), bool)
        if saved_rows:
            saved_mask = np.isin(idxs, np.fromiter(saved_rows, np.int64))
        prev_eff = (sv_paired[idxs] if sv_paired is not None
                    else np.full(len(idxs), -1, np.int64))
        need = (prev_eff <= 0) & ~saved_mask
        sc = prev_eff.copy()
        nrows = idxs[need] if need.any() else None
        return {"entries": entries, "istrand": istrand, "hb": hb,
                "sv_paired": sv_paired, "saved_rows": saved_rows,
                "ropts": ropts, "alive": alive, "idxs": idxs,
                "saved_mask": saved_mask, "need": need, "sc": sc,
                "nrows": nrows}

    def _halfpaired_select(self, ctx):
        """Suppression + top-k selection half of the unpaired fallback
        round; returns the full-SW task for `_run_full_sw_sides` (both
        mates' feet share one kernel dispatch).  ctx comes from
        `_halfpaired_begin` after `_score_windows_sides` filled
        ctx["fresh"]."""
        cfg = self.cfg
        entries = ctx["entries"]
        istrand = ctx["istrand"]
        hb = ctx["hb"]
        sv_paired = ctx["sv_paired"]
        saved_rows = ctx["saved_rows"]
        ropts = ctx["ropts"]
        alive = ctx["alive"]
        idxs, saved_mask, need = ctx["idxs"], ctx["saved_mask"], ctx["need"]
        sc = ctx["sc"]
        if ctx["nrows"] is not None:
            sc[need] = ctx["fresh"]

        score_max = hb.score_max[idxs].astype(np.int64)
        t1 = ropts["pass1_threshold"]
        thr = (np.full(len(idxs), -t1, np.int64) if t1 < 0
               else (score_max * (t1 / 100.0)).astype(np.int64))
        wlen_cfg = np.array([e.window_len for e in entries], np.int64)
        order = np.lexsort((np.arange(len(idxs)), hb.st[idxs], hb.rid[idxs]))
        eff = sc.copy()
        sup = _suppress_scan_flags(hb, idxs, order, sc, thr, need,
                                   saved_mask, cfg.window_overlap,
                                   wlen_cfg)
        eff[sup] = 0
        # f1 accounting for the fallback round's fresh scores
        _live = need & ~sup
        if _live.any():
            _rl = np.array([entries[r].read_len for r in hb.rid[idxs]],
                           np.int64)
            self.tel.f1.add(int(_live.sum()),
                            int((hb.w_len[idxs][_live].astype(np.int64)
                                 * _rl[_live]).sum()))

        # select top-k unsaved hits per read.  Selection has NO min_matches
        # gate (read_get_vector_hits, mapping.c:1540-1560): hits below
        # min_matches keep their persisted paired-round scores and remain
        # eligible here.
        scores_full = (sv_paired.copy() if sv_paired is not None
                       else np.full(hb.n, -1, np.int64))
        scores_full[idxs] = eff
        smax_full = hb.score_max.astype(np.int64)
        thr_full = (np.full(hb.n, -t1, np.int64) if t1 < 0
                    else (smax_full * (t1 / 100.0)).astype(np.int64))
        live = scores_full >= thr_full
        if alive is not None:
            live &= alive[hb.rid]
        rows_live = np.flatnonzero(live).astype(np.int64)
        if saved_rows:
            rows_live = rows_live[~np.isin(
                rows_live, np.fromiter(saved_rows, np.int64))]
        if not len(rows_live):
            return {"entries": entries, "istrand": istrand, "hb": hb,
                    "rows": [], "thr": cfg.sw_full_threshold,
                    "score_vectors": None}
        pct = (100000 * scores_full[rows_live].astype(np.int64)
               // hb.score_max[rows_live].astype(np.int64))
        rid = hb.rid[rows_live]
        order2 = np.lexsort((np.arange(len(rows_live)), -pct, rid))
        K = 3 * cfg.num_outputs
        # first K per read in order2 (vectorized run-cumcount)
        r_sorted = rid[order2]
        starts = np.r_[True, r_sorted[1:] != r_sorted[:-1]]
        grp_start = np.maximum.accumulate(
            np.where(starts, np.arange(len(r_sorted)), 0))
        cumcount = np.arange(len(r_sorted)) - grp_start
        sel_arr = rows_live[order2[cumcount < K]]
        return {"entries": entries, "istrand": istrand, "hb": hb,
                "rows": [int(r) for r in sel_arr],
                "thr": cfg.sw_full_threshold,
                "score_vectors": scores_full[sel_arr].astype(np.int64)}

    def _halfpaired_finish(self, task, res):
        """Unpaired pass-2 selection over one side's full-SW results."""
        cfg = self.cfg
        hb = task["hb"]
        by_read = {}
        for row, fh in res.items():
            if fh is None or fh.score_full == 0:
                continue
            smax = fh.score_max
            if fh.score_full < abs_or_pct(cfg.sw_full_threshold, smax):
                continue
            fh.pass2_key = (100000 * fh.score_full) // smax
            by_read.setdefault(int(hb.rid[row]), []).append(fh)

        from shrimp_tpu_torch.pipeline.options import ReadMappingOptions
        opts = ReadMappingOptions()
        opts.pass2.num_outputs = cfg.num_outputs
        opts.pass2.strata = cfg.strata
        out = {}
        for r, finals in by_read.items():
            # paired mode computes its own class-based MQVs
            kept = self._select_hits(finals, opts, compute_mqv=False)
            if kept:
                out[r] = kept
        return out

    # ------------------------------------------------------------------
    def _paired_mqv(self, pr: PairResult):
        """compute_paired_mqv (output.c:812-942)."""
        cfg = self.cfg
        pcfg = self.pcfg
        probs = self.probs
        re = pr.re

        unp = {0: [fh for s, fh in pr.unpaired_hits if s == 0],
               1: [fh for s, fh in pr.unpaired_hits if s == 1]}

        # z1 per read over final unpaired hits
        z1 = {}
        for nip in (0, 1):
            z1[nip] = sum(fh.posterior for fh in unp[nip])
            for fh in unp[nip]:
                fh.z0 = fh.posterior
                fh.z1 = z1[nip]

        # insert-size prior normalization
        insert_size_denom = 0.0
        for fh0, fh1, isz in pr.paired_hits:
            insert_size_denom += mapq.get_pr_insert_size(
                isz, pcfg.insert_size_mean, pcfg.insert_size_stddev)

        # paired posteriors: z2 per foot (sum over its pairings), z3 total
        z3 = 0.0
        foot_pairings = {0: {}, 1: {}}
        for k, (fh0, fh1, isz) in enumerate(pr.paired_hits):
            foot_pairings[0].setdefault(id(fh0), (fh0, []))[1].append(k)
            foot_pairings[1].setdefault(id(fh1), (fh1, []))[1].append(k)
        for nip in (0, 1):
            for fid, (fh, ks) in foot_pairings[nip].items():
                tmp = 0.0
                for k in ks:
                    fh0, fh1, isz = pr.paired_hits[k]
                    mate = fh1 if nip == 0 else fh0
                    pr_ins = mapq.get_pr_insert_size(
                        isz, pcfg.insert_size_mean, pcfg.insert_size_stddev)
                    tmp += pr_ins * mate.posterior
                tmp *= fh.posterior
                tmp = max(tmp, 1e-200)
                fh.z2 = tmp
                fh.insert_size_denom = insert_size_denom
                if nip == 0:
                    z3 += tmp
        for nip in (0, 1):
            for fid, (fh, ks) in foot_pairings[nip].items():
                fh.z3 = z3

        # class-random probabilities
        pr_top_random = [1.0, 1.0, 1.0]
        for nip in (0, 1):
            if not unp[nip]:
                continue
            best = max(unp[nip], key=lambda fh: fh.z0)
            ptr = mapq.pr_random_mapping_given_score(
                re[nip].read_len, best.score_full, cfg.params,
                cfg.colour_space)
            for fh in unp[nip]:
                fh.pr_top_random = ptr
            pr_top_random[nip] = min(
                ptr * self.index.total_len, 1.0)
        if pr.paired_hits:
            best_tmp = 1.0
            for fh0, fh1, isz in pr.paired_hits:
                tmp = mapq.pr_random_mapping_given_score(
                    re[0].read_len, fh0.score_full, cfg.params,
                    cfg.colour_space)
                tmp *= mapq.pr_random_mapping_given_score(
                    re[1].read_len, fh1.score_full, cfg.params,
                    cfg.colour_space)
                tmp *= 1000
                best_tmp = min(best_tmp, tmp)
            for fh0, fh1, isz in pr.paired_hits:
                fh0.pr_top_random = best_tmp
                fh1.pr_top_random = best_tmp
            pr_top_random[2] = min(
                best_tmp * self.index.total_len, 1.0)

        pr_missed = [mapq.get_pr_missed(re[1].read_len),
                     mapq.get_pr_missed(re[0].read_len)]
        for nip in (0, 1):
            for fh in unp[nip]:
                fh.pr_missed_mp = pr_missed[nip]

        denom = 0.0
        if unp[0]:
            denom += pr_top_random[1] * pr_top_random[2] * pr_missed[0]
        if unp[1]:
            denom += pr_top_random[0] * pr_top_random[2] * pr_missed[1]
        if pr.paired_hits:
            denom += pr_top_random[0] * pr_top_random[1]

        for nip in (0, 1):
            for fh in unp[nip]:
                p_corr = (pr_top_random[1 - nip] * pr_top_random[2]
                          * pr_missed[nip] / denom) * (fh.z0 / fh.z1)
                m = mapq.qv_from_pr_corr(p_corr)
                fh.mqv = 0 if m < 4 else m
        for fh0, fh1, isz in pr.paired_hits:
            for fh in (fh0, fh1):
                p_corr = (pr_top_random[0] * pr_top_random[1] / denom) \
                    * (fh.z2 / fh.z3)
                m = mapq.qv_from_pr_corr(p_corr)
                fh.mqv = 0 if m < 4 else m

    # ------------------------------------------------------------------
    def sam_records_pair(self, pr: PairResult) -> list[sam.SamRecord]:
        """readpair_output SAM emission (output.c:1237-1282)."""
        cfg = self.cfg
        recs: list[sam.SamRecord] = []
        re = pr.re
        for fh0, fh1, isz in pr.paired_hits:
            recs.append(self._paired_record(re[0], fh0, re[1], fh1, isz,
                                            True))
            self._append_tail_tags(recs[-1], re[0], fh0, mate_re=re[1])
            recs.append(self._paired_record(re[1], fh1, re[0], fh0, -isz,
                                            False))
            self._append_tail_tags(recs[-1], re[1], fh1, mate_re=re[0])
        for nip, fh in pr.unpaired_hits:
            mate_nip = 1 - nip
            mapped = self._halfpair_record(re[nip], fh, re[mate_nip],
                                           nip == 0)
            self._append_tail_tags(mapped, re[nip], fh, mate_re=re[mate_nip])
            unmapped = self._mate_unmapped_record(re[mate_nip], re[nip], fh,
                                                  mate_nip == 0)
            self._append_tail_tags(unmapped, re[mate_nip], None,
                                   mate_re=re[nip])
            if nip == 0:
                recs.extend([mapped, unmapped])
            else:
                recs.extend([unmapped, mapped])
        if not pr.paired_hits and not pr.unpaired_hits and cfg.sam_unaligned:
            for nip in (0, 1):
                if cfg.colour_space:
                    rec = sam.unaligned_record_cs(re[nip].name, re[nip].seq,
                                                  re[nip].qual)
                else:
                    rec = sam.unaligned_record(re[nip].name, re[nip].seq,
                                               re[nip].qual, cfg.qual_delta)
                rec.flag = 0x1 | 0x4 | 0x8 | (0x40 if nip == 0 else 0x80)
                self._append_tail_tags(rec, re[nip], None,
                                       mate_re=re[1 - nip])
                recs.append(rec)
        return recs

    def legacy_records_pair(self, pr: PairResult,
                            include_read: bool = False) -> list[str]:
        """Legacy-format lines for one pair (hit_output !Eflag branch via
        readpair_output)."""
        re = pr.re
        lines: list[str] = []
        for fh1, fh2, _isz in pr.paired_hits:
            lines.append(self.legacy_record(re[0], fh1, include_read))
            lines.append(self.legacy_record(re[1], fh2, include_read))
        for nip, fh in pr.unpaired_hits:
            mapped = self.legacy_record(re[nip], fh, include_read)
            unmapped = f">{re[1 - nip].name}"
            lines.extend([mapped, unmapped] if nip == 0
                         else [unmapped, mapped])
        return lines

    def _hit_coords(self, fh: FinalHit, cn: int):
        contig_len = int(self.index.contig_len[cn])
        read_start = fh.read_start + 1
        read_end = read_start + fh.rmapped - 1
        if fh.gen_st == 0:
            gstart = fh.g_off + fh.genome_start + 1
        else:
            right_most = contig_len - (fh.g_off + fh.genome_start)
            gstart = right_most - (read_end - read_start
                                   - fh.deletions + fh.insertions)
        gend = gstart + fh.gmapped - 1
        return gstart, gend

    def _paired_record(self, re_s, fh_s, re_m, fh_m, isz, first_in_pair):
        cfg = self.cfg
        qname = common_qname(re_s.name, re_m.name)
        gstart_s, gend_s = self._hit_coords(fh_s, fh_s.cn)
        gstart_m, gend_m = self._hit_coords(fh_m, fh_m.cn)
        rname = self.index.contig_names[fh_s.cn]
        mrnm = self.index.contig_names[fh_m.cn]
        same = rname == mrnm
        # recompute isize from 5' coords for the SAM field (output.c:641-661)
        if same:
            fp_s = gend_s if fh_s.gen_st == 1 else gstart_s - 1
            fp_m = gend_m if fh_m.gen_st == 1 else gstart_m - 1
            tlen = fp_m - fp_s
        else:
            tlen = 0
        rec = self._base_mapped_record(re_s, fh_s, qname)
        rec.rnext = "=" if same else mrnm
        rec.pnext = gstart_m
        rec.tlen = tlen
        rec.flag |= (0x1 | 0x2
                     | (0x20 if fh_m.gen_st == 1 else 0)
                     | (0x40 if first_in_pair else 0x80))
        tags = [t for t in rec.tags if not t.startswith(("Z0", "Z1"))]
        if cfg.compute_mapping_qualities and not cfg.all_contigs:
            # Z fields suppressed under --all-contigs (output.c:691)
            as_idx = 1
            z_tags = [
                f"Z2:i:{mapq.double_to_neglog(fh_s.z2)}",
                f"Z3:i:{mapq.double_to_neglog(fh_s.z3)}",
                f"Z4:i:{mapq.double_to_neglog(fh_s.pr_top_random)}",
                f"Z6:i:{mapq.double_to_neglog(fh_s.insert_size_denom)}",
            ]
            tags = tags[:as_idx] + z_tags + tags[as_idx:]
        rec.tags = tags
        return rec

    def _halfpair_record(self, re_s, fh, re_m, first_in_pair):
        cfg = self.cfg
        qname = common_qname(re_s.name, re_m.name)
        rec = self._base_mapped_record(re_s, fh, qname)
        rec.flag |= 0x1 | 0x8 | (0x40 if first_in_pair else 0x80)
        tags = [t for t in rec.tags if not t.startswith(("Z0", "Z1"))]
        if cfg.compute_mapping_qualities and not cfg.all_contigs:
            # Z fields suppressed under --all-contigs (output.c:691)
            z_tags = [
                f"Z0:i:{mapq.double_to_neglog(fh.z0)}",
                f"Z1:i:{mapq.double_to_neglog(fh.z1)}",
                f"Z4:i:{mapq.double_to_neglog(fh.pr_top_random)}",
                f"Z5:i:{mapq.double_to_neglog(fh.pr_missed_mp)}",
            ]
            tags = tags[:1] + z_tags + tags[1:]
        rec.tags = tags
        return rec

    def _base_mapped_record(self, re_s, fh, qname):
        cfg = self.cfg
        if cfg.colour_space:
            return sam.aligned_record_cs(
                name=qname,
                seq_text=re_s.seq,
                qual_raw=re_s.qual,
                contig_name=self.index.contig_names[fh.cn],
                contig_len=int(self.index.contig_len[fh.cn]),
                genome_start0=fh.g_off + fh.genome_start,
                read_start0=fh.read_start,
                rmapped=fh.rmapped, gmapped=fh.gmapped,
                insertions=fh.insertions, deletions=fh.deletions,
                mismatches=fh.mismatches,
                ops=fh.ops, qralign=fh.qralign,
                qual33=(fh.qual33 if cfg.compute_mapping_qualities else None),
                crossovers=fh.crossovers,
                bfast=cfg.bfast,
                reverse_strand=fh.gen_st == 1,
                score_full=fh.score_full,
                mapq_v=fh.mqv if cfg.compute_mapping_qualities else 255,
                z0=None, z1=None,
                read_len=re_s.read_len)
        return sam.aligned_record_from_ops(
            name=qname,
            seq_text=re_s.seq,
            qual=re_s.qual,
            contig_name=self.index.contig_names[fh.cn],
            contig_len=int(self.index.contig_len[fh.cn]),
            genome_start0=fh.g_off + fh.genome_start,
            read_start0=fh.read_start,
            rmapped=fh.rmapped, gmapped=fh.gmapped,
            insertions=fh.insertions, deletions=fh.deletions,
            mismatches=fh.mismatches,
            ops=fh.ops,
            reverse_strand=fh.gen_st == 1,
            score_full=fh.score_full,
            mapq_v=fh.mqv if cfg.compute_mapping_qualities else 255,
            z0=None, z1=None,
            qual_delta=cfg.qual_delta,
            read_len=re_s.read_len)

    def _mate_unmapped_record(self, re_u, re_m, fh_m, first_in_pair):
        """SAM line for the unmapped mate of a half-paired hit
        (hit_output with rh == NULL, output.c:407-475)."""
        cfg = self.cfg
        qname = common_qname(re_u.name, re_m.name)
        gstart_m, _ = self._hit_coords(fh_m, fh_m.cn)
        if cfg.colour_space:
            rec = sam.unaligned_record_cs(qname, re_u.seq, re_u.qual)
        else:
            rec = sam.unaligned_record(qname, re_u.seq, re_u.qual,
                                       cfg.qual_delta)
        rec.flag = (0x1 | 0x4
                    | (0x20 if fh_m.gen_st == 1 else 0)
                    | (0x40 if first_in_pair else 0x80))
        rec.rnext = self.index.contig_names[fh_m.cn]
        rec.pnext = gstart_m
        return rec
