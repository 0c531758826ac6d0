"""The end-to-end unpaired mapping funnel (L4), letter and colour space,
the counterpart of `shrimp_tpu/pipeline/mapper.py`.

Replicates `gmapper/mapping.c:handle_read` (:1791-1868) for a whole batch
of reads at once:

  candidates (native C on the host,
  or the K10 kernels on the device) →  pass 1 vector-SW filter, or the gapless
                                  diagonal score of -U / -M mirna (device)
                               →  window-overlap suppression + top-k (host)
                               →  pass 2 full SW + traceback: 3-state in
                                  letter space, 4-layer in colour space
                                  (device)
                               →  [colour space: posterior HMM post_sw]
                                  posterior / threshold / dedup / top-k
                                  → MQV → SAM (host)

The host NumPy and native-C logic is the JAX package's, copied line for
line because it is what makes the SAM bytes exact.  Only the device calls
differ: candidates go through `ops.candidates_device` when
`MapperConfig.device_candidates` says so (True, or "auto" after timing
both paths once), pass 1 through `ops.sw_vector` or `ops.sw_gapless`,
pass 2 through `ops.sw_full` or `ops.sw_full_cs`.  The vector pass 1
gathers every window from planes that stay resident on the device
(`DeviceIndex`), as the device candidates read a CSR index resident there
(`ops.candidates_device.DeviceL3Index`); on a CUDA device the kernels
run, on the CPU their plain versions.  The gapless pass 1 gathers its
diagonals from the same resident planes (the JAX package gathers them on
the host).

Paired mapping (`pipeline/paired.py`) subclasses this Mapper and runs
the same kernels on both mates' rows, each framed at its input strand.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass

import numpy as np
import torch

from shrimp_tpu_torch import dna, mapq
from shrimp_tpu_torch.index import GenomeIndex
from shrimp_tpu_torch.io import sam
from shrimp_tpu_torch.ops.params import ScoreProbs
from shrimp_tpu_torch.pipeline import candidates as cand
from shrimp_tpu_torch.pipeline import candidates_batch as cb
from shrimp_tpu_torch.pipeline.options import (MapperConfig, ReadMappingOptions,
                                         abs_or_pct, is_absolute)
from shrimp_tpu_torch.utils import telemetry
from shrimp_tpu_torch.ops import (candidates_device, sw_full, sw_full_cs,
                                  sw_gapless, sw_vector)

# bytes of GENOME_PAD appended to the resident device plane (the JAX
# package's layout, kept so the two planes are byte-identical)
PASS1_PLANE_PAD = 1 << 12

# measured host->device probe bandwidth (bytes/s) per device type, one
# probe per process
_SHIP_BW: dict[str, float] = {}


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _reverse_complement_plane(index: GenomeIndex) -> np.ndarray:
    """The reverse-complement letter plane, contig by contig at the same
    offsets (genome_contigs_rc, genome.c:1107)."""
    parts = []
    for c in range(index.num_contigs):
        lo = int(index.contig_offsets[c])
        hi = lo + int(index.contig_len[c])
        parts.append(dna.reverse_complement(index.genome[lo:hi]))
    return (np.concatenate(parts).astype(np.int8)
            if parts else np.zeros(0, np.int8))


def _colour_plane_rc(index: GenomeIndex, genome_rc: np.ndarray) -> np.ndarray:
    """Colour translation of the reverse-complement letter plane, contig by
    contig (genome_cs_contigs_rc, genome.c:1098-1119)."""
    parts = []
    for c in range(index.num_contigs):
        lo = int(index.contig_offsets[c])
        hi = lo + int(index.contig_len[c])
        parts.append(dna.letters_to_colours(genome_rc[lo:hi], dna.BASE_T))
    return (np.concatenate(parts).astype(np.int8)
            if parts else np.zeros(0, np.int8))


def _concat_aranges(lengths: np.ndarray) -> np.ndarray:
    """[0..l0), [0..l1), ... as one flat int64 array."""
    total = int(lengths.sum())
    starts = np.zeros(len(lengths) + 1, np.int64)
    np.cumsum(lengths, out=starts[1:])
    return (np.arange(total, dtype=np.int64)
            - np.repeat(starts[:-1], lengths))


@dataclass
class FinalHit:
    """One reported alignment (read_hit + sw_full_results subset)."""

    cn: int
    gen_st: int                 # 0 = forward genome strand, 1 = reverse
    g_off: int                  # window start, frame per gen_st
    w_len: int
    score_full: int             # posterior score (== SW score in LS)
    sw_score: int
    pass2_key: int
    posterior: float
    read_start: int
    genome_start: int           # window-relative
    rmapped: int
    gmapped: int
    matches: int
    mismatches: int
    insertions: int
    deletions: int
    ops: np.ndarray
    mqv: int = 255
    z0: float = 0.0
    z1: float = 0.0
    # --extra-sam-fields side data (output.c:739-756)
    kmer_matches: int = 0             # read_hit.matches (kmer count)
    score_window_gen: int = 0
    score_vector: int = 0
    score_max: int = 0
    # colour-space extras (sw_full_results CS fields + post_sw output)
    crossovers: int = 0
    dbalign: str = ""
    qralign: str = ""
    qual33: str | None = None


@dataclass
class DeviceIndex:
    """The part of a GenomeIndex that lives on the device for pass 1, each
    plane int8 with a tail of PASS1_PLANE_PAD bytes of GENOME_PAD, and the
    contig offsets and lengths as int64.  Letter space keeps the genome
    plane; colour space keeps the forward||reverse-complement
    concatenations of the colour and letter planes (`cs_cat`, `ls_cat`),
    so a reverse hit is a start offset by the genome length.  Window
    starts are int64 end to end, so one plane covers any genome size."""

    plane: torch.Tensor | None
    contig_offsets: torch.Tensor
    contig_lens: torch.Tensor
    cs_cat: torch.Tensor | None = None
    ls_cat: torch.Tensor | None = None

    @classmethod
    def from_index(cls, index: GenomeIndex, device,
                   colour_space: bool = False,
                   genome_rc: np.ndarray | None = None,
                   genome_cs_rc: np.ndarray | None = None) -> "DeviceIndex":
        """genome_rc / genome_cs_rc: the reverse-complement letter and
        colour planes, when the caller has them already."""
        device = torch.device(device)
        offs = torch.tensor(np.asarray(index.contig_offsets),
                            dtype=torch.int64, device=device)
        lens = torch.tensor(np.asarray(index.contig_len), dtype=torch.int64,
                            device=device)
        if not colour_space:
            return cls(plane=_padded_plane([index.genome], device),
                       contig_offsets=offs, contig_lens=lens)
        if index.genome_cs is None:
            raise ValueError("colour-space mapping needs an index built "
                             "with colour_space=True")
        if genome_rc is None:
            genome_rc = _reverse_complement_plane(index)
        if genome_cs_rc is None:
            genome_cs_rc = _colour_plane_rc(index, genome_rc)
        return cls(plane=None, contig_offsets=offs, contig_lens=lens,
                   cs_cat=_padded_plane([index.genome_cs, genome_cs_rc],
                                        device),
                   ls_cat=_padded_plane([index.genome, genome_rc], device))


def _padded_plane(parts, device) -> torch.Tensor:
    """The parts end to end, then PASS1_PLANE_PAD bytes of GENOME_PAD, as
    one int8 tensor on `device`."""
    host = np.concatenate(
        [np.asarray(a, dtype=np.int8) for a in parts]
        + [np.full(PASS1_PLANE_PAD, sw_vector.GENOME_PAD, np.int8)])
    return torch.from_numpy(host).to(device)


class Mapper:
    """Maps batches of reads against a GenomeIndex on `device`: the card
    (the kernels) unless the caller asks for the CPU (their plain PyTorch
    versions)."""

    def __init__(self, index: GenomeIndex, cfg: MapperConfig | None = None,
                 device: str | torch.device = "cuda"):
        self.index = index
        self.cfg = cfg or MapperConfig()
        self.device = torch.device(device)
        cs = self.cfg.colour_space
        self.probs = ScoreProbs.from_scores(self.cfg.params, cs)
        # reverse-complement genome plane, same contig offsets
        self.genome_rc = _reverse_complement_plane(index)
        # the colour translation of the reverse-complement strand
        self.genome_cs_rc = (_colour_plane_rc(index, self.genome_rc)
                             if cs else None)
        # the CS vector filter scores colour mismatches as one crossover
        # (f1_setup arg: match + crossover, gmapper.c:2932-2934)
        self.vect_params = (self.cfg.params if not cs
                            else self.cfg.params.with_(
                                mismatch=self.cfg.params.match
                                + self.cfg.params.crossover))
        # the pass-1 planes stay resident on the device
        self.dev_index = DeviceIndex.from_index(
            index, self.device, colour_space=cs, genome_rc=self.genome_rc,
            genome_cs_rc=self.genome_cs_rc)
        self.min_seed_span = index.seed_set.min_span
        self.stats = {"reads": 0, "reads_matched": 0, "reads_dropped": 0,
                      "total_matches": 0, "pass1_windows": 0,
                      "pass2_windows": 0, "dup_matches_pruned": 0,
                      "reads_dropped_max_aln": 0, "reads_matched_conf": 0,
                      "device_l3_fallbacks": 0}
        self._dev_l3 = None
        # K10's device planes, kept between calls (ops/candidates_device.py)
        self._dev_l3_ws = candidates_device.L3Workspace()
        self._dev_l3_a_cap = self.DEVICE_L3_A_CAP
        self._dev_l3_a2_cap = self.DEVICE_L3_A2_CAP
        self._l3_choice = None          # auto-tune result ("device"/"host")
        self._l3_reason = None          # why, when decided without timing
        self._l3_model = None           # amortization-model inputs
        # the pipelined streams run two batches on worker threads; counter
        # read-modify-writes must not interleave (#pragma omp atomic
        # analogue, mapping.c:1732-1750)
        self._stats_lock = threading.Lock()
        self.tel = telemetry.Telemetry(lock=self._stats_lock)

    def _bump(self, **deltas) -> None:
        with self._stats_lock:
            for k, v in deltas.items():
                self.stats[k] += v

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    # ------------------------------------------------------------------
    def _gather_windows(self, plane: np.ndarray, cn: np.ndarray,
                        g_off: np.ndarray, w_len: np.ndarray,
                        G: int) -> np.ndarray:
        """Vectorized window extraction → int8 [N, G] padded with GENOME_PAD.

        Bulk rows go through a strided sliding-window view indexed by the
        row's start (one [N] gather — ~4.4x faster than an [N, G] fancy
        index); the rare rows whose start lies within G of the plane end
        (where the view's start clamp would shift the contents) take the
        exact per-element clamp path.  Bit-identical to the element-wise
        min(lo+col, L-1) gather because windows never overhang their
        contig (g_off + w_len <= clen)."""
        L = len(plane)
        lo = self.index.contig_offsets[cn] + g_off
        cols = np.arange(G, dtype=np.int64)[None, :]
        if G > L:
            idxm = np.minimum(lo[:, None] + cols, L - 1)
            out = plane[idxm]
        else:
            swv = np.lib.stride_tricks.sliding_window_view(plane, G)
            out = swv[np.minimum(lo, L - G)]
            tail = np.flatnonzero(lo > L - G)
            if len(tail):
                idxm = np.minimum(lo[tail][:, None] + cols, L - 1)
                out[tail] = plane[idxm]
        return np.where(cols >= w_len[:, None],
                        np.int8(sw_vector.GENOME_PAD),
                        out).astype(np.int8)

    def _vector_scores(self, entries, rid, st, cn, g_off_pos, w_len,
                       istrand, G: int, R: int) -> torch.Tensor:
        """Pass-1 vector-SW scores for hit rows (g_off in pos-strand
        frame); istrand int [N] is each row's input strand (0 unpaired; a
        reversed mate's rows 1).  Returns an int32 tensor on the mapper's
        device, still in flight on a card.

        LS scores read[st] against the forward genome (istrand plays no
        part).  CS first applies the reverse_hit framing
        (read_pass1_per_strand, mapping.c:1317-1341): the input-strand
        colour read, read[istrand], against the colour plane of the hit's
        genome strand (reverse where st != istrand), colour 0 against
        lstocs(letter plane, initbp); a reverse hit starts one genome
        length into the fw||rc planes.

        Windows are gathered from the resident planes at int64 starts on
        every device — fused into the kernel on a card, by the plain
        version on the CPU — so per batch only O(windows) starts and one
        [B, 2, R] read matrix cross to the device.  Windows never
        overhang their contig, so this equals the host gather."""
        dix = self.dev_index
        wl = self._to_device(w_len.astype(np.int32))
        rid_d = self._to_device(rid.astype(np.int32))
        rb2 = self._reads2_device(entries, R)
        if not self.cfg.colour_space:
            lo = (dix.contig_offsets[self._to_device(cn.astype(np.int64))]
                  + self._to_device(g_off_pos.astype(np.int64)))
            return sw_vector.p1_gather_score_ls(
                dix.plane, lo, wl, rid_d,
                self._to_device(st.astype(np.int32)), rb2, G,
                self.cfg.params)
        clen = self.index.contig_len[cn].astype(np.int64)
        rev = st != istrand
        goff_f = np.where(rev, clen - g_off_pos - w_len.astype(np.int64),
                          g_off_pos)
        lo = (self.index.contig_offsets[cn].astype(np.int64) + goff_f
              + np.where(rev, int(self.index.total_len), 0))
        initbp = np.array([entries[r].initbp for r in rid], np.int8)
        return sw_vector.p1_gather_score_cs(
            dix.cs_cat, dix.ls_cat, self._to_device(lo.astype(np.int64)),
            wl, rid_d, self._to_device(np.asarray(istrand, np.int32)),
            self._to_device(initbp), rb2, G, self.vect_params)

    def _gapless_scores(self, entries, rid, st, cn, g_off_pos, ax, ay,
                        al, aw, w_len, R: int,
                        istrand=None) -> torch.Tensor:
        """Pass-1 gapless scores: sw_gapless along the anchor diagonal
        (f1_run with gapless=true, f1-wrapper.h:118-120; sw-gapless.c:58).
        Returns an int32 tensor on the mapper's device, still in flight on
        a card.

        g_idx = g_off + anchor.x, r_idx = anchor.y in the hit's genome-strand
        frame (read_pass1_per_strand, mapping.c:1335-1348); CS applies the
        reverse_hit framing first (reverse where st != istrand; istrand
        int [N] each row's input strand, constant per read, by default 0,
        the read as given) and reads the
        input-strand read, read[istrand], against the hit strand's half of
        the fw||rc planes.  The framing is O(hits) NumPy on the host; the
        diagonals are gathered from the resident planes on every device (in
        the kernel on a card, by the plain version on the CPU), the CS
        forced first colour made there too, so per batch only O(hits)
        arrays and the [B, 2, R] read matrix cross to the device."""
        dix = self.dev_index
        if istrand is None:
            istrand = np.zeros(len(rid), np.int8)
        g_off = g_off_pos.astype(np.int64)
        ax = ax.astype(np.int64)
        ay = ay.astype(np.int64)
        cs = self.cfg.colour_space
        half = np.zeros(len(rid), np.int64)
        if cs:
            # reverse_hit framing (mapping.c:272-281)
            clen = self.index.contig_len[cn].astype(np.int64)
            rlen = np.array([e.read_len for e in entries], np.int64)[rid]
            wl = w_len.astype(np.int64)
            al = al.astype(np.int64)
            aw = aw.astype(np.int64)
            rev = st != istrand
            g_off = np.where(rev, clen - g_off - wl, g_off)
            ax = np.where(rev, -ax + (wl - 1) - (al - 1) - (aw - 1), ax)
            ay = np.where(rev, -ay + (rlen - 1) - (al - 1) + (aw - 1), ay)
            half[rev] = int(self.index.total_len)
        d0 = g_off + ax - ay
        g_left = np.maximum(d0, 0)
        # per hit: contig, first genome column, plane half; first read
        # column, read, strand
        h64 = self._to_device(np.stack([cn.astype(np.int64), g_left, half]))
        h32 = self._to_device(np.stack([np.maximum(-d0, 0), rid, st])
                              .astype(np.int32))
        start = dix.contig_offsets[h64[0]] + h64[1] + h64[2]
        glen = dix.contig_lens[h64[0]] - h64[1]
        p = self.vect_params
        if not cs:
            return sw_gapless.p1_gather_gapless_ls(
                dix.plane, start, glen, h32[0], h32[1], h32[2],
                self._reads2_device(entries, R), p)
        # the colour-space kernel reads strand 0 of the read matrix: put
        # each read's input strand there (unpaired reads are all at 0)
        rb2 = self._reads2_matrix(entries, R)
        flip = np.zeros(len(entries), bool)
        flip[rid[np.asarray(istrand) != 0]] = True
        if flip.any():
            rb2[flip] = rb2[flip][:, ::-1]
        rb2 = self._to_device(rb2)
        initbp = self._to_device(np.array([e.initbp for e in entries],
                                          np.int8))
        return sw_gapless.p1_gather_gapless_cs(
            dix.cs_cat, dix.ls_cat, start, glen, h32[0], h32[1], initbp, rb2,
            p)

    def map_batch(self, reads: list[tuple[str, str, str | None]],
                  options: list[ReadMappingOptions] | None = None
                  ) -> list[tuple[cand.ReadEntry, list[FinalHit]]]:
        """Map a batch of (name, seq, qual) reads; returns final hits per
        read in input order."""
        cfg = self.cfg
        option_sets = options or cfg.unpaired_options()

        with self.tel.stage("readparse"):
            entries = cand.prepare_reads(reads, cfg, self.min_seed_span)
            if cfg.seed_qual_filter:
                # Qflag && SQFflag gate (mapping.c:78): FASTA reads carry
                # no quals, so the filter is inert for them
                cand.apply_seed_qual_filter(entries, self.index.seed_set,
                                            cfg.qual_delta)
        ok = np.array([e.read_len <= cfg.longest_read_len
                       and e.max_n_kmers > 0 for e in entries])
        self._bump(reads=len(entries), reads_dropped=int((~ok).sum()))

        live_entries = [e for e, o in zip(entries, ok) if o]
        live_map = np.flatnonzero(ok)
        results: list[list[FinalHit]] = [[] for _ in entries]

        # multi-round option-set fall-through (handle_read loop,
        # mapping.c:1807-1858): a read advances to the next option set while
        # its pass2 round reports not-done (stop_count/stop_threshold)
        pending = list(range(len(live_entries)))
        for opts in option_sets:
            if not pending:
                break
            sub = [live_entries[i] for i in pending]
            per_read: dict[int, list[FinalHit]] = {}
            hb = self._candidates(sub, opts)
            if hb.n:
                self._bump(pass1_windows=hb.n)
                with self.tel.stage("pass1"):
                    sel = self._pass1(sub, hb, opts)
                if sel is not None:
                    self._bump(pass2_windows=len(sel["rid"]))
                    with self.tel.stage("pass2"):
                        per_read = self._pass2(sub, sel, opts)
            nxt = []
            for k, li in enumerate(pending):
                hits = per_read.get(k, [])
                if hits:
                    results[live_map[li]].extend(hits)
                if opts.pass2.stop_count > 0:
                    cnt = sum(
                        1 for h in hits
                        if h.score_full >= int(abs_or_pct(
                            opts.pass2.stop_threshold, h.score_max)))
                    if cnt < opts.pass2.stop_count:
                        nxt.append(li)
            pending = nxt

        n_m = sum(1 for hits in results if hits)
        n_t = sum(len(hits) for hits in results)
        self._bump(reads_matched=n_m, total_matches=n_t)
        return list(zip(entries, results))

    # ------------------------------------------------------------------
    def map_stream(self, reads_iter, batch_size: int = 8192,
                   options: list[ReadMappingOptions] | None = None,
                   n_workers: int = 1):
        """Pipelined mapping over a read stream.

        Yields (ReadEntry, hits) in input order.  Host work (read prep,
        candidate generation, selection) for one batch overlaps the
        asynchronous device work of its neighbours (CUDA launches return
        before the kernels finish; results are fetched one stage later).

        n_workers > 1 (-N) runs whole batches on a worker pool instead:
        up to n_workers batches in flight, numpy/C stages release the GIL
        so host multicore machines get real concurrency (output order and
        bytes identical — stats are lock-guarded)."""
        cfg = self.cfg
        opts = (options or cfg.unpaired_options())[0]

        if n_workers > 1:
            from concurrent.futures import ThreadPoolExecutor
            ex = ThreadPoolExecutor(max_workers=n_workers)

            def run_batch(reads):
                return self.map_batch(reads, options=options)

            try:
                futs = []
                batch: list = []
                for rec in reads_iter:
                    batch.append(rec)
                    if len(batch) >= batch_size:
                        futs.append(ex.submit(run_batch, batch))
                        batch = []
                        while len(futs) > n_workers:
                            yield from futs.pop(0).result()
                if batch:
                    futs.append(ex.submit(run_batch, batch))
                for f in futs:
                    yield from f.result()
            finally:
                ex.shutdown(wait=True)
            return

        def stage0(reads):
            with self.tel.stage("readparse"):
                entries = cand.prepare_reads(reads, cfg, self.min_seed_span)
                if cfg.seed_qual_filter:
                    cand.apply_seed_qual_filter(
                        entries, self.index.seed_set, cfg.qual_delta)
            ok = np.array([e.read_len <= cfg.longest_read_len
                           and e.max_n_kmers > 0 for e in entries])
            self._bump(reads=len(entries), reads_dropped=int((~ok).sum()))
            live = [e for e, o in zip(entries, ok) if o]
            live_map = np.flatnonzero(ok)
            hb = self._candidates(live, opts) if live else None
            with self.tel.stage("pass1"):
                p1 = (self._pass1_dispatch(live, hb, opts)
                      if hb is not None and hb.n else None)
            if hb is not None and hb.n:
                self._bump(pass1_windows=hb.n)
            return {"entries": entries, "live": live, "live_map": live_map,
                    "hb": hb, "p1": p1}

        def stage1(st0):
            if st0["p1"] is None:
                st0["sel"] = None
                st0["p2"] = None
                return st0
            with self.tel.stage("pass1"):
                sel = self._pass1_finish(st0["live"], st0["hb"], opts,
                                         st0["p1"])
            st0["sel"] = sel
            with self.tel.stage("pass2"):
                st0["p2"] = (self._pass2_dispatch(st0["live"], sel)
                             if sel is not None else None)
            if sel is not None:
                self._bump(pass2_windows=len(sel["rid"]))
            return st0

        def stage2(st0):
            entries = st0["entries"]
            results = [[] for _ in entries]
            if st0["p2"] is not None:
                with self.tel.stage("pass2"):
                    per_read = self._pass2_finish(st0["live"], st0["sel"],
                                                  opts, st0["p2"])
                for li, hits in per_read.items():
                    results[st0["live_map"][li]] = hits
            n_m = sum(1 for hits in results if hits)
            n_t = sum(len(hits) for hits in results)
            self._bump(reads_matched=n_m, total_matches=n_t)
            return list(zip(entries, results))

        in_p1 = None     # batch with pass1 dispatched
        in_p2 = None     # batch with pass2 dispatched
        batch: list = []
        for rec in reads_iter:
            batch.append(rec)
            if len(batch) < batch_size:
                continue
            nxt = stage0(batch)
            batch = []
            if in_p2 is not None:
                yield from stage2(in_p2)
            in_p2 = stage1(in_p1) if in_p1 is not None else None
            in_p1 = nxt
        if batch:
            nxt = stage0(batch)
            if in_p2 is not None:
                yield from stage2(in_p2)
            in_p2 = stage1(in_p1) if in_p1 is not None else None
            in_p1 = nxt
        if in_p2 is not None:
            yield from stage2(in_p2)
        if in_p1 is not None:
            yield from stage2(stage1(in_p1))

    # ------------------------------------------------------------------
    # device-L3 plane capacities (expansion / post-region-filter /
    # emitted); grown in powers of two on overflow up to the max, then
    # host fallback
    DEVICE_L3_A_CAP = 1 << 21
    DEVICE_L3_A2_CAP = 1 << 17
    DEVICE_L3_A_CAP_MAX = 1 << 24
    DEVICE_L3_H_CAP = 1 << 18

    def _l3_autotune(self, entries, opts) -> bool:
        """Pick the faster L3 path by timing both once (the first device
        call, which ships the index and builds the kernels, excluded)."""
        if self._l3_choice is not None:
            return self._l3_choice == "device"
        if not self._device_l3_ok(entries, opts):
            return False                  # stay undecided until eligible
        # an out-of-memory (postings that do not fit next to the pass-1
        # planes) is a permanent host verdict, not a crash
        try:
            if self._candidates_device(entries, opts) is None:
                self._l3_choice = "host"
                return False
            t0 = time.time()
            self._candidates_device(entries, opts)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            t_dev = time.time() - t0
        except torch.OutOfMemoryError:
            self._bump(device_l3_fallbacks=1)
            self._l3_choice = "host"
            self._dev_l3 = None
            self._dev_l3_ws = candidates_device.L3Workspace()
            return False
        saved, self.cfg.device_candidates = self.cfg.device_candidates, False
        t0 = time.time()
        try:
            sub = entries[: max(len(entries) // 4, 1)]
            for st in (0, 1):
                if not (self.cfg.strand_mask >> st) & 1:
                    continue
                ab = cb.anchors_batch(
                    sub, self.index, st,
                    collapse=opts.anchor_list.collapse,
                    list_cutoff=self.index.list_cutoff,
                    use_region_counts=opts.anchor_list.use_region_counts)
                cb.hit_list_batch(sub, self.index, ab, opts.hit_list,
                                  self.cfg)
        finally:
            self.cfg.device_candidates = saved
        t_host = (time.time() - t0) * (len(entries) / max(len(sub), 1))
        self._l3_choice = "device" if t_dev < t_host else "host"
        if self._l3_model is not None:   # measured verdict for the stats
            self._l3_model["t_dev_batch"] = round(t_dev, 3)
            self._l3_model["t_host_batch"] = round(t_host, 3)
        return self._l3_choice == "device"

    def _device_l3_ok(self, entries, opts) -> bool:
        """Static eligibility for the on-device candidate path (int32
        capacity contract, ops/candidates_device.py)."""
        if not self.cfg.device_candidates:
            return False
        if any(e.sqf is not None for e in entries):
            return False      # seed-qual-filter runs on the host path
        if self.index.total_len >= (1 << 31):
            return False
        if len(entries) > (1 << 12):
            return False
        if opts.hit_list.match_mode == 3:          # paired heavy-mp path
            return False
        # no region-table size gate: past DENSE_REGION_TABLE_MAX entries
        # the kernels switch to the sparse sort formulation.  The one-time
        # CSR ship to the device must amortize: past the immediate budget
        # the decision is a lazy ski-rental crossover — ship once the
        # host-L3 seconds already spent (or projected from an
        # expected_reads hint) exceed the estimated ship cost times the
        # amortize factor.
        if self.cfg.device_candidates != True:  # noqa: E712  ("auto")
            ship_bytes = 4 * sum(
                len(self.index.positions[sn]) + len(self.index.offsets[sn])
                for sn in range(len(self.index.offsets)))
            est = ship_bytes / self._ship_bandwidth()
            spent = (self.tel.stages["anchor_list"].secs
                     + self.tel.stages["hit_list"].secs)
            # a later batch refreshes the inputs and keeps the measured
            # verdict (t_dev_batch, t_host_batch, ship_secs_actual)
            self._l3_model = {
                **(self._l3_model or {}),
                "ship_bytes": ship_bytes,
                "ship_est_secs": round(est, 2),
                "host_l3_secs_spent": round(spent, 2),
                "amortize_factor": self.cfg.device_l3_amortize_factor,
            }
            if ship_bytes > self.cfg.device_l3_hbm_budget_bytes:
                self._l3_choice = "host"
                self._l3_reason = (
                    f"postings {ship_bytes / 1e9:.1f}GB exceed "
                    f"{self.cfg.device_l3_hbm_budget_bytes / 1e9:.0f}GB "
                    "HBM residency budget")
                return False
            if est > self.cfg.device_l3_ship_budget_secs:
                bar = est * self.cfg.device_l3_amortize_factor
                reads_seen = self.stats["reads"]
                if self.cfg.expected_reads and reads_seen:
                    per_read = spent / reads_seen
                    projected = per_read * float(self.cfg.expected_reads)
                    self._l3_model["host_l3_secs_projected"] = \
                        round(projected, 2)
                    if projected < bar:
                        # enough batches measured -> the projection is
                        # stable; make the verdict permanent
                        if reads_seen >= 4096:
                            self._l3_choice = "host"
                        self._l3_reason = (
                            f"projected host L3 {projected:.1f}s over "
                            f"{self.cfg.expected_reads} reads < "
                            f"{bar:.0f}s amortized ship")
                        return False
                elif spent < bar:
                    self._l3_reason = (
                        f"deferred ship: host L3 spent {spent:.1f}s < "
                        f"{bar:.0f}s (ski-rental crossover, "
                        f"ship ~{est:.0f}s)")
                    return False
                self._l3_reason = None   # crossover reached: ship below
        return True

    def _ship_bandwidth(self) -> float:
        """Measured host->device bytes/s (one 32 MB probe per process and
        device type)."""
        kind = self.device.type
        if kind not in _SHIP_BW:
            probe = torch.ones(1 << 25, dtype=torch.int8)
            dst = torch.empty_like(probe, device=self.device)
            dst[: 1 << 20].copy_(probe[: 1 << 20])          # warm path
            if kind == "cuda":
                torch.cuda.synchronize(self.device)
            t0 = time.time()
            dst.copy_(probe)
            if kind == "cuda":
                torch.cuda.synchronize(self.device)
            _SHIP_BW[kind] = max(probe.numel() / max(time.time() - t0, 1e-6),
                                 1.0)
        return _SHIP_BW[kind]

    def _candidates_device(self, entries, opts):
        """The on-device L3: equal to the host path, with whole-batch host
        fallback when a capacity maxes out (counted)."""
        cdv = candidates_device
        if self._dev_l3 is None:
            _t0 = time.time()
            self._dev_l3 = cdv.DeviceL3Index.from_host(self.index,
                                                       self.device)
            if self._l3_model is not None:
                self._l3_model["ship_secs_actual"] = \
                    round(time.time() - _t0, 2)
        B = len(entries)
        R = _round_up(max(e.read_len for e in entries), 16)
        codes = {0: np.zeros((B, R), np.int8), 1: np.zeros((B, R), np.int8)}
        rlen = np.zeros(B, np.int32)
        minpos = np.zeros(B, np.int32)
        wlen = np.zeros(B, np.int32)
        thr = np.zeros(B, np.int32)
        p = self.cfg.params
        t = opts.hit_list.threshold
        for b, e in enumerate(entries):
            codes[0][b, :e.read_len] = e.read[0]
            codes[1][b, :e.read_len] = e.read[1]
            rlen[b] = e.read_len
            minpos[b] = e.min_kmer_pos
            wlen[b] = e.window_len
            if t >= 0:
                thr[b] = int(min(e.read_len, e.window_len) * p.match
                             * (t / 100.0))
        lc = min(int(self.index.list_cutoff), 0x7FFFFFFF)
        n_regions = (self.index.total_len >> cb.REGION_BITS) + 1

        parts = []
        for st in (0, 1):
            if not (self.cfg.strand_mask >> st) & 1:
                continue
            while True:
                a_cap = self._dev_l3_a_cap
                a2_cap = self._dev_l3_a2_cap
                out = cdv.device_candidates(
                    codes[st], rlen, minpos, wlen, thr, self._dev_l3,
                    a_cap=a_cap, a2_cap=a2_cap,
                    h_cap=self.DEVICE_L3_H_CAP,
                    n_regions=n_regions,
                    use_region_counts=opts.anchor_list.use_region_counts,
                    region_bits=cb.REGION_BITS,
                    region_overlap=cb.REGION_OVERLAP,
                    collapse=opts.anchor_list.collapse,
                    gapless=opts.hit_list.gapless,
                    match_mode=opts.hit_list.match_mode,
                    threshold=float(t),
                    match=p.match, b_gap_open=p.b_gap_open,
                    b_gap_extend=p.b_gap_extend,
                    list_cutoff=lc,
                    num_contigs=self.index.num_contigs,
                    workspace=self._dev_l3_ws)
                if not bool(out["overflow"]):
                    break
                grew = False
                if int(out["n_total"]) > a_cap and \
                        a_cap < self.DEVICE_L3_A_CAP_MAX:
                    self._dev_l3_a_cap = a_cap << 1
                    grew = True
                if int(out["n_survivors"]) > a2_cap and \
                        a2_cap < self.DEVICE_L3_A_CAP_MAX:
                    self._dev_l3_a2_cap = a2_cap << 1
                    grew = True
                if not grew:
                    self._bump(device_l3_fallbacks=1)
                    return None                    # host fallback
            n = int(out["n"])
            cols = dict(zip(cdv.COLUMNS, torch.stack(
                [out[f][:n] for f in cdv.COLUMNS]).cpu().numpy()))
            order = np.lexsort((cols["g_off"], cols["cn"], cols["rid"]))
            parts.append(cb.HitBatch(
                rid=cols["rid"][order].astype(np.int32),
                st=np.full(n, st, np.int8),
                cn=cols["cn"][order].astype(np.int32),
                g_off=cols["g_off"][order].astype(np.int64),
                w_len=cols["w_len"][order].astype(np.int32),
                score_window_gen=cols["score_window_gen"][order]
                .astype(np.int32),
                matches=cols["matches"][order].astype(np.int32),
                score_max=cols["score_max"][order].astype(np.int32),
                anchor_x=cols["anchor_x"][order].astype(np.int64),
                anchor_y=cols["anchor_y"][order].astype(np.int64),
                anchor_length=cols["anchor_length"][order].astype(np.int32),
                anchor_width=cols["anchor_width"][order].astype(np.int32)))
        return parts

    def _candidates(self, entries, opts) -> cb.HitBatch:
        parts = None
        use_device = self.cfg.device_candidates
        if use_device == "auto":
            use_device = self._l3_autotune(entries, opts)
        if use_device and self._device_l3_ok(entries, opts):
            with self.tel.stage("anchor_list"):
                parts = self._candidates_device(entries, opts)
        if parts is None:
            parts = []
            for st in (0, 1):
                if not (self.cfg.strand_mask >> st) & 1:
                    continue
                # region_counts ride inside the fused native anchor
                # construction (anchors_from_csr) when available, so they
                # are accounted under the anchor_list stage timer
                with self.tel.stage("anchor_list"):
                    ab = cb.anchors_batch(
                        entries, self.index, st,
                        collapse=opts.anchor_list.collapse,
                        list_cutoff=self.index.list_cutoff,
                        use_region_counts=opts.anchor_list
                        .use_region_counts)
                with self.tel.stage("hit_list"):
                    parts.append(cb.hit_list_batch(entries, self.index, ab,
                                                   opts.hit_list, self.cfg))
        merged = cb.HitBatch(**{
            f: np.concatenate([getattr(h, f) for h in parts])
            for f in ("rid", "st", "cn", "g_off", "w_len",
                      "score_window_gen", "matches", "score_max",
                      "anchor_x", "anchor_y", "anchor_length",
                      "anchor_width")})
        return merged

    # ------------------------------------------------------------------
    def _reads2_matrix(self, entries, R) -> np.ndarray:
        """Padded per-read code planes int8 [B, 2, R] (both strands)."""
        out = np.full((len(entries), 2, R), sw_vector.READ_PAD, np.int8)
        for b, e in enumerate(entries):
            out[b, 0, :e.read_len] = e.read[0]
            out[b, 1, :e.read_len] = e.read[1]
        return out

    def _reads2_device(self, entries, R) -> torch.Tensor:
        """The batch's read matrix on the mapper's device, int8 [B, 2, R]:
        what either pass-1 engine reads its rows from."""
        return self._to_device(self._reads2_matrix(entries, R))

    def _reads_matrix(self, entries, rid, st, R) -> np.ndarray:
        """Per-window read rows int8 [N, R]: one vectorized take by
        (rid, st) from the [B, 2, R] batch plane."""
        return self._reads2_matrix(entries, R)[rid, st]

    def _pass1_dispatch(self, entries, hb: cb.HitBatch, opts):
        """Launch the pass-1 kernel (vector SW, or the gapless diagonal
        score); returns a context whose device result is still in
        flight."""
        keep = hb.matches >= opts.pass1.min_matches
        if not keep.any():
            return None
        idxs = np.flatnonzero(keep)
        rid = hb.rid[idxs]
        st = hb.st[idxs]
        # G in 128s as in the JAX package (the window columns past w_len
        # are GENOME_PAD, which never changes a score)
        G = _round_up(max(1, int(hb.w_len[idxs].max())), 128)
        R = _round_up(max(e.read_len for e in entries), 8)
        if opts.pass1.gapless:
            dev = self._gapless_scores(
                entries, rid, st, hb.cn[idxs], hb.g_off[idxs],
                hb.anchor_x[idxs], hb.anchor_y[idxs],
                hb.anchor_length[idxs], hb.anchor_width[idxs],
                hb.w_len[idxs], R)
        else:
            # unpaired reads are at input strand 0, the read as given
            dev = self._vector_scores(entries, rid, st, hb.cn[idxs],
                                      hb.g_off[idxs], hb.w_len[idxs],
                                      np.zeros(len(idxs), np.int8), G, R)
        return {"idxs": idxs, "rid": rid, "st": st, "dev": dev, "R": R}

    def _pass1(self, entries, hb: cb.HitBatch, opts):
        """Vector SW scores + overlap suppression + per-read top-k.

        Returns dict of column arrays of the selected hits, or None."""
        ctx = self._pass1_dispatch(entries, hb, opts)
        if ctx is None:
            return None
        return self._pass1_finish(entries, hb, opts, ctx)

    def _pass1_finish(self, entries, hb: cb.HitBatch, opts, ctx):
        idxs = ctx["idxs"]
        rid = ctx["rid"]
        st = ctx["st"]
        _t0 = time.time()
        scores = ctx["dev"].cpu().numpy().astype(np.int64)
        _f1_secs = time.time() - _t0
        score_max = hb.score_max[idxs].astype(np.int64)
        if opts.pass1.threshold >= 0:
            # (int)abs_or_pct truncation (read_pass1_per_strand,
            # mapping.c:1353) — the float product is cast, not rounded
            thr = (score_max
                   * (opts.pass1.threshold / 100.0)).astype(np.int64)
        else:
            thr = np.full(len(idxs), int(-opts.pass1.threshold), np.int64)

        # window-overlap suppression scan per (read, strand), in hit order
        # (read_pass1_per_strand, mapping.c:1303-1330); sequential
        # dependence -> the native C scan (Python fallback below)
        wlen_cfg = np.array([e.window_len for e in entries], np.int64)
        ovl_r = np.array([int(abs_or_pct(opts.pass1.window_overlap, w))
                          for w in wlen_cfg], np.int64)
        order_key = np.lexsort((np.arange(len(idxs)), st, rid))
        suppressed = np.zeros(len(idxs), bool)
        from shrimp_tpu_torch import native as _native
        _clib = _native.load_candidates()
        if _clib is not None and hasattr(_clib, "pass1_suppress"):
            import ctypes as _ct
            _i64p = _ct.POINTER(_ct.c_longlong)
            _sup = np.zeros(len(idxs), np.uint8)
            _cn = np.ascontiguousarray(hb.cn[idxs], np.int32)
            _go = np.ascontiguousarray(hb.g_off[idxs], np.int64)
            _thr = np.ascontiguousarray(thr, np.int64)
            _sc = np.ascontiguousarray(scores, np.int64)
            _rid = np.ascontiguousarray(rid, np.int32)
            _st = np.ascontiguousarray(st, np.int8)
            _ord = np.ascontiguousarray(order_key, np.int64)
            _clib.pass1_suppress(
                _ord.ctypes.data_as(_i64p), len(idxs),
                _rid.ctypes.data_as(_ct.POINTER(_ct.c_int32)),
                _st.ctypes.data_as(_ct.POINTER(_ct.c_int8)),
                _cn.ctypes.data_as(_ct.POINTER(_ct.c_int32)),
                _go.ctypes.data_as(_i64p),
                _sc.ctypes.data_as(_i64p), _thr.ctypes.data_as(_i64p),
                np.ascontiguousarray(ovl_r).ctypes.data_as(_i64p),
                np.ascontiguousarray(wlen_cfg).ctypes.data_as(_i64p),
                _sup.ctypes.data_as(_ct.POINTER(_ct.c_uint8)))
            suppressed = _sup.astype(bool)
        else:
            lg_ptr = -1
            prev_rid = prev_st = None
            for n in order_key:
                r, s = rid[n], st[n]
                if (r, s) != (prev_rid, prev_st):
                    lg_ptr = -1
                    prev_rid, prev_st = r, s
                if lg_ptr >= 0 and hb.cn[idxs[n]] == hb.cn[idxs[lg_ptr]] \
                   and (hb.g_off[idxs[n]] + ovl_r[r]
                        <= hb.g_off[idxs[lg_ptr]] + wlen_cfg[r]):
                    suppressed[n] = True
                    continue
                if scores[n] >= thr[n]:
                    lg_ptr = n

        eff_scores = np.where(suppressed, 0, scores)
        # kernel telemetry: the reference invokes the filter only for
        # non-suppressed hits (read_pass1_per_strand, mapping.c:1303-1330);
        # cells = glen*rlen (sw-vector.c:509) or rlen (sw-gapless.c:105)
        _inv = int((~suppressed).sum())
        _rlen = np.array([entries[r].read_len for r in rid], np.int64)
        if opts.pass1.gapless:
            _cells = int(_rlen[~suppressed].sum())
        else:
            _cells = int((hb.w_len[idxs][~suppressed].astype(np.int64)
                          * _rlen[~suppressed]).sum())
        self.tel.f1.add(_inv, _cells, _f1_secs)
        live = eff_scores >= thr
        if not live.any():
            return None
        pct = (100000 * eff_scores) // np.maximum(score_max, 1)
        key = eff_scores if is_absolute(opts.pass1.threshold) else pct

        # per-read top-k via the reference's explicit min-heap — the heap
        # ARRAY order feeds pass2 and breaks all downstream ties
        # (read_get_vector_hits, mapping.c:1394-1432)
        with self.tel.stage("get_vector_hits"):
            ln = np.flatnonzero(live)
            # group live rows by read, stream order preserved within a
            # read (stable sort of the already-ascending row ids)
            rows_sorted = ln[np.argsort(rid[ln], kind="stable")] \
                .astype(np.int64)
            uniq_r, first = np.unique(rid[rows_sorted], return_index=True)
            bounds = np.concatenate(
                [first, [len(rows_sorted)]]).astype(np.int64)
            K = opts.pass1.num_outputs
            sel_rows = None
            if _clib is not None and hasattr(_clib, "topk_select_batch"):
                import ctypes as _ct
                _i64p = _ct.POINTER(_ct.c_longlong)
                key64 = np.ascontiguousarray(key, np.int64)
                out64 = np.empty(len(rows_sorted), np.int64)
                out_n = np.empty(len(uniq_r), np.int64)
                rc = _clib.topk_select_batch(
                    rows_sorted.ctypes.data_as(_i64p),
                    np.ascontiguousarray(bounds).ctypes.data_as(_i64p),
                    len(uniq_r), key64.ctypes.data_as(_i64p), K,
                    out64.ctypes.data_as(_i64p),
                    out_n.ctypes.data_as(_i64p))
                if rc == 0:
                    if int(out_n.sum()) == len(rows_sorted):
                        sel_rows = out64
                    else:
                        take = (np.repeat(bounds[:-1], out_n)
                                + _concat_aranges(out_n))
                        sel_rows = out64[take]
            if sel_rows is None:
                from shrimp_tpu_torch.utils import extheap
                sel_list = []
                for g in range(len(uniq_r)):
                    sel_list.extend(extheap.topk_select(
                        rows_sorted[bounds[g]:bounds[g + 1]].tolist(),
                        key, K))
                sel_rows = np.array(sel_list, dtype=np.int64)
        src = idxs[sel_rows]
        return {
            "rid": rid[sel_rows], "st": st[sel_rows],
            "cn": hb.cn[src], "g_off": hb.g_off[src],
            "w_len": hb.w_len[src], "score_max": hb.score_max[src],
            "anchor_x": hb.anchor_x[src], "anchor_y": hb.anchor_y[src],
            "anchor_length": hb.anchor_length[src],
            "anchor_width": hb.anchor_width[src],
            "score_vector": eff_scores[sel_rows],
            "matches": hb.matches[src],
            "score_window_gen": hb.score_window_gen[src],
        }

    # ------------------------------------------------------------------
    def _pass2(self, entries, sel, opts) -> dict[int, list[FinalHit]]:
        ctx = self._pass2_dispatch(entries, sel)
        return self._pass2_finish(entries, sel, opts, ctx)

    def _pass2_dispatch(self, entries, sel):
        """Launch the pass-2 full-SW kernel; device results stay in
        flight until _pass2_finish.

        sel["istrand"], where given, is each row's input strand (the
        paired path's reversed mates: 1); the read row is read[istrand]
        and the hit lies on the reverse genome strand where st !=
        istrand (hit_run_full_sw, mapping.c:383-398).  Unpaired rows are
        at input strand 0."""
        cfg = self.cfg
        N = len(sel["rid"])
        rid = sel["rid"]
        st = sel["st"]
        cn = sel["cn"]
        w_len = sel["w_len"].astype(np.int64)
        clen = self.index.contig_len[cn]
        rlen = np.array([entries[r].read_len for r in rid], np.int64)
        istrand = np.asarray(sel.get("istrand", np.zeros(N, np.int8)),
                             np.int8)

        # reverse_hit (mapping.c:272-281)
        gen_st = (st != istrand).astype(np.int64)
        g_off = np.where(gen_st == 1, clen - sel["g_off"] - w_len,
                         sel["g_off"]).astype(np.int64)
        ax = sel["anchor_x"].astype(np.int64)
        ay = sel["anchor_y"].astype(np.int64)
        al = sel["anchor_length"].astype(np.int64)
        aw = sel["anchor_width"].astype(np.int64)
        rev_mask = gen_st == 1
        ax = np.where(rev_mask, -ax + (w_len - 1) - (al - 1) - (aw - 1), ax)
        ay = np.where(rev_mask, -ay + (rlen - 1) - (al - 1) + (aw - 1), ay)

        G = _round_up(max(1, int(w_len.max())), 128)
        R = _round_up(max(e.read_len for e in entries), 8)
        gb_f = self._gather_windows(self.index.genome, cn, g_off, w_len, G)
        gb_r = self._gather_windows(self.genome_rc, cn, g_off, w_len, G)
        gb = np.where(rev_mask[:, None], gb_r, gb_f)
        rb = self._reads_matrix(entries, rid, istrand, R)
        rev = rev_mask & cfg.rev_tiebreak

        if cfg.anchor_width >= 0:
            # anchor_widen (sw-full-ls.c:175-178)
            bx = ax - cfg.anchor_width // 2
            by = ay + cfg.anchor_width // 2
            bw = aw + cfg.anchor_width
            band_xmin, band_xmax = sw_full.compute_band(bx, by, al, bw,
                                                        w_len, R)
            # f2 telemetry: banded cell count per row (sw-full-ls.c:237)
            _rows = np.arange(R)[None, :] < rlen[:, None]
            _f2_cells = np.where(
                _rows, band_xmax.astype(np.int64) - band_xmin + 1,
                0).sum(axis=1)
            # packed width: the widest band row in 32s.  When it reaches
            # G (where the JAX package switches to its unbanded-layout
            # kernel) this is round_up(G, 32), as bands never leave the
            # window
            W = _round_up(int((band_xmax - band_xmin).max()) + 1, 32)
        else:
            # no band: the same packed kernel over the full band
            # [0, w_len - 1] of every row
            band_xmin = np.zeros((N, R), np.int32)
            band_xmax = np.broadcast_to(
                (w_len - 1).astype(np.int32)[:, None], (N, R)).copy()
            _f2_cells = w_len * rlen
            W = _round_up(G, 32)

        dev_in = [self._to_device(a) for a in (gb, rb, rev, band_xmin,
                                                 band_xmax)]
        qr4 = None
        if cfg.colour_space:
            qr4 = np.full((N, 4, R), sw_vector.READ_PAD, np.int8)
            xover = np.full((N, R), cfg.params.crossover, np.int32)
            for n, r in enumerate(rid):
                e = entries[r]
                qr4[n, :, :e.read_len] = cand.get_read_ls4(e, istrand[n])
                if e.crossover_score is not None:
                    xover[n, :e.read_len] = e.crossover_score
            # the 4-layer DP: the same packed form over the full band
            # where the JAX package switches to its unbanded kernel
            stats_d, ops_d = sw_full_cs.sw_full_cs_and_traceback_packed(
                dev_in[0], self._to_device(qr4), self._to_device(xover),
                *dev_in[2:], cfg.params,
                local_alignment=not cfg.global_alignment,
                taboo_len=cfg.indel_taboo_len, W=W)
        else:
            stats_d, ops_d = sw_full.sw_full_and_traceback_packed(
                *dev_in, cfg.params,
                local_alignment=not cfg.global_alignment, W=W)
            # LS pass2 re-runs the vector filter per hit before the scalar
            # DP (hit_run_full_sw, mapping.c:400-415) — account it under f1
            self.tel.f1.add(N, int((w_len * rlen).sum()))
        return {"stats_d": stats_d, "ops_d": ops_d, "qr4": qr4, "gb": gb,
                "N": N, "gen_st": gen_st, "g_off": g_off, "w_len": w_len,
                "cn": cn, "f2_cells_rows": np.asarray(_f2_cells, np.int64)}

    def _pass2_finish(self, entries, sel, opts, ctx):
        cfg = self.cfg
        N = ctx["N"]
        rid = sel["rid"]
        gen_st = ctx["gen_st"]
        g_off = ctx["g_off"]
        w_len = ctx["w_len"]
        cn = ctx["cn"]
        _t0 = time.time()
        stats = ctx["stats_d"].cpu().numpy()[:N]
        self.tel.f2.add(0, 0, time.time() - _t0)
        # scalar-SW invocations: in LS the reference only runs sw_full_ls
        # when the per-hit vector re-score clears the pass2 threshold
        # (mapping.c:406-415); that re-score equals the pass1 vector score
        _smax = sel["score_max"].astype(np.int64)
        if cfg.colour_space or cfg.gapless:
            _qual = np.ones(N, bool)
        else:
            _thr = np.array([abs_or_pct(opts.pass2.threshold, s)
                             for s in _smax])
            _qual = sel["score_vector"].astype(np.int64) >= _thr
        self.tel.f2.add(int(_qual.sum()),
                        int(ctx["f2_cells_rows"][_qual].sum()))
        crossovers = stats[:, 10] if cfg.colour_space else None
        ops_all = ctx["ops_d"].cpu().numpy()[:N]
        score = stats[:, 0]
        tb = {"read_start": stats[:, 1], "genome_start": stats[:, 2],
              "matches": stats[:, 3], "mismatches": stats[:, 4],
              "insertions": stats[:, 5], "deletions": stats[:, 6],
              "rmapped": stats[:, 7], "gmapped": stats[:, 8],
              "ops_len": stats[:, 9], "ops": ops_all}

        # --- selection per read (read_pass2) ---
        out: dict[int, list[FinalHit]] = {}
        score_max = sel["score_max"].astype(np.int64)
        grp_order = np.argsort(rid, kind="stable")
        grp_bounds = np.searchsorted(rid[grp_order],
                                     np.unique(rid))
        uniq = np.unique(rid)

        # CS: collect raw-threshold survivors first, run the posterior HMM
        # for all of them in one vectorized batch (bit-equal to the per-hit
        # pass), then finalize below
        cs_posteriors: dict[int, tuple[float, str]] = {}
        cs_renders: dict[int, tuple[str, str]] = {}
        if cfg.colour_space:
            from shrimp_tpu_torch.ops import post_sw as post_sw_mod
            gb_np, qr4 = ctx["gb"], ctx["qr4"]
            items = []
            item_rows = []
            for n in range(len(rid)):
                s = int(score[n])
                if s <= 0:
                    continue
                thresh = abs_or_pct(opts.pass2.threshold, score_max[n])
                if s < thresh:
                    continue
                ops_n = tb["ops"][n, :tb["ops_len"][n]]
                e = entries[rid[n]]
                dbal, qral = sw_full_cs.render_alignment_cs(
                    ops_n, gb_np[n], qr4[n],
                    int(tb["genome_start"][n]), int(tb["read_start"][n]))
                cs_renders[n] = (dbal, qral)
                if cfg.compute_mapping_qualities:
                    q_in = (None if (e.qual is None or cfg.ignore_qvs)
                            else e.qual)
                    items.append({"colours": e.read[0], "initbp": e.initbp,
                                  "qual": q_in,
                                  "read_start": int(tb["read_start"][n]),
                                  "dbalign": dbal, "qralign": qral})
                    item_rows.append(n)
            if items:
                _t0 = time.time()
                res = post_sw_mod.post_sw_batch(
                    items, self.probs, qual_delta=cfg.qual_delta,
                    qual_vector_offset=cfg.qual_vector_offset)
                # post_sw: cells = 16 * alignment columns (sw-post.c:716)
                self.tel.fwbw.add(
                    len(items),
                    16 * sum(len(it["dbalign"]) for it in items),
                    time.time() - _t0)
                for n, r in zip(item_rows, res):
                    cs_posteriors[n] = r

        for gi, li in enumerate(uniq):
            lo = grp_bounds[gi]
            hi = grp_bounds[gi + 1] if gi + 1 < len(uniq) else len(rid)
            rows = grp_order[lo:hi]
            finals: list[FinalHit] = []
            for n in rows:
                s = int(score[n])
                if s <= 0:
                    continue
                thresh = abs_or_pct(opts.pass2.threshold, score_max[n])
                rmapped = int(tb["rmapped"][n])
                ops_n = tb["ops"][n, :tb["ops_len"][n]].copy()
                if cfg.colour_space:
                    # sw_full_cs itself zeroes sub-threshold raw scores
                    # (sw-full-cs.c:1215-1223)
                    if s < thresh:
                        continue
                    dbal, qral = cs_renders[n]
                    qual33 = None
                    if cfg.compute_mapping_qualities:
                        posterior, qual33 = cs_posteriors[n]
                        score_full = mapq.posterior_score(posterior, rmapped,
                                                          self.probs)
                        if score_full < thresh:
                            continue
                    else:
                        posterior = 0.0
                        score_full = s
                else:
                    dbal = qral = ""
                    qual33 = None
                    posterior = mapq.ls_posterior(s, rmapped, self.probs)
                    ps = mapq.posterior_score(posterior, rmapped, self.probs)
                    score_full = ps if cfg.compute_mapping_qualities else s
                    if score_full < thresh:
                        continue
                pct = (100000 * score_full) // int(score_max[n])
                key = (score_full if is_absolute(opts.pass2.threshold)
                       else pct)
                finals.append(FinalHit(
                    cn=int(cn[n]), gen_st=int(gen_st[n]), g_off=int(g_off[n]),
                    w_len=int(w_len[n]), score_full=score_full, sw_score=s,
                    pass2_key=key, posterior=posterior,
                    read_start=int(tb["read_start"][n]),
                    genome_start=int(tb["genome_start"][n]),
                    rmapped=rmapped, gmapped=int(tb["gmapped"][n]),
                    matches=int(tb["matches"][n]),
                    mismatches=int(tb["mismatches"][n]),
                    insertions=int(tb["insertions"][n]),
                    deletions=int(tb["deletions"][n]),
                    ops=ops_n,
                    score_max=int(score_max[n]),
                    crossovers=(int(crossovers[n]) if crossovers is not None
                                else 0),
                    dbalign=dbal, qralign=qral, qual33=qual33,
                    kmer_matches=int(sel["matches"][n]),
                    score_window_gen=int(sel["score_window_gen"][n]),
                    score_vector=int(sel["score_vector"][n])))
            kept = self._select_hits(finals, opts)
            if kept:
                out[int(li)] = kept
        return out

    # ------------------------------------------------------------------
    def _select_hits(self, finals: list[FinalHit],
                     opts: ReadMappingOptions,
                     compute_mqv: bool | None = None) -> list[FinalHit]:
        """Dedup, sort, trim, strata, max-alignments, MQV
        (read_pass2, mapping.c:1690-1763).  compute_mqv overrides the
        config flag (the paired mapper computes its own class-based MQVs)
        without mutating shared state."""
        cfg = self.cfg
        if compute_mqv is None:
            compute_mqv = cfg.compute_mapping_qualities

        def gen_start_key(fh: FinalHit):
            return (fh.cn, fh.gen_st, fh.g_off + fh.genome_start)

        def gen_end_key(fh: FinalHit):
            gstart = fh.g_off + fh.genome_start
            return (fh.cn, fh.gen_st,
                    -gstart - fh.rmapped + fh.deletions - fh.insertions)

        if len(finals) == 1:
            if cfg.max_alignments and 1 > cfg.max_alignments:
                self._bump(reads_dropped_max_aln=1)
                return []
            if compute_mqv:
                mqvs, z1 = mapq.compute_unpaired_mqv(
                    [finals[0].posterior])
                finals[0].mqv = mqvs[0]
                finals[0].z0 = finals[0].posterior
                finals[0].z1 = z1
            return finals

        def dedup_by(hits: list[FinalHit], keyf) -> list[FinalHit]:
            hits = sorted(hits, key=keyf)
            outl: list[FinalHit] = []
            i = 0
            while i < len(hits):
                j = i
                best = i
                while j < len(hits) and keyf(hits[j]) == keyf(hits[i]):
                    if hits[j].pass2_key > hits[best].pass2_key:
                        best = j
                    j += 1
                outl.append(hits[best])
                i = j
            return outl

        with self.tel.stage("duplicate_removal"):
            dedup = dedup_by(dedup_by(finals, gen_start_key), gen_end_key)
        if len(dedup) < len(finals):
            self._bump(dup_matches_pruned=len(finals) - len(dedup))
        dedup.sort(key=lambda fh: -fh.pass2_key)
        dedup = dedup[:opts.pass2.num_outputs]

        if opts.pass2.strata and dedup:
            top = dedup[0].score_full
            dedup = [fh for fh in dedup if fh.score_full == top]

        if dedup and cfg.max_alignments and len(dedup) > cfg.max_alignments:
            self._bump(reads_dropped_max_aln=1)
            return []

        if compute_mqv and dedup:
            mqvs, z1 = mapq.compute_unpaired_mqv(
                [fh.posterior for fh in dedup])
            for fh, m in zip(dedup, mqvs):
                fh.mqv = m
                fh.z0 = fh.posterior
                fh.z1 = z1
        return dedup

    # ------------------------------------------------------------------
    def render_hit_alignment(self, re: cand.ReadEntry,
                             fh: FinalHit) -> tuple[str, str]:
        """dbalign/qralign strings for one hit (rendered lazily; CS hits
        carry them from the CS traceback already)."""
        if fh.qralign:
            return fh.dbalign, fh.qralign
        plane = self.genome_rc if fh.gen_st == 1 else self.index.genome
        lo = int(self.index.contig_offsets[fh.cn]) + fh.g_off
        window = plane[lo:lo + fh.w_len]
        res = sw_full.SWAlignment(
            score=fh.sw_score, read_start=fh.read_start,
            genome_start=fh.genome_start, ops=fh.ops)
        sw_full.render_alignment(res, window, re.read[0])
        return res.dbalign, res.qralign

    def legacy_record(self, re: cand.ReadEntry, fh: FinalHit,
                      include_read: bool) -> str:
        """One legacy SHRiMP-format line (hit_output !Eflag branch,
        gmapper/output.c:272-295)."""
        from shrimp_tpu_torch.io import legacy
        dbal, qral = self.render_hit_alignment(re, fh)
        read_seq = None
        if include_read:
            if self.cfg.colour_space:
                read_seq = (dna.decode([re.initbp])
                            + dna.decode(re.read[0], dna.COLOUR_SPACE))
            else:
                read_seq = dna.decode(re.read[0])
        return legacy.output_normal(
            re.name, self.index.contig_names[fh.cn],
            genome_start0=fh.g_off + fh.genome_start, gmapped=fh.gmapped,
            read_start0=fh.read_start, rmapped=fh.rmapped,
            read_length=re.read_len, score=fh.score_full,
            dbalign=dbal, qralign=qral,
            genome_len=int(self.index.contig_len[fh.cn]),
            revcmpl=fh.gen_st == 1, read_seq=read_seq)

    def legacy_records(self, re: cand.ReadEntry, hits: list[FinalHit],
                       include_read: bool = False) -> list[str]:
        """Legacy-format lines for one read (`-P`, the pretty blocks, is
        not ported)."""
        if not hits:
            return [f">{re.name}"] if self.cfg.sam_unaligned else []
        sel = hits
        if self.cfg.single_best_mapping and self.cfg.compute_mapping_qualities:
            best = max(range(len(hits)), key=lambda i: hits[i].mqv)
            sel = [hits[best]]
        return [self.legacy_record(re, fh, include_read) for fh in sel]

    # ------------------------------------------------------------------
    def _append_tail_tags(self, rec, re_e, fh, mate_re=None) -> None:
        """R2/X2, RG:Z and --extra-sam-fields tags, in the reference's
        order (output.c:452-464, 731-756)."""
        cfg = self.cfg
        if cfg.sam_r2 and mate_re is not None:
            tag = "X2" if cfg.colour_space else "R2"
            rec.tags.append(f"{tag}:Z:{mate_re.seq}")
        if cfg.sam_read_group_name:
            rec.tags.append(f"RG:Z:{cfg.sam_read_group_name}")
        if cfg.extra_sam_fields and fh is not None:
            from shrimp_tpu_torch.io import legacy
            db, qr = self.render_hit_alignment(re_e, fh)
            es = legacy.alignment_edit_string(db, qr)
            if fh.gen_st == 1:
                es = legacy.reverse_alignment_edit_string(es)
            rec.tags.append(
                f"ZM:i:{fh.kmer_matches}\tZR:i:{fh.score_window_gen}\t"
                f"ZV:i:{fh.score_vector}\tZH:i:{fh.sw_score}\tZE:Z:{es}")

    def sam_records(self, re: cand.ReadEntry,
                    hits: list[FinalHit]) -> list[sam.SamRecord]:
        """read_output + hit_output for one read."""
        cfg = self.cfg
        recs = []
        if not hits:
            if cfg.sam_unaligned:
                if cfg.colour_space:
                    recs.append(sam.unaligned_record_cs(re.name, re.seq,
                                                        re.qual))
                else:
                    recs.append(sam.unaligned_record(re.name, re.seq,
                                                     re.qual, cfg.qual_delta))
                self._append_tail_tags(recs[-1], re, None)
            return recs
        sel = hits
        if cfg.single_best_mapping and cfg.compute_mapping_qualities:
            best = max(range(len(hits)), key=lambda i: hits[i].mqv)
            sel = [hits[best]]
        if cfg.colour_space:
            for fh in sel:
                recs.append(sam.aligned_record_cs(
                    name=re.name,
                    seq_text=re.seq,
                    qual_raw=re.qual,
                    contig_name=self.index.contig_names[fh.cn],
                    contig_len=int(self.index.contig_len[fh.cn]),
                    genome_start0=fh.g_off + fh.genome_start,
                    read_start0=fh.read_start,
                    rmapped=fh.rmapped, gmapped=fh.gmapped,
                    insertions=fh.insertions, deletions=fh.deletions,
                    mismatches=fh.mismatches,
                    ops=fh.ops, qralign=fh.qralign,
                    qual33=(fh.qual33
                            if cfg.compute_mapping_qualities else None),
                    crossovers=fh.crossovers,
                    bfast=cfg.bfast,
                    reverse_strand=fh.gen_st == 1,
                    score_full=fh.score_full,
                    mapq_v=fh.mqv if cfg.compute_mapping_qualities else 255,
                    z0=(fh.z0 if cfg.compute_mapping_qualities
                        and not cfg.all_contigs else None),
                    z1=(fh.z1 if cfg.compute_mapping_qualities
                        and not cfg.all_contigs else None),
                    read_len=re.read_len))
                self._append_tail_tags(recs[-1], re, fh)
            return recs
        for fh in sel:
            recs.append(sam.aligned_record_from_ops(
                name=re.name,
                seq_text=re.seq,
                qual=re.qual,
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
                z0=(fh.z0 if cfg.compute_mapping_qualities
                    and not cfg.all_contigs else None),
                z1=(fh.z1 if cfg.compute_mapping_qualities
                    and not cfg.all_contigs else None),
                qual_delta=cfg.qual_delta,
                read_len=re.read_len))
            self._append_tail_tags(recs[-1], re, fh)
        return recs
