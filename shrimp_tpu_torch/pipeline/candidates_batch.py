"""Vectorized batch candidate generation — NumPy column arrays end-to-end.

Semantically identical to `candidates.py`'s per-read walk (tested against
it); restructured so a whole read batch flows through array ops:

  * kmer → mapidx: one gather per seed over the padded read-code matrix,
  * posting-list expansion: CSR repeat/cumsum instead of a per-kmer loop,
  * colinear collapse: run-detection in (read, diag-slot, order) space —
    exactly the reference's diag-modulo cache semantics (mapping.c:997-1013),
  * window pairing: fixed-lookback vectorized max instead of the per-anchor
    backward scan (exact when windows hold <= `hit_lookback` anchors; the
    overflow count is tracked).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from shrimp_tpu_torch.index import GenomeIndex
from shrimp_tpu_torch.pipeline.candidates import ReadEntry
from shrimp_tpu_torch.pipeline.options import HitListOptions, MapperConfig, abs_or_pct


@dataclass
class AnchorBatch:
    """Flat anchor rows for a whole batch, sorted by (read, strand, x)."""

    rid: np.ndarray      # int32 read index in batch
    st: np.ndarray       # int8 strand
    x: np.ndarray        # int64 global genome position
    y: np.ndarray        # int32 read position
    length: np.ndarray   # int32
    weight: np.ndarray   # int32
    cn: np.ndarray       # int32

    @property
    def n(self) -> int:
        return len(self.x)


@dataclass
class HitBatch:
    """Flat candidate-window rows (read_hit columns) for a whole batch."""

    rid: np.ndarray
    st: np.ndarray
    cn: np.ndarray
    g_off: np.ndarray
    w_len: np.ndarray
    score_window_gen: np.ndarray
    matches: np.ndarray
    score_max: np.ndarray
    anchor_x: np.ndarray
    anchor_y: np.ndarray
    anchor_length: np.ndarray
    anchor_width: np.ndarray

    @property
    def n(self) -> int:
        return len(self.g_off)


def mapidx_batch(entries: list[ReadEntry], idx: GenomeIndex,
                 st: int) -> list[np.ndarray]:
    """Per-seed mapidx matrices for all reads on one strand.

    Returns per seed: uint32[B, Kmax] with 0xFFFFFFFF for invalid slots.
    """
    B = len(entries)
    Rmax = max((e.read_len for e in entries), default=0)
    codes = np.zeros((B, Rmax), np.int8)
    rlen = np.zeros(B, np.int64)
    minpos = np.zeros(B, np.int64)
    for b, e in enumerate(entries):
        codes[b, :e.read_len] = e.read[st]
        rlen[b] = e.read_len
        minpos[b] = e.min_kmer_pos
    out = []
    for seed in idx.seed_set.seeds:
        K = max(Rmax - seed.span + 1, 0)
        if K == 0:
            out.append(np.full((B, 0), 0xFFFFFFFF, np.uint32))
            continue
        starts = np.arange(K)[None, :] + minpos[:, None]       # [B, K]
        valid = starts + seed.span <= rlen[:, None]
        if seed.positions is not None:
            valid &= np.isin(starts - minpos[:, None], seed.positions)
        # one fancy gather over a strided window view instead of a
        # take_along_axis per seed position (invalid slots masked below)
        win = np.lib.stride_tricks.sliding_window_view(codes, seed.span,
                                                       axis=1)
        K0 = win.shape[1]
        row_idx = np.minimum(starts, K0 - 1)
        sel = win[np.arange(B)[:, None, None], row_idx[:, :, None],
                  np.asarray(seed.ones_idx)[None, None, :]]
        shifts = (2 * np.arange(len(seed.ones_idx), dtype=np.uint64))
        acc = np.bitwise_or.reduce(
            (sel.astype(np.uint64) & np.uint64(3)) << shifts[None, None, :],
            axis=2)
        if idx.seed_set.use_hashing:
            # exact kmer_to_mapidx_hash over the padded code plane: flatten
            # rows so window starts index one big array
            from shrimp_tpu_torch.index import hash_mapidx
            max_span = max(sd.span for sd in idx.seed_set.seeds)
            flat = codes.reshape(-1)
            starts_flat = (np.arange(B)[:, None] * Rmax
                           + np.minimum(starts, Rmax - seed.span)).ravel()
            acc = hash_mapidx(flat, starts_flat, seed.span, seed.ones_idx,
                              max_span).reshape(B, K).astype(np.uint64)
        mi = acc.astype(np.uint32)
        mi[~valid] = np.uint32(0xFFFFFFFF)
        out.append(mi)
    return out


REGION_BITS = 11        # DEF_REGION_BITS
REGION_OVERLAP = 50     # DEF_REGION_OVERLAP
_REGION_TABLE = None    # persistent native visit-table workspace


def sqf_region_extras(entries: list, idx: GenomeIndex, st: int,
                      list_cutoff: int = 0xFFFFFFFF):
    """Region-visit entries contributed by --enable-seed-qual-filter'ed
    kmer slots.

    read_get_mapidxs stores mapidx **0** for a mapidx-site-filtered slot
    (mapping.c:78-81); the region-count loops (read_get_region_counts
    mapping.c:475, read_get_mp_region_counts :561) iterate every slot with
    its stored mapidx and re-check neither filter.  Anchor generation
    skips anchor-site-filtered slots (mapping.c:936-939), so those slots'
    posting lists (bucket 0 if also mapidx-filtered, the true list
    otherwise) appear in the visit counts but not in the expanded anchors.
    This returns exactly that anchors/regions difference as (rid, x), or
    None when empty."""
    rid_parts, x_parts = [], []
    mapidxs = None
    for sn in range(len(idx.seed_set.seeds)):
        off = idx.offsets[sn]
        for r, e in enumerate(entries):
            if e.sqf is None or not len(e.sqf[sn]):
                continue
            ma = e.sqf[sn]
            if not ma.any():
                continue
            mm = e.sqf_mapidx[sn]
            if mapidxs is None:
                mapidxs = mapidx_batch(entries, idx, st)
            mi_row = mapidxs[sn][r, :len(ma)]
            slots = np.flatnonzero(ma & (mi_row != 0xFFFFFFFF))
            eff = np.where(mm[slots], 0, mi_row[slots]).astype(np.int64)
            lo = off[eff]
            hi = off[eff + 1]
            lens = hi - lo
            lens = np.where(lens > list_cutoff, 0, lens)
            total = int(lens.sum())
            if not total:
                continue
            starts = np.zeros(len(lens) + 1, np.int64)
            np.cumsum(lens, out=starts[1:])
            within = (np.arange(total, dtype=np.int64)
                      - np.repeat(starts[:-1], lens))
            x_parts.append(idx.positions[sn][np.repeat(lo, lens) + within]
                           .astype(np.int64))
            rid_parts.append(np.full(total, r, np.int32))
    if not x_parts:
        return None
    return (np.concatenate(rid_parts), np.concatenate(x_parts))


def _region_keys(rid: np.ndarray, x: np.ndarray, region_bits: int,
                 region_overlap: int) -> np.ndarray:
    """All (read, region) visit keys for posting entries, including the
    previous-region extension near a region start."""
    reg = x >> region_bits
    off = x & ((1 << region_bits) - 1)
    key = (rid.astype(np.int64) << 24) | reg
    ext = (off < region_overlap) & (reg > 0)
    return np.concatenate([key, key[ext] - 1])


def region_has2_filter(rid: np.ndarray, x: np.ndarray,
                       region_bits: int = REGION_BITS,
                       region_overlap: int = REGION_OVERLAP,
                       extra=None) -> np.ndarray:
    """Region-count pruning (read_get_region_counts +
    advance_index_in_genomemap, mapping.c:475-780).

    The genome is cut into 2^region_bits-byte regions; a posting entry
    "visits" its region, and also the previous region when it lies within
    region_overlap of the region start.  Anchors whose region (or, near the
    start, the previous region) was visited < 2 times by this read-strand are
    discarded.  Returns a keep mask.

    Uses the native C visit-table when available (O(n), the reference's
    region_map structure) instead of the sort-based NumPy fallback.

    extra: optional (rid, x) posting entries that contribute visits but
    are not part of the returned mask (seed-qual-filter bucket-0 slots).
    """
    if len(x) and extra is None:
        from shrimp_tpu_torch import native
        lib = native.load_candidates()
        if lib is not None:
            import ctypes
            n_reads = int(rid.max()) + 1
            n_regions = (int(x.max()) >> region_bits) + 1
            tbl_sz = n_reads * n_regions
            if tbl_sz <= (1 << 33):
                global _REGION_TABLE
                if _REGION_TABLE is None or len(_REGION_TABLE) < tbl_sz:
                    _REGION_TABLE = np.zeros(
                        max(tbl_sz, 1 << 20), np.uint8)
                rid32 = np.ascontiguousarray(rid, np.int32)
                x64 = np.ascontiguousarray(x, np.int64)
                keep = np.empty(len(x), np.uint8)
                rc = lib.region_has2_filter(
                    rid32.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                    x64.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
                    len(x), region_bits, region_overlap,
                    n_regions, n_reads,
                    _REGION_TABLE.ctypes.data_as(
                        ctypes.POINTER(ctypes.c_uint8)),
                    keep.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
                if rc == 0:
                    return keep.astype(bool)
    reg = x >> region_bits
    off = x & ((1 << region_bits) - 1)
    key = (rid.astype(np.int64) << 24) | reg   # region < 2^24 => genome < 32Gbp
    ext = (off < region_overlap) & (reg > 0)
    all_keys = np.concatenate([key, key[ext] - 1])
    if extra is not None:
        all_keys = np.concatenate(
            [all_keys,
             _region_keys(extra[0], extra[1], region_bits, region_overlap)])
    uniq, counts = np.unique(all_keys, return_counts=True)
    has2 = uniq[counts >= 2]
    if len(has2) == 0:
        return np.zeros(len(key), bool)
    in_has2 = np.searchsorted(has2, key)
    ok_main = (in_has2 < len(has2)) & (has2[np.minimum(in_has2, len(has2) - 1)] == key)
    in_prev = np.searchsorted(has2, key - 1)
    ok_prev = ext & (in_prev < len(has2)) & \
        (has2[np.minimum(in_prev, len(has2) - 1)] == key - 1)
    return ok_main | ok_prev


def region_visits(rid: np.ndarray, x: np.ndarray,
                  region_bits: int = REGION_BITS,
                  region_overlap: int = REGION_OVERLAP,
                  extra=None):
    """Per-(read, region) visit counts from raw posting entries
    (read_get_region_counts, mapping.c:475-540): each entry visits its
    region, plus the previous one when within region_overlap of the region
    start.  extra: (rid, x) visit-only entries (seed-qual-filter bucket-0
    slots).  Returns (sorted unique keys rid<<24|region, counts)."""
    all_keys = _region_keys(rid, x, region_bits, region_overlap)
    if extra is not None:
        all_keys = np.concatenate(
            [all_keys,
             _region_keys(extra[0], extra[1], region_bits, region_overlap)])
    return np.unique(all_keys, return_counts=True)


def _lookup_counts(keys: np.ndarray, counts: np.ndarray,
                   q: np.ndarray) -> np.ndarray:
    if len(keys) == 0:
        return np.zeros(len(q), np.int64)
    i = np.minimum(np.searchsorted(keys, q), len(keys) - 1)
    return np.where(keys[i] == q, counts[i], 0)


def _mp_counts(rid: np.ndarray, regq: np.ndarray, mate,
               lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """Max mate region count (capped at 2) over [regq+lo, regq+hi]."""
    mkeys, mcounts = mate
    key = (rid.astype(np.int64) << 24) | regq
    count_mp = np.zeros(len(key), np.int64)
    if len(lo) == 0:
        return count_mp
    omin, omax = int(lo.min()), int(hi.max())
    for o in range(omin, omax + 1):
        valid = (lo <= o) & (o <= hi) & (regq + o >= 0)
        c = np.minimum(_lookup_counts(mkeys, mcounts, key + o), 2)
        count_mp = np.maximum(count_mp, np.where(valid, c, 0))
    return count_mp


def mp_heavy_flags(rid: np.ndarray, x: np.ndarray, mate,
                   dmin_r: np.ndarray, dmax_r: np.ndarray,
                   region_bits: int = REGION_BITS,
                   region_overlap: int = REGION_OVERLAP) -> np.ndarray:
    """Per-anchor heavy_mp flag for hit-list match_mode 3
    (read_get_hit_list, mapping.c:1108-1119): mate MP count >= 2 for the
    anchor's region, or for the previous region when within
    region_overlap of the region start."""
    reg = x >> region_bits
    off = x & ((1 << region_bits) - 1)
    lo = dmin_r[rid]
    hi = dmax_r[rid]
    heavy = _mp_counts(rid, reg, mate, lo, hi) >= 2
    ext = (off < region_overlap) & (reg > 0)
    if ext.any():
        heavy |= ext & (_mp_counts(rid, reg - 1, mate, lo, hi) >= 2)
    return heavy


def region_mp_filter(rid: np.ndarray, x: np.ndarray, own, mate,
                     dmin_r: np.ndarray, dmax_r: np.ndarray, mode: int,
                     region_bits: int = REGION_BITS,
                     region_overlap: int = REGION_OVERLAP) -> np.ndarray:
    """Mate-pair region-count pruning (advance_index_in_genomemap with
    use_mp_region_counts != 0, mapping.c:682-748).

    own / mate: (keys, counts) from `region_visits` for this read-strand
    and for the mate's opposite strand.  dmin_r/dmax_r: per-read region
    deltas (readpair_compute_mp_ranges' delta_region, indexed by rid).
    count_main = 2 if the own region has >= 2 visits else 1; count_mp is the
    max mate count (capped at 2) over [region+dmin_r, region+dmax_r].
    Keep modes: 1 = main>=2 AND mp>=2; 2 = main>=2 OR mp>=2;
    3 = mp>=1 AND main+mp>=3.  An anchor near the region start may also
    qualify via the previous region."""
    mkeys, mcounts = mate
    okeys, ocounts = own
    reg = x >> region_bits
    off = x & ((1 << region_bits) - 1)
    lo = dmin_r[rid]
    hi = dmax_r[rid]

    def cond(regq):
        key = (rid.astype(np.int64) << 24) | regq
        count_main = np.where(_lookup_counts(okeys, ocounts, key) >= 2, 2, 1)
        count_mp = _mp_counts(rid, regq, mate, lo, hi)
        if mode == 1:
            return (count_main >= 2) & (count_mp >= 2)
        if mode == 2:
            return (count_main >= 2) | (count_mp >= 2)
        return (count_mp >= 1) & (count_main + count_mp >= 3)

    keep = cond(reg)
    ext = (off < region_overlap) & (reg > 0)
    if ext.any():
        keep |= ext & cond(reg - 1)
    return keep


def _expansion_lists(entries: list[ReadEntry], idx: GenomeIndex, st: int,
                     list_cutoff: int = 0xFFFFFFFF):
    """Per-seed CSR list metadata for one strand (the shared front half
    of posting expansion): a list of per-seed tuples
    (fl, base, rows, kcols, span) covering every non-empty posting list
    after list_cutoff truncation, in (seed, read, kmer) order."""
    mapidxs = mapidx_batch(entries, idx, st)
    B = len(entries)
    out = []
    for sn, seed in enumerate(idx.seed_set.seeds):
        mi = mapidxs[sn]                       # [B, K]
        if mi.size == 0:
            continue
        off = idx.offsets[sn]
        valid = mi != 0xFFFFFFFF
        for r, e in enumerate(entries):
            # --enable-seed-qual-filter: mapidx-site-filtered slots were
            # stored as mapidx 0 (mapping.c:78-81); anchor-site-filtered
            # slots are skipped (mapping.c:936-939).  Slots dropped here
            # still feed the region counts via sqf_region_extras.
            if e.sqf is not None and len(e.sqf[sn]):
                mm = e.sqf_mapidx[sn]
                mi[r, :len(mm)][mm & valid[r, :len(mm)]] = 0
                ma = e.sqf[sn]
                valid[r, :len(ma)] &= ~ma
        mi_safe = np.where(valid, mi, 0)
        lo = off[mi_safe]
        hi = off[mi_safe + 1]
        lens = np.where(valid, hi - lo, 0)
        lens = np.where(lens > list_cutoff, 0, lens)
        if int(lens.sum()) == 0:
            continue
        flat_lens = lens.ravel()
        nz = flat_lens > 0
        fl = flat_lens[nz].astype(np.int64)
        base = lo.ravel()[nz].astype(np.int64)
        rows = np.broadcast_to(np.arange(B)[:, None],
                               lens.shape).ravel()[nz]
        kcols = np.broadcast_to(
            np.arange(lens.shape[1])[None, :], lens.shape).ravel()[nz]
        out.append((sn, fl, base, rows, kcols, seed.span))
    return out


def expand_postings(entries: list[ReadEntry], idx: GenomeIndex, st: int,
                    list_cutoff: int = 0xFFFFFFFF):
    """Raw posting-list expansion for one strand: returns (rid, x, y, ln)
    flat arrays across all seeds (unsorted)."""
    rid_parts, x_parts, y_parts, ln_parts = [], [], [], []
    minpos = np.array([e.min_kmer_pos for e in entries], np.int64)
    for sn, fl0, base, all_rows, all_kcols, span in \
            _expansion_lists(entries, idx, st, list_cutoff):
        pos = idx.positions[sn]
        fl = fl0
        total = int(fl.sum())
        from shrimp_tpu_torch import native
        lib = native.load_candidates()
        if lib is not None and pos.dtype == np.uint32:
            import ctypes
            i64p = ctypes.POINTER(ctypes.c_longlong)
            i32p = ctypes.POINTER(ctypes.c_int32)
            xs = np.empty(total, np.int64)
            rids = np.empty(total, np.int32)
            ys = np.empty(total, np.int32)
            fl_c = np.ascontiguousarray(fl)
            base_c = np.ascontiguousarray(base)
            rows_c = np.ascontiguousarray(all_rows, np.int32)
            kcols_c = np.ascontiguousarray(all_kcols, np.int32)
            minpos_c = np.ascontiguousarray(minpos, np.int64)
            pos_c = np.ascontiguousarray(pos, np.uint32)
            lib.expand_postings_fused(
                fl_c.ctypes.data_as(i64p), base_c.ctypes.data_as(i64p),
                rows_c.ctypes.data_as(i32p), kcols_c.ctypes.data_as(i32p),
                minpos_c.ctypes.data_as(i64p), len(fl_c),
                pos_c.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
                xs.ctypes.data_as(i64p), rids.ctypes.data_as(i32p),
                ys.ctypes.data_as(i32p))
            x_parts.append(xs)
            rid_parts.append(rids)
            y_parts.append(ys)
        else:
            # NumPy CSR expansion fallback
            starts_out = np.zeros(len(fl) + 1, np.int64)
            np.cumsum(fl, out=starts_out[1:])
            within = (np.arange(total, dtype=np.int64)
                      - np.repeat(starts_out[:-1], fl))
            x_parts.append(pos[np.repeat(base, fl) + within]
                           .astype(np.int64))
            rows = np.repeat(all_rows, fl)
            rid_parts.append(rows.astype(np.int32))
            y_parts.append((np.repeat(all_kcols, fl)
                            + minpos[rows]).astype(np.int32))
        ln_parts.append(np.full(total, span, np.int32))

    if not x_parts:
        z = np.zeros(0, np.int64)
        z32 = np.zeros(0, np.int32)
        return (z32, z, z32.copy(), z32.copy())
    return (np.concatenate(rid_parts), np.concatenate(x_parts),
            np.concatenate(y_parts), np.concatenate(ln_parts))


def _get_region_table(tbl_sz: int) -> np.ndarray:
    global _REGION_TABLE
    if _REGION_TABLE is None or len(_REGION_TABLE) < tbl_sz:
        _REGION_TABLE = np.zeros(max(tbl_sz, 1 << 20), np.uint8)
    return _REGION_TABLE


def _anchors_fused(entries, idx, st: int, collapse: bool,
                   list_cutoff: int, use_region_counts: bool):
    """Fully fused native L3: CSR expansion + has-2 region pruning +
    sort + collapse in one C call (anchors_from_csr) — no intermediate
    posting arrays are materialized at all.  Returns AnchorBatch or None
    when the native path is unavailable for these inputs."""
    from shrimp_tpu_torch import native
    lib = native.load_candidates()
    if lib is None:
        return None
    if any(p.dtype != np.uint32 for p in idx.positions):
        return None
    n_reads = len(entries)
    total_len = int(idx.total_len)
    # shift must clear REGION_BITS so the group key (rid, region) of the
    # sorted-scan pruning never mixes rid bits into the region field
    shift = max(REGION_BITS + 1, (max(total_len - 1, 1)).bit_length())
    if shift + max(1, n_reads.bit_length()) > 62:
        return None

    lists = _expansion_lists(entries, idx, st, list_cutoff)
    empty64 = np.zeros(0, np.int64)
    empty32 = np.zeros(0, np.int32)
    if not lists:
        return AnchorBatch(empty32, np.zeros(0, np.int8), empty64,
                           empty32, empty32.copy(), empty32.copy(),
                           empty32.copy())
    import ctypes
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_longlong)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    fl = np.ascontiguousarray(np.concatenate([t[1] for t in lists]))
    base = np.ascontiguousarray(np.concatenate([t[2] for t in lists]))
    rows = np.ascontiguousarray(
        np.concatenate([t[3] for t in lists]), np.int32)
    kcols = np.ascontiguousarray(
        np.concatenate([t[4] for t in lists]), np.int32)
    spans = np.ascontiguousarray(np.concatenate(
        [np.full(len(t[1]), t[5], np.int32) for t in lists]))
    seedno = np.ascontiguousarray(np.concatenate(
        [np.full(len(t[1]), t[0], np.int32) for t in lists]))
    total = int(fl.sum())
    if total == 0:
        return AnchorBatch(empty32, np.zeros(0, np.int8), empty64,
                           empty32, empty32.copy(), empty32.copy(),
                           empty32.copy())
    minpos = np.ascontiguousarray(
        [e.min_kmer_pos for e in entries], np.int64)
    rlen = np.ascontiguousarray(
        [e.read_len for e in entries], np.int64)
    coffs = np.ascontiguousarray(idx.contig_offsets, np.int64)
    pos_ptrs = (u32p * len(idx.positions))(
        *[p.ctypes.data_as(u32p) for p in idx.positions])
    out_rid = np.empty(total, np.int32)
    out_x = np.empty(total, np.int64)
    out_y = np.empty(total, np.int32)
    out_ln = np.empty(total, np.int32)
    out_wt = np.empty(total, np.int32)
    out_cn = np.empty(total, np.int32)
    import os as _os
    if total_len < (1 << 32) and hasattr(lib, "anchors_from_csr_rm") \
            and not _os.environ.get("SHRIMP_TPU_NO_RM"):
        # read-major variant: regroup lists by read so each read's
        # postings sort/prune/collapse in cache (no DRAM radix scatter);
        # stable regrouping preserves the per-read tie order, so output
        # is byte-identical to the global (rid, x) sort
        order = np.argsort(rows, kind="stable")
        fl, base, rows, kcols, spans, seedno = (
            np.ascontiguousarray(a[order])
            for a in (fl, base, rows, kcols, spans, seedno))
        per_read = np.bincount(rows, weights=fl, minlength=n_reads)
        n_out = lib.anchors_from_csr_rm(
            fl.ctypes.data_as(i64p), base.ctypes.data_as(i64p),
            rows.ctypes.data_as(i32p), kcols.ctypes.data_as(i32p),
            spans.ctypes.data_as(i32p), seedno.ctypes.data_as(i32p),
            len(fl), int(per_read.max()),
            minpos.ctypes.data_as(i64p), pos_ptrs,
            1 if use_region_counts else 0, REGION_BITS, REGION_OVERLAP,
            rlen.ctypes.data_as(i64p), int(rlen.max()),
            coffs.ctypes.data_as(i64p), len(coffs),
            1 if collapse else 0,
            out_rid.ctypes.data_as(i32p), out_x.ctypes.data_as(i64p),
            out_y.ctypes.data_as(i32p), out_ln.ctypes.data_as(i32p),
            out_wt.ctypes.data_as(i32p), out_cn.ctypes.data_as(i32p))
    else:
        n_out = lib.anchors_from_csr(
            fl.ctypes.data_as(i64p), base.ctypes.data_as(i64p),
            rows.ctypes.data_as(i32p), kcols.ctypes.data_as(i32p),
            spans.ctypes.data_as(i32p), seedno.ctypes.data_as(i32p),
            len(fl), total,
            minpos.ctypes.data_as(i64p), pos_ptrs,
            1 if use_region_counts else 0, REGION_BITS, REGION_OVERLAP,
            rlen.ctypes.data_as(i64p), int(rlen.max()),
            coffs.ctypes.data_as(i64p), len(coffs),
            1 if collapse else 0, shift,
            out_rid.ctypes.data_as(i32p), out_x.ctypes.data_as(i64p),
            out_y.ctypes.data_as(i32p), out_ln.ctypes.data_as(i32p),
            out_wt.ctypes.data_as(i32p), out_cn.ctypes.data_as(i32p))
    if n_out < 0:
        return None
    st_col = np.full(n_out, st, np.int8)
    return AnchorBatch(out_rid[:n_out], st_col, out_x[:n_out],
                       out_y[:n_out], out_ln[:n_out], out_wt[:n_out],
                       out_cn[:n_out])


def _anchors_native(entries, idx, rid, x, y, ln, keep, st: int,
                    collapse: bool):
    """Fused C anchor construction: filter + stable (rid, x) sort +
    slot-cache collapse + contig resolve in one native pass (identical
    output to the NumPy path below; tested in test_candidates_native)."""
    from shrimp_tpu_torch import native
    lib = native.load_candidates()
    if lib is None:
        return None
    import ctypes
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_longlong)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    rid_c = np.ascontiguousarray(rid, np.int32)
    x_c = np.ascontiguousarray(x, np.int64)
    y_c = np.ascontiguousarray(y, np.int32)
    ln_c = np.ascontiguousarray(ln, np.int32)
    if keep is not None:
        keep_c = np.ascontiguousarray(keep, np.uint8)
        n_kept = int(keep_c.sum())
        keep_ptr = keep_c.ctypes.data_as(u8p)
    else:
        n_kept = len(x_c)
        keep_ptr = ctypes.cast(None, u8p)
    if n_kept == 0:
        z = np.zeros(0, np.int64)
        z32 = np.zeros(0, np.int32)
        return AnchorBatch(z32, np.zeros(0, np.int8), z, z32, z32, z32, z32)
    rlen = np.ascontiguousarray(
        [e.read_len for e in entries], np.int64)
    coffs = np.ascontiguousarray(idx.contig_offsets, np.int64)
    out_rid = np.empty(n_kept, np.int32)
    out_x = np.empty(n_kept, np.int64)
    out_y = np.empty(n_kept, np.int32)
    out_ln = np.empty(n_kept, np.int32)
    out_wt = np.empty(n_kept, np.int32)
    out_cn = np.empty(n_kept, np.int32)
    n_out = lib.anchors_from_postings(
        rid_c.ctypes.data_as(i32p), x_c.ctypes.data_as(i64p),
        y_c.ctypes.data_as(i32p), ln_c.ctypes.data_as(i32p),
        keep_ptr, len(x_c),
        rlen.ctypes.data_as(i64p), int(rlen.max()),
        coffs.ctypes.data_as(i64p), len(coffs),
        1 if collapse else 0,
        out_rid.ctypes.data_as(i32p), out_x.ctypes.data_as(i64p),
        out_y.ctypes.data_as(i32p), out_ln.ctypes.data_as(i32p),
        out_wt.ctypes.data_as(i32p), out_cn.ctypes.data_as(i32p))
    if n_out < 0:
        return None
    st_col = np.full(n_out, st, np.int8)
    return AnchorBatch(out_rid[:n_out], st_col, out_x[:n_out],
                       out_y[:n_out], out_ln[:n_out], out_wt[:n_out],
                       out_cn[:n_out])


def anchors_batch(entries: list[ReadEntry], idx: GenomeIndex, st: int,
                  collapse: bool = True,
                  list_cutoff: int = 0xFFFFFFFF,
                  use_region_counts: bool = False,
                  postings=None,
                  region_filter=None) -> AnchorBatch:
    """Build the merged anchor lists for all reads on one strand.

    postings: precomputed `expand_postings` result (avoids re-expansion);
    region_filter: keep-mask callable(rid, x) overriding the default has-2
    region filter (used for mate-pair region counts)."""
    sqf_active = any(e.sqf is not None for e in entries)
    if postings is None and region_filter is None and not sqf_active:
        ab = _anchors_fused(entries, idx, st, collapse, list_cutoff,
                            use_region_counts)
        if ab is not None:
            return ab
    if postings is None:
        postings = expand_postings(entries, idx, st, list_cutoff)
    rid, x, y, ln = postings

    keep = None
    if len(x) and region_filter is not None:
        keep = region_filter(rid, x)
    elif use_region_counts and len(x):
        extra = (sqf_region_extras(entries, idx, st, list_cutoff)
                 if sqf_active else None)
        keep = region_has2_filter(rid, x, extra=extra)

    if len(x):
        ab = _anchors_native(entries, idx, rid, x, y, ln, keep, st,
                             collapse)
        if ab is not None:
            return ab

    if keep is not None:
        rid, x, y, ln = rid[keep], x[keep], y[keep], ln[keep]
    if not len(x):
        z = np.zeros(0, np.int64)
        z32 = np.zeros(0, np.int32)
        return AnchorBatch(z32, np.zeros(0, np.int8), z, z32, z32, z32, z32)

    # single combined-key stable sort ((rid, x) lexsort equivalent):
    # x < 2^40 (1 Tbp genomes), rid < 2^23
    order = np.argsort((rid.astype(np.int64) << 40) | x, kind="stable")
    rid, x, y, ln = rid[order], x[order], y[order], ln[order]
    cn = idx.contig_of(x).astype(np.int32)
    wt = np.ones(len(x), np.int32)

    if collapse and len(x):
        rlen = np.array([e.read_len for e in entries], np.int64)
        R = rlen[rid]
        slot = (x + R - y) % R
        diag = x - y
        # group by (rid, slot), preserve x-order inside groups
        g_order = np.argsort(rid.astype(np.int64) * np.int64(R.max() + 1)
                             + slot, kind="stable")
        r2, s2, d2, c2 = rid[g_order], slot[g_order], diag[g_order], cn[g_order]
        new_run = np.ones(len(x), bool)
        if len(x) > 1:
            same = ((r2[1:] == r2[:-1]) & (s2[1:] == s2[:-1])
                    & (d2[1:] == d2[:-1]) & (c2[1:] == c2[:-1]))
            new_run[1:] = ~same
        run_id = np.cumsum(new_run) - 1
        head_pos = np.flatnonzero(new_run)           # in g_order space
        # aggregate weight and extent per run
        x2, ln2 = x[g_order], ln[g_order]
        run_wt = np.bincount(run_id)
        ext = x2 + ln2
        n_runs = len(head_pos)
        run_ext = np.maximum.reduceat(ext, head_pos)
        head_idx = g_order[head_pos]                 # original indices
        ln_new = ln.copy()
        wt_new = wt.copy()
        ln_new[head_idx] = (run_ext - x[head_idx]).astype(np.int32)
        wt_new[head_idx] = run_wt.astype(np.int32)
        keep = np.zeros(len(x), bool)
        keep[head_idx] = True
        rid, x, y, ln, wt, cn = (rid[keep], x[keep], y[keep],
                                 ln_new[keep], wt_new[keep], cn[keep])

    st_col = np.full(len(x), st, np.int8)
    return AnchorBatch(rid, st_col, x, y, ln, wt, cn)


def _hit_list_native(lib, entries, idx, an, options, cfg, heavy_mp):
    """One C pass: backward in-window scan + threshold emit + window
    placement + anchor join (native hit_list_from_anchors); the final
    (rid, cn, g_off) lexsort stays in NumPy."""
    import ctypes
    n = an.n
    p = cfg.params
    rlen = np.array([e.read_len for e in entries], np.int64)
    wlen = np.array([e.window_len for e in entries], np.int64)
    coffs = np.ascontiguousarray(idx.contig_offsets, np.int64)
    clens = np.ascontiguousarray(idx.contig_len, np.int64)
    heavy = (np.ascontiguousarray(heavy_mp, np.uint8)
             if heavy_mp is not None else None)

    o_rid = np.empty(n, np.int32)
    o_st = np.empty(n, np.int8)
    o_cn = np.empty(n, np.int32)
    o_goff = np.empty(n, np.int64)
    o_wlen = np.empty(n, np.int32)
    o_swg = np.empty(n, np.int32)
    o_matches = np.empty(n, np.int32)
    o_smax = np.empty(n, np.int32)
    o_ax = np.empty(n, np.int64)
    o_ay = np.empty(n, np.int64)
    o_alen = np.empty(n, np.int32)
    o_awid = np.empty(n, np.int32)

    a_rid = np.ascontiguousarray(an.rid, np.int32)
    a_st = np.ascontiguousarray(an.st, np.int8)
    a_x = np.ascontiguousarray(an.x, np.int64)
    a_y = np.ascontiguousarray(an.y, np.int32)
    a_ln = np.ascontiguousarray(an.length, np.int32)
    a_wt = np.ascontiguousarray(an.weight, np.int32)
    a_cn = np.ascontiguousarray(an.cn, np.int32)

    def P(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))

    i32, i64, i8 = ctypes.c_int32, ctypes.c_longlong, ctypes.c_int8
    u8 = ctypes.c_uint8
    n_out = lib.hit_list_from_anchors(
        P(a_rid, i32), P(a_st, i8), P(a_x, i64), P(a_y, i32),
        P(a_ln, i32), P(a_wt, i32), P(a_cn, i32),
        P(heavy, u8) if heavy is not None else None, n,
        P(rlen, i64), P(wlen, i64), P(coffs, i64), P(clens, i64),
        int(p.match), int(p.b_gap_open), int(p.b_gap_extend),
        float(options.threshold), int(bool(options.gapless)),
        int(options.match_mode),
        P(o_rid, i32), P(o_st, i8), P(o_cn, i32), P(o_goff, i64),
        P(o_wlen, i32), P(o_swg, i32), P(o_matches, i32), P(o_smax, i32),
        P(o_ax, i64), P(o_ay, i64), P(o_alen, i32), P(o_awid, i32))
    hb = HitBatch(
        rid=o_rid[:n_out], st=o_st[:n_out], cn=o_cn[:n_out],
        g_off=o_goff[:n_out], w_len=o_wlen[:n_out],
        score_window_gen=o_swg[:n_out], matches=o_matches[:n_out],
        score_max=o_smax[:n_out], anchor_x=o_ax[:n_out],
        anchor_y=o_ay[:n_out], anchor_length=o_alen[:n_out],
        anchor_width=o_awid[:n_out])
    order = np.lexsort((hb.g_off, hb.cn, hb.rid))
    for f in ("rid", "st", "cn", "g_off", "w_len", "score_window_gen",
              "matches", "score_max", "anchor_x", "anchor_y",
              "anchor_length", "anchor_width"):
        setattr(hb, f, getattr(hb, f)[order])
    return hb


def hit_list_batch(entries: list[ReadEntry], idx: GenomeIndex,
                   an: AnchorBatch, options: HitListOptions,
                   cfg: MapperConfig,
                   heavy_mp: np.ndarray | None = None) -> HitBatch:
    """Vectorized window generation (read_get_hit_list_per_strand).

    heavy_mp: per-anchor mate-heavy flags for match_mode 3 (paired -n 3):
    heavy anchors bypass the weight-1 exclusion and the window-gen
    threshold (mapping.c:1108-1185)."""
    n = an.n
    empty32 = np.zeros(0, np.int32)
    if n == 0:
        z = np.zeros(0, np.int64)
        return HitBatch(empty32, np.zeros(0, np.int8), empty32, z, empty32,
                        empty32, empty32, empty32, z, z, empty32, empty32)
    from shrimp_tpu_torch import native
    _lib = native.load_candidates()
    if _lib is not None and hasattr(_lib, "hit_list_from_anchors"):
        return _hit_list_native(_lib, entries, idx, an, options, cfg,
                                heavy_mp)
    return _hit_list_numpy(entries, idx, an, options, cfg, heavy_mp)


def _hit_list_numpy(entries, idx, an, options, cfg, heavy_mp=None):
    """Pure-NumPy window generation (fallback + differential oracle for
    the native path; see tests/test_candidates_native.py)."""
    n = an.n
    empty32 = np.zeros(0, np.int32)
    p = cfg.params
    match = p.match

    rlen = np.array([e.read_len for e in entries], np.int64)[an.rid]
    wlen_cfg = np.array([e.window_len for e in entries], np.int64)[an.rid]
    coff = idx.contig_offsets[an.cn]
    clen = idx.contig_len[an.cn]

    w_len = np.minimum(wlen_cfg, clen)
    gend = (an.x - coff) + rlen - 1 - an.y
    gend = np.minimum(gend, clen - 1)
    gstart = np.where(gend >= wlen_cfg, gend - wlen_cfg, 0)

    max_score = an.length.astype(np.int64) * match
    if not options.gapless:
        if options.match_mode == 2:
            max_score = np.where(an.weight == 1, -1, max_score)
        elif options.match_mode == 3 and heavy_mp is not None:
            max_score = np.where((an.weight == 1) & ~heavy_mp, -1, max_score)
    max_idx = np.arange(n, dtype=np.int64)

    if not options.gapless:
        # per-anchor window floor: first anchor index with the same read and
        # x >= coff + gstart (anchors are (rid, x)-sorted, so the reference's
        # backward scan covers exactly [lo_idx, i-1])
        BIGX = np.int64(1) << 40
        keys = an.rid.astype(np.int64) * BIGX + an.x
        targets = an.rid.astype(np.int64) * BIGX + (coff + gstart)
        lo_idx = np.searchsorted(keys, targets, side="left")
        rows = np.arange(n, dtype=np.int64)
        active = rows - 1 >= lo_idx
        k = 1
        while active.any():
            act = np.flatnonzero(active)
            i_a = act
            jc = act - k
            ok = an.y[jc] < an.y[i_a]
            dx = an.x[i_a] - an.x[jc]
            dy = (an.y[i_a] - an.y[jc]).astype(np.int64)
            diag_del = dx - dy > 0        # deletion in read
            li = an.length[i_a].astype(np.int64)
            short_len = np.where(diag_del, dy, dx) + li
            long_len = np.where(diag_del, dx, dy) + li
            tmp = short_len * match + np.where(
                long_len > short_len,
                p.b_gap_open + (long_len - short_len) * p.b_gap_extend, 0)
            better = ok & (tmp > max_score[i_a])
            upd = i_a[better]
            max_score[upd] = tmp[better]
            max_idx[upd] = jc[better]
            k += 1
            active[act] = act - k >= lo_idx[act]

    base = np.minimum(rlen, w_len) * match
    if options.threshold >= 0:
        # (int)abs_or_pct truncation as in mapping.c:1163
        thr = (base * (options.threshold / 100.0)).astype(np.int64)
    else:
        thr = np.full(n, int(-options.threshold), np.int64)
    if options.gapless or options.match_mode == 1:
        emit = np.ones(n, bool)
    else:
        emit = max_score >= thr
        if options.match_mode == 3 and heavy_mp is not None:
            emit |= heavy_mp

    if not emit.any():
        z = np.zeros(0, np.int64)
        return HitBatch(empty32, np.zeros(0, np.int8), empty32, z, empty32,
                        empty32, empty32, empty32, z, z, empty32, empty32)

    i_sel = np.flatnonzero(emit)
    mi = max_idx[i_sel]
    x_len = (an.x[i_sel] - an.x[mi]) + an.length[i_sel]
    wl = wlen_cfg[i_sel]
    goff = np.where((wl - x_len) // 2 < an.x[mi] - coff[i_sel],
                    (an.x[mi] - coff[i_sel]) - (wl - x_len) // 2, 0)
    goff = np.where(goff + w_len[i_sel] > clen[i_sel],
                    clen[i_sel] - w_len[i_sel], goff)

    # anchor join of (i, max_idx) relative to window (anchor_join semantics)
    has_pair = mi < i_sel
    xi = an.x[i_sel] - coff[i_sel] - goff
    yi = an.y[i_sel].astype(np.int64)
    li = an.length[i_sel].astype(np.int64)
    xj = an.x[mi] - coff[i_sel] - goff
    yj = an.y[mi].astype(np.int64)
    lj = an.length[mi].astype(np.int64)

    nw = np.minimum(xi + yi, np.where(has_pair, xj + yj, xi + yi))
    sw = np.minimum(xi - yi, np.where(has_pair, xj - yj, xi - yi))
    ne = np.maximum(xi - yi, np.where(has_pair, xj - yj, xi - yi))
    se = np.maximum(xi + yi + 2 * (li - 1),
                    np.where(has_pair, xj + yj + 2 * (lj - 1),
                             xi + yi + 2 * (li - 1)))
    nw = np.where((nw + sw) % 2 != 0, nw - 1, nw)
    ax = (nw + sw) // 2
    ay = nw - ax
    ne = np.where((ne - sw) % 2 != 0, ne + 1, ne)
    aw = (ne - sw) // 2 + 1
    se = np.where((se - nw) % 2 != 0, se + 1, se)
    al = (se - nw) // 2 + 1
    # single-anchor case: identity
    ax = np.where(has_pair, ax, xi)
    ay = np.where(has_pair, ay, yi)
    al = np.where(has_pair, al, li)
    aw = np.where(has_pair, aw, 1)
    n_matches = np.where(has_pair, an.weight[i_sel] + an.weight[mi],
                         an.weight[i_sel]).astype(np.int32)

    hb = HitBatch(
        rid=an.rid[i_sel],
        st=an.st[i_sel],
        cn=an.cn[i_sel],
        g_off=goff.astype(np.int64),
        w_len=w_len[i_sel].astype(np.int32),
        score_window_gen=max_score[i_sel].astype(np.int32),
        matches=n_matches,
        score_max=(np.minimum(rlen[i_sel], w_len[i_sel]) * match).astype(np.int32),
        anchor_x=ax.astype(np.int64),
        anchor_y=ay.astype(np.int64),
        anchor_length=al.astype(np.int32),
        anchor_width=aw.astype(np.int32),
    )
    # stable (rid, cn, g_off) order — the reference's per-strand insertion
    # sort by g_off within cn
    order = np.lexsort((hb.g_off, hb.cn, hb.rid))
    for f in ("rid", "st", "cn", "g_off", "w_len", "score_window_gen",
              "matches", "score_max", "anchor_x", "anchor_y",
              "anchor_length", "anchor_width"):
        setattr(hb, f, getattr(hb, f)[order])
    return hb
