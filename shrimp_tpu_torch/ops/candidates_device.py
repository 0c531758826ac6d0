"""On-device candidate generation (L3, K10), the counterpart of
`shrimp_tpu/ops/candidates_device.py`.

One strand of a batch of reads goes from its int8 codes to the window
rows of the host path (`pipeline/candidates_batch.py`: expand_postings ->
region_has2_filter -> anchors_batch collapse -> hit_list_batch), exactly:

  * per seed, the k-mer id of every (read, k-mer) row (2-bit packing, or
    the Jenkins chain of -H), the minpos shift, the read-length bound and
    the positioned-seed mask; the CSR offsets lookup and the list cut-off;
  * the CSR posting expansion in host row order (seed-major, then read,
    then k-mer, then list order) into the anchor plane;
  * region-count pruning (read_get_region_counts, mapping.c:475-780),
    with the previous-region extension: a dense (read, region) visit table,
    or, past `dense_region_cap` entries, runs of sorted visit keys;
  * the stable compaction of the survivors into the a2 plane, the stable
    (rid, x) sort, contig numbers;
  * the colinear collapse over (rid, diagonal slot, diagonal, contig) runs;
  * the backward pairing scan (mapping.c:1121-1184), the emission
    threshold, the window coordinates and the anchor join.

Capacities: postings past `a_cap`, survivors past `a2_cap` and windows
past `h_cap` are cut, and `overflow` reports it; so does a row whose
window a short contig clamped under a percentage threshold.  The caller
then grows the capacity or maps the batch on the host.  Arithmetic is
int32 with the JAX program's sentinels (`INVALID_X`, `NEG`).

Two versions of `device_candidates`, which picks by the device of the
index it is given:
  * the plain PyTorch version (`device_candidates_plain`), step for step
    the JAX function; CPU tensors only;
  * the CUDA kernels of `csrc/candidates_device.cu`, one fixed sequence
    launched by one call, read-major with one block per read
    (`device_candidates_cuda`): the kernels keep every count on the
    device, so a call reads back one small counters vector (its one host
    synchronisation), and its planes are sized by the capacities and kept
    in an `L3Workspace` between calls.  Region counts need no (read,
    region) table: in the read's x order a posting's region has a second
    visit iff a neighbour lies in the region's x interval.
The plain version sizes every plane from the counts of the batch; the cut
rows are padding in the JAX function and change no output.  The one
departure from the JAX function follows the host path: an absolute
threshold (stored negated) is `int(-threshold)`, as `hit_list_batch` has
it; the JAX function compares against its negation.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from shrimp_tpu_torch import _build

NEG = -(1 << 30)
INVALID_X = 0x7FFFFFF0
INVALID_MI = 0xFFFFFFFF
HASH_BITS = 24
# above this (read x region) entry count the region pruning switches from
# the dense visit table to the sparse sort formulation
DENSE_REGION_TABLE_MAX = 1 << 28

# the window columns of the output, in the order of the JAX function's dict
COLUMNS = ("rid", "cn", "g_off", "w_len", "score_window_gen", "matches",
           "score_max", "anchor_x", "anchor_y", "anchor_length",
           "anchor_width")

# launches of the K10 kernels (one per device_candidates_cuda call)
LAUNCHES = _build.LaunchCounter()


@dataclass
class DeviceL3Index:
    """The CSR index resident on one device: every seed's positions in
    one int32 plane, per seed int32 offsets into it, and the contig
    offsets and lengths; plus the seed geometry."""

    offsets: tuple            # per seed: int32 [4^w + 1] (values into plane)
    positions: torch.Tensor   # int32 [total postings of all seeds]
    contig_offsets: torch.Tensor   # int32 [C]
    contig_len: torch.Tensor       # int32 [C]
    spans: tuple
    ones: tuple               # per seed: tuple of the seed's one offsets
    seed_positions: tuple     # per seed: allowed read offsets, or None
    use_hashing: bool
    hash_max_span: int
    ones_dev: tuple           # per seed: `ones` as int32 on the device
    seed_positions_dev: tuple  # per seed: int32 on the device, or None
    genome_len: int = 0       # bases in the genome (positions lie below)

    @classmethod
    def from_host(cls, idx, device="cuda") -> "DeviceL3Index":
        device = torch.device(device)
        pos_parts = []
        offs = []
        base = 0
        for sn in range(len(idx.offsets)):
            offs.append(torch.from_numpy(
                (idx.offsets[sn].astype(np.int64) + base).astype(np.int32))
                .to(device))
            pos_parts.append(np.asarray(idx.positions[sn]).astype(np.int32))
            base += len(idx.positions[sn])
        positions = (np.concatenate(pos_parts) if pos_parts
                     else np.zeros(1, np.int32))
        seeds = idx.seed_set.seeds
        ones = tuple(tuple(int(o) for o in s.ones_idx) for s in seeds)
        seed_positions = tuple(
            None if s.positions is None else tuple(int(p) for p in s.positions)
            for s in seeds)

        def i32(a):
            return torch.tensor(np.asarray(a, np.int32), device=device)

        return cls(
            offsets=tuple(offs),
            positions=torch.from_numpy(positions).to(device),
            contig_offsets=i32(idx.contig_offsets),
            contig_len=i32(idx.contig_len),
            spans=tuple(int(s.span) for s in seeds),
            ones=ones,
            seed_positions=seed_positions,
            use_hashing=bool(idx.seed_set.use_hashing),
            hash_max_span=max((int(s.span) for s in seeds), default=0),
            ones_dev=tuple(i32(o) for o in ones),
            seed_positions_dev=tuple(None if p is None else i32(p)
                                     for p in seed_positions),
            genome_len=int(idx.total_len))

    @property
    def device(self) -> torch.device:
        return self.positions.device


def _jenkins32(a: torch.Tensor) -> torch.Tensor:
    """The reference's 32-bit integer hash (gmapper.h:308-318) on int64
    lanes holding uint32 values, masked after every step."""
    m = 0xFFFFFFFF
    a = ((a + 0x7ED55D16) + (a << 12)) & m
    a = ((a ^ 0xC761C23C) ^ (a >> 19)) & m
    a = ((a + 0x165667B1) + (a << 5)) & m
    a = ((a + 0xD3A2646C) ^ (a << 9)) & m
    a = ((a + 0xFD7046C5) + (a << 3)) & m
    a = ((a ^ 0xB55A4F09) ^ (a >> 16)) & m
    return a


def _mapidx_seed(codes, rlen, minpos, span: int, ones: tuple, seed_pos,
                 use_hashing: bool, max_span: int) -> torch.Tensor:
    """int64 [B, K] k-mer ids (invalid = 0xFFFFFFFF), K = R - span + 1:
    window starts shifted by minpos, positioned seeds masked."""
    B, R = codes.shape
    K = max(R - span + 1, 0)
    starts = (torch.arange(K, dtype=torch.int64)[None, :]
              + minpos.to(torch.int64)[:, None])
    valid = (starts + span) <= rlen.to(torch.int64)[:, None]
    if seed_pos is not None:
        allow = torch.zeros(K, dtype=torch.bool)
        for p in seed_pos:
            if p < K:
                allow[p] = True
        valid = valid & allow[None, :]
    c = codes.to(torch.int64)

    def col(o):
        return torch.gather(c, 1, (starts + o).clamp_max(R - 1))

    if not use_hashing:
        mi = torch.zeros((B, K), dtype=torch.int64)
        for k, o in enumerate(ones):
            mi = mi | ((col(o) & 3) << (2 * k))
    else:
        key = torch.zeros((B, K), dtype=torch.int64)
        for w in range((max_span + 7) // 8):
            v = torch.zeros((B, K), dtype=torch.int64)
            for o in ones:
                j = span - 1 - int(o)
                if j // 8 != w:
                    continue
                v = v | ((col(int(o)) & 0xF) << (4 * (j % 8)))
            key = _jenkins32(v ^ key)
        mi = key & ((1 << HASH_BITS) - 1)
    return torch.where(valid, mi, INVALID_MI)


def _outputs(cols: dict, emit_rows: torch.Tensor, h_cap: int, overflow,
             total: int, n_sur: int, device) -> dict:
    """The JAX function's output dict: the emitted rows compacted to the
    front of [h_cap] int32 columns (zeros past them)."""
    n = int(emit_rows.numel())
    m = min(n, h_cap)
    out = {"overflow": torch.tensor(bool(overflow) or n > h_cap),
           "n_total": torch.tensor(total, dtype=torch.int64),
           "n_survivors": torch.tensor(n_sur, dtype=torch.int64),
           "n": torch.tensor(n, dtype=torch.int64)}
    for f in COLUMNS:
        v = torch.zeros(h_cap, dtype=torch.int32, device=device)
        if m:
            v[:m] = cols[f][emit_rows[:m]]
        out[f] = v
    emit = torch.zeros(h_cap, dtype=torch.bool, device=device)
    emit[:m] = True
    out["emit"] = emit
    return out


def device_candidates_plain(codes, rlen, minpos, wlen_cfg, thr_read,
                            dev: DeviceL3Index, *, a_cap: int, a2_cap: int,
                            h_cap: int, n_regions: int = 1,
                            use_region_counts: bool = False,
                            region_bits: int = 11, region_overlap: int = 50,
                            collapse: bool = True, gapless: bool = False,
                            match_mode: int = 2, threshold: float = 55.0,
                            match: int = 10, b_gap_open: int = -33,
                            b_gap_extend: int = -3,
                            list_cutoff: int = 0x7FFFFFFF,
                            num_contigs: int = 1,
                            dense_region_cap: int = DENSE_REGION_TABLE_MAX
                            ) -> dict:
    """`device_candidates` in plain PyTorch on CPU tensors: codes int8
    [B, R] (one strand), rlen / minpos / wlen_cfg / thr_read int32 [B]
    (thr_read: the host-truncated percentage threshold per read)."""
    _build.require_cpu(codes, rlen, minpos, wlen_cfg, thr_read,
                       dev.positions)
    i32, i64 = torch.int32, torch.int64
    B, R = codes.shape
    rlen = rlen.to(i32)
    wlen_cfg = wlen_cfg.to(i32)
    overflow = False

    # ---- per-seed posting lens in host row order ----
    lens_p, lo_p, rid_p, y_p, span_p = [], [], [], [], []
    for sn, span in enumerate(dev.spans):
        mi = _mapidx_seed(codes, rlen, minpos, span, dev.ones[sn],
                          dev.seed_positions[sn], dev.use_hashing,
                          dev.hash_max_span)
        K = mi.shape[1]
        if K == 0:
            continue
        valid = mi != INVALID_MI
        mi_safe = torch.where(valid, mi, 0)
        off = dev.offsets[sn]
        lo = off[mi_safe]
        ln = torch.where(valid, off[mi_safe + 1] - lo, 0)
        ln = torch.where(ln > list_cutoff, 0, ln)
        lens_p.append(ln.reshape(-1))
        lo_p.append(lo.reshape(-1))
        rid_p.append(torch.arange(B, dtype=i32).repeat_interleave(K))
        y_p.append((torch.arange(K, dtype=i32)[None, :]
                    + minpos.to(i32)[:, None]).reshape(-1))
        span_p.append(torch.full((B * K,), span, dtype=i32))
    if not lens_p:
        return _outputs({}, torch.zeros(0, dtype=i64), h_cap, False, 0, 0,
                        codes.device)
    lens = torch.cat(lens_p)
    lo_all = torch.cat(lo_p)
    L = lens.numel()
    starts = torch.cat([torch.zeros(1, dtype=i64), torch.cumsum(lens, 0)])
    total = int(starts[-1])
    overflow |= total > a_cap
    n_exp = min(total, a_cap)

    # ---- CSR expansion into the anchor plane ----
    slot = torch.arange(n_exp, dtype=i64)
    seg = (torch.searchsorted(starts, slot, right=True) - 1).clamp(0, L - 1)
    src = (lo_all[seg].to(i64) + (slot - starts[seg])).clamp(
        0, dev.positions.numel() - 1)
    ax = dev.positions[src]
    arid = torch.cat(rid_p)[seg]
    ay = torch.cat(y_p)[seg]
    aln = torch.cat(span_p)[seg]

    # ---- region-count pruning ----
    if use_region_counts and n_exp:
        reg = ax >> region_bits
        ext = ((ax & ((1 << region_bits) - 1)) < region_overlap) & (reg > 0)
        if B * n_regions <= dense_region_cap:
            flat = arid.to(i64) * n_regions + reg.to(i64)
            table = torch.zeros(B * n_regions, dtype=i32)
            table.index_add_(0, flat, torch.ones(n_exp, dtype=i32))
            table.index_add_(0, flat[ext] - 1,
                             torch.ones(int(ext.sum()), dtype=i32))
            keep = (table[flat] >= 2) | (
                ext & (table[(flat - 1).clamp_min(0)] >= 2))
        else:
            vkey = torch.cat([(arid.to(i64) << 32) | reg.to(i64),
                              (arid[ext].to(i64) << 32)
                              | (reg[ext].to(i64) - 1)])
            vsrc = torch.cat([slot, slot[ext]])
            skey, order = torch.sort(vkey, stable=True)
            eq_prev = torch.cat([torch.zeros(1, dtype=torch.bool),
                                 skey[1:] == skey[:-1]])
            eq_next = torch.cat([eq_prev[1:], torch.zeros(1,
                                                          dtype=torch.bool)])
            keep = torch.zeros(n_exp, dtype=torch.bool)
            keep[vsrc[order][eq_prev | eq_next]] = True
        rows = torch.nonzero(keep).flatten()
    else:
        rows = slot
    n_sur = rows.numel()
    overflow |= n_sur > a2_cap
    rows = rows[:a2_cap]
    ax, ay, aln, arid = ax[rows], ay[rows], aln[rows], arid[rows]

    # ---- stable (rid, x) sort; expansion order breaks ties ----
    perm = torch.sort((arid.to(i64) << 32) | ax.to(i64), stable=True).indices
    ax, ay, aln, arid = ax[perm], ay[perm], aln[perm], arid[perm]
    cn = (torch.searchsorted(dev.contig_offsets, ax.clamp_min(0), right=True)
          - 1).clamp(0, num_contigs - 1).to(i32)
    awt = torch.ones_like(ax)

    # ---- colinear collapse on (rid, slot, diag, cn) runs ----
    if collapse and ax.numel():
        rl = rlen[arid].clamp_min(1)
        dslot = torch.remainder(ax + rl - ay, rl)
        diag = ax - ay
        gkey = arid * (R + 1) + dslot
        g_order = torch.sort(gkey, stable=True).indices
        r2, s2, d2, c2 = arid[g_order], dslot[g_order], diag[g_order], \
            cn[g_order]
        x2, l2 = ax[g_order], aln[g_order]
        same = torch.cat([torch.zeros(1, dtype=torch.bool),
                          (r2[1:] == r2[:-1]) & (s2[1:] == s2[:-1])
                          & (d2[1:] == d2[:-1]) & (c2[1:] == c2[:-1])])
        head = ~same
        run_id = torch.cumsum(head.to(i64), 0) - 1
        n_runs = int(head.sum())
        run_wt = torch.zeros(n_runs, dtype=i32).index_add_(
            0, run_id, torch.ones_like(x2))
        run_ext = torch.full((n_runs,), NEG, dtype=i32).scatter_reduce_(
            0, run_id, x2 + l2, "amax")
        ln_new2 = torch.where(head, run_ext[run_id] - x2, 0)
        wt_new2 = torch.where(head, run_wt[run_id], 0)
        inv = torch.empty_like(g_order)
        inv[g_order] = torch.arange(g_order.numel())
        keep = head[inv]
        kept = torch.nonzero(keep).flatten()
        ax, ay, arid, cn = ax[kept], ay[kept], arid[kept], cn[kept]
        aln = ln_new2[inv][kept].to(i32)
        awt = wt_new2[inv][kept].to(i32)

    # ---- window pairing (read_get_hit_list_per_strand) ----
    n = ax.numel()
    rlen_a = rlen[arid]
    wcfg_a = wlen_cfg[arid]
    coff = dev.contig_offsets[cn]
    clen = dev.contig_len[cn]
    w_len = torch.minimum(wcfg_a, clen)
    gend = torch.minimum((ax - coff) + rlen_a - 1 - ay, clen - 1)
    gstart = torch.where(gend >= wcfg_a, gend - wcfg_a, 0)
    floor_x = coff + gstart
    max_score = (aln * match).to(i32)
    if not gapless and match_mode == 2:
        max_score = torch.where(awt == 1, -1, max_score).to(i32)
    idx = torch.arange(n, dtype=i64)
    max_idx = idx.clone()
    if not gapless:
        k = 1
        active_any = n > 0
        while active_any:
            j = idx - k
            jc = j.clamp(0, max(n - 1, 0))
            xj = ax[jc]
            yj = ay[jc]
            active = (j >= 0) & (arid[jc] == arid) & (xj >= floor_x)
            ok = active & (yj < ay)
            dx = ax - xj
            dy = ay - yj
            del_in_read = dx - dy > 0
            short_len = torch.where(del_in_read, dy, dx) + aln
            long_len = torch.where(del_in_read, dx, dy) + aln
            tmp = short_len * match + torch.where(
                long_len > short_len,
                b_gap_open + (long_len - short_len) * b_gap_extend, 0)
            better = ok & (tmp > max_score)
            max_score = torch.where(better, tmp, max_score).to(i32)
            max_idx = torch.where(better, jc, max_idx)
            active_any = bool(active.any())
            k += 1

    # ---- emission threshold ((int)abs_or_pct truncation) ----
    base = torch.minimum(rlen_a, w_len) * match
    if threshold >= 0:
        thr = thr_read.to(i32)[arid]
        overflow |= bool(((w_len != wcfg_a) & (rlen_a > w_len)).any())
    else:
        thr = torch.full((n,), int(-threshold), dtype=i32)
    if gapless or match_mode == 1:
        emit = torch.ones(n, dtype=torch.bool)
    else:
        emit = max_score >= thr

    # ---- window coordinates + anchor join (hit_list_batch formulas) ----
    mi_ = max_idx
    xj, yj, lj = ax[mi_], ay[mi_], aln[mi_]
    x_len = (ax - xj) + aln
    half = (wcfg_a - x_len) // 2
    goff = torch.where(half < xj - coff, (xj - coff) - half, 0)
    goff = torch.where(goff + w_len > clen, clen - w_len, goff)
    has_pair = mi_ < idx
    xi = ax - coff - goff
    yi = ay
    li = aln
    xjw = xj - coff - goff
    nw = torch.minimum(xi + yi, torch.where(has_pair, xjw + yj, xi + yi))
    sw = torch.minimum(xi - yi, torch.where(has_pair, xjw - yj, xi - yi))
    ne = torch.maximum(xi - yi, torch.where(has_pair, xjw - yj, xi - yi))
    se = torch.maximum(xi + yi + 2 * (li - 1),
                       torch.where(has_pair, xjw + yj + 2 * (lj - 1),
                                   xi + yi + 2 * (li - 1)))
    nw = torch.where((nw + sw) % 2 != 0, nw - 1, nw)
    axj = (nw + sw) // 2
    ayj = nw - axj
    ne = torch.where((ne - sw) % 2 != 0, ne + 1, ne)
    aw = (ne - sw) // 2 + 1
    se = torch.where((se - nw) % 2 != 0, se + 1, se)
    al = (se - nw) // 2 + 1
    cols = {
        "rid": arid, "cn": cn, "g_off": goff, "w_len": w_len,
        "score_window_gen": max_score, "score_max": base,
        "matches": torch.where(has_pair, awt + awt[mi_], awt),
        "anchor_x": torch.where(has_pair, axj, xi),
        "anchor_y": torch.where(has_pair, ayj, yi),
        "anchor_length": torch.where(has_pair, al, li),
        "anchor_width": torch.where(has_pair, aw, 1),
    }
    cols = {f: v.to(i32) for f, v in cols.items()}
    return _outputs(cols, torch.nonzero(emit).flatten(), h_cap, overflow,
                    total, n_sur, codes.device)


# ---------------------------------------------------------------------------
# Host-side helpers of the CUDA wrapper: the read-major row order, the
# seed-major cut and the counters layout.  Plain functions, so that the CPU
# tests hold them to the plain version.

# the counters vector the kernels fill (int64), by index
COUNTERS = ("n_total", "n_survivors", "n", "clamped", "keep_global_reads",
            "collapse_global_reads")
N_COUNTERS = 8
MAX_SEEDS = 32


def row_layout(spans, R: int) -> tuple[list[int], list[int], int]:
    """The read-major row order: a read's rows are (seed, k-mer) in seed
    order, K = R - span + 1 k-mers per seed.  Returns each seed's K, its
    first row within the read, and the rows per read."""
    Ks = [max(R - int(s) + 1, 0) for s in spans]
    base = [int(v) for v in np.concatenate([[0], np.cumsum(Ks)])]
    return Ks, base[:-1], base[-1]


def seed_major_cut(counts: torch.Tensor, cap: int
                   ) -> tuple[torch.Tensor, torch.Tensor, int]:
    """counts [B, S] (postings, or survivors, per read and seed) taken in
    seed-major order (seed, then read), the first `cap` kept: returns how
    many of each are kept [B, S], each read's start among the kept in
    read-major order [B + 1], and the total.  What l3_scan_postings and
    l3_scan_survivors compute on the card."""
    c = counts.to(torch.int64)
    flat = c.t().reshape(-1)                        # seed-major
    pre = torch.cumsum(flat, 0) - flat
    kept = torch.minimum((cap - pre).clamp_min(0), flat)
    kept = kept.reshape(c.shape[1], c.shape[0]).t()
    per_read = kept.sum(1)
    base = torch.zeros(c.shape[0] + 1, dtype=torch.int64)
    base[1:] = torch.cumsum(per_read, 0)
    return kept, base, int(flat.sum())


def decode_counters(counts, a_cap: int, a2_cap: int, h_cap: int) -> dict:
    """The counters vector read back after a call: the scalars of the
    output dict, and the reads each per-read kernel took in its global
    tier."""
    v = dict(zip(COUNTERS, (int(x) for x in counts)))
    overflow = (v["n_total"] > a_cap or v["n_survivors"] > a2_cap
                or bool(v["clamped"]) or v["n"] > h_cap)
    return {"overflow": overflow, "n_total": v["n_total"],
            "n_survivors": v["n_survivors"], "n": v["n"],
            "global_reads": v["keep_global_reads"]
            + v["collapse_global_reads"]}


# ---------------------------------------------------------------------------
# CUDA kernels
_LIB = None
# reads that a per-read kernel took in its global-memory tier (too many
# postings or survivors for shared memory), summed over calls
GLOBAL_TIER_READS = _build.LaunchCounter()


class _Args(ctypes.Structure):
    """Mirror of `Args` in csrc/candidates_device.cu."""
    _fields_ = ([(f, ctypes.c_void_p) for f in (
        "codes", "rlen", "minpos", "wlen_cfg", "thr_read", "positions",
        "contig_offsets", "contig_len", "seedtab", "seedints", "lens", "lo",
        "tot", "kept", "kbase", "scnt", "a2kept", "abase", "wcnt", "ebase",
        "kscr", "surv", "cints", "cflags", "staging", "out", "emit",
        "counters")]
        + [(f, ctypes.c_longlong) for f in ("P", "a_cap", "a2_cap", "h_cap")]
        + [(f, ctypes.c_int) for f in (
            "B", "R", "S", "Ktot", "C", "xbits", "sbits", "use_hashing",
            "hash_words",
            "list_cutoff", "use_region_counts", "region_bits",
            "region_overlap", "collapse", "gapless", "match_mode",
            "pct_threshold", "thr_abs", "match", "b_gap_open",
            "b_gap_extend")])


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("candidates_device")
        lib.l3_candidates_launch.restype = ctypes.c_int
        lib.l3_candidates_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_void_p)]
        lib.l3_graph_destroy.restype = ctypes.c_int
        lib.l3_graph_destroy.argtypes = [ctypes.c_void_p]
        lib.l3_args_size.restype = ctypes.c_int
        if lib.l3_args_size() != ctypes.sizeof(_Args):
            raise RuntimeError("candidates_device: Args is "
                               f"{lib.l3_args_size()} bytes in CUDA, "
                               f"{ctypes.sizeof(_Args)} in ctypes")
        _LIB = lib
    return _LIB


class L3Workspace:
    """The device planes of `device_candidates_cuda`, sized by the call's
    capacities and reused from call to call: a plane is allocated again
    only when a call needs more than it holds.  Also the pinned staging of
    the inputs and the seed table of the last (index, R).  The columns a
    call returns are views of its output plane, valid until the next call
    with the same workspace."""

    def __init__(self) -> None:
        self._t: dict[str, torch.Tensor] = {}
        self.allocations = 0
        self._seed_key = None
        self._seeds = None
        # the last call's kernel arguments and what they point to
        self.args_key = None
        self.args = None
        # (words, pinned host buffer, its numpy view, device buffer) of the
        # inputs
        self.stage = None
        # the executable CUDA graph of the last call's launches
        self.graph = ctypes.c_void_p()

    def drop_graph(self) -> None:
        if self.graph.value and _LIB is not None:
            _LIB.l3_graph_destroy(self.graph)
        self.graph = ctypes.c_void_p()

    def __del__(self):
        try:
            self.drop_graph()
        except Exception:  # noqa: BLE001  (interpreter shutdown)
            pass

    def get(self, name: str, numel: int, dtype, device) -> torch.Tensor:
        """The first `numel` elements of plane `name`."""
        t = self._t.get(name)
        if t is None or t.numel() < numel or t.dtype != dtype or \
                t.device != device:
            t = torch.empty(max(int(numel), 1), dtype=dtype, device=device)
            self._t[name] = t
            self.allocations += 1
        return t[:max(int(numel), 1)]

    def largest_bytes(self) -> int:
        """The bytes of the largest device plane held."""
        return max((t.numel() * t.element_size() for t in self._t.values()
                    if t.device.type == "cuda"), default=0)

    def seeds(self, dev: DeviceL3Index, R: int):
        """(seed table int64 [S, 8], ones and positions int32, rows per
        read) of `dev` at read width R, made once per (index, R).  A
        seed's row: K, span, ones, their offset in the ints, positions
        (-1: any), their offset, its first row in a read, the address of
        its CSR offsets (the order of csrc/candidates_device.cu)."""
        key = self._seed_key
        if key is None or key[0] is not dev or key[1] != R:
            Ks, rb, Ktot = row_layout(dev.spans, R)
            ints, tab = [], []
            for sn, span in enumerate(dev.spans):
                ones = list(dev.ones[sn])
                pos = dev.seed_positions[sn]
                ones_off = len(ints)
                ints += ones
                pos_off = len(ints)
                ints += list(pos or ())
                tab.append([Ks[sn], int(span), len(ones), ones_off,
                            -1 if pos is None else len(pos), pos_off, rb[sn],
                            dev.offsets[sn].data_ptr()])
            d = dev.device
            self._seeds = (
                torch.tensor(np.asarray(tab, np.int64).reshape(-1, 8),
                             device=d),
                torch.tensor(np.asarray(ints or [0], np.int32), device=d),
                Ktot)
            self._seed_key = (dev, R)
        return self._seeds


def _upload(ws: L3Workspace, d, codes, rlen, minpos, wlen_cfg, thr_read):
    """The device addresses of the five inputs, and the copy that brings
    them there: their own addresses and no copy when they are all CUDA
    tensors, else one device buffer that they reach packed in one pinned
    buffer, in one asynchronous copy (host address, device address,
    bytes) that the kernels' launch makes first."""
    arrs = (codes, rlen, minpos, wlen_cfg, thr_read)
    if all(torch.is_tensor(a) and a.device.type == "cuda" for a in arrs):
        return tuple(a.data_ptr() for a in arrs), (None, None, 0)
    B, R = codes.shape
    words = 4 * B + (B * R + 3) // 4
    st = ws.stage
    if st is None or st[0] < words or st[3].device != d:
        host = torch.empty(words, dtype=torch.int32, pin_memory=True)
        st = ws.stage = (words, host, host.numpy(),
                         torch.empty(words, dtype=torch.int32, device=d))
        ws.allocations += 2
    hv = st[2]
    for k, a in enumerate(arrs[1:]):
        hv[k * B:(k + 1) * B] = a.cpu().numpy() if torch.is_tensor(a) else a
    hv[4 * B:].view(np.int8)[:B * R] = (
        codes.cpu().numpy() if torch.is_tensor(codes) else codes).reshape(-1)
    p = st[3].data_ptr()
    return ((p + 16 * B, p, p + 4 * B, p + 8 * B, p + 12 * B),
            (st[1].data_ptr(), p, 4 * words))


def _make_args(ws: L3Workspace, d, dev: DeviceL3Index, inputs, B: int,
               R: int, seedtab, seedints, Ktot: int, S: int, *, a_cap, a2_cap,
               h_cap, use_region_counts, region_bits, region_overlap,
               collapse, gapless, match_mode, threshold, match, b_gap_open,
               b_gap_extend, list_cutoff, num_contigs):
    """The kernels' arguments over the workspace's planes (grown where the
    call needs more) and the inputs' addresses, and the output columns,
    emit and counters planes."""
    i32, i64, u8 = torch.int32, torch.int64, torch.uint8
    g = lambda name, n, dt: ws.get(name, n, dt, d)  # noqa: E731
    out = g("out", len(COLUMNS) * h_cap, i32).view(len(COLUMNS), h_cap)
    emit = g("emit", h_cap, torch.bool)
    counters = g("counters", N_COUNTERS, i64)
    planes = {
        "lens": g("lens", B * Ktot, i32), "lo": g("lo", B * Ktot, i32),
        "tot": g("tot", B * S, i64), "kept": g("kept", B * S, i32),
        "kbase": g("kbase", B + 1, i64), "scnt": g("scnt", B * S, i32),
        "a2kept": g("a2kept", B * S, i32),
        "abase": g("abase", B + 1, i64), "wcnt": g("wcnt", B, i32),
        "ebase": g("ebase", B + 1, i64), "kscr": g("kscr", 4 * a_cap, i32),
        "surv": g("surv", 3 * a_cap, i32),
        "cints": g("cints", 10 * a2_cap, i32),
        "cflags": g("cflags", 2 * a2_cap, u8),
        "staging": g("staging", len(COLUMNS) * a2_cap, i32),
    }
    args = _Args(
        **dict(zip(("codes", "rlen", "minpos", "wlen_cfg", "thr_read"),
                   inputs)),
        positions=dev.positions.data_ptr(),
        contig_offsets=dev.contig_offsets.data_ptr(),
        contig_len=dev.contig_len.data_ptr(), seedtab=seedtab.data_ptr(),
        seedints=seedints.data_ptr(),
        **{k: v.data_ptr() for k, v in planes.items()},
        out=out.data_ptr(), emit=emit.data_ptr(),
        counters=counters.data_ptr(), P=dev.positions.numel(),
        a_cap=a_cap, a2_cap=a2_cap, h_cap=h_cap, B=B, R=R, S=S,
        Ktot=Ktot, C=num_contigs,
        xbits=max(int(dev.genome_len), 1).bit_length() if dev.genome_len
        else 31, sbits=max(int(R), 1).bit_length(),
        use_hashing=int(dev.use_hashing),
        hash_words=(dev.hash_max_span + 7) // 8,
        list_cutoff=int(list_cutoff),
        use_region_counts=int(use_region_counts),
        region_bits=region_bits, region_overlap=region_overlap,
        collapse=int(collapse), gapless=int(gapless),
        match_mode=match_mode, pct_threshold=int(threshold >= 0),
        thr_abs=int(-threshold) if threshold < 0 else 0, match=match,
        b_gap_open=b_gap_open, b_gap_extend=b_gap_extend)
    return args, tuple(out), emit, counters


def device_candidates_cuda(codes, rlen, minpos, wlen_cfg, thr_read,
                           dev: DeviceL3Index, *, a_cap: int, a2_cap: int,
                           h_cap: int, n_regions: int = 1,
                           use_region_counts: bool = False,
                           region_bits: int = 11, region_overlap: int = 50,
                           collapse: bool = True, gapless: bool = False,
                           match_mode: int = 2, threshold: float = 55.0,
                           match: int = 10, b_gap_open: int = -33,
                           b_gap_extend: int = -3,
                           list_cutoff: int = 0x7FFFFFFF,
                           num_contigs: int = 1,
                           dense_region_cap: int = DENSE_REGION_TABLE_MAX,
                           workspace: L3Workspace | None = None) -> dict:
    """`device_candidates` on the card: one fixed sequence of kernels
    (`csrc/candidates_device.cu`) and one read-back of a small counters
    vector.  Inputs as for the plain version: CUDA tensors on the index's
    device, or host arrays, which go over in one pinned copy.  Region
    counts need no (read, region) table, so `n_regions` and
    `dense_region_cap` change nothing here.  `workspace` holds the planes
    between calls; without one, the call makes its own."""
    d = dev.device
    if d.type != "cuda":
        raise ValueError(f"the K10 kernels need a CUDA index; got {d}")
    B, R = codes.shape
    for name, t, dt, nd in (("codes", codes, torch.int8, 2),
                            ("rlen", rlen, torch.int32, 1),
                            ("minpos", minpos, torch.int32, 1),
                            ("wlen_cfg", wlen_cfg, torch.int32, 1),
                            ("thr_read", thr_read, torch.int32, 1)):
        if torch.is_tensor(t) and t.device.type == "cuda":
            _build.check_tensor(name, t, dt, nd, d)
        if t.shape[0] != B:
            raise ValueError(f"{name} has {t.shape[0]} rows, expected {B}")
    if not torch.is_tensor(rlen) and B and int(np.max(rlen)) > R:
        raise ValueError(f"a read length exceeds the codes' width {R}")
    if num_contigs != dev.contig_offsets.numel():
        raise ValueError(f"num_contigs {num_contigs} differs from the "
                         f"index's {dev.contig_offsets.numel()} contigs")
    S = len(dev.spans)
    if not 0 < S <= MAX_SEEDS:
        raise ValueError(f"the K10 kernels take 1-{MAX_SEEDS} seeds; got {S}")
    ws = workspace if workspace is not None else L3Workspace()
    lib = _lib()
    i64 = torch.int64
    with torch.cuda.device(d):
        inputs, (h_src, d_dst, nbytes) = _upload(ws, d, codes, rlen, minpos,
                                                 wlen_cfg, thr_read)
        seedtab, seedints, Ktot = ws.seeds(dev, R)
        # a call like the last one (same index, shapes, capacities, options
        # and input planes) launches the same arguments again
        key = (dev, *inputs, B, R, a_cap, a2_cap, h_cap,
               bool(use_region_counts), region_bits, region_overlap,
               bool(collapse), bool(gapless), match_mode, float(threshold),
               match, b_gap_open, b_gap_extend, int(list_cutoff), num_contigs)
        if ws.args_key is not None and ws.args_key[0] is dev and \
                ws.args_key[1:] == key[1:]:
            args, cols, emit, counters = ws.args
        else:
            ws.drop_graph()
            ws.args = _make_args(
                ws, d, dev, inputs, B, R, seedtab, seedints, Ktot, S,
                a_cap=a_cap, a2_cap=a2_cap, h_cap=h_cap,
                use_region_counts=use_region_counts, region_bits=region_bits,
                region_overlap=region_overlap, collapse=collapse,
                gapless=gapless, match_mode=match_mode, threshold=threshold,
                match=match, b_gap_open=b_gap_open,
                b_gap_extend=b_gap_extend, list_cutoff=list_cutoff,
                num_contigs=num_contigs)
            ws.args_key = key
            args, cols, emit, counters = ws.args
        stream = torch.cuda.current_stream(d).cuda_stream
        # the launches go as one CUDA graph, captured on the first call
        # with these arguments
        _build.check_launch(lib, "l3_candidates", lib.l3_candidates_launch(
            ctypes.addressof(args), h_src, d_dst, nbytes, stream,
            ctypes.byref(ws.graph)))
        LAUNCHES.add()
        counts = counters[:len(COUNTERS)].tolist()     # the one read-back
    v = decode_counters(counts, a_cap, a2_cap, h_cap)
    GLOBAL_TIER_READS.add(v["global_reads"])
    res = {"overflow": torch.tensor(v["overflow"]),
           "n_total": torch.tensor(v["n_total"], dtype=i64),
           "n_survivors": torch.tensor(v["n_survivors"], dtype=i64),
           "n": torch.tensor(v["n"], dtype=i64)}
    res.update(zip(COLUMNS, cols))
    res["emit"] = emit
    return res


def device_candidates(codes, rlen, minpos, wlen_cfg, thr_read,
                      dev: DeviceL3Index, **kw) -> dict:
    """Counterpart of `shrimp_tpu.ops.candidates_device.device_candidates`:
    whole-batch exact candidate windows for one strand.  A CUDA index
    takes the kernels (host arrays go over in one pinned copy; keyword
    `workspace` reuses an `L3Workspace`), a CPU index the plain version.

    Returns the columns of COLUMNS as [h_cap] int32 tensors holding the
    emitted windows at the front (zeros after), `emit` (bool [h_cap]),
    `n` (windows emitted), `n_total` (postings expanded), `n_survivors`
    (postings kept by the region counts) and `overflow`.  Row order in the
    valid prefix is the host HitBatch order before its final
    (rid, cn, g_off) lexsort."""
    d = dev.device
    if d.type == "cuda":
        return device_candidates_cuda(codes, rlen, minpos, wlen_cfg,
                                      thr_read, dev, **kw)
    kw.pop("workspace", None)
    codes = torch.as_tensor(np.ascontiguousarray(codes)
                            if isinstance(codes, np.ndarray) else codes,
                            dtype=torch.int8, device=d)
    rlen, minpos, wlen_cfg, thr_read = (
        torch.as_tensor(np.ascontiguousarray(a) if isinstance(a, np.ndarray)
                        else a, dtype=torch.int32, device=d)
        for a in (rlen, minpos, wlen_cfg, thr_read))
    return device_candidates_plain(codes, rlen, minpos, wlen_cfg, thr_read,
                                   dev, **kw)
