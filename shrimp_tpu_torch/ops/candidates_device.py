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
  * the CUDA kernels of `csrc/candidates_device.cu` with torch's stable
    sort and prefix sum between them (`device_candidates_cuda`).
Both size every plane from the counts of the batch rather than from the
capacities; the cut rows are padding in the JAX function and change no
output.  The one departure from the JAX function follows the host path:
an absolute threshold (stored negated) is `int(-threshold)`, as
`hit_list_batch` has it; the JAX function compares against its negation.
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
REG_SENT = 0x7FFFFFF0
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
                                     for p in seed_positions))

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
# CUDA kernels
_LIB = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("candidates_device")
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        sig = {
            "l3_lens_launch": [vp, vp, vp, i, i, i, i, vp, i, vp, i, i, i,
                               vp, i, vp, vp, vp],
            "l3_expand_launch": [vp, vp, vp, ll, vp, vp, vp, i, vp, vp, ll,
                                 ll, vp, vp, ll, i, i, vp],
            "l3_region_keep_launch": [vp, ll, vp, ll, i, i, vp, vp],
            "l3_region_visits_launch": [vp, ll, i, i, i, vp, vp, vp],
            "l3_region_runs_launch": [vp, vp, vp, ll, ll, vp, vp],
            "l3_compact_a2_launch": [vp, ll, vp, vp, ll, vp, vp, vp],
            "l3_collapse_prep_launch": [vp, vp, ll, vp, vp, i, i, vp, vp,
                                        vp],
            "l3_collapse_runs_launch": [vp, vp, vp, ll, vp, vp],
            "l3_compact_launch": [vp, i, ll, vp, vp, ll, vp, vp],
            "l3_pair_emit_launch": [vp, ll, vp, vp, vp, vp, vp, i, i, i, i,
                                    i, i, i, vp, vp, vp, vp],
        }
        for name, argtypes in sig.items():
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = argtypes
        _LIB = lib
    return _LIB


def _ptr(t):
    return None if t is None else t.data_ptr()


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
                           dense_region_cap: int = DENSE_REGION_TABLE_MAX
                           ) -> dict:
    """`device_candidates` on the card: the K10 kernels with torch's
    stable sorts and prefix sums between them.  Inputs as for the plain
    version, on the index's CUDA device."""
    d = dev.device
    if d.type != "cuda":
        raise ValueError(f"the K10 kernels need a CUDA index; got {d}")
    B, R = codes.shape
    for name, t, dt, nd in (("codes", codes, torch.int8, 2),
                            ("rlen", rlen, torch.int32, 1),
                            ("minpos", minpos, torch.int32, 1),
                            ("wlen_cfg", wlen_cfg, torch.int32, 1),
                            ("thr_read", thr_read, torch.int32, 1)):
        _build.check_tensor(name, t, dt, nd, d)
        if t.shape[0] != B:
            raise ValueError(f"{name} has {t.shape[0]} rows, expected {B}")
    if num_contigs != dev.contig_offsets.numel():
        raise ValueError(f"num_contigs {num_contigs} differs from the "
                         f"index's {dev.contig_offsets.numel()} contigs")
    i32, i64, u8 = torch.int32, torch.int64, torch.uint8
    lib = _lib()
    with torch.cuda.device(d):
        stream = torch.cuda.current_stream(d).cuda_stream

        def run(name, *args):
            _build.check_launch(lib, name, getattr(lib, name)(*args, stream))

        # ---- l3_lens, one launch per seed ----
        Ks = [max(R - span + 1, 0) for span in dev.spans]
        row_base = np.concatenate([[0], np.cumsum([B * K for K in Ks])])
        L = int(row_base[-1])
        if L == 0:
            return _outputs({}, torch.zeros(0, dtype=i64), h_cap, False, 0,
                            0, d)
        lens = torch.empty(L, dtype=i32, device=d)
        lo = torch.empty(L, dtype=i32, device=d)
        LAUNCHES.add()
        for sn, span in enumerate(dev.spans):
            if Ks[sn] == 0:
                continue
            sp = dev.seed_positions_dev[sn]
            b0 = int(row_base[sn])
            run("l3_lens_launch", codes.data_ptr(), rlen.data_ptr(),
                minpos.data_ptr(), B, R, Ks[sn], span,
                dev.ones_dev[sn].data_ptr(), len(dev.ones[sn]), _ptr(sp),
                -1 if sp is None else sp.numel(), int(dev.use_hashing),
                (dev.hash_max_span + 7) // 8, dev.offsets[sn].data_ptr(),
                int(list_cutoff), lens[b0:].data_ptr(), lo[b0:].data_ptr())
        incl = torch.cumsum(lens, 0, dtype=i64)
        total = int(incl[-1])
        overflow = total > a_cap
        n_exp = min(total, a_cap)
        if n_exp == 0:
            return _outputs({}, torch.zeros(0, dtype=i64), h_cap, overflow,
                            total, 0, d)

        # ---- l3_expand (+ the dense region visits) ----
        starts = incl - lens
        plane = torch.empty((4, n_exp), dtype=i32, device=d)
        dense = (use_region_counts and B * n_regions <= dense_region_cap)
        table = (torch.zeros(B * n_regions, dtype=i32, device=d) if dense
                 else None)
        seed_tab = torch.tensor(np.asarray(row_base, np.int64), device=d)
        k_tab = torch.tensor(np.asarray(Ks, np.int32), device=d)
        span_tab = torch.tensor(np.asarray(dev.spans, np.int32), device=d)
        run("l3_expand_launch", lens.data_ptr(), starts.data_ptr(),
            lo.data_ptr(), L, seed_tab.data_ptr(), k_tab.data_ptr(),
            span_tab.data_ptr(), len(dev.spans), minpos.data_ptr(),
            dev.positions.data_ptr(), dev.positions.numel(), n_exp,
            plane.data_ptr(), _ptr(table), n_regions, region_bits,
            region_overlap)
        del lens, lo, incl, starts

        # ---- region-count keep test ----
        flag = pos = None
        n_sur = n_exp
        if use_region_counts:
            flag = torch.zeros(n_exp, dtype=u8, device=d)
            if dense:
                run("l3_region_keep_launch", plane.data_ptr(), n_exp,
                    table.data_ptr(), n_regions, region_bits,
                    region_overlap, flag.data_ptr())
                del table
            else:
                vkeys = torch.empty(2 * n_exp, dtype=i64, device=d)
                vsrc = torch.empty(2 * n_exp, dtype=i64, device=d)
                run("l3_region_visits_launch", plane.data_ptr(), n_exp, B,
                    region_bits, region_overlap, vkeys.data_ptr(),
                    vsrc.data_ptr())
                skeys, order = torch.sort(vkeys, stable=True)
                run("l3_region_runs_launch", skeys.data_ptr(),
                    order.data_ptr(), vsrc.data_ptr(), 2 * n_exp, n_exp,
                    flag.data_ptr())
                del vkeys, vsrc, skeys, order
            pos = torch.cumsum(flag, 0, dtype=i64)
            n_sur = int(pos[-1])
        overflow = overflow or n_sur > a2_cap
        n_a2 = min(n_sur, a2_cap)
        if n_a2 == 0:
            return _outputs({}, torch.zeros(0, dtype=i64), h_cap, overflow,
                            total, n_sur, d)

        # ---- stable compaction into the a2 plane, stable (rid, x) sort ----
        a2 = torch.empty((4, n_a2), dtype=i32, device=d)
        key = torch.empty(n_a2, dtype=i64, device=d)
        run("l3_compact_a2_launch", plane.data_ptr(), n_exp, _ptr(flag),
            _ptr(pos), n_a2, a2.data_ptr(), key.data_ptr())
        del plane, flag, pos
        perm = torch.sort(key, stable=True).indices
        anchors = torch.empty((6, n_a2), dtype=i32, device=d)
        gkey = torch.empty(n_a2, dtype=i32, device=d) if collapse else None
        run("l3_collapse_prep_launch", a2.data_ptr(), perm.data_ptr(), n_a2,
            rlen.data_ptr(), dev.contig_offsets.data_ptr(), num_contigs,
            R + 1, anchors.data_ptr(), _ptr(gkey))
        del a2, key, perm

        # ---- colinear collapse ----
        n_c = n_a2
        if collapse:
            g_order = torch.sort(gkey, stable=True).indices
            flag = torch.empty(n_a2, dtype=u8, device=d)
            run("l3_collapse_runs_launch", anchors.data_ptr(),
                gkey.data_ptr(), g_order.data_ptr(), n_a2, flag.data_ptr())
            pos = torch.cumsum(flag, 0, dtype=i64)
            n_c = int(pos[-1])
            kept = torch.empty((6, n_c), dtype=i32, device=d)
            run("l3_compact_launch", anchors.data_ptr(), 6, n_a2,
                flag.data_ptr(), pos.data_ptr(), n_c, kept.data_ptr())
            anchors = kept
            del g_order, flag, pos, gkey

        # ---- pairing, threshold, window join ----
        out = torch.empty((len(COLUMNS), n_c), dtype=i32, device=d)
        emit = torch.empty(n_c, dtype=u8, device=d)
        clamped = torch.zeros(1, dtype=i32, device=d)
        run("l3_pair_emit_launch", anchors.data_ptr(), n_c, rlen.data_ptr(),
            wlen_cfg.data_ptr(), thr_read.data_ptr(),
            dev.contig_offsets.data_ptr(), dev.contig_len.data_ptr(),
            int(match), int(b_gap_open), int(b_gap_extend), int(gapless),
            int(match_mode), int(threshold >= 0),
            int(-threshold) if threshold < 0 else 0, out.data_ptr(),
            emit.data_ptr(), clamped.data_ptr())
        pos = torch.cumsum(emit, 0, dtype=i64)
        counts = torch.stack([pos[-1], clamped[0].to(i64)]).cpu()
        n = int(counts[0])
        overflow = overflow or bool(counts[1]) or n > h_cap
        final = torch.zeros((len(COLUMNS), h_cap), dtype=i32, device=d)
        run("l3_compact_launch", out.data_ptr(), len(COLUMNS), n_c,
            emit.data_ptr(), pos.data_ptr(), h_cap, final.data_ptr())
    res = {"overflow": torch.tensor(overflow),
           "n_total": torch.tensor(total, dtype=i64),
           "n_survivors": torch.tensor(n_sur, dtype=i64),
           "n": torch.tensor(n, dtype=i64)}
    for f, v in zip(COLUMNS, final):
        res[f] = v
    e = torch.zeros(h_cap, dtype=torch.bool, device=d)
    e[:min(n, h_cap)] = True
    res["emit"] = e
    return res


def device_candidates(codes, rlen, minpos, wlen_cfg, thr_read,
                      dev: DeviceL3Index, **kw) -> dict:
    """Counterpart of `shrimp_tpu.ops.candidates_device.device_candidates`:
    whole-batch exact candidate windows for one strand.  Array inputs
    (numpy or tensors) go to the index's device; a CUDA index takes the
    kernels, a CPU index the plain version.

    Returns the columns of COLUMNS as [h_cap] int32 tensors holding the
    emitted windows at the front (zeros after), `emit` (bool [h_cap]),
    `n` (windows emitted), `n_total` (postings expanded), `n_survivors`
    (postings kept by the region counts) and `overflow`.  Row order in the
    valid prefix is the host HitBatch order before its final
    (rid, cn, g_off) lexsort."""
    d = dev.device
    codes = torch.as_tensor(np.ascontiguousarray(codes)
                            if isinstance(codes, np.ndarray) else codes,
                            dtype=torch.int8, device=d)
    rlen, minpos, wlen_cfg, thr_read = (
        torch.as_tensor(np.ascontiguousarray(a) if isinstance(a, np.ndarray)
                        else a, dtype=torch.int32, device=d)
        for a in (rlen, minpos, wlen_cfg, thr_read))
    if d.type == "cuda":
        return device_candidates_cuda(codes, rlen, minpos, wlen_cfg,
                                      thr_read, dev, **kw)
    return device_candidates_plain(codes, rlen, minpos, wlen_cfg, thr_read,
                                   dev, **kw)
