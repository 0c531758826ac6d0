"""The read-major formulation of on-device candidate generation (K10)
that `csrc/candidates_device.cu` runs, modelled in numpy on the CPU with
the wrapper's host-side helpers (`row_layout`, `seed_major_cut`,
`decode_counters`), and held to the plain version
(`device_candidates_plain`) column by column: one block per read, the
postings cut at a_cap in seed-major order, sorted by (x, expansion order),
the region counts as a neighbour test in x order, the survivors cut at
a2_cap, the per-read collapse and pairing, windows cut at h_cap.  Every
output is an integer: all comparisons are exact."""

import numpy as np
import pytest
import torch

from shrimp_tpu_torch import dna
from shrimp_tpu_torch import index as gindex
from shrimp_tpu_torch import seeds as seedmod
from shrimp_tpu_torch.io import fastx
from shrimp_tpu_torch.ops import candidates_device as cdv
from shrimp_tpu_torch.pipeline import candidates as cand
from shrimp_tpu_torch.pipeline import candidates_batch as cb
from shrimp_tpu_torch.pipeline.options import MapperConfig


def _setup(seed=3, n_contigs=3, contig_len=60_000, n_reads=96, read_len=50,
           use_hashing=False, st=0, threshold=55.0, repeat=0):
    """A random genome's index (with `repeat` extra copies of one 2 kb
    stretch, for reads with many postings) and one strand's inputs of
    mutated reads drawn from it."""
    rng = np.random.default_rng(seed)
    contigs = [rng.integers(0, 4, contig_len).astype(np.int8)
               for _ in range(n_contigs)]
    if repeat:
        unit = contigs[0][:2000].copy()
        for k in range(repeat):
            c = contigs[k % n_contigs]
            p = int(rng.integers(2000, contig_len - 2000))
            c[p:p + 2000] = unit
    idx = gindex.build_index(
        [fastx.Contig(name=f"c{i}", codes=c) for i, c in enumerate(contigs)],
        seedmod.make_seed_set(None, use_hashing=use_hashing))
    reads = []
    for i in range(n_reads):
        p = (int(rng.integers(0, 1950)) if repeat and i % 4 == 0
             else int(rng.integers(0, len(idx.genome) - read_len)))
        r = idx.genome[p:p + read_len].copy()
        for _ in range(int(rng.integers(0, 3))):
            q = int(rng.integers(0, read_len))
            r[q] = (r[q] + int(rng.integers(1, 4))) % 4
        if rng.random() < 0.5:
            r = dna.reverse_complement(r)
        reads.append((f"r{i}", dna.decode(r), None))
    cfg = MapperConfig(qual_delta=64)
    entries = cand.prepare_reads(reads, cfg, idx.seed_set.min_span)
    B = len(entries)
    R = -(-max(e.read_len for e in entries) // 16) * 16
    codes = np.zeros((B, R), np.int8)
    rlen, minpos, wlen, thr = (np.zeros(B, np.int32) for _ in range(4))
    for b, e in enumerate(entries):
        codes[b, :e.read_len] = e.read[st]
        rlen[b], minpos[b], wlen[b] = e.read_len, e.min_kmer_pos, e.window_len
        if threshold >= 0:
            thr[b] = int(min(e.read_len, e.window_len) * cfg.params.match
                         * (threshold / 100.0))
    p = cfg.params
    kw = dict(a_cap=1 << 20, a2_cap=1 << 19, h_cap=1 << 16,
              n_regions=(idx.total_len >> cb.REGION_BITS) + 1,
              region_bits=cb.REGION_BITS, region_overlap=cb.REGION_OVERLAP,
              threshold=threshold, match=p.match, b_gap_open=p.b_gap_open,
              b_gap_extend=p.b_gap_extend, num_contigs=idx.num_contigs)
    args = tuple(torch.from_numpy(a) for a in (codes, rlen, minpos, wlen,
                                               thr))
    return cdv.DeviceL3Index.from_host(idx, "cpu"), args, kw


def _floordiv(a, b):
    return a // b          # numpy int64 // floors, as jnp's


def readmajor_model(codes, rlen, minpos, wlen_cfg, thr_read, dev, *, a_cap,
                    a2_cap, h_cap, use_region_counts=False, region_bits=11,
                    region_overlap=50, collapse=True, gapless=False,
                    match_mode=2, threshold=55.0, match=10, b_gap_open=-33,
                    b_gap_extend=-3, list_cutoff=0x7FFFFFFF, num_contigs=1,
                    **_):
    """The kernels' stages, read by read, in numpy (int64 lanes holding
    the int32 values)."""
    B, R = codes.shape
    S = len(dev.spans)
    Ks, rb, Ktot = cdv.row_layout(dev.spans, R)
    # l3_lens: read-major rows (seed, k-mer) of each read
    lens = np.zeros((B, Ktot), np.int64)
    lo = np.zeros((B, Ktot), np.int64)
    for sn, span in enumerate(dev.spans):
        if Ks[sn] == 0:
            continue
        mi = cdv._mapidx_seed(codes, rlen, minpos, span, dev.ones[sn],
                              dev.seed_positions[sn], dev.use_hashing,
                              dev.hash_max_span)
        valid = mi != cdv.INVALID_MI
        ms = torch.where(valid, mi, 0)
        off = dev.offsets[sn].to(torch.int64)
        ln = torch.where(valid, off[ms + 1] - off[ms], 0)
        ln = torch.where(ln > list_cutoff, 0, ln)
        lens[:, rb[sn]:rb[sn] + Ks[sn]] = ln.numpy()
        lo[:, rb[sn]:rb[sn] + Ks[sn]] = off[ms].numpy()
    tot = np.stack([lens[:, rb[s]:rb[s] + Ks[s]].sum(1) for s in range(S)],
                   1)
    # l3_scan_postings: the a_cap cut in seed-major order
    kept, kbase, total = cdv.seed_major_cut(torch.from_numpy(tot), a_cap)
    kept = kept.numpy()
    positions = dev.positions.numpy().astype(np.int64)
    P = len(positions)
    per_read = []
    scnt = np.zeros((B, S), np.int64)
    for b in range(B):
        # l3_keep: kept postings in (seed, k-mer, list) order
        xs, rows, seeds = [], [], []
        for sn in range(S):
            left = int(kept[b, sn])
            for r in range(rb[sn], rb[sn] + Ks[sn]):
                k = min(left, int(lens[b, r]))
                left -= k
                src = np.clip(lo[b, r] + np.arange(k), 0, P - 1)
                xs.append(positions[src])
                rows += [r] * k
                seeds += [sn] * k
        x = np.concatenate(xs) if xs else np.zeros(0, np.int64)
        rows, seeds = np.array(rows, np.int64), np.array(seeds, np.int64)
        n = len(x)
        order = np.lexsort((np.arange(n), x))           # (x, position)
        xq = x[order]
        keep_q = np.ones(n, bool)
        if use_region_counts and n:
            reg = xq >> region_bits
            ext = ((xq & ((1 << region_bits) - 1)) < region_overlap) \
                & (reg > 0)
            ov = min(max(region_overlap, 0), 1 << region_bits)
            xp = np.concatenate([[np.iinfo(np.int64).min], xq[:-1]])
            xn = np.concatenate([xq[1:], [np.iinfo(np.int64).max]])
            r0 = reg << region_bits
            keep_q = (xp >= r0) | (xn < r0 + (1 << region_bits) + ov) \
                | (ext & ((xp >= r0 - (1 << region_bits)) | (xn < r0 + ov)))
        keep_o = np.zeros(n, bool)
        keep_o[order] = keep_q
        rank = np.cumsum(keep_o) - keep_o                # expansion order
        for sn in range(S):
            scnt[b, sn] = keep_o[seeds == sn].sum()
        sel = order[keep_q]                              # survivors, x order
        per_read.append((x[sel], rows[sel], seeds[sel], rank[sel]))
    # l3_scan_survivors: the a2_cap cut in seed-major order
    a2kept, _, n_sur = cdv.seed_major_cut(torch.from_numpy(scnt), a2_cap)
    a2kept = a2kept.numpy()
    coffs = dev.contig_offsets.numpy().astype(np.int64)
    clens = dev.contig_len.numpy().astype(np.int64)
    windows, clamped = [], False
    for b in range(B):
        sx, srow, sseed, srank = per_read[b]
        spre = np.concatenate([[0], np.cumsum(scnt[b])])[:-1]
        ok = (srank - spre[sseed]) < a2kept[b][sseed]
        X = sx[ok]
        Y = srow[ok] - np.array(rb)[sseed[ok]] + int(minpos[b])
        SP = np.array(dev.spans, np.int64)[sseed[ok]]
        m2 = len(X)
        CN = np.clip(np.searchsorted(coffs, np.maximum(X, 0), side="right")
                     - 1, 0, num_contigs - 1)
        head = np.ones(m2, bool)
        WT = np.ones(m2, np.int64)
        NL = SP.copy()
        if collapse and m2:
            rl = max(int(rlen[b]), 1)
            slot = np.mod(X + rl - Y, rl)
            g = np.lexsort((np.arange(m2), slot))
            diag = X - Y
            for q in range(m2):
                e = g[q]
                if q and slot[g[q - 1]] == slot[e] and \
                        diag[g[q - 1]] == diag[e] and CN[g[q - 1]] == CN[e]:
                    head[e] = False
                    continue
                wt, ext_ = 1, X[e] + SP[e]
                for qq in range(q + 1, m2):
                    f = g[qq]
                    if slot[f] != slot[e] or diag[f] != diag[e] or \
                            CN[f] != CN[e]:
                        break
                    wt += 1
                    ext_ = max(ext_, X[f] + SP[f])
                WT[e], NL[e] = wt, ext_ - X[e]
        rl, wc = int(rlen[b]), int(wlen_cfg[b])
        for i in np.flatnonzero(head):
            x, y, ln, wt, cn = X[i], Y[i], NL[i], WT[i], CN[i]
            coff, clen = coffs[cn], clens[cn]
            w_len = min(wc, clen)
            gend = min((x - coff) + rl - 1 - y, clen - 1)
            floor_x = coff + (gend - wc if gend >= wc else 0)
            ms = ln * match
            if not gapless and match_mode == 2 and wt == 1:
                ms = -1
            mi = i
            if not gapless:
                for j in range(i - 1, -1, -1):
                    if X[j] < floor_x:
                        break
                    if not head[j] or Y[j] >= y:
                        continue
                    dx, dy = x - X[j], y - Y[j]
                    short = (dy if dx - dy > 0 else dx) + ln
                    long_ = (dx if dx - dy > 0 else dy) + ln
                    tmp = short * match + (b_gap_open + (long_ - short)
                                           * b_gap_extend
                                           if long_ > short else 0)
                    if tmp > ms:
                        ms, mi = tmp, j
            thr = int(-threshold) if threshold < 0 else int(thr_read[b])
            if threshold >= 0 and w_len != wc and rl > w_len:
                clamped = True
            if not (gapless or match_mode == 1 or ms >= thr):
                continue
            xj, yj, lj = X[mi], Y[mi], NL[mi]
            half = _floordiv(wc - ((x - xj) + ln), 2)
            goff = (xj - coff) - half if half < xj - coff else 0
            if goff + w_len > clen:
                goff = clen - w_len
            pair = mi < i
            xi, xjw = x - coff - goff, xj - coff - goff
            if pair:
                nw = min(xi + y, xjw + yj)
                sw = min(xi - y, xjw - yj)
                ne = max(xi - y, xjw - yj)
                se = max(xi + y + 2 * (ln - 1), xjw + yj + 2 * (lj - 1))
                nw -= (nw + sw) % 2 != 0
                ne += (ne - sw) % 2 != 0
                se += (se - nw) % 2 != 0
                axj = _floordiv(nw + sw, 2)
                anchor = (axj, nw - axj, _floordiv(se - nw, 2) + 1,
                          _floordiv(ne - sw, 2) + 1)
            else:
                anchor = (xi, y, ln, 1)
            windows.append((b, cn, goff, w_len, ms,
                            wt + WT[mi] if pair else wt,
                            min(rl, w_len) * match, *anchor))
    counts = [total, n_sur, len(windows), int(clamped), 0, 0]
    v = cdv.decode_counters(counts, a_cap, a2_cap, h_cap)
    res = {"overflow": torch.tensor(v["overflow"]),
           "n_total": torch.tensor(v["n_total"], dtype=torch.int64),
           "n_survivors": torch.tensor(v["n_survivors"], dtype=torch.int64),
           "n": torch.tensor(v["n"], dtype=torch.int64)}
    w = np.array(windows, np.int64).reshape(-1, len(cdv.COLUMNS))[:h_cap]
    for c, f in enumerate(cdv.COLUMNS):
        col = torch.zeros(h_cap, dtype=torch.int32)
        col[:len(w)] = torch.from_numpy(w[:, c].astype(np.int32))
        res[f] = col
    res["emit"] = torch.arange(h_cap) < len(w)
    return res


# name -> (_setup kwargs, device_candidates keywords): the K10 cases of the
# card tests, and cuts at each capacity
CASES = {
    "dense_regions": ({"seed": 3}, {"use_region_counts": True}),
    "dense_regions_rc": ({"seed": 3, "st": 1}, {"use_region_counts": True}),
    "sparse_regions": ({"seed": 23}, {"use_region_counts": True,
                                      "dense_region_cap": 0}),
    "collapse_off": ({"seed": 29}, {"use_region_counts": True,
                                    "collapse": False}),
    "hashed": ({"seed": 5, "use_hashing": True}, {}),
    "gapless": ({"seed": 11}, {"match_mode": 1, "gapless": True}),
    "match_mode_1": ({"seed": 9}, {"match_mode": 1}),
    "list_cutoff": ({"seed": 17, "contig_len": 8_000}, {"list_cutoff": 2}),
    "absolute_threshold": ({"seed": 37, "threshold": -300.0},
                           {"use_region_counts": True}),
    "overflow": ({"seed": 13, "n_reads": 48}, {"a_cap": 256}),
    "a2_cut": ({"seed": 7}, {"use_region_counts": True, "a2_cap": 300}),
    "h_cut": ({"seed": 19}, {"h_cap": 40}),
    "repeats": ({"seed": 41, "repeat": 12}, {"use_region_counts": True}),
}


def _run(case):
    setup_kw, kw_over = CASES[case]
    dev, args, kw = _setup(**setup_kw)
    kw.update(kw_over)
    if "threshold" in setup_kw:
        kw["threshold"] = setup_kw["threshold"]
    return dev, args, kw


@pytest.mark.parametrize("case", sorted(CASES))
def test_readmajor_model_equals_plain(case):
    dev, args, kw = _run(case)
    want = cdv.device_candidates_plain(*args, dev, **kw)
    got = readmajor_model(*args, dev, **kw)
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    assert int(want["n"]) > 0
    cut = {"overflow": "n_total", "a2_cut": "n_survivors", "h_cut": "n"}
    assert bool(want["overflow"]) == (case in cut)
    if case in cut:
        cap = {"n_total": "a_cap", "n_survivors": "a2_cap", "n": "h_cap"}
        assert int(want[cut[case]]) > kw[cap[cut[case]]]


def test_row_layout_is_seed_major_within_a_read():
    Ks, base, ktot = cdv.row_layout((14, 19, 19), 64)
    assert Ks == [51, 46, 46] and base == [0, 51, 97] and ktot == 143
    assert cdv.row_layout((20,), 16) == ([0], [0], 0)


def test_seed_major_cut_equals_the_plain_cut():
    """The cut of `seed_major_cut` keeps, per (read, seed), the postings
    the plain version keeps among its first a_cap in seed-major order."""
    dev, args, kw = _run("overflow")
    codes, rlen, minpos = args[:3]
    B, R = codes.shape
    Ks, _, _ = cdv.row_layout(dev.spans, R)
    tot, sm_rid, sm_seed = [], [], []
    for sn, span in enumerate(dev.spans):
        mi = cdv._mapidx_seed(codes, rlen, minpos, span, dev.ones[sn],
                              dev.seed_positions[sn], dev.use_hashing,
                              dev.hash_max_span)
        v = mi != cdv.INVALID_MI
        ms = torch.where(v, mi, 0)
        off = dev.offsets[sn].to(torch.int64)
        ln = torch.where(v, off[ms + 1] - off[ms], 0)
        tot.append(ln.sum(1))
        sm_rid.append(torch.arange(B).repeat_interleave(ln.sum(1)))
        sm_seed.append(torch.full((int(ln.sum()),), sn))
    tot = torch.stack(tot, 1)
    rid, seed = torch.cat(sm_rid), torch.cat(sm_seed)
    for cap in (0, 1, 256, 1000, int(tot.sum()), int(tot.sum()) + 5):
        kept, base, total = cdv.seed_major_cut(tot, cap)
        assert total == int(tot.sum())
        want = torch.zeros_like(tot)
        want.index_put_((rid[:cap], seed[:cap]),
                        torch.ones(min(cap, len(rid)), dtype=torch.int64),
                        accumulate=True)
        assert torch.equal(kept, want)
        assert torch.equal(base[1:] - base[:-1], kept.sum(1))
        assert int(base[-1]) == min(cap, total)


def test_decode_counters_layout():
    v = cdv.decode_counters([10, 4, 3, 0, 2, 1, 0, 0], 10, 4, 3)
    assert v == {"overflow": False, "n_total": 10, "n_survivors": 4, "n": 3,
                 "global_reads": 3}
    for counts in ([11, 4, 3, 0], [10, 5, 3, 0], [10, 4, 4, 0],
                   [10, 4, 3, 1]):
        assert cdv.decode_counters(counts + [0, 0], 10, 4, 3)["overflow"]


def test_workspace_grows_and_is_reused():
    ws = cdv.L3Workspace()
    a = ws.get("keys", 100, torch.int64, torch.device("cpu"))
    n = ws.allocations
    b = ws.get("keys", 50, torch.int64, torch.device("cpu"))
    assert ws.allocations == n and b.data_ptr() == a.data_ptr()
    assert b.numel() == 50
    ws.get("keys", 200, torch.int64, torch.device("cpu"))
    assert ws.allocations == n + 1
