"""The cell order of the pass-2 kernels (`csrc/sw_full.cu`, K3 + K4, and
`csrc/sw_full_cs.cu`, K7 + K8), modelled in numpy and held to the plain
versions `sw_full_and_traceback_packed_plain` and
`sw_full_cs_and_traceback_packed_plain`.

The model runs the kernels' formulation, vectorised over alignments and
over the columns of a segment, with every alignment in step as the tiles
of a warp are (the letter-space kernel runs (T, C) = (16, 2) or (32, 2),
the colour-space one C = 1 with T = 16 or 32; the model takes any):
  * a tile of T lanes per alignment, each lane owning C adjacent columns
    of a segment of S = T * C; a row is swept segment after segment,
    u = s*S + lane*C + c, and only over the row's computed prefix
    nc[i] = min(band width, W, glen - xmin[i]) (0 past rlen); the number
    of segments is the largest over the alignments in step;
  * one row of states per alignment, updated in place one segment late:
    segment s reads its predecessors (columns s*T + d - 1 and up), then
    writes segment s - 1's columns (below s*T), so every read sees the
    previous row;
  * predecessors past the previous row's computed prefix are implied:
    past W or before column 0 the border triple; past glen the fill (in
    letter space) or the previous row's border (in colour space); past the
    band the border triple;
  * the W state as a tilted prefix max: each lane's running max over its
    columns, the lanes' maxima over the tile (log2 T steps of shfl_up with
    width T), carried from segment to segment;
  * the best cell kept per lane as (score, row * W + column, start state)
    and reduced over the tile with xor shuffles;
  * the pointers of the computed prefix only, packed row after row at
    offsets off[i] = nc[0] + ... + nc[i - 1], and a walk over them that
    reads pointer 0 past a row's prefix.
Scores are integers: the comparisons are exact."""

import numpy as np
import pytest
import torch

from shrimp_tpu_torch.ops import sw_full as tsf
from shrimp_tpu_torch.ops import sw_full_cs as tcs
from shrimp_tpu_torch.ops.params import SWParams
from shrimp_tpu_torch.pipeline.candidates import cs_read_ls4

NEG_INF = -(1 << 28)
LS = SWParams.letter_space()
CS = SWParams.colour_space()
ASYM = SWParams(match=5, mismatch=-4, a_gap_open=-10, a_gap_extend=-1,
                b_gap_open=-6, b_gap_extend=-2)
# gap costs near a match: long gaps and W-state chains win often
ODD = SWParams(match=3, mismatch=-1, a_gap_open=-2, a_gap_extend=-1,
               b_gap_open=-2, b_gap_extend=-1, crossover=-3)
BASE_N = 15


def shfl_up(x, off):
    """__shfl_up_sync(mask, x, off, T) over the last axis: lane t reads
    lane t - off, lanes below off keep their own value."""
    y = x.copy()
    y[..., off:] = x[..., :-off]
    return y


def shfl_last(x):
    """__shfl_sync(mask, x, T - 1, T): the tile's last lane, to all."""
    return x[..., -1]


def tilted_scan(tilt, c_run, C=1):
    """The segment's tilted prefix max, as a tile of T lanes owning C
    columns each computes it: each lane's running max over its columns,
    the lanes' maxima scanned over the tile (log2 T steps of shfl_up),
    then the exclusive form seeded with the carried segment maximum.
    tilt [B, T * C] in column order; returns (the tile's inclusive maxima
    [B, T], the exclusive prefix max [B, T * C])."""
    B, S = tilt.shape
    T = S // C
    run = np.maximum.accumulate(tilt.reshape(B, T, C), axis=2)
    incl = run[:, :, -1]
    off = 1
    while off < T:
        incl = np.maximum(incl, shfl_up(incl, off))
        off <<= 1
    ex = shfl_up(incl, 1)
    ex[:, 0] = c_run
    ex[:, 1:] = np.maximum(ex[:, 1:], c_run[:, None])
    excl = np.empty_like(run)
    excl[:, :, 0] = ex
    excl[:, :, 1:] = np.maximum(ex[:, :, None], run[:, :, :-1])
    return incl, excl.reshape(B, S)


def west(x, carry):
    """Each lane's west neighbour; lane 0 takes the carry."""
    y = shfl_up(x, 1)
    y[..., 0] = carry
    return y


def tile_best(lb, lpos, lst):
    """The xor-shuffle reduction over a tile: the higher score, then the
    lower row * W + column.  Returns each alignment's (score, pos, state)."""
    T = lb.shape[-1]
    lb, lpos, lst = lb.copy(), lpos.copy(), lst.copy()
    off = T >> 1
    while off:
        p = np.arange(T) ^ off
        ob, opos, ost = lb[:, p], lpos[:, p], lst[:, p]
        take = (ob > lb) | ((ob == lb) & (opos < lpos))
        lb = np.where(take, ob, lb)
        lpos = np.where(take, opos, lpos)
        lst = np.where(take, ost, lst)
        off >>= 1
    return lb[:, 0], lpos[:, 0], lst[:, 0]


def lane_best(lb, lpos, lst, C):
    """Each lane's first strict maximum over its C columns, kept in the
    order the lane visits them (row by row, then column)."""
    B, S = lb.shape
    sh = (B, S // C, C)
    lb, lpos, lst = lb.reshape(sh), lpos.reshape(sh), lst.reshape(sh)
    k = np.argmax(np.where(lb == lb.max(2, keepdims=True), -lpos,
                           np.iinfo(np.int64).min), axis=2)[..., None]
    return (np.take_along_axis(lb, k, 2)[..., 0],
            np.take_along_axis(lpos, k, 2)[..., 0],
            np.take_along_axis(lst, k, 2)[..., 0])


def computed_prefix(xmin, xmax, glen, rlen, W):
    """nc[b, i]: the columns a row computes, a prefix of [0, W)."""
    R = xmin.shape[1]
    nc = np.minimum(np.minimum(xmax - xmin + 1, W), glen[:, None] - xmin)
    nc = np.maximum(nc, 0)
    nc[np.arange(R)[None, :] >= rlen[:, None]] = 0
    return nc


def row_offsets(nc):
    """off[b, i]: where row i's pointers start in the packed plane."""
    return np.concatenate([np.zeros((len(nc), 1), np.int64),
                           np.cumsum(nc, 1)[:, :-1]], 1)


def shift_clip(xc, xmin_p, i, smax):
    return np.clip(xc - xmin_p, 0, smax) if i else np.zeros_like(xc)


def start_state(s_nw, s_n, s_w):
    """The walk's first state: NW, then W, then N if strictly greater."""
    st = np.where(s_w > s_nw, 2, 0)
    sb = np.maximum(s_nw, s_w)
    return np.where(s_n > sb, 1, st)


# ---------------------------------------------------------------------------
# letter space (K3 + K4)
def ls_tiles(gb, rb, rev, bxmin, bxmax, p, loc, W, T, C=1):
    """The tiled formulation of K3 + K4.  Returns (stats int32 [B, 10],
    ops uint8 [B, R + G], nc [B, R], off [B, R])."""
    B, G = gb.shape
    R = rb.shape[1]
    L = R + G
    g = gb.astype(np.int64)
    r = rb.astype(np.int64)
    rc = rev.astype(bool)[:, None]
    aoe = -(p.a_gap_open + p.a_gap_extend)
    ae = -p.a_gap_extend
    boe = -(p.b_gap_open + p.b_gap_extend)
    be = -p.b_gap_extend
    rlen = (r >= 0).sum(1)
    glen = (g >= 0).sum(1)
    fill = 0 if loc else NEG_INF
    bor = np.array([0, p.b_gap_open, p.a_gap_open] if loc else [NEG_INF] * 3)
    smax = tsf.shift_max(G)
    xmin = bxmin.astype(np.int64)
    nc = computed_prefix(xmin, bxmax.astype(np.int64), glen, rlen, W)
    off = row_offsets(nc)
    plane = np.zeros((B, R * W), np.int64)
    # the in-place row; columns past the previous prefix are never read
    row = np.full((B, W, 3), 77777, np.int64)
    S = T * C
    cols = np.arange(S)[None, :]
    bidx = np.arange(B)[:, None]
    # per column; a lane's C columns reduce in order, as the lane does
    lb = np.zeros((B, S), np.int64)
    lpos = np.zeros((B, S), np.int64)
    lst = np.zeros((B, S), np.int64)
    nc_p = np.zeros(B, np.int64)
    xmin_p = np.zeros(B, np.int64)
    gl_p = np.zeros(B, np.int64)

    def pred(k):
        """[B, T, 3]: stored inside the previous prefix, else implied."""
        inside = (k >= 0) & (k < nc_p[:, None])
        v = row[bidx, np.clip(k, 0, W - 1)]
        past_glen = (k >= 0) & (k < W) & (k >= gl_p[:, None])
        imp = np.where(past_glen[..., None], fill, bor[None, None, :])
        return np.where(inside[..., None], v, imp)

    for i in range(int(rlen.max(initial=0))):
        xc, nci = xmin[:, i], nc[:, i]
        d = shift_clip(xc, xmin_p, i, smax)
        gsh = np.clip(xc, 0, smax)
        rch = r[:, i][:, None]
        elig = (np.full(B, loc) | (i == rlen - 1))[:, None]
        c_nw = np.full(B, bor[0])
        c_w = np.full(B, bor[2])
        c_run = np.full(B, bor[0])
        pending = []

        def flush():
            while pending:
                bb, uu, v = pending.pop()
                row[bb, uu] = v

        for s in range(int(-(-nci.max(initial=0) // S))):
            u = s * S + cols
            act = u < nci[:, None]
            if i == 0:     # virtual row -1, in both modes
                pd = np.broadcast_to(np.array([0, p.b_gap_open,
                                               p.a_gap_open]), (B, S, 3))
                pn = pd
            else:
                kn = u + d[:, None]
                pd = pred(kn - 1)
                pn = pred(kn)
            flush()
            gi = u + gsh[:, None]
            gc = np.where(gi < G, g[bidx, np.minimum(gi, G - 1)], -1)
            ms = np.where(gc == rch, p.match, p.mismatch)
            a1, a2, a3 = (pd[..., 0] + ms, pd[..., 1] + ms, pd[..., 2] + ms)
            # NW: forward nw, n, w; reverse w, n, nw; first strict max
            fs, fp = a1, np.full_like(a1, tsf.NW_FROM_NW)
            t = a2 > fs
            fs, fp = np.where(t, a2, fs), np.where(t, tsf.NW_FROM_N, fp)
            t = a3 > fs
            fs, fp = np.where(t, a3, fs), np.where(t, tsf.NW_FROM_W, fp)
            rs, rp = a3, np.full_like(a1, tsf.NW_FROM_W)
            t = a2 > rs
            rs, rp = np.where(t, a2, rs), np.where(t, tsf.NW_FROM_N, rp)
            t = a1 > rs
            rs, rp = np.where(t, a1, rs), np.where(t, tsf.NW_FROM_NW, rp)
            s_nw, p_nw = np.where(rc, rs, fs), np.where(rc, rp, fp)
            if loc:
                z = s_nw <= 0
                s_nw, p_nw = np.where(z, 0, s_nw), np.where(z, 0, p_nw)
            n1, n2 = pn[..., 0] - boe, pn[..., 1] - be
            f = n2 > n1
            fs, fp = np.where(f, n2, n1), np.where(f, tsf.N_FROM_N,
                                                   tsf.N_FROM_NW)
            t = n1 > n2
            rs, rp = np.where(t, n1, n2), np.where(t, tsf.N_FROM_NW,
                                                   tsf.N_FROM_N)
            s_n, p_n = np.where(rc, rs, fs), np.where(rc, rp, fp)
            if loc:
                z = s_n <= 0
                s_n, p_n = np.where(z, 0, s_n), np.where(z, 0, p_n)
            incl, excl = tilted_scan(s_nw + ae * (u + 1), c_run, C)
            s_w = np.maximum(excl - aoe - ae * u, bor[2] - ae * (u + 1))
            w_fl = np.maximum(s_w, 0) if loc else s_w
            cnw = west(s_nw, c_nw) - aoe
            cw = west(w_fl, c_w) - ae
            p_w = np.where(rc, np.where(cw >= cnw, tsf.W_FROM_W,
                                        tsf.W_FROM_NW),
                           np.where(cnw >= cw, tsf.W_FROM_NW, tsf.W_FROM_W))
            if loc:
                z = s_w <= 0
                s_w, p_w = np.where(z, 0, s_w), np.where(z, 0, p_w)
            c_nw, c_w = shfl_last(s_nw), shfl_last(w_fl)
            c_run = np.maximum(c_run, shfl_last(incl))
            cell = np.maximum(np.maximum(s_nw, s_n), s_w)
            imp = act & elig & (cell > lb)
            lb = np.where(imp, cell, lb)
            lpos = np.where(imp, i * W + u, lpos)
            lst = np.where(imp, start_state(s_nw, s_n, s_w), lst)
            # the pointers at once; the states after the next segment's
            # reads
            bb, ll = np.nonzero(act)
            uu = u[0, ll]
            plane[bb, off[bb, i] + uu] = (p_nw | (p_n << 2)
                                          | (p_w << 4))[bb, ll]
            pending.append((bb, uu, np.stack([s_nw, s_n, s_w], -1)[bb, ll]))
        flush()
        nc_p, xmin_p, gl_p = nci, xc, glen - xc

    score, pos, st0 = tile_best(*lane_best(lb, lpos, lst, C))
    stats = np.zeros((B, 10), np.int64)
    ops = np.zeros((B, L), np.uint8)
    for b in range(B):
        if score[b] <= 0:
            continue
        i, u = divmod(int(pos[b]), W)
        j = int(xmin[b, i]) + u
        state = int(st0[b])
        rs = gs = mt = mm = ins = dl = 0
        buf = []
        for _ in range(L):
            ii = min(max(i, 0), R - 1)
            jj = min(max(j, 0), G - 1)
            ur = jj - int(xmin[b, ii])
            cellp = (int(plane[b, off[b, ii] + ur])
                     if 0 <= ur < nc[b, ii] else 0)
            ptr = (cellp >> (2 * state)) & 3
            if ptr == 0:
                break
            if state == tsf.STATE_NW:
                buf.append(tsf.OP_MATCH)
                if g[b, jj] == r[b, ii]:
                    mt += 1
                else:
                    mm += 1
                rs, gs = i, j
                i, j = i - 1, j - 1
                state = {tsf.NW_FROM_NW: tsf.STATE_NW,
                         tsf.NW_FROM_N: tsf.STATE_N}.get(ptr, tsf.STATE_W)
            elif state == tsf.STATE_N:
                buf.append(tsf.OP_DEL)
                dl += 1
                rs = i
                i -= 1
                state = tsf.STATE_N if ptr == tsf.N_FROM_N else tsf.STATE_NW
            else:
                buf.append(tsf.OP_INS)
                ins += 1
                gs = j
                j -= 1
                state = tsf.STATE_W if ptr == tsf.W_FROM_W else tsf.STATE_NW
            if i < 0 or j < 0:
                break
        stats[b] = [score[b], rs, gs, mt, mm, ins, dl, mt + mm + dl,
                    mt + mm + ins, len(buf)]
        ops[b, :len(buf)] = buf[::-1]
    return stats.astype(np.int32), ops, nc, off


# ---------------------------------------------------------------------------
# colour space (K7 + K8)
def _ptr(layer, state):
    return 1 + layer * 3 + state


def _first_max(cands):
    """First strict maximum over ordered (score, ptr) pairs."""
    s, pp = cands[0]
    pp = np.broadcast_to(pp, s.shape)
    for c, q in cands[1:]:
        t = c > s
        s, pp = np.where(t, c, s), np.where(t, q, pp)
    return s, pp


def cs_tiles(gb, qr4, xover, rev, bxmin, bxmax, p, loc, taboo, W, T):
    """The tiled formulation of K7 + K8.  Returns (stats int32 [B, 11],
    ops uint8 [B, R + G], nc [B, R], off [B, R])."""
    B, G = gb.shape
    R = qr4.shape[2]
    L = R + G
    g = gb.astype(np.int64)
    q = qr4.astype(np.int64)
    xo = xover.astype(np.int64)
    rc = rev.astype(bool)[:, None]
    aoe = -(p.a_gap_open + p.a_gap_extend)
    ae = -p.a_gap_extend
    boe = -(p.b_gap_open + p.b_gap_extend)
    be = -p.b_gap_extend
    a_go, b_go = p.a_gap_open, p.b_gap_open
    rlen = (q[:, 0] >= 0).sum(1)
    glen = (g >= 0).sum(1)
    smax = tsf.shift_max(G)
    xmin = bxmin.astype(np.int64)
    nc = computed_prefix(xmin, bxmax.astype(np.int64), glen, rlen, W)
    off = row_offsets(nc)
    # pointers: [layer][off[row] + column], 12 bits each
    plane = np.zeros((B, 4, R * W), np.int64)
    # the in-place row: [column, state, layer]
    row = np.full((B, W, 3, 4), 77777, np.int64)
    S = T          # one column a lane
    cols = np.arange(S)[None, :]
    bidx = np.arange(B)[:, None]
    k4 = np.arange(4)
    lb = np.zeros((B, S), np.int64)
    lpos = np.zeros((B, S), np.int64)
    lst = np.zeros((B, S), np.int64)
    nc_p = np.zeros(B, np.int64)
    xmin_p = np.zeros(B, np.int64)

    def border(e):
        """[B, 3, 4]: a row's border triple per layer, e[B] its crossover."""
        ie = np.where(k4[None, :] == 0, 0, e[:, None])
        if not loc:
            return np.full((B, 3, 4), NEG_INF, np.int64)
        return np.stack([ie, b_go + ie, a_go + ie], 1)

    for i in range(int(rlen.max(initial=0))):
        xc, nci = xmin[:, i], nc[:, i]
        d = shift_clip(xc, xmin_p, i, smax)
        gsh = np.clip(xc, 0, smax)
        xp = xo[:, i]
        cm1 = border(xo[:, i - 1] if i else np.zeros(B, np.int64))
        col = border(xp)
        tok = (i < rlen - taboo)[:, None]
        elig = (np.full(B, loc) | (i == rlen - 1))[:, None]
        qk = q[:, :, i]                                    # [B, 4]
        c_nw = col[:, 0].copy()                            # [B, 4]
        c_w = col[:, 2].copy()
        c_run = np.where(tok, c_nw, NEG_INF)

        def pred(k):
            """[B, T, 3, 4]: stored inside the previous prefix, else the
            previous row's border."""
            inside = (k >= 0) & (k < nc_p[:, None])
            v = row[bidx, np.clip(k, 0, W - 1)]
            return np.where(inside[..., None, None], v, cm1[:, None])

        pending = []

        def flush():
            while pending:
                bb, uu, v = pending.pop()
                row[bb, uu] = v

        for s in range(int(-(-nci.max(initial=0) // S))):
            u = s * S + cols
            act = u < nci[:, None]
            if i == 0:     # virtual top row, the global crossover
                e = np.where(k4 == 0, 0, p.crossover)
                top = np.stack([e, b_go + e, a_go + e])    # [3, 4]
                pd = pn = np.broadcast_to(top, (B, S, 3, 4))
            else:
                kn = u + d[:, None]
                pd = pred(kn - 1)
                pn = pred(kn)
            flush()
            gi = u + gsh[:, None]
            gc = np.where(gi < G, g[bidx, np.minimum(gi, G - 1)], -1)
            md, mn = [], []
            for l in range(4):
                d_nw, d_n, d_w = pd[..., 0, l], pd[..., 1, l], pd[..., 2, l]
                d_n = np.where(tok, d_n, NEG_INF)
                f = _first_max([(d_nw, _ptr(l, 0)), (d_n, _ptr(l, 1)),
                                (d_w, _ptr(l, 2))])
                rr = _first_max([(d_w, _ptr(l, 2)), (d_n, _ptr(l, 1)),
                                 (d_nw, _ptr(l, 0))])
                md.append((np.where(rc, rr[0], f[0]),
                           np.where(rc, rr[1], f[1])))
                c1 = np.where(tok, pn[..., 0, l] - boe, NEG_INF)
                c2 = pn[..., 1, l] - be
                f = _first_max([(c1, _ptr(l, 0)), (c2, _ptr(l, 1))])
                rr = _first_max([(c2, _ptr(l, 1)), (c1, _ptr(l, 0))])
                mn.append((np.where(rc, rr[0], f[0]),
                           np.where(rc, rr[1], f[1])))
            out_s = np.zeros((B, S, 3, 4), np.int64)
            ptrs = np.zeros((B, S, 4), np.int64)
            st_k = []
            for k in range(4):
                reset = 0 if k == 0 else xp[:, None]
                qc = qk[:, k][:, None]
                ms = np.where((gc == BASE_N) | (qc == BASE_N), 0,
                              np.where(gc == qc, p.match, p.mismatch))
                xk = xp[:, None]
                s_nw, p_nw = _first_max(
                    [(md[k][0] + ms, md[k][1])]
                    + [(md[l][0] + ms + xk, md[l][1])
                       for l in range(4) if l != k])
                if loc:
                    z = s_nw <= reset
                    s_nw, p_nw = np.where(z, reset, s_nw), np.where(z, 0,
                                                                    p_nw)
                s_n, p_n = _first_max(
                    [mn[k]] + [(mn[l][0] + xk, mn[l][1])
                               for l in range(4) if l != k])
                if loc:
                    z = s_n <= reset
                    s_n, p_n = np.where(z, reset, s_n), np.where(z, 0, p_n)
                col_w = col[:, 2, k][:, None]
                incl, excl = tilted_scan(
                    np.where(tok, s_nw, NEG_INF) + ae * (u + 1), c_run[:, k])
                s_w = np.maximum(excl - aoe - ae * u, col_w - ae * (u + 1))
                w_fl = np.maximum(s_w, reset) if loc else s_w
                cnw = np.where(tok, west(s_nw, c_nw[:, k]) - aoe, NEG_INF)
                cw = west(w_fl, c_w[:, k]) - ae
                p_w = np.where(
                    rc, np.where(cw >= cnw, _ptr(k, 2), _ptr(k, 0)),
                    np.where(cnw >= cw, _ptr(k, 0), _ptr(k, 2)))
                if loc:
                    z = s_w <= reset
                    s_w, p_w = np.where(z, reset, s_w), np.where(z, 0, p_w)
                c_nw[:, k] = shfl_last(s_nw)
                c_w[:, k] = shfl_last(w_fl)
                c_run[:, k] = np.maximum(c_run[:, k], shfl_last(incl))
                out_s[..., 0, k], out_s[..., 1, k], out_s[..., 2, k] = \
                    s_nw, s_n, s_w
                ptrs[..., k] = p_nw | (p_n << 4) | (p_w << 8)
                st_k.append((s_nw, s_n, s_w))
            # best: per lane in (column, layer) order, first strict max
            for k in range(4):
                s_nw, s_n, s_w = st_k[k]
                cell = np.maximum(np.maximum(s_nw, s_n), s_w)
                imp = act & elig & (cell > lb)
                lb = np.where(imp, cell, lb)
                lpos = np.where(imp, (i * W + u) * 4 + k, lpos)
                lst = np.where(imp, start_state(s_nw, s_n, s_w), lst)
            bb, ll = np.nonzero(act)
            uu = u[0, ll]
            for k in range(4):
                plane[bb, k, off[bb, i] + uu] = ptrs[bb, ll, k]
            pending.append((bb, uu, out_s[bb, ll]))
        flush()
        nc_p, xmin_p = nci, xc

    score, pos, st0 = tile_best(lb, lpos, lst)
    stats = np.zeros((B, 11), np.int64)
    ops = np.zeros((B, L), np.uint8)
    for b in range(B):
        if score[b] <= 0:
            continue
        cellpos, k = divmod(int(pos[b]), 4)
        i, u = divmod(cellpos, W)
        j = int(xmin[b, i]) + u
        state = int(st0[b])
        rs = gs = mt = mm = ins = dl = xo_n = 0
        buf = []
        for _ in range(L):
            ii = min(max(i, 0), R - 1)
            jj = min(max(j, 0), G - 1)
            ur = jj - int(xmin[b, ii])
            cellp = (int(plane[b, k, off[b, ii] + ur])
                     if 0 <= ur < nc[b, ii] else 0)
            ptr = (cellp >> (4 * state)) & 15
            if ptr == 0:
                break
            sl, ss = divmod(ptr - 1, 3)
            xv = sl != k
            if state == 0:
                gch, qch = int(g[b, jj]), int(q[b, k, ii])
                if gch == qch or gch == BASE_N or qch == BASE_N:
                    mt += 1
                else:
                    mm += 1
                rs, gs = i, j
                i, j = i - 1, j - 1
                op = tcs.OP_MATCH
            elif state == 1:
                dl += 1
                rs = i
                i -= 1
                op = tcs.OP_DEL
            else:
                ins += 1
                gs = j
                j -= 1
                op = tcs.OP_INS
            buf.append(op | (k << 2) | (tcs.OP_XOVER if xv else 0))
            xo_n += xv
            k, state = sl, ss
            if i < 0 or j < 0:
                break
        if k != 0 and buf:
            buf[-1] |= tcs.OP_XOVER
            xo_n += 1
        stats[b] = [score[b], rs, gs, mt, mm, ins, dl, mt + mm + dl,
                    mt + mm + ins, len(buf), xo_n]
        ops[b, :len(buf)] = buf[::-1]
    return stats.astype(np.int32), ops, nc, off


# ---------------------------------------------------------------------------
# cases
def ls_case(seed, B=24, G=96, R=64, rlen=50, W=32, band="anchor",
            all_miss=False):
    """Reads cut from their windows with up to 5 substitutions and a few
    indels' worth of shift, random strands, and bands: "anchor"
    (compute_band, cut to width W), "diag" (the band steps by one column
    a row: d = 1), "flat" (the band stays put: d = 0), "jump" (starts
    leaping past the shift clip and past glen), "glen" (bands running past
    the end of the window), or "full" ([0, glen - 1])."""
    rng = np.random.default_rng(seed)
    gb = rng.integers(0, 4, (B, G)).astype(np.int8)
    glen = rng.integers(rlen + 4, G + 1, B)
    for b in range(B):
        gb[b, glen[b]:] = -1
    rb = np.full((B, R), -2, np.int8)
    starts = np.zeros(B, np.int64)
    for b in range(B):
        s = starts[b] = int(rng.integers(0, glen[b] - rlen + 1))
        rr = gb[b, s:s + rlen].copy()
        for _ in range(int(rng.integers(0, 6))):
            k = int(rng.integers(0, rlen))
            rr[k] = (rr[k] + int(rng.integers(1, 4))) % 4
        if rng.random() < 0.3:      # an indel: drop a genome letter
            k = int(rng.integers(1, rlen - 1))
            rr[k:] = gb[b, s + k + 1:s + rlen + 1][:rlen - k] \
                if s + rlen + 1 <= glen[b] else rr[k:]
        rb[b, :rlen] = rr
    if all_miss:                    # no letter ever matches: best 0
        gb = np.where(gb >= 0, 0, gb).astype(np.int8)
        rb = np.where(rb >= 0, 1, rb).astype(np.int8)
    rev = rng.random(B) < 0.5
    i = np.arange(R)[None, :]
    if band == "anchor":
        ay = rng.integers(0, 8, B)
        bxmin, bxmax = tsf.compute_band(
            starts + ay + rng.integers(-3, 4, B), ay, np.full(B, rlen // 2),
            rng.integers(max(W // 4, 1), max(W // 2, 2), B), glen, R)
    elif band == "diag":
        lo = np.clip(starts[:, None] - 6 + i, 0, (glen - 1)[:, None])
        bxmin, bxmax = lo, np.minimum(lo + rng.integers(8, W, (B, 1)),
                                      (glen - 1)[:, None])
    elif band == "flat":
        lo = np.broadcast_to(np.maximum(starts - 4, 0)[:, None], (B, R))
        bxmin, bxmax = lo, np.minimum(lo + rlen + 8, (glen - 1)[:, None])
    elif band == "jump":
        bxmin = np.zeros((B, R), np.int64)
        for b in range(B):
            steps = np.where(rng.random(R) < 0.1,
                             rng.integers(20, 3 * G // 2, R),
                             rng.integers(0, 2, R))
            bxmin[b] = np.cumsum(steps) - steps[0]
        bxmax = bxmin + rng.integers(6, 20, (B, 1))
    elif band == "glen":
        lo = np.clip(starts[:, None] + i - 4, 0, None)
        bxmin, bxmax = lo, lo + rng.integers(10, W, (B, 1))
    else:
        bxmin = np.zeros((B, R), np.int64)
        bxmax = np.broadcast_to((glen - 1)[:, None], (B, R)).copy()
    bxmax = np.minimum(bxmax, bxmin + W - 1)
    return gb, rb, rev, bxmin.astype(np.int32), bxmax.astype(np.int32)


def cs_case(seed, B=24, G=96, R=64, rlen=50, W=32, band="anchor",
            per_colour=False, n_rate=0.0):
    """Colour reads cut from their windows with 15% colour noise (N
    colours at n_rate) as four letter decodings, global or per-colour
    crossover costs, and the bands of `ls_case`."""
    rng = np.random.default_rng(seed)
    gb, _, rev, bxmin, bxmax = ls_case(seed + 1000, B, G, R, rlen, W, band)
    glen = (gb >= 0).sum(1)
    qr4 = np.full((B, 4, R), -2, np.int8)
    xover = np.full((B, R), CS.crossover, np.int32)
    for b in range(B):
        st = int(rng.integers(0, glen[b] - rlen + 1))
        initbp = int(rng.integers(0, 4))
        letters = np.concatenate(([initbp], gb[b, st:st + rlen]))
        colours = np.where(rng.random(rlen) < 0.15, rng.integers(0, 4, rlen),
                           letters[:-1] ^ letters[1:]).astype(np.int8)
        colours[rng.random(rlen) < n_rate] = 4
        qr4[b, :, :rlen] = cs_read_ls4(colours, initbp)
        if per_colour:
            xover[b, :rlen] = -rng.integers(20, 181, rlen)
    return gb, qr4, xover, rev, bxmin, bxmax


def _plain_ls(case, p, loc, W):
    s, o = tsf.sw_full_and_traceback_packed_plain(
        *[torch.from_numpy(np.ascontiguousarray(a)) for a in case], p, loc,
        W)
    return s.numpy(), o.numpy()


def _plain_cs(case, p, loc, taboo, W):
    s, o = tcs.sw_full_cs_and_traceback_packed_plain(
        *[torch.from_numpy(np.ascontiguousarray(a)) for a in case], p, loc,
        taboo, W)
    return s.numpy(), o.numpy()


def assert_same(got, want):
    (s_got, o_got), (s_want, o_want) = got[:2], want
    bad = np.flatnonzero((s_got != s_want).any(axis=1))
    assert not len(bad), (bad[:4], s_got[bad[:2]], s_want[bad[:2]])
    assert np.array_equal(o_got, o_want)


LS_CASES = {
    "anchor": dict(band="anchor"),
    "diag_d1": dict(band="diag", W=40),
    "flat_d0": dict(band="flat", W=64),
    "jump_past_clip": dict(band="jump", W=24),
    "past_glen": dict(band="glen", W=48),
    "full_band": dict(band="full", W=96),
    "best_zero": dict(band="anchor", all_miss=True),
    "long_reads": dict(B=8, G=256, R=160, rlen=150, W=64),
}


@pytest.mark.parametrize("T,C", [(16, 2), (32, 2), (8, 1), (16, 1), (32, 1),
                                 (8, 4)])
@pytest.mark.parametrize("loc", [True, False], ids=["local", "glocal"])
@pytest.mark.parametrize("case", list(LS_CASES))
def test_ls_tiles_equal_plain(case, loc, T, C):
    kw = dict(LS_CASES[case])
    params = ASYM if case == "flat_d0" else ODD if case == "diag_d1" else LS
    c = ls_case(len(case) * 7 + T + C, **kw)
    W = kw.get("W", 32)
    got = ls_tiles(*c, params, loc, W, T, C)
    assert_same(got, _plain_ls(c, params, loc, W))
    if case == "best_zero" and loc:
        assert not got[0][:, 0].any()


CS_CASES = {
    "anchor": (dict(band="anchor"), 0),
    "per_colour_taboo": (dict(band="anchor", per_colour=True), 6),
    "n_colours": (dict(band="diag", W=40, n_rate=0.08), 0),
    "flat_d0": (dict(band="flat", W=64), 2),
    "jump_past_clip": (dict(band="jump", W=24), 3),
    "past_glen": (dict(band="glen", W=48, per_colour=True), 0),
    "full_band": (dict(band="full", W=96), 4),
}


@pytest.mark.parametrize("T", [8, 16, 32])
@pytest.mark.parametrize("loc", [True, False], ids=["local", "glocal"])
@pytest.mark.parametrize("case", list(CS_CASES))
def test_cs_tiles_equal_plain(case, loc, T):
    kw, taboo = CS_CASES[case]
    params = ODD if case == "flat_d0" else CS
    c = cs_case(len(case) * 11 + T, B=16, **kw)
    W = kw.get("W", 32)
    got = cs_tiles(*c, params, loc, taboo, W, T)
    assert_same(got, _plain_cs(c, params, loc, taboo, W))


def test_ls_band_prefix_is_what_the_walk_reads():
    """The packed plane holds only the computed prefix of each row, rows
    back to back: on anchor bands well under the R * W of a full plane."""
    c = ls_case(3, B=32, W=64)
    stats, _, nc, off = ls_tiles(*c, LS, True, 64, 8)
    rlen = (c[1] >= 0).sum(1)
    assert (nc <= 64).all() and (off[:, -1] + nc[:, -1] == nc.sum(1)).all()
    assert nc.sum() < 0.75 * (rlen * 64).sum()
    assert (stats[:, 0] > 0).all()


@pytest.mark.parametrize("name", ["sw_full", "sw_full_cs"])
def test_probe_instruments_the_shipped_sources(name):
    """`utils/pass2_probe.py` stamps the shipped kernels at their
    `PASS2_PROBE(k)` marks: the start after the tile's slot is known, the
    middle before the tile's best-cell reduction, the end after the ops
    are written; its copy defines the marks before the source's empty
    default and appends its launcher over the swept shapes."""
    import os

    from shrimp_tpu_torch import _build
    from shrimp_tpu_torch.utils import pass2_probe
    with open(os.path.join(_build.CSRC, name + ".cu")) as fh:
        src = fh.read()
    kernel = src[src.index("_kernel("):src.index("int launch(")]
    marks = [kernel.index(f"PASS2_PROBE({k});") for k in range(3)]
    assert kernel.index("const bool live") < marks[0] < marks[1] < marks[2]
    assert marks[1] < kernel.index("__shfl_xor_sync(FULL, lb")
    assert kernel.rindex("orow[") < marks[2]
    out = pass2_probe._instrumented(src) + pass2_probe._sweep_launcher(
        name, [(8, 1)])
    assert out.index("#define PASS2_PROBE(k)") < out.index(
        "#ifndef PASS2_PROBE")
    assert "g_clk[3 * b + (k)] = clock64()" in out
    assert "probe_set_clk" in out and 'extern "C" int probe_launch' in out
    with pytest.raises(RuntimeError):
        pass2_probe._instrumented(src.replace("PASS2_PROBE(1);", ""))
