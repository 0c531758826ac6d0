"""Posterior forward/backward pass for colour-space alignments (L2e).

Covers `common/sw-post.c`: given a full-SW colour-space alignment, run a
16-state HMM over the aligned colours — states are (left letter, right
letter) pairs; a state emits the genome letter (error rate pr_snp) and the
colour between its two letters (error rate from the colour's quality value).
Outputs:

  1. ``posterior`` — Pr[read | location] summed over all alignments
     respecting the current gaps (`post_sw`, sw-post.c:603-720), including
     the gap open/extend priors (`get_posterior`, :575-597).
  2. per-base qualities for the called letters (`get_base_qualities`,
     :556-572), emitted as the SAM QUAL string.

The arithmetic replicates the reference operation-for-operation in float64
(including the per-column min-scaling and the sequential summation order) so
quality strings and neglog-quantized Z fields match byte-for-byte.

Three forms: `post_sw` (one alignment, the scalar walk) and `post_sw_batch`
(rendered alignments, vectorized over hits) take the dbalign / qralign
strings; `post_sw_packed` takes pass 2's rows as K7+K8 leave them (stats,
traceback ops, windows, letter decodings) with the batch's reads, and runs
the CUDA kernel `csrc/post_sw.cu` for CUDA tensors or its plain version
(`post_sw_packed_plain`, bit-equal to `post_sw_batch` through the shared
`_fwbw`) for CPU ones.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from shrimp_tpu_torch import _build, mapq
from shrimp_tpu_torch.ops.params import ScoreProbs
from shrimp_tpu_torch.ops.sw_full_cs import OP_DEL, OP_INS, OP_MATCH

BASE_N = 15
HUGE = math.inf

_LEFT = np.arange(16) >> 2 & 3
_RIGHT = np.arange(16) & 3


def _node_priors(has_let, let, pr_snp, col, colerr):
    """-log emission for the 16 states of one column (nodePrior,
    sw-post.c:115-143)."""
    val = np.zeros(16)
    if has_let:
        val = val - np.where(_RIGHT == let,
                             math.log(1 - pr_snp), math.log(pr_snp / 3.0))
    emit_col = (_LEFT ^ _RIGHT)
    val = val - np.where(emit_col == col,
                         math.log(1 - colerr), math.log(colerr / 3.0))
    return val


def post_sw_batch(items: list[dict], probs: ScoreProbs, *,
                  qual_delta: int = 33, qual_vector_offset: int = 0,
                  use_sanger_qvs: bool = True) -> list[tuple[float, str]]:
    """Vectorized-across-hits forward/backward.

    Each item: {colours, initbp, qual (str|None), read_start, dbalign,
    qralign}.  Per-element float operations and summation chains are
    identical to post_sw, so results are bit-equal; only the hit axis is
    vectorized."""
    H = len(items)
    if H == 0:
        return []
    cols_all = []
    meta = []
    for it in items:
        cols = _load_columns(it["colours"], it["qual"], it["read_start"],
                             it["dbalign"], it["qralign"], probs,
                             qual_delta, qual_vector_offset, use_sanger_qvs)
        cols_all.append(cols)
        meta.append(it)
    L = max(len(c[0]) for c in cols_all)
    has_let = np.zeros((H, L), bool)
    lets = np.zeros((H, L), np.int64)
    colv = np.zeros((H, L), np.int64)
    colerr = np.full((H, L), 0.5)
    bcall = np.zeros((H, L), np.int64)
    lens = np.zeros(H, np.int64)
    initbps = np.array([it["initbp"] for it in items], np.int64)
    for h, (hl, lt, cv, ce, bc) in enumerate(cols_all):
        n = len(hl)
        lens[h] = n
        has_let[h, :n] = hl
        lets[h, :n] = lt
        colv[h, :n] = cv
        colerr[h, :n] = ce
        bcall[h, :n] = bc

    total, qv = _fwbw(has_let, lets, colv, colerr, bcall, lens, initbps,
                      probs.pr_mismatch)

    out = []
    for h, it in enumerate(items):
        n = int(lens[h])
        qual33 = "".join(chr(33 + int(q)) for q in qv[h, :n])
        res = math.exp(-float(total[h]))
        dbalign = it["dbalign"]
        qralign = it["qralign"]
        for i in range(len(dbalign)):
            if dbalign[i] == "-":
                res *= probs.pr_ins_extend
                if i == 0 or dbalign[i - 1] != "-":
                    res *= probs.pr_ins_open
            elif qralign[i] == "-":
                res *= probs.pr_del_extend
                if i == 0 or qralign[i - 1] != "-":
                    res *= probs.pr_del_open
        out.append((res, qual33))
    return out


def _fwbw(has_let, lets, colv, colerr, bcall, lens, initbps, pr_snp):
    """The forward/backward over [H, L] column arrays (do_forwards,
    do_backwards, post_traceback: sw-post.c:183-366), shared by
    `post_sw_batch` and `post_sw_packed_plain`.  Returns each hit's
    -log Pr[read | location] (`total`, float64 [H]) and its per-column
    base qualities (int64 [H, L], capped at 40, 0 for an N call)."""
    H, L = colv.shape
    # NP[h, i, j]: -log emission (nodePrior) — two chained subtractions
    let_term = np.where(_RIGHT[None, None, :] == lets[:, :, None],
                        math.log(1 - pr_snp), math.log(pr_snp / 3.0))
    NP = np.where(has_let[:, :, None], 0.0 - let_term, 0.0)
    emit_col = (_LEFT ^ _RIGHT)[None, None, :]
    col_match = emit_col == colv[:, :, None]
    NP = NP - np.where(col_match, np.log(1 - colerr)[:, :, None],
                       np.log(colerr / 3.0)[:, :, None])

    pred = np.stack([(_LEFT + 4 * m) for m in range(4)])
    succ = np.stack([(_RIGHT * 4 + m) for m in range(4)])

    F = np.empty((H, L, 16))
    fscale = np.zeros((H, L))
    f0 = np.where(_LEFT[None, :] == initbps[:, None], NP[:, 0, :], HUGE)
    fscale[:, 0] = np.min(f0, axis=1)
    F[:, 0, :] = f0 - fscale[:, 0:1]
    for i in range(1, L):
        e = np.exp(-F[:, i - 1, :])
        s = e[:, pred[0]]
        s = s + e[:, pred[1]]
        s = s + e[:, pred[2]]
        s = s + e[:, pred[3]]
        row = NP[:, i, :] - np.log(s)
        sc = np.min(row, axis=1)
        F[:, i, :] = row - sc[:, None]
        fscale[:, i] = sc + fscale[:, i - 1]

    # totals at each hit's final column
    idx_last = lens - 1
    ef = np.exp(-F[np.arange(H), idx_last])
    tot = ef[:, 0].copy()
    for j in range(1, 16):
        tot = tot + ef[:, j]
    total = -np.log(tot) + fscale[np.arange(H), idx_last]

    Bk = np.zeros((H, L, 16))
    bscale = np.zeros((H, L))
    for i in range(L - 2, -1, -1):
        e = np.exp(-(NP[:, i + 1, :] + Bk[:, i + 1, :]))
        s = e[:, succ[0]]
        s = s + e[:, succ[1]]
        s = s + e[:, succ[2]]
        s = s + e[:, succ[3]]
        row = -np.log(s)
        sc = np.min(row, axis=1)
        row = row - sc[:, None]
        bs = sc + bscale[:, i + 1]
        # a hit whose last column is i restarts here (B = 0, scale 0)
        here_last = idx_last == i
        Bk[:, i, :] = np.where(here_last[:, None], 0.0, row)
        bscale[:, i] = np.where(here_last, 0.0, bs)

    # per-column letter posteriors and qualities
    w = np.exp(-(F + Bk + fscale[:, :, None] + bscale[:, :, None]
                 - total[:, None, None]))
    post = np.zeros((H, L, 4))
    for jj in range(16):
        post[:, :, _RIGHT[jj]] += w[:, :, jj]
    bc_post = np.take_along_axis(
        post, np.minimum(bcall, 3)[:, :, None], axis=2)[:, :, 0]
    pr_err = 1 - bc_post
    qv = np.where(pr_err > 0.99999999, 0,
                  np.where(pr_err < 1e-25, 250,
                           np.trunc(-10.0 * np.log(np.maximum(pr_err, 1e-300))
                                    / math.log(10.0)))).astype(np.int64)
    qv = np.where(bcall == BASE_N, 0, qv)
    return total, np.minimum(qv, 40)


def _load_columns(colours, qual, read_start, dbalign, qralign, probs,
                  qual_delta, qual_vector_offset, use_sanger_qvs):
    """load_local_vectors (sw-post.c:472-552) -> per-column arrays.

    Vectorized: one pass of byte-array ops per hit; the per-element float
    math (10**(-q/10), the non-Sanger transform, the 0.75 cap) is identical
    to the scalar walk, so results stay bit-equal."""
    from shrimp_tpu_torch import dna

    use_read_qvs = qual is not None
    pre = np.asarray(colours[:read_start])
    if len(pre) and ((pre < 0) | (pre > 3)).any():
        start_run = BASE_N
        min_qv = 0
    else:
        start_run = int(np.bitwise_xor.reduce(pre)) if len(pre) else 0
        min_qv = 10000
        if use_read_qvs and read_start:
            qpre = np.frombuffer(
                qual.encode("latin-1"), np.uint8
            )[qual_vector_offset:qual_vector_offset + read_start]
            min_qv = int(qpre.min())

    db = np.frombuffer(dbalign.encode("latin-1"), np.uint8)
    qr = np.frombuffer(qralign.encode("latin-1"), np.uint8)
    keep = qr != ord("-")
    dbk = db[keep]
    qrk = qr[keep]
    n = len(dbk)
    j = read_start + np.arange(n)

    has_let = dbk != ord("-")
    code_db = dna.CHAR_TO_CODE[dbk].astype(np.int64)
    lets = np.where(has_let, np.where((code_db >= 0) & (code_db <= 3),
                                      code_db, BASE_N), 0)
    c = np.asarray(colours)[j].astype(np.int64)
    first = np.arange(n) == 0
    forced = (first & (start_run == BASE_N)) | (c == BASE_N)
    cols = np.where(forced, 0,
                    np.where(first, c ^ (0 if start_run == BASE_N
                                         else start_run), c))
    if use_read_qvs:
        qj = np.frombuffer(qual.encode("latin-1"), np.uint8
                           )[qual_vector_offset + j].astype(np.int64)
        q = np.where(first, np.minimum(min_qv, qj), qj) - qual_delta
        err = np.where(q <= 0, 0.99999999,
                       np.where(q >= 250, 1e-25, 10.0 ** (-q / 10.0)))
        if not use_sanger_qvs:
            err = err / (1 + err)
        err = np.where(err > .75, .75, err)
    else:
        err = np.full(n, probs.pr_xover)
    colerrs = np.where(forced, .75, err)

    code_qr = dna.CHAR_TO_CODE[qrk].astype(np.int64)
    base_calls = np.where((code_qr >= 0) & (code_qr <= 3), code_qr, BASE_N)
    return has_let, lets, cols, colerrs, base_calls


def post_sw(colours: np.ndarray, initbp: int, qual: str | None,
            read_start: int, dbalign: str, qralign: str,
            probs: ScoreProbs, *,
            qual_delta: int = 33, qual_vector_offset: int = 0,
            use_sanger_qvs: bool = True) -> tuple[float, str]:
    """Forward/backward over one alignment; returns (posterior, qual33).

    colours: the full forward colour read (int codes); read_start: first
    aligned colour index; dbalign/qralign: alignment strings from the CS
    traceback (qralign lowercase = crossover).
    """
    use_read_qvs = qual is not None
    if not use_read_qvs:
        default_qual = mapq.qv_from_pr_err(probs.pr_xover)

    # --- load_local_vectors (sw-post.c:472-552) ---
    # fold any clipped prefix colours into the first aligned column
    start_run = 0
    min_qv = 10000
    for j in range(read_start):
        c = int(colours[j])
        if c == BASE_N:
            start_run = BASE_N
            min_qv = 0
            break
        start_run ^= c
        if use_read_qvs:
            min_qv = min(min_qv, ord(qual[qual_vector_offset + j]))

    has_let: list[bool] = []
    lets: list[int] = []
    cols: list[int] = []
    colerrs: list[float] = []
    base_calls: list[int] = []
    j = read_start
    for i in range(len(dbalign)):
        qc = qralign[i]
        if qc == "-":
            continue
        dc = dbalign[i]
        if dc != "-":
            has_let.append(True)
            lets.append("ACGT".index(dc.upper()) if dc.upper() in "ACGT"
                        else BASE_N)
        else:
            has_let.append(False)
            lets.append(0)
        c = int(colours[j])
        n0 = len(cols)
        if (n0 == 0 and start_run == BASE_N) or c == BASE_N:
            cols.append(0)
            colerrs.append(.75)
        else:
            cols.append(c ^ (start_run if n0 == 0 else 0))
            if use_read_qvs:
                q = (min(min_qv, ord(qual[qual_vector_offset + j]))
                     if n0 == 0 else ord(qual[qual_vector_offset + j]))
                err = mapq.pr_err_from_qv(q - qual_delta)
                if not use_sanger_qvs:
                    err = err / (1 + err)
                if err > .75:
                    err = .75
                colerrs.append(err)
            else:
                colerrs.append(probs.pr_xover)
        u = qc.upper()
        base_calls.append("ACGT".index(u) if u in "ACGT" else BASE_N)
        j += 1

    n = len(cols)
    pr_snp = probs.pr_mismatch

    NP = np.empty((n, 16))
    for i in range(n):
        NP[i] = _node_priors(has_let[i], lets[i], pr_snp, cols[i], colerrs[i])

    # --- forwards (do_forwards, sw-post.c:322-366) ---
    F = np.empty((n, 16))
    fscale = np.empty(n)
    f0 = np.where(_LEFT == initbp, NP[0], HUGE)
    fscale[0] = np.min(np.where(_LEFT == initbp, NP[0], HUGE))
    F[0] = f0 - fscale[0]
    # transition: state j at column i sums predecessors k with
    # right(k) == left(j); k = left(j) + 4*m in ascending order
    pred = np.stack([(_LEFT + 4 * m) for m in range(4)])    # [4, 16]
    for i in range(1, n):
        e = np.exp(-F[i - 1])
        s = e[pred[0]]
        s = s + e[pred[1]]
        s = s + e[pred[2]]
        s = s + e[pred[3]]
        row = NP[i] - np.log(s)
        sc = np.min(row)
        F[i] = row - sc
        fscale[i] = sc + fscale[i - 1]

    ef = np.exp(-F[n - 1])
    tot = ef[0]
    for j in range(1, 16):
        tot = tot + ef[j]
    total = -math.log(tot) + fscale[n - 1]

    # --- backwards (do_backwards, sw-post.c:270-320) ---
    Bk = np.empty((n, 16))
    bscale = np.empty(n)
    Bk[n - 1] = 0.0
    bscale[n - 1] = 0.0
    succ = np.stack([(_RIGHT * 4 + m) for m in range(4)])   # [4, 16]
    for i in range(n - 2, -1, -1):
        e = np.exp(-(NP[i + 1] + Bk[i + 1]))
        s = e[succ[0]]
        s = s + e[succ[1]]
        s = s + e[succ[2]]
        s = s + e[succ[3]]
        row = -np.log(s)
        sc = np.min(row)
        Bk[i] = row - sc
        bscale[i] = sc + bscale[i + 1]

    # --- per-column letter posteriors (post_traceback, sw-post.c:183-208) ---
    qual_chars = []
    for i in range(n):
        w = np.exp(-(F[i] + Bk[i] + fscale[i] + bscale[i] - total))
        post = np.zeros(4)
        for jj in range(16):
            post[_RIGHT[jj]] += w[jj]
        bc = base_calls[i]
        tmp = mapq.qv_from_pr_corr(post[bc]) if bc != BASE_N else 0
        if tmp > 40:
            tmp = 40
        qual_chars.append(chr(33 + tmp))

    # --- alignment posterior with gap priors (get_posterior, :575-597) ---
    res = math.exp(-total)
    for i in range(len(dbalign)):
        if dbalign[i] == "-":
            res *= probs.pr_ins_extend
            if i == 0 or dbalign[i - 1] != "-":
                res *= probs.pr_ins_open
        elif qralign[i] == "-":
            res *= probs.pr_del_extend
            if i == 0 or qralign[i - 1] != "-":
                res *= probs.pr_del_open
    return res, "".join(qual_chars)


# ---------------------------------------------------------------------------
# The packed form: the posterior of pass 2's rows read from K7+K8's outputs
# (stats, traceback ops) where they lie, with no rendered strings.
# launches of the post_sw kernel
LAUNCHES = _build.LaunchCounter()


def _colerr_bytes(qual_delta: int, use_sanger_qvs: bool) -> np.ndarray:
    """The colour error of each raw quality byte, float64 [256]: the
    elementwise arithmetic of `_load_columns` (10 ** (-q / 10), the
    non-Sanger transform, the 0.75 cap) on every byte at once."""
    q = np.arange(256, dtype=np.int64) - qual_delta
    err = np.where(q <= 0, 0.99999999,
                   np.where(q >= 250, 1e-25, 10.0 ** (-q / 10.0)))
    if not use_sanger_qvs:
        err = err / (1 + err)
    return np.where(err > .75, .75, err)


def emission_table(probs: ScoreProbs, qual_delta: int,
                   use_sanger_qvs: bool) -> np.ndarray:
    """The kernel's emission terms, float64 [2 * 258 + 2]: log(1 - err)
    for the 258 error classes, then log(err / 3) for them, then
    log(1 - pr_snp) and log(pr_snp / 3), each computed as `_fwbw` computes
    it, so the kernel's node priors are the plain version's bit for bit.
    The classes: the 256 raw quality bytes, then a forced column (an N
    colour, or the first column after an N in the clipped prefix: 0.75),
    then a read without qualities (the crossover probability)."""
    err = np.concatenate([_colerr_bytes(qual_delta, use_sanger_qvs),
                          [.75, probs.pr_xover]])
    pr_snp = probs.pr_mismatch
    return np.concatenate([np.log(1 - err), np.log(err / 3.0),
                           [math.log(1 - pr_snp), math.log(pr_snp / 3.0)]])


def post_sw_packed_plain(ops, stats, genome, qr4, rid, thresh, colours, qual,
                         has_qual, initbp, probs: ScoreProbs, *,
                         qual_delta: int = 33, qual_vector_offset: int = 0,
                         use_sanger_qvs: bool = True):
    """The packed posterior, plain version (CPU tensors).  The columns of
    every kept row come from its ops at once, as `render_alignment_cs`
    and `_load_columns` derive them from the rendered strings; then the
    forward/backward of `post_sw_batch` (`_fwbw`).  Equal to
    `post_sw_batch` on the rendered rows bit for bit.  Inputs and outputs
    as `post_sw_packed`."""
    _build.require_cpu(ops, stats, genome, qr4, rid, thresh, colours, qual,
                       has_qual, initbp)
    ops, stats, genome, qr4, rid, thresh, colours, qual, has_qual, initbp = (
        t.numpy() for t in (ops, stats, genome, qr4, rid, thresh, colours,
                            qual, has_qual, initbp))
    N, R = qr4.shape[0], qr4.shape[2]
    posterior = np.zeros(N, np.float64)
    qv_out = np.zeros((N, R), np.uint8)
    score = stats[:, 0].astype(np.int64)
    rows = np.flatnonzero((score > 0) & (score >= thresh))
    H = len(rows)
    if H == 0:
        return torch.from_numpy(posterior), torch.from_numpy(qv_out)
    st = stats[rows].astype(np.int64)
    rs, gs, ops_len = st[:, 1], st[:, 2], st[:, 9]
    rd = rid[rows].astype(np.int64)
    T = int(ops_len.max())

    # the alignment columns (render_alignment_cs)
    t_ax = np.arange(T)
    valid = t_ax[None, :] < ops_len[:, None]
    op = ops[rows, :T].astype(np.int64)
    typ = np.where(valid, op & 3, -1)
    k = (op >> 2) & 3
    cg = valid & (typ != OP_DEL)
    cr = valid & (typ != OP_INS)
    gi = gs[:, None] + np.cumsum(cg, axis=1) - cg
    ri = rs[:, None] + np.cumsum(cr, axis=1) - cr
    G = genome.shape[1]
    gcode = genome[rows[:, None], np.clip(gi, 0, G - 1)].astype(np.int64) & 15
    qcode = qr4[rows[:, None], k, np.clip(ri, 0, R - 1)].astype(np.int64) & 15
    qcode = np.where((typ == OP_MATCH) & (qcode == 15), gcode, qcode)

    # the read-consuming columns, packed to [H, L] (load_local_vectors)
    lens = cr.sum(axis=1)
    L = int(lens.max())
    h_i, t_i = np.nonzero(cr)
    c_i = (np.cumsum(cr, axis=1) - 1)[h_i, t_i]
    in_col = np.arange(L)[None, :] < lens[:, None]
    has_let = np.zeros((H, L), bool)
    has_let[h_i, c_i] = typ[h_i, t_i] == OP_MATCH
    g_col = np.zeros((H, L), np.int64)
    g_col[h_i, c_i] = gcode[h_i, t_i]
    lets = np.where(has_let, np.where(g_col <= 3, g_col, BASE_N), 0)
    bcall = np.zeros((H, L), np.int64)
    bcall[h_i, c_i] = np.where(qcode[h_i, t_i] <= 3, qcode[h_i, t_i], BASE_N)

    # the clipped prefix folded into the first column
    RC = colours.shape[1]
    crow = colours[rd].astype(np.int64)
    in_pre = np.arange(RC)[None, :] < rs[:, None]
    bad = (in_pre & ((crow < 0) | (crow > 3))).any(axis=1)
    start_run = np.bitwise_xor.reduce(np.where(in_pre, crow, 0), axis=1)
    start_run = np.where(bad, BASE_N, start_run)
    use_q = has_qual[rd].astype(bool)
    qrow = qual[rd].astype(np.int64)
    off = qual_vector_offset
    Q = qual.shape[1]
    q_pre = np.arange(Q)[None, :] - off
    in_qpre = (q_pre >= 0) & (q_pre < rs[:, None])
    min_qv = np.where(in_qpre, qrow, 10000).min(axis=1, initial=10000)

    j = rs[:, None] + np.arange(L)[None, :]
    c = np.take_along_axis(crow, np.clip(j, 0, RC - 1), axis=1)
    first = np.arange(L)[None, :] == 0
    forced = (first & (start_run == BASE_N)[:, None]) | (c == BASE_N)
    colv = np.where(forced, 0,
                    np.where(first, c ^ np.where(start_run == BASE_N, 0,
                                                 start_run)[:, None], c))
    qj = np.take_along_axis(qrow, np.clip(off + j, 0, Q - 1), axis=1)
    qb = np.where(first, np.minimum(min_qv[:, None], qj), qj)
    err = np.where(use_q[:, None],
                   _colerr_bytes(qual_delta, use_sanger_qvs)[
                       np.clip(qb, 0, 255)], probs.pr_xover)
    colerr = np.where(in_col, np.where(forced, .75, err), 0.5)
    colv = np.where(in_col, colv, 0)

    total, qv = _fwbw(has_let, lets, colv, colerr, bcall, lens,
                      initbp[rd].astype(np.int64), probs.pr_mismatch)

    # get_posterior: the gap priors multiplied in alignment order
    res = np.array([math.exp(-t) for t in total.tolist()])
    dl = typ == OP_DEL
    ins = typ == OP_INS
    for t in range(T):
        d_open = dl[:, t] & (~dl[:, t - 1] if t else True)
        i_open = ins[:, t] & (~ins[:, t - 1] if t else True)
        res = np.where(dl[:, t], res * probs.pr_ins_extend, res)
        res = np.where(d_open, res * probs.pr_ins_open, res)
        res = np.where(ins[:, t], res * probs.pr_del_extend, res)
        res = np.where(i_open, res * probs.pr_del_open, res)
    posterior[rows] = res
    qv_out[rows, :L] = np.where(in_col, qv, 0).astype(np.uint8)
    return torch.from_numpy(posterior), torch.from_numpy(qv_out)


_LIB = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("post_sw")
        vp, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        lib.post_sw_launch.restype = ctypes.c_int
        lib.post_sw_launch.argtypes = [
            vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp,
            i, i, i, i, i, i, i, i, d, d, d, d, d, vp, vp, vp, vp]
        lib.post_sw_plan.restype = ctypes.c_int
        lib.post_sw_plan.argtypes = [i, ctypes.POINTER(ctypes.c_int)]
        _LIB = lib
    return _LIB


def launch_plan(R: int) -> dict:
    """The kernel's shape for reads of R columns, as its launcher fixes
    it: whether a row's forward sweep is kept in shared memory, and the
    global scratch bytes a row needs when it is not."""
    out = (ctypes.c_int * 2)()
    _lib().post_sw_plan(R, out)
    return dict(zip(("staged", "scratch_per_row"), out))


def post_sw_packed_cuda(ops, stats, genome, qr4, rid, thresh, colours, qual,
                        has_qual, initbp, probs: ScoreProbs, *,
                        qual_delta: int = 33, qual_vector_offset: int = 0,
                        use_sanger_qvs: bool = True):
    """The packed posterior on the card, one launch (`csrc/post_sw.cu`).
    Inputs and outputs as `post_sw_packed`, on one CUDA device."""
    dev = ops.device
    if dev.type != "cuda":
        raise ValueError(f"the post_sw kernel needs CUDA tensors; got {dev}")
    for name, t, dtype, ndim in (
            ("ops", ops, torch.uint8, 2), ("stats", stats, torch.int32, 2),
            ("genome", genome, torch.int8, 2), ("qr4", qr4, torch.int8, 3),
            ("rid", rid, torch.int32, 1), ("thresh", thresh, torch.int32, 1),
            ("colours", colours, torch.int8, 2),
            ("qual", qual, torch.uint8, 2),
            ("has_qual", has_qual, torch.bool, 1),
            ("initbp", initbp, torch.int8, 1)):
        _build.check_tensor(name, t, dtype, ndim, dev)
    N, R = qr4.shape[0], qr4.shape[2]
    B = colours.shape[0]
    if (qr4.shape[1] != 4 or stats.shape[0] != N or stats.shape[1] < 10
            or ops.shape[0] != N or genome.shape[0] != N
            or rid.shape[0] != N or thresh.shape[0] != N):
        raise ValueError("post_sw: ops, stats, genome, qr4 [N, 4, R], rid "
                         "and thresh must have a row each for N rows")
    if qual.shape[0] != B or has_qual.shape[0] != B or initbp.shape[0] != B:
        raise ValueError("post_sw: colours, qual, has_qual and initbp must "
                         "have a row each for the batch's reads")
    posterior = torch.empty(N, dtype=torch.float64, device=dev)
    qv = torch.empty((N, R), dtype=torch.uint8, device=dev)
    if N == 0:
        return posterior, qv
    lib = _lib()
    per = launch_plan(R)["scratch_per_row"]
    scratch = torch.empty(N * per, dtype=torch.uint8, device=dev)
    table = torch.from_numpy(emission_table(
        probs, qual_delta, use_sanger_qvs)).to(dev)
    p = probs
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.post_sw_launch(
            ops.data_ptr(), stats.data_ptr(), genome.data_ptr(),
            qr4.data_ptr(), rid.data_ptr(), thresh.data_ptr(),
            colours.data_ptr(), qual.data_ptr(), has_qual.data_ptr(),
            initbp.data_ptr(), table.data_ptr(), N, int(ops.shape[1]),
            int(stats.shape[1]), int(genome.shape[1]), R,
            int(colours.shape[1]), int(qual.shape[1]),
            int(qual_vector_offset), p.pr_ins_open, p.pr_ins_extend,
            p.pr_del_open, p.pr_del_extend, math.log(10.0),
            scratch.data_ptr(), posterior.data_ptr(), qv.data_ptr(), stream)
    _build.check_launch(lib, "post_sw", rc)
    LAUNCHES.add()
    return posterior, qv


def post_sw_packed(ops, stats, genome, qr4, rid, thresh, colours, qual,
                   has_qual, initbp, probs: ScoreProbs, *,
                   qual_delta: int = 33, qual_vector_offset: int = 0,
                   use_sanger_qvs: bool = True):
    """The posterior of pass 2's colour-space rows, from K7+K8's outputs:
    the kernel for CUDA tensors, the plain version for CPU ones.

    Per row n of N: ops uint8 [N, T] (type | layer << 2 | OP_XOVER, the
    first stats[n, 9] in alignment order), stats int32 [N, >= 10] (score,
    read_start, genome_start, ..., ops_len at column 9), genome int8
    [N, G] (the row's window), qr4 int8 [N, 4, R] (its letter decodings),
    rid int32 [N] (its read), thresh int32 [N] (the least score kept).
    Per read b of the batch: colours int8 [B, >= read length] (the forward
    colours), qual uint8 [B, Q] (the raw quality bytes, read from
    qual_vector_offset on), has_qual bool [B] (False: no qualities, or
    ignored), initbp int8 [B].  Rows with a score of at least 1 and at
    least thresh get posterior float64 [N] (Pr[read | location] with the
    gap priors: post_sw's first output) and qv uint8 [N, R] (the base
    qualities of their read-consuming columns, 0 past them: post_sw's
    QUAL less 33); other rows get 0."""
    kw = dict(qual_delta=qual_delta, qual_vector_offset=qual_vector_offset,
              use_sanger_qvs=use_sanger_qvs)
    args = (ops, stats, genome, qr4, rid, thresh, colours, qual, has_qual,
            initbp, probs)
    if ops.device.type == "cuda":
        return post_sw_packed_cuda(*args, **kw)
    return post_sw_packed_plain(*args, **kw)
