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
"""

from __future__ import annotations

import math

import numpy as np

from shrimp_tpu_torch import mapq
from shrimp_tpu_torch.ops.params import ScoreProbs

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

    pr_snp = probs.pr_mismatch
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
    qv = np.minimum(qv, 40)

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
