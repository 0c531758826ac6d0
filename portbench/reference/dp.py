"""The best score of a read aligned end to end against any stretch of a
genome window, with SHRiMP2's affine gaps (Gotoh), for many reads at
once; and the score of one stated alignment.

`sat` (the control) saturates every sum to the signed 8-bit range, as a
striped 8-bit Smith-Waterman would.
"""

from __future__ import annotations

import numpy as np

from reference.params import Scores

NEG = -(1 << 20)


def _clip(a, sat: bool):
    return np.clip(a, -128, 127) if sat else a


def best_semiglobal(reads: np.ndarray, rlen: np.ndarray,
                    wins: np.ndarray, wlen: np.ndarray, s: Scores,
                    sat: bool = False) -> np.ndarray:
    """reads int [N, R] (codes 0-3), rlen [N]; wins int [N, W], wlen
    [N].  The best score of aligning all rlen[n] read bases to any
    substring of wins[n, :wlen[n]]: the genome's ends are free, the
    read's are not.  Three states, as SHRiMP2's full SW has them: a
    diagonal step from any state; a gap in the genome (CIGAR I), opened
    from a diagonal cell or extended; a gap in the read (CIGAR D),
    opened from a diagonal cell or extended."""
    N, R = reads.shape
    W = wins.shape[1]
    cols = np.arange(W + 1)
    valid = cols[None, :] <= wlen[:, None]          # column 0: no base yet
    # the row before the read: every genome start is free
    diag = np.zeros((N, W + 1), np.int64)
    ins = np.full((N, W + 1), s.ins_open, np.int64)
    dele = np.full((N, W + 1), s.del_open, np.int64)
    best = np.full(N, NEG, np.int64)
    io = s.ins_open + s.ins_extend
    do = s.del_open + s.del_extend
    ramp = -s.del_extend * cols[None, :]             # >= 0
    for i in range(R):
        top = np.maximum(np.maximum(diag, ins), dele)
        ins = _clip(np.maximum(diag + io, ins + s.ins_extend), sat)
        sub = np.where(reads[:, i:i + 1] == wins, s.match, s.mismatch)
        diag = np.full((N, W + 1), NEG, np.int64)
        diag[:, 1:] = _clip(top[:, :-1] + sub, sat)
        diag = np.where(valid, diag, NEG)
        # dele[j] = max over k < j of diag[k] + open + extend
        #           + (j - 1 - k) extend
        run = np.maximum.accumulate(diag + ramp, axis=1)
        dele = np.full((N, W + 1), NEG, np.int64)
        dele[:, 1:] = run[:, :-1] - ramp[:, 1:] + do - s.del_extend
        dele = np.where(valid, _clip(np.maximum(dele, NEG), sat), NEG)
        ins = np.where(valid, ins, NEG)
        last = i == rlen - 1
        if last.any():
            row = np.maximum(np.maximum(diag, ins), dele).max(axis=1)
            best = np.where(last, np.maximum(best, row), best)
    return best


def path_score(read: np.ndarray, genome: np.ndarray, cigar: list,
               s: Scores, sat: bool = False) -> dict:
    """Score, mismatches and gap bases of the alignment `cigar` of
    `read` (codes, in the record's orientation) starting at genome[0];
    clipped bases score nothing.  None if the path leaves the genome
    slice or the read."""
    i = j = 0
    score = mism = ins = dels = 0
    for n, op in cigar:
        if op == "M":
            if i + n > len(read) or j + n > len(genome):
                return None
            eq = read[i:i + n] == genome[j:j + n]
            k = int(eq.sum())
            if sat:
                for e in eq:
                    score = int(_clip(score + (s.match if e else s.mismatch),
                                      True))
            else:
                score += k * s.match + (n - k) * s.mismatch
            mism += n - k
            i += n
            j += n
        elif op == "I":
            score = int(_clip(score + s.ins_open + n * s.ins_extend, sat))
            ins += n
            i += n
        elif op == "D":
            score = int(_clip(score + s.del_open + n * s.del_extend, sat))
            dels += n
            j += n
        elif op in "SH":
            i += n if op == "S" else 0
        else:
            return None
    if i > len(read) or j > len(genome):
        return None
    return {"score": score, "mismatches": mism, "ins": ins, "dels": dels,
            "read_used": i, "genome_used": j}


def best_colour(colours: np.ndarray, initbp: np.ndarray, xo: np.ndarray,
                rlen: np.ndarray, wins: np.ndarray, wlen: np.ndarray,
                s: Scores) -> np.ndarray:
    """colours int [N, R] (0-3), initbp [N] (the primer's letter), xo
    [N, R] the score of a crossover at each colour, rlen [N]; wins int
    [N, W] (letter codes), wlen [N].  The best score of aligning all
    rlen[n] colours of read n end to end to any substring of
    wins[n, :wlen[n]], in SHRiMP2's colour-space model: the read is a
    letter at each colour, a letter whose colour with the letter before
    (the primer's before the first) is not the read's colour is a
    crossover and scores xo at that colour; letters score match or
    mismatch against the genome, gaps are affine as in letter space.
    Three states a letter, as `best_semiglobal`: a diagonal step from
    any state, a gap in the genome (CIGAR I: a letter against no base,
    which still has its colour) opened from a diagonal cell or extended,
    a gap in the read (CIGAR D: bases against no letter, which keep the
    letter) opened from a diagonal cell or extended."""
    N, R = colours.shape
    W = wins.shape[1]
    cols = np.arange(W + 1)
    valid = (cols[None, :] <= wlen[:, None])[:, None, :]    # [N, 1, W + 1]
    letters = np.arange(4)
    io = s.ins_open + s.ins_extend
    do = s.del_open + s.del_extend
    ramp = -s.del_extend * cols[None, None, :]
    sub = np.where(letters[None, :, None] == wins[:, None, :], s.match,
                   s.mismatch)                             # [N, 4, W]
    best = np.full(N, NEG, np.int64)
    rows = np.arange(N)
    # the row before the read: the primer's letter, every start free
    prev_top = np.full((N, 4, W + 1), NEG, np.int64)
    prev_top[rows, initbp] = 0
    prev_ins_src = np.full((N, 4, W + 1), NEG, np.int64)
    prev_ins_src[rows, initbp] = io
    for i in range(R):
        # letter l after letter m is no crossover where m ^ l is the
        # read's colour
        same = letters[None, :] ^ colours[:, i:i + 1]      # [N, 4]: m of l
        x = xo[:, i][:, None, None]

        def cross(src):
            keep = np.take_along_axis(src, same[:, :, None], axis=1)
            return np.maximum(keep, src.max(axis=1, keepdims=True) + x)

        diag_src = cross(prev_top)
        diag = np.full((N, 4, W + 1), NEG, np.int64)
        diag[:, :, 1:] = diag_src[:, :, :-1] + sub
        diag = np.where(valid, diag, NEG)
        ins = np.where(valid, cross(prev_ins_src), NEG)
        run = np.maximum.accumulate(diag + ramp, axis=2)
        dele = np.full((N, 4, W + 1), NEG, np.int64)
        dele[:, :, 1:] = run[:, :, :-1] - ramp[:, :, 1:] + do - s.del_extend
        dele = np.where(valid, np.maximum(dele, NEG), NEG)
        top = np.maximum(np.maximum(diag, ins), dele)
        last = i == rlen - 1
        if last.any():
            best = np.where(last, np.maximum(best, top.max(axis=(1, 2))),
                            best)
        prev_top = top
        prev_ins_src = np.maximum(diag + io, ins + s.ins_extend)
    return best
