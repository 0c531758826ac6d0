"""SHRiMP2's posterior of a colour-space alignment (sw-post.c): a hidden
Markov model over the alignment's columns whose states are the pairs
(left letter, right letter) of the read's letters around a colour.  A
state emits the genome letter of its column (right letter; error rate
pr_mismatch) and the read's colour (left ^ right; error rate from the
colour's quality).  Consecutive states share a letter.  The forward
pass gives Pr[read | alignment]; forward x backward gives each called
base's posterior, printed as its quality.

Written as a scaled forward / backward over probabilities; `dtype`
float32 is the control's precision.
"""

from __future__ import annotations

import math

import numpy as np

from reference.params import Probs

LEFT = np.arange(16) >> 2
RIGHT = np.arange(16) & 3
# successor j of state k shares k's right letter as its left letter
LINK = (RIGHT[:, None] == LEFT[None, :]).astype(np.float64)   # [k, j]


def pr_err_from_qv(q):
    if q <= 0:
        return 0.99999999
    if q >= 250:
        return 1e-25
    return 10.0 ** (-q / 10.0)


def qv_from_pr_err(p: float) -> int:
    if p > 0.99999999:
        return 0
    if p < 1e-25:
        return 250
    return int(-10.0 * math.log(p) / math.log(10.0))


def columns(colours, qual, qual_delta: int, read_start: int,
            dbalign: str, qralign: str, pr: Probs):
    """Per read colour of the alignment: whether the genome has a letter
    there, the letter, the colour (the clipped prefix folded into the
    first), its error rate, and the called base."""
    pre = [int(c) for c in colours[:read_start]]
    start_run, forced_first = 0, any(c > 3 for c in pre)
    for c in pre:
        start_run ^= c
    min_q = min((ord(qual[j]) for j in range(read_start)), default=None) \
        if qual is not None else None
    out = []
    j = read_start
    for i, qc in enumerate(qralign):
        if qc == "-":
            continue
        dc = dbalign[i]
        has = dc != "-"
        let = "ACGT".find(dc.upper()) if has else 0
        c = int(colours[j])
        first = not out
        if (first and forced_first) or c > 3:
            col, err = 0, 0.75
        else:
            col = c ^ start_run if first else c
            if qual is None:
                err = pr.pr_xover
            else:
                q = ord(qual[j])
                if first and min_q is not None:
                    q = min(q, min_q)
                err = min(pr_err_from_qv(q - qual_delta), 0.75)
        call = "ACGT".find(qc.upper())
        out.append((has, let if let >= 0 else 15, col, err,
                    call if call >= 0 else 15))
        j += 1
    return out


def posterior(colours, initbp: int, qual, qual_delta: int,
              read_start: int, dbalign: str, qralign: str, pr: Probs,
              dtype=np.float64) -> tuple[float, str]:
    """(Pr of the read given the alignment, with the gap priors; the
    base-quality string, PHRED+33)."""
    f = dtype
    cols = columns(colours, qual, qual_delta, read_start, dbalign, qralign,
                   pr)
    n = len(cols)
    snp = f(pr.pr_mismatch)
    E = np.empty((n, 16), f)
    for i, (has, let, col, err, _) in enumerate(cols):
        e = np.ones(16, f)
        if has:
            e = e * np.where(RIGHT == let, f(1) - snp, snp / f(3))
        err = f(err)
        E[i] = e * np.where((LEFT ^ RIGHT) == col, f(1) - err, err / f(3))
    link = LINK.astype(f)
    F = np.empty((n, 16), f)
    scale = np.empty(n, f)
    a = np.where(LEFT == initbp, E[0], f(0))
    scale[0] = a.sum()
    F[0] = a / scale[0]
    for i in range(1, n):
        a = E[i] * (F[i - 1] @ link)
        scale[i] = a.sum()
        F[i] = a / scale[i]
    B = np.empty((n, 16), f)
    B[n - 1] = 1
    for i in range(n - 2, -1, -1):
        B[i] = link @ (E[i + 1] * B[i + 1]) / scale[i + 1]
    gamma = F * B
    quals = []
    for i, (_, _, _, _, call) in enumerate(cols):
        if call > 3:
            quals.append(chr(33))
            continue
        p_call = gamma[i][RIGHT == call].sum() / gamma[i].sum()
        quals.append(chr(33 + min(qv_from_pr_err(float(f(1) - p_call)), 40)))
    res = f(np.exp(np.log(scale).sum()))
    for i in range(len(dbalign)):
        if dbalign[i] == "-":
            res *= f(pr.pr_ins_extend)
            if i == 0 or dbalign[i - 1] != "-":
                res *= f(pr.pr_ins_open)
        elif qralign[i] == "-":
            res *= f(pr.pr_del_extend)
            if i == 0 or qralign[i - 1] != "-":
                res *= f(pr.pr_del_open)
    return float(res), "".join(quals)
