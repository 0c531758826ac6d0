"""SHRiMP2 v2.2.2's default scores (gmapper-defaults.h) and the
probabilities it derives from them (gmapper.c, the alpha / beta of the
score <-> log-probability map and the posterior's gap priors).

The arithmetic is stated as the reference states it, in float64, so
that the quantised fields it feeds (Z0 / Z1 at 1000 x -ln, MQV, base
qualities) come out as the reference prints them.  `dtype` selects the
float type: the control computes the same in float32.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class Scores:
    match: int = 10
    mismatch: int = -15
    del_open: int = -33        # -g: a gap in the read (CIGAR D)
    del_extend: int = -7       # -e
    ins_open: int = -33        # -q: a gap in the genome (CIGAR I)
    ins_extend: int = -3       # -f
    crossover: int = -20       # colour space only (-x)


LETTER = Scores()
COLOUR = Scores(mismatch=-24)


@dataclass(frozen=True)
class Probs:
    alpha: float
    beta: float
    pr_mismatch: float
    pr_xover: float
    pr_del_open: float
    pr_del_extend: float
    pr_ins_open: float
    pr_ins_extend: float


def probs(s: Scores, colour: bool, dtype=np.float64) -> Probs:
    f = dtype
    log2 = f(math.log(2.0))
    if colour:
        pr_xover = f(0.03)
        alpha = f(s.crossover) / (f(np.log(pr_xover / f(3))) / log2)
        pr_mismatch = f(1.0) / (f(1.0) + (f(1.0) / f(3.0))
                                * f(2.0) ** ((f(s.match - s.mismatch))
                                             / alpha))
    else:
        pr_mismatch = f(0.01)
        pr_xover = f(0.0)
        alpha = f(s.match - s.mismatch) / (
            f(np.log((f(1) - pr_mismatch) / (pr_mismatch / f(3.0)))) / log2)
    beta = (f(s.match) - f(2) * alpha
            - alpha * f(np.log(f(1) - pr_mismatch)) / log2)
    return Probs(
        alpha=alpha, beta=beta, pr_mismatch=pr_mismatch, pr_xover=pr_xover,
        pr_del_open=f(2.0) ** (f(s.del_open) / alpha),
        pr_del_extend=f(2.0) ** (f(s.del_extend) / alpha),
        pr_ins_open=f(2.0) ** (f(s.ins_open) / alpha),
        pr_ins_extend=f(2.0) ** ((f(s.ins_extend) - beta) / alpha))
