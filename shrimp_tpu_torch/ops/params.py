"""Alignment scoring parameters.

Score conventions follow the reference CLI (`gmapper/gmapper-defaults.h:44-58`):
match positive; mismatch/gap scores *negative*.  "a" gaps consume genome
characters (gap in the read; `-g/-e`, the reference's west state,
`common/sw-full-ls.c:328-353`); "b" gaps consume read characters (gap in the
genome; `-q/-f`, the north state, `sw-full-ls.c:300-325`).

Opening a gap of length L costs `open + L*extend` (both negative): the DP adds
`open+extend` on the first gap character and `extend` on each further one
(`sw-vector.c:172-179`, `sw-full-ls.c:304,332`).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
import math


@dataclass(frozen=True)
class SWParams:
    match: int = 10
    mismatch: int = -15
    a_gap_open: int = -33
    a_gap_extend: int = -7
    b_gap_open: int = -33
    b_gap_extend: int = -3
    crossover: int = -20          # colour-space only (DEF_CS_XOVER_SCORE)

    @classmethod
    def letter_space(cls) -> "SWParams":
        return cls()

    @classmethod
    def colour_space(cls) -> "SWParams":
        return cls(mismatch=-24)   # DEF_CS_MISMATCH_SCORE

    def with_(self, **kw) -> "SWParams":
        return replace(self, **kw)


@dataclass(frozen=True)
class ScoreProbs:
    """Probability parameters derived from scores (gmapper.c:2555-2573).

    alpha/beta define the score<->log-probability mapping used by the
    posterior engine and mapping qualities; pr_* are the HMM emission and
    gap open/extend probabilities.
    """

    alpha: float
    beta: float
    pr_mismatch: float
    pr_xover: float
    pr_del_open: float
    pr_del_extend: float
    pr_ins_open: float
    pr_ins_extend: float

    @classmethod
    def from_scores(cls, p: SWParams, colour_space: bool) -> "ScoreProbs":
        log2 = math.log(2.0)
        if colour_space:
            pr_xover = 0.03
            alpha = p.crossover / (math.log(pr_xover / 3) / log2)
            pr_mismatch = 1.0 / (
                1.0 + (1.0 / 3.0) * 2.0 ** ((p.match - p.mismatch) / alpha))
        else:
            pr_mismatch = 0.01
            pr_xover = 0.0
            alpha = (p.match - p.mismatch) / (
                math.log((1 - pr_mismatch) / (pr_mismatch / 3.0)) / log2)
        beta = p.match - 2 * alpha - alpha * math.log(1 - pr_mismatch) / log2
        return cls(
            alpha=alpha,
            beta=beta,
            pr_mismatch=pr_mismatch,
            pr_xover=pr_xover,
            pr_del_open=2.0 ** (p.a_gap_open / alpha),
            pr_del_extend=2.0 ** (p.a_gap_extend / alpha),
            pr_ins_open=2.0 ** (p.b_gap_open / alpha),
            pr_ins_extend=2.0 ** ((p.b_gap_extend - beta) / alpha),
        )
