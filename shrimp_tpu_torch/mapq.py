"""Mapping-quality math (MQV) — unpaired and paired posteriors.

Mirrors:
  * `qv_from_pr_err/corr` (common/util.h:266-283) and `double_to_neglog`
    quantization (util.h:293-297) used by the Z-field side channel,
  * the LS posterior shortcut (`hit_run_post_sw`, mapping.c:1626-1642),
  * `compute_unpaired_mqv` (gmapper/output.c:778-793),
  * `compute_paired_mqv` (output.c:812-942) and its helpers
    `pr_random_mapping_given_score` / `get_pr_missed` (mapping.h:28-61),
  * `normal_cdf` insert-size prior (util.h:308-326).

All of this is tiny dense host math over <= num_outputs survivors; the
device funnel hands over (score, rmapped) pairs.
"""

from __future__ import annotations

import math

from shrimp_tpu_torch.ops.params import ScoreProbs, SWParams


def qv_from_pr_err(pr_err: float) -> int:
    if pr_err > 0.99999999:
        return 0
    if pr_err < 1e-25:
        return 250
    return int(-10.0 * math.log(pr_err) / math.log(10.0))


def qv_from_pr_corr(pr_corr: float) -> int:
    return qv_from_pr_err(1 - pr_corr)


def pr_err_from_qv(qv: int) -> float:
    if qv <= 0:
        return 0.99999999
    if qv >= 250:
        return 1e-25
    return 10.0 ** (-qv / 10.0)


def double_to_neglog(x: float, shift: int = 1000) -> int:
    return int(shift * -math.log(x))


def neglog_to_double(y: int, shift: int = 1000) -> float:
    return math.exp(-y / shift)


def normal_cdf(x: float, mean: float, stddev: float) -> float:
    """Abramowitz-Stegun polynomial CDF (util.h:308-326) — replicated
    coefficient-for-coefficient so Z2 recombination is bit-compatible."""
    y = abs((x - mean) / stddev)
    b0, b1, b2 = 0.2316419, 0.319381530, -0.356563782
    b3, b4, b5 = 1.781477937, -1.821255978, 1.330274429
    pi = 3.141592653589
    t = 1.0 / (1.0 + b0 * y)
    res = (math.exp(-y * y / 2) / math.sqrt(2.0 * pi)) * (
        (((b5 * t + b4) * t + b3) * t + b2) * t + b1) * t
    if x > mean:
        res = 1 - res
    return res


def ls_posterior(score: int, rmapped: int, probs: ScoreProbs) -> float:
    """Letter-space posterior from the SW score (mapping.c:1632-1634)."""
    return 2.0 ** ((score - rmapped * (2.0 * probs.alpha + probs.beta))
                   / probs.alpha)


def posterior_score(posterior: float, rmapped: int, probs: ScoreProbs) -> int:
    """Posterior mapped back to score space (mapping.c:1637-1640)."""
    ps = int(round(probs.alpha * math.log(posterior) / math.log(2.0)
                   + rmapped * (2.0 * probs.alpha + probs.beta)))
    return max(ps, 0)


def log_nchoosek(n: int, k: int) -> float:
    return (math.lgamma(n + 1) - math.lgamma(k + 1) - math.lgamma(n - k + 1))


def pr_random_mapping_given_score(read_len: int, score: int, p: SWParams,
                                  colour_space: bool) -> float:
    """mapping.h:39-61."""
    if score > read_len * p.match:
        return 1e-200
    if colour_space:
        n_err = -(-(read_len * p.match - score) // abs(p.crossover))
    else:
        n_err = -(-(read_len * p.match - score) // abs(p.mismatch - p.match))
    tmp = (-log_nchoosek(read_len, n_err) - n_err * math.log(3)
           + read_len * math.log(4))
    return math.exp(-tmp)


def get_pr_missed(read_len: int) -> float:
    """mapping.h:28-37."""
    if read_len < 40:
        return 1e-10
    if read_len < 60:
        return 1e-14
    return 1e-16


def compute_unpaired_mqv(posteriors: list[float]) -> tuple[list[int], float]:
    """Z1 + per-hit MQV (compute_unpaired_mqv, output.c:778-793).

    Returns (mqvs, z1); mqv < 4 is squashed to 0."""
    z1 = sum(posteriors)
    mqvs = []
    for post in posteriors:
        mqv = qv_from_pr_corr(post / z1)
        mqvs.append(0 if mqv < 4 else mqv)
    return mqvs, z1


def get_pr_insert_size(insert_size: float, mean: float, stddev: float) -> float:
    """output.c:795-809."""
    res = (normal_cdf(insert_size + 10, mean, stddev)
           - normal_cdf(insert_size - 10, mean, stddev))
    return max(res, 1e-200)
