"""SHRiMP2's mapping qualities of a read pair (compute_paired_mqv,
output.c:812-942, with mapping.h's pr_random_mapping_given_score and
get_pr_missed and util.h's normal_cdf), worked out from the pair's SAM
records.

Every hit of a pair is printed, so the records hold what the output
step had: each proper pairing as two records (mate 1's, then mate 2's)
and each half-paired hit as its mapped record beside its unmapped mate.
A foot (one mate's alignment) may sit in several pairings; it is known
by its mate, contig, position, strand and CIGAR.

`dtype` is the float type of every posterior, sum and product: float64
as SHRiMP2 computes them, float32 in the control.  Sums are taken in
the order of the records, as the C code adds them, but for each mate's
Z1, which is Python's `sum` as in the unpaired Z1 (see judge.hit_set).
"""

from __future__ import annotations

import math

import numpy as np

from reference.posterior import qv_from_pr_err

INSERT_MEAN = 200.0            # DEF_INSERT_SIZE_MEAN
INSERT_STDDEV = 100.0          # DEF_INSERT_SIZE_STDDEV
# pair modes whose insert is signed by mate 1's strand being forward
FORWARD_SIGNED = ("opp-in", "col-fw")


def normal_cdf(x: float, mean: float, stddev: float) -> float:
    """The Abramowitz-Stegun polynomial of util.h, coefficient for
    coefficient."""
    y = abs((x - mean) / stddev)
    b0, b1, b2 = 0.2316419, 0.319381530, -0.356563782
    b3, b4, b5 = 1.781477937, -1.821255978, 1.330274429
    t = 1.0 / (1.0 + b0 * y)
    res = (math.exp(-y * y / 2) / math.sqrt(2.0 * 3.141592653589)) * (
        (((b5 * t + b4) * t + b3) * t + b2) * t + b1) * t
    return 1 - res if x > mean else res


def pr_insert(isz: int) -> float:
    return max(normal_cdf(isz + 10, INSERT_MEAN, INSERT_STDDEV)
               - normal_cdf(isz - 10, INSERT_MEAN, INSERT_STDDEV), 1e-200)


def pr_random(read_len: int, score: int, match: int, step: int) -> float:
    """The chance that a random read of `read_len` scores `score`
    somewhere: n_err = ceil((len x match - score) / step) errors among
    the read's bases; `step` is |mismatch - match| in letter space."""
    if score > read_len * match:
        return 1e-200
    n_err = -(-(read_len * match - score) // step)
    lc = (math.lgamma(read_len + 1) - math.lgamma(n_err + 1)
          - math.lgamma(read_len - n_err + 1))
    return math.exp(-(-lc - n_err * math.log(3) + read_len * math.log(4)))


def pr_missed(read_len: int) -> float:
    return 1e-10 if read_len < 40 else 1e-14 if read_len < 60 else 1e-16


def neglog(x) -> int:
    """Z fields: 1000 x -ln x, truncated (util.h double_to_neglog); a
    float32 product can underflow to 0, read as the largest int32."""
    x = float(x)
    return int(1000 * -math.log(x)) if 0 < x < math.inf else 2**31 - 1


def foot_key(r) -> tuple:
    return (r.flag & 0xC0, r.rname, r.pos, r.reverse, tuple(r.cigar))


def five_prime(r) -> int:
    end = r.pos + sum(n for n, op in r.cigar if op in "MD") - 1
    return end if r.reverse else r.pos - 1


def expected(recs: list, post: dict, score: dict, read_lens: tuple,
             genome_len: int, pair_mode: str, match: int, step: int,
             dtype=np.float64) -> dict:
    """{index of a mapped record: (MAPQ, {tag: value})} for the pair's
    records `recs`, from each foot's posterior and posterior score
    (`post`, `score`, by foot key)."""
    f = dtype
    pairings, unp = [], {0: [], 1: []}
    k = 0
    while k < len(recs):
        a = recs[k]
        if a.flag & 0x2:
            b = recs[k + 1]
            isz = (five_prime(b) - five_prime(a)
                   if a.rname == b.rname else 0)
            fwd_signed = pair_mode in FORWARD_SIGNED
            sign = 1 if (not a.reverse) == fwd_signed else -1
            pairings.append((k, k + 1, foot_key(a), foot_key(b), sign * isz))
            k += 2
            continue
        for j in (k, k + 1):
            if recs[j].mapped:
                unp[0 if recs[j].flag & 0x40 else 1].append(j)
        k += 2
    out = {}
    with np.errstate(all="ignore"):
        z1 = {}
        for nip in (0, 1):
            z1[nip] = (f(sum(float(post[foot_key(recs[j])])
                             for j in unp[nip])) if f is np.float64
                       else _fsum((post[foot_key(recs[j])]
                                   for j in unp[nip]), f))
        denom_ins = f(0)
        for *_, isz in pairings:
            denom_ins = f(denom_ins + f(pr_insert(isz)))
        # z2 of each foot: its pairings' insert priors times the mates'
        # posteriors, times its own; z3 over mate 1's feet
        feet = ({}, {})
        for p, (_, _, k0, k1, isz) in enumerate(pairings):
            feet[0].setdefault(k0, []).append(p)
            feet[1].setdefault(k1, []).append(p)
        z2, z3 = {}, f(0)
        for nip in (0, 1):
            for key, ps in feet[nip].items():
                tmp = f(0)
                for p in ps:
                    mate = pairings[p][3 - nip]
                    tmp = f(tmp + f(pr_insert(pairings[p][4]))
                            * f(post[mate]))
                tmp = max(f(tmp * f(post[key])), f(1e-200))
                z2[(nip, key)] = tmp
                if nip == 0:
                    z3 = f(z3 + tmp)
        top = [f(1), f(1), f(1)]
        ptr_of = {}
        for nip in (0, 1):
            if not unp[nip]:
                continue
            best = max(unp[nip], key=lambda j: post[foot_key(recs[j])])
            ptr = f(pr_random(read_lens[nip], score[foot_key(recs[best])],
                              match, step))
            for j in unp[nip]:
                ptr_of[j] = ptr
            top[nip] = min(f(ptr * f(genome_len)), f(1))
        if pairings:
            best_tmp = f(1)
            for _, _, k0, k1, _ in pairings:
                tmp = f(f(pr_random(read_lens[0], score[k0], match, step))
                        * f(pr_random(read_lens[1], score[k1], match, step)))
                best_tmp = min(best_tmp, f(tmp * f(1000)))
            top[2] = min(f(best_tmp * f(genome_len)), f(1))
        missed = [f(pr_missed(read_lens[1])), f(pr_missed(read_lens[0]))]
        denom = f(0)
        if unp[0]:
            denom = f(denom + top[1] * top[2] * missed[0])
        if unp[1]:
            denom = f(denom + top[0] * top[2] * missed[1])
        if pairings:
            denom = f(denom + top[0] * top[1])
        for nip in (0, 1):
            for j in unp[nip]:
                p0 = f(post[foot_key(recs[j])])
                p_corr = f(f(top[1 - nip] * top[2] * missed[nip] / denom)
                           * f(p0 / z1[nip]))
                out[j] = (_mqv(p_corr, f),
                          {"Z0": neglog(p0), "Z1": neglog(z1[nip]),
                           "Z4": neglog(ptr_of[j]),
                           "Z5": neglog(missed[nip])})
        for i0, i1, k0, k1, _ in pairings:
            for nip, j, key in ((0, i0, k0), (1, i1, k1)):
                p_corr = f(f(top[0] * top[1] / denom)
                           * f(z2[(nip, key)] / z3))
                out[j] = (_mqv(p_corr, f),
                          {"Z2": neglog(z2[(nip, key)]), "Z3": neglog(z3),
                           "Z4": neglog(best_tmp),
                           "Z6": neglog(denom_ins)})
    return out


def _fsum(values, f):
    s = f(0)
    for v in values:
        s = f(s + f(v))
    return s


def _mqv(p_corr, f) -> int:
    p = float(f(1) - f(p_corr))
    if math.isnan(p):
        return 0
    q = qv_from_pr_err(p)
    return 0 if q < 4 else q
