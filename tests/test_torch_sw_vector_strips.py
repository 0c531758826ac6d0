"""The cell order of the pass-1 kernel (`csrc/sw_vector.cu`), modelled in
PyTorch, vectorised over pairs, and held to the plain `sw_score_batch`:
one thread per pair, pad rows dropped from the read (row 0 keeps the
row-0 plane only when it is the read's own row 0), the window swept in
strips of 16 columns with the read rows inside, the A-gap carried along a
strip from H0 and handed to the next strip per row, the B-gap per column,
and the sweep stopped at the window's length when pads can only lower a
score.  Scores are integers: the comparisons are exact."""

import numpy as np
import pytest
import torch

from shrimp_tpu_torch.ops import sw_vector as tsv
from shrimp_tpu_torch.ops.params import SWParams

NEG_INF = tsv.NEG_INF
T = 16
LS = SWParams.letter_space()
ASYM = SWParams(match=5, mismatch=-4, a_gap_open=-10, a_gap_extend=-1,
                b_gap_open=-6, b_gap_extend=-2)
CS = SWParams.colour_space()
CS_VECT = CS.with_(mismatch=CS.match + CS.crossover)
# a positive mismatch: pads past the window may raise a score, so the
# sweep must run the full width
ODD = SWParams(match=3, mismatch=1, a_gap_open=-2, a_gap_extend=-1,
               b_gap_open=-2, b_gap_extend=-1)


def strip_model(genome, read, params, wlen, row0=None):
    """The kernel's sweep.  genome int8 [B, G] (GENOME_PAD past wlen),
    read int8 [B, R], wlen int32 [B], row0 optional int8 [B, G]."""
    B, G = genome.shape
    g = genome.to(torch.int32)
    g0 = None if row0 is None else row0.to(torch.int32)
    m, x = params.match, params.mismatch
    aoe = -(params.a_gap_open + params.a_gap_extend)
    ae = -params.a_gap_extend
    boe = -(params.b_gap_open + params.b_gap_extend)
    be = -params.b_gap_extend
    # the read compacted to its non-pad rows
    rd = torch.full(read.shape, tsv.READ_PAD, dtype=torch.int32)
    n = (read != tsv.READ_PAD).sum(1)
    for b in range(B):
        keep = read[b][read[b] != tsv.READ_PAD]
        rd[b, :len(keep)] = keep.to(torch.int32)
    has_row0 = (read[:, 0] != tsv.READ_PAD) if g0 is not None else \
        torch.zeros(B, dtype=torch.bool)
    trunc = x <= 0 and aoe >= 0 and ae >= 0 and boe >= 0 and be >= 0
    neg1 = (read == tsv.GENOME_PAD).any(1)
    nc = torch.where(torch.tensor(trunc) & ~neg1,
                     wlen.clamp(0, G).to(torch.int64), G)
    # the strips run over columns padded to a multiple of 16
    Gp = -(-G // T) * T
    pad = torch.full((B, Gp - G), tsv.GENOME_PAD, dtype=torch.int32)
    g = torch.cat([g, pad], 1)
    if g0 is not None:
        g0 = torch.cat([g0, pad], 1)
    Rn = read.shape[1]
    bound_h = torch.zeros((B, Rn), dtype=torch.int32)
    bound_e = torch.full((B, Rn), NEG_INF, dtype=torch.int32)
    best = torch.zeros(B, dtype=torch.int32)
    for j0 in range(0, Gp, T):
        active = j0 < nc                              # the pair's strip
        H = torch.zeros((B, T), dtype=torch.int32)
        Bv = torch.full((B, T), NEG_INF, dtype=torch.int32)
        prev_left = torch.zeros(B, dtype=torch.int32)
        for i in range(Rn):
            live = active & (i < n)
            rc = rd[:, i]
            codes = g[:, j0:j0 + T]
            if g0 is not None and i == 0:
                codes = torch.where(has_row0[:, None], g0[:, j0:j0 + T],
                                    codes)
            diag = prev_left.clone()
            e = bound_e[:, i].clone()
            Hn, Bn = H.clone(), Bv.clone()
            for t in range(T):
                hd = diag + torch.where(codes[:, t] == rc, m, x)
                diag = H[:, t]
                bn = torch.maximum(H[:, t] - boe, Bv[:, t] - be)
                h0 = torch.maximum(torch.maximum(hd, torch.zeros_like(hd)),
                                   bn)
                h = torch.maximum(h0, e)
                e = torch.maximum(h0 - aoe, e - ae)
                Hn[:, t], Bn[:, t] = h, bn
                counts = live & (j0 + t < nc)
                best = torch.where(counts, torch.maximum(best, h), best)
            prev_left = torch.where(live, bound_h[:, i], prev_left)
            bound_h[:, i] = torch.where(live, Hn[:, T - 1], bound_h[:, i])
            bound_e[:, i] = torch.where(live, e, bound_e[:, i])
            H = torch.where(live[:, None], Hn, H)
            Bv = torch.where(live[:, None], Bn, Bv)
    return best


def _case(seed, B, G, R, interior_pads=0, row0_pad=False, codes=5):
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, codes, (B, G)).astype(np.int8)
    wlen = rng.integers(max(G // 2, 1), G + 1, B).astype(np.int32)
    for b in range(B):
        genome[b, wlen[b]:] = tsv.GENOME_PAD
    read = np.full((B, R), tsv.READ_PAD, np.int8)
    for b in range(B):
        L = int(rng.integers(1, R + 1))
        s = int(rng.integers(0, max(int(wlen[b]) - L, 0) + 1))
        seg = genome[b, s:s + L]
        read[b, :len(seg)] = np.where(seg < 0, 0, seg)
        read[b, len(seg):L] = rng.integers(0, 4, L - len(seg))
        for _ in range(int(rng.integers(0, 4))):
            read[b, int(rng.integers(L))] = rng.integers(0, 4)
        for _ in range(interior_pads):
            read[b, int(rng.integers(L))] = tsv.READ_PAD
    if row0_pad:
        read[::2, 0] = tsv.READ_PAD
    row0 = rng.integers(0, 4, (B, G)).astype(np.int8)
    return (torch.from_numpy(genome), torch.from_numpy(read),
            torch.from_numpy(wlen), torch.from_numpy(row0))


CASES = {
    "ls": (dict(seed=1, B=24, G=128, R=56), LS, False),
    "asym": (dict(seed=2, B=24, G=100, R=40), ASYM, False),
    "g_below_32": (dict(seed=3, B=24, G=20, R=24), LS, False),
    "g_1": (dict(seed=4, B=16, G=1, R=8), ASYM, False),
    "g_not_multiple_of_32": (dict(seed=5, B=24, G=70, R=50), LS, False),
    "interior_pads": (dict(seed=6, B=24, G=96, R=40, interior_pads=3), ASYM,
                      False),
    "row0_plane": (dict(seed=7, B=24, G=64, R=32), CS_VECT, True),
    "row0_pad_with_plane": (dict(seed=8, B=24, G=64, R=32, row0_pad=True,
                                 interior_pads=2), ASYM, True),
    "positive_mismatch": (dict(seed=9, B=24, G=60, R=60), ODD, False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_strip_model_equals_sw_score_batch(case):
    kw, params, with_row0 = CASES[case]
    genome, read, wlen, row0 = _case(**kw)
    r0 = row0 if with_row0 else None
    want = tsv.sw_score_batch(genome, read, params, r0)
    got = strip_model(genome, read, params, wlen, r0)
    assert torch.equal(got, want)
    assert (want > 0).any()
