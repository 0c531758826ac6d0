"""The reference's pieces against the program's own versions of the
same arithmetic, on the CPU: the colour-space DP's best score against
the plain version of the K7 kernel over the full band, and the paired
mapping-quality helpers against the program's `mapq`.  The reference
itself imports nothing of the program; only these tests do."""

import numpy as np
import pytest
import torch

from reference import dp, pairmqv, params

R, G, B = 24, 36, 160


def _colour_case(seed: int):
    """Reads of letters from each window with mismatches and an indel,
    encoded as colours after a primer, with colour errors."""
    rng = np.random.default_rng(seed)
    init = rng.integers(0, 4, B)
    genome = rng.integers(0, 4, (B, G))
    wlen = rng.integers(R - 2, G + 1, B)
    letters = np.zeros((B, R), np.int64)
    for b in range(B):
        st = int(rng.integers(0, max(1, wlen[b] - R + 1)))
        seg = list(genome[b, st:st + R + 4])
        k = int(rng.integers(2, R - 2))
        if b % 3 == 0:
            del seg[k:k + int(rng.integers(1, 3))]
        elif b % 3 == 1:
            seg[k:k] = list(rng.integers(0, 4, int(rng.integers(1, 3))))
        seg = np.array((seg + list(rng.integers(0, 4, R)))[:R])
        flip = rng.random(R) < 0.05
        seg[flip] = rng.integers(0, 4, int(flip.sum()))
        letters[b] = seg
    prev = np.concatenate([init[:, None], letters[:, :-1]], axis=1)
    colours = letters ^ prev
    err = rng.random((B, R)) < 0.08
    colours[err] = rng.integers(0, 4, int(err.sum()))
    xo = -rng.integers(1, 41, (B, R))
    g = np.where(np.arange(G)[None, :] < wlen[:, None], genome, -1)
    return init, colours, xo, g, wlen


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_colour_dp_is_the_kernels_best_over_the_full_band(seed):
    from shrimp_tpu_torch.ops import sw_full_cs
    from shrimp_tpu_torch.ops.params import SWParams
    init, colours, xo, g, wlen = _colour_case(seed)
    # the DP's top row: the first colour crosses over at the better of
    # -x and its own score (the judge scores a path so)
    xo_ref = xo.copy()
    xo_ref[:, 0] = np.maximum(params.COLOUR.crossover, xo[:, 0])
    ref = dp.best_colour(colours, init, xo_ref, np.full(B, R), g, wlen,
                         params.COLOUR)
    cum = np.bitwise_xor.accumulate(colours, axis=1)
    qr4 = np.stack([((init + k) % 4)[:, None] ^ cum for k in range(4)],
                   axis=1)
    xmax = np.broadcast_to((wlen - 1)[:, None], (B, R)).copy()
    prog = sw_full_cs.sw_full_cs_batch_packed(
        torch.tensor(g, dtype=torch.int32),
        torch.tensor(qr4, dtype=torch.int32),
        torch.tensor(xo, dtype=torch.int32), torch.zeros(B, dtype=bool),
        torch.zeros((B, R), dtype=torch.int32),
        torch.tensor(xmax, dtype=torch.int32), SWParams.colour_space(),
        local_alignment=False, taboo_len=0, W=64)[0].numpy()
    # the kernel's best starts at 0: a read with no alignment above 0
    # reads 0 there
    assert (ref >= 0).sum() > B // 2
    np.testing.assert_array_equal(np.maximum(ref, 0), prog)


@pytest.mark.parametrize("isz", [-700, -3, 0, 150, 199, 200, 201, 450, 2000])
def test_insert_prior_is_the_programs(isz):
    from shrimp_tpu_torch import mapq
    assert pairmqv.pr_insert(isz) == mapq.get_pr_insert_size(
        isz, pairmqv.INSERT_MEAN, pairmqv.INSERT_STDDEV)


@pytest.mark.parametrize("score", [-5, 0, 250, 374, 475, 499, 500, 501])
def test_random_mapping_chance_is_the_programs(score):
    from shrimp_tpu_torch import mapq
    from shrimp_tpu_torch.ops.params import SWParams
    p = SWParams.letter_space()
    s = params.LETTER
    assert pairmqv.pr_random(50, score, s.match, s.match - s.mismatch) == \
        mapq.pr_random_mapping_given_score(50, score, p, False)
    assert pairmqv.pr_missed(50) == mapq.get_pr_missed(50)
