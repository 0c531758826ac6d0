"""Colour-space pass 2 of the PyTorch port (`shrimp_tpu_torch.ops.sw_full_cs`)
against the JAX package: the band-packed 4-layer DP + traceback
`sw_full_cs_and_traceback_packed_jax` over local / glocal, forward /
revcmpl, global and per-colour crossover costs, indel taboo, N colours and
a jumping band; the full band against the unbanded
`sw_full_cs_and_traceback_jax` (the form the port retires); and
`render_alignment_cs`.  Stats and ops are integers and must be exactly
equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shrimp_tpu import dna
from shrimp_tpu.ops import sw_full as jsf
from shrimp_tpu.ops import sw_full_cs as jcs
from shrimp_tpu.ops.params import SWParams
from shrimp_tpu_torch.ops import sw_full_cs as tcs

PARAMS = SWParams.colour_space()


def make_qr4(colours, initbp):
    """The read's four letter decodings (ReadEntry.read_ls4): layer k
    starts from letter (initbp + k) % 4; an N colour gives BASE_N and
    restarts the chain."""
    qr4 = np.empty((4, len(colours)), np.int8)
    for k in range(4):
        letter = (k + initbp) % 4
        for j, c in enumerate(colours):
            if not 0 <= c <= 3:
                qr4[k, j] = dna.BASE_N
                letter = (k + initbp) % 4
            else:
                letter ^= int(c)
                qr4[k, j] = letter
    return qr4


def make_case(seed, B=32, G=96, R=64, rlen=50, per_colour=False,
              n_rate=0.0, band="anchor"):
    """Colour reads cut from their windows with 15% colour noise; bands
    from compute_band ("anchor"), nondecreasing starts with jumps wider
    than the packed width and past the shift clip ("jump"), or the full
    band [0, glen - 1] ("full")."""
    rng = np.random.default_rng(seed)
    gb = rng.integers(0, 4, (B, G)).astype(np.int8)
    glen = rng.integers(rlen + 10, G + 1, B)
    for b in range(B):
        gb[b, glen[b]:] = -1                     # GENOME_PAD
    qr4 = np.full((B, 4, R), -2, np.int8)
    xover = np.full((B, R), PARAMS.crossover, np.int32)
    starts = np.zeros(B, np.int64)
    for b in range(B):
        s = starts[b] = int(rng.integers(0, glen[b] - rlen))
        initbp = int(rng.integers(0, 4))
        letters = np.concatenate(([initbp], gb[b, s:s + rlen]))
        colours = (letters[:-1] ^ letters[1:]).astype(np.int8)
        noise = rng.random(rlen) < 0.15
        colours = np.where(noise, rng.integers(0, 4, rlen),
                           colours).astype(np.int8)
        if n_rate:
            colours[rng.random(rlen) < n_rate] = dna.BASE_N
        qr4[b, :, :rlen] = make_qr4(colours, initbp)
        if per_colour:
            xover[b, :rlen] = -rng.integers(20, 181, rlen)
    rev = rng.random(B) < 0.5
    if band == "full":
        bxmin = np.zeros((B, R), np.int32)
        bxmax = np.broadcast_to((glen - 1).astype(np.int32)[:, None],
                                (B, R)).copy()
    elif band == "jump":
        # starts that stall, then leap by up to 1.5 G (beyond the
        # power-of-two shift clip of the TPU kernel) at random rows
        bxmin = np.zeros((B, R), np.int32)
        for b in range(B):
            steps = np.where(rng.random(R) < 0.08,
                             rng.integers(20, 3 * G // 2, R),
                             rng.integers(0, 2, R))
            bxmin[b] = np.cumsum(steps) - steps[0]
        bxmax = bxmin + rng.integers(8, 24, (B, 1)).astype(np.int32)
    else:
        # an anchor on the read's own diagonal, give or take a few
        ay = rng.integers(0, 10, B).astype(np.int64)
        ax = starts + ay + rng.integers(-3, 4, B)
        bxmin, bxmax = jsf.compute_band(
            ax, ay, np.full(B, 30, np.int64),
            rng.integers(9, 17, B).astype(np.int64), glen.astype(np.int64),
            R)
    return gb, qr4, xover, rev, bxmin.astype(np.int32), \
        bxmax.astype(np.int32)


def run_port(case, loc, taboo, W):
    stats, ops = tcs.sw_full_cs_and_traceback_packed(
        *[torch.from_numpy(np.ascontiguousarray(a)) for a in case],
        PARAMS, loc, taboo, W)
    gb, qr4 = case[0], case[1]
    assert stats.dtype == torch.int32 and ops.dtype == torch.uint8
    assert tuple(stats.shape) == (len(gb), 11)
    assert tuple(ops.shape) == (len(gb), qr4.shape[2] + gb.shape[1])
    return stats.numpy(), ops.numpy()


def run_jax_packed(case, loc, taboo, W):
    return jcs.sw_full_cs_and_traceback_packed_jax(
        *[jnp.asarray(a) for a in case], PARAMS, loc, taboo, W=W)


def assert_same(got, want):
    s_got, o_got = got
    s_want, o_want = (np.asarray(x) for x in want)
    bad = np.flatnonzero((s_got != s_want).any(axis=1))
    assert not len(bad), (bad[:5], s_got[bad[:3]], s_want[bad[:3]])
    assert np.array_equal(o_got, o_want)
    assert (s_got[:, 0] > 0).sum() >= len(s_got) // 2


@pytest.mark.parametrize("seed,per_colour,taboo", [
    (1, False, 0), (2, True, 0), (3, False, 4), (4, True, 7)])
@pytest.mark.parametrize("loc", [True, False], ids=["local", "glocal"])
def test_packed_equals_jax(loc, seed, per_colour, taboo):
    case = make_case(seed, per_colour=per_colour)
    W = int((case[5] - case[4]).max()) + 1
    assert_same(run_port(case, loc, taboo, W),
                run_jax_packed(case, loc, taboo, W))


def test_n_colours_equal_jax():
    """N colours (BASE_N letters in every layer) score 0 and count as
    matches in the walk."""
    case = make_case(9, n_rate=0.06)
    assert (case[1] == dna.BASE_N).any()
    W = int((case[5] - case[4]).max()) + 1
    assert_same(run_port(case, True, 0, W), run_jax_packed(case, True, 0, W))


@pytest.mark.parametrize("loc", [True, False], ids=["local", "glocal"])
def test_jumping_band_equals_jax(loc):
    """Row-to-row band shifts wider than W and past the TPU kernel's
    power-of-two clip: both versions clip the same way."""
    case = make_case(11, band="jump")
    W = int((case[5] - case[4]).max()) + 1
    assert (np.diff(case[4], axis=1) > 128).any()
    got = run_port(case, loc, 3, W)
    want = run_jax_packed(case, loc, 3, W)
    s_got, o_got = got
    s_want, o_want = (np.asarray(x) for x in want)
    assert np.array_equal(s_got, s_want)
    assert np.array_equal(o_got, o_want)


@pytest.mark.parametrize("loc,taboo", [(True, 0), (False, 0), (True, 5)],
                         ids=["local", "glocal", "local_taboo"])
def test_full_band_equals_unbanded_jax(loc, taboo):
    """W = round_up(G, 32) over [0, glen - 1]: the packed form equals the
    unbanded sw_full_cs_and_traceback_jax bit for bit, which is why the
    port has no unbanded kernel."""
    case = make_case(5, per_colour=True, band="full")
    G = case[0].shape[1]
    got = run_port(case, loc, taboo, -(-G // 32) * 32)
    assert_same(got, jcs.sw_full_cs_and_traceback_jax(
        *[jnp.asarray(a) for a in case[:4]], PARAMS, loc, taboo))


def test_render_alignment_cs_equals_jax():
    case = make_case(6, per_colour=True, n_rate=0.03)
    gb, qr4 = case[0], case[1]
    W = int((case[5] - case[4]).max()) + 1
    stats, ops = run_port(case, True, 0, W)
    n = 0
    for b in range(len(gb)):
        if stats[b, 0] <= 0:
            continue
        args = (ops[b, :stats[b, 9]], gb[b], qr4[b], int(stats[b, 2]),
                int(stats[b, 1]))
        assert tcs.render_alignment_cs(*args) == \
            jcs.render_alignment_cs(*args)
        n += 1
    assert n >= len(gb) // 2


def test_codes_copied_unchanged():
    for name in ("BASE_N", "STATE_NW", "STATE_N", "STATE_W", "OP_MATCH",
                 "OP_INS", "OP_DEL", "OP_XOVER"):
        assert getattr(tcs, name) == getattr(jcs, name), name
    assert [tcs._ptr(k, s) for k in range(4) for s in range(3)] == \
        [jcs._ptr(k, s) for k in range(4) for s in range(3)]


def test_kernel_wrapper_refuses_cpu_tensors():
    case = make_case(1, B=2)
    with pytest.raises(ValueError, match="CUDA"):
        tcs.sw_full_cs_and_traceback_packed_cuda(
            *[torch.from_numpy(a) for a in case], PARAMS, True, 0, 32)
