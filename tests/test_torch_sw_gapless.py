"""Gapless pass 1 of the PyTorch port (`shrimp_tpu_torch.ops.sw_gapless`)
against the JAX package's `gapless_score_batch`: letter space (column 0
scored like the others) and colour space (the forced-first-colour s0
override).  Scores are integers and must be exactly equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shrimp_tpu.ops import sw_gapless as jsg
from shrimp_tpu.ops.params import SWParams
from shrimp_tpu_torch.ops import sw_gapless as tsg


def _diagonals(seed, N, R):
    """Diagonal rows as the mapper gathers them: genome codes 0-4 with a
    GENOME_PAD tail past the contig end, read codes 0-3 with a READ_PAD
    tail past the read end, mostly matching so runs score high."""
    rng = np.random.default_rng(seed)
    diag = rng.integers(0, 5, (N, R)).astype(np.int8)
    reads = np.where(rng.random((N, R)) < 0.8, np.minimum(diag, 3),
                     rng.integers(0, 4, (N, R))).astype(np.int8)
    for n in range(N):
        g_end = int(rng.integers(0, R + 1))
        r_end = int(rng.integers(0, R + 1))
        diag[n, g_end:] = jsg.GENOME_PAD
        reads[n, r_end:] = jsg.READ_PAD
    return diag, reads


def _port(diag, reads, params, s0=None):
    got = tsg.gapless_score_batch(
        torch.from_numpy(diag), torch.from_numpy(reads), params,
        None if s0 is None else torch.from_numpy(s0))
    assert got.dtype == torch.int32 and tuple(got.shape) == (len(diag),)
    return got.numpy()


@pytest.mark.parametrize("R", [1, 8, 37, 100])
@pytest.mark.parametrize("params", [SWParams.letter_space(),
                                    SWParams.colour_space()],
                         ids=["ls", "cs"])
def test_plain_equals_jax(params, R):
    diag, reads = _diagonals(R, 300, R)
    want = np.asarray(jsg.gapless_score_batch(jnp.asarray(diag),
                                              jnp.asarray(reads), params))
    assert np.array_equal(_port(diag, reads, params), want)


@pytest.mark.parametrize("seed", [1, 2])
def test_cs_s0_equals_jax(seed):
    """Colour space: column 0 takes s0 (+match for a forced match, 0 for a
    skipped forced mismatch, or the plain column score)."""
    p = SWParams.colour_space()
    diag, reads = _diagonals(seed, 300, 50)
    rng = np.random.default_rng(seed + 10)
    s0 = rng.choice([0, p.match, p.mismatch], 300).astype(np.int32)
    want = np.asarray(jsg.gapless_score_batch(
        jnp.asarray(diag), jnp.asarray(reads), p, s0=jnp.asarray(s0)))
    assert np.array_equal(_port(diag, reads, p, s0), want)


def test_empty_batch():
    z = np.zeros((0, 16), np.int8)
    assert _port(z, z, SWParams.letter_space()).shape == (0,)


def test_plain_refuses_non_cpu_tensors():
    g = torch.zeros((2, 8), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="CPU tensors"):
        tsg.gapless_score_batch_plain(g, g, SWParams())


def test_kernel_wrapper_refuses_cpu_tensors():
    g = torch.zeros((2, 8), dtype=torch.int8)
    with pytest.raises(ValueError, match="CUDA"):
        tsg.gapless_score_batch_cuda(g, g, SWParams())
