"""Pass-1 vector SW of the PyTorch port (`shrimp_tpu_torch.ops.sw_vector`)
against the JAX package: the anti-diagonal `sw_score_batch`, the row scan
`sw_score_batch_rows`, the Pallas kernel in interpret mode and the NumPy
oracle, on the cases of tests/test_sw_vector.py.  Scores are integers and
must be exactly equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shrimp_tpu import dna
from shrimp_tpu.ops import sw_vector as jsv
from shrimp_tpu.ops.params import SWParams
from shrimp_tpu.ops.sw_vector_pallas import sw_score_batch_pallas
from shrimp_tpu.pipeline.mapper import (_p1_gather_score_cs,
                                        _p1_gather_score_ls)
from shrimp_tpu_torch.ops import sw_vector as tsv

ASYM = SWParams(match=5, mismatch=-4, a_gap_open=-10, a_gap_extend=-1,
                b_gap_open=-6, b_gap_extend=-2)


def _pad(arrs, L, fill):
    out = np.full((len(arrs), L), fill, np.int8)
    for i, a in enumerate(arrs):
        out[i, :len(a)] = a
    return out


def _random_pairs(seed, n=32):
    rng = np.random.default_rng(seed)
    genomes, reads = [], []
    for _ in range(n):
        genomes.append(rng.integers(0, 4, size=rng.integers(20, 70))
                       .astype(np.int8))
        reads.append(rng.integers(0, 4, size=rng.integers(10, 50))
                     .astype(np.int8))
    return genomes, reads


def _asym_pairs():
    rng = np.random.default_rng(7)
    genomes, reads = [], []
    for _ in range(8):
        g = rng.integers(0, 4, size=60).astype(np.int8)
        r = g[10:40].copy()
        r = np.delete(r, 5)          # deletion
        r[12] = (r[12] + 1) % 4      # SNP
        genomes.append(g)
        reads.append(r)
    return genomes, reads


CASES = {
    "perfect_match": ([dna.encode("ACGTACGTACGT")], [dna.encode("ACGTACGT")],
                      SWParams()),
    "single_mismatch": ([dna.encode("AAAACCCCGGGG")],
                        [dna.encode("AACACCCC")], SWParams()),
    "gap_costs": ([dna.encode("ACGTAACGT")], [dna.encode("ACGTACGT")],
                  SWParams()),
    "empty_overlap": ([dna.encode("AAAA")], [dna.encode("GGGG")], SWParams()),
    "random": (*_random_pairs(42), SWParams()),
    "n_matches_n": ([np.array([dna.BASE_N] * 8, np.int8)],
                    [np.array([dna.BASE_N] * 8, np.int8)], SWParams()),
    "asymmetric_gaps_default": (*_asym_pairs(), SWParams()),
    "asymmetric_gaps": (*_asym_pairs(), ASYM),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_equals_jax(case):
    genomes, reads, params = CASES[case]
    G = max(len(g) for g in genomes)
    R = max(len(r) for r in reads)
    gb = _pad(genomes, G, jsv.GENOME_PAD)
    rb = _pad(reads, R, jsv.READ_PAD)
    got = tsv.sw_score_batch(torch.from_numpy(gb), torch.from_numpy(rb),
                             params)
    assert got.dtype == torch.int32
    got = got.numpy()
    oracle = [jsv.sw_score_numpy(g, r, params)
              for g, r in zip(genomes, reads)]
    assert got.tolist() == oracle
    jg, jr = jnp.asarray(gb), jnp.asarray(rb)
    assert np.array_equal(got, np.asarray(jsv.sw_score_batch(jg, jr, params)))
    assert np.array_equal(got, np.asarray(
        jsv.sw_score_batch_rows(jg, jr, params)))
    assert np.array_equal(got, np.asarray(
        sw_score_batch_pallas(jg, jr, params, interpret=True)))


def _mutated_reads(rng, genome, R, lo_len):
    B, G = genome.shape
    read = np.full((B, R), jsv.READ_PAD, np.int8)
    for b in range(B):
        L = int(rng.integers(lo_len, R + 1))
        s = int(rng.integers(0, G - L))
        read[b, :L] = genome[b, s:s + L]
        for _ in range(int(rng.integers(0, 5))):
            read[b, int(rng.integers(L))] = rng.integers(0, 4)
    return read


@pytest.mark.parametrize("params", [SWParams.colour_space(), ASYM],
                         ids=["colour_space", "asymmetric"])
def test_row0_plane(params):
    """The colour-space row-0 plane: read row 0 scores against it."""
    rng = np.random.default_rng(11)
    B, G, R = 16, 96, 32
    genome = rng.integers(0, 4, size=(B, G)).astype(np.int8)
    row0 = rng.integers(0, 4, size=(B, G)).astype(np.int8)
    read = _mutated_reads(rng, genome, R, 10)
    got = tsv.sw_score_batch(torch.from_numpy(genome), torch.from_numpy(read),
                             params, torch.from_numpy(row0)).numpy()
    jg, jr, j0 = jnp.asarray(genome), jnp.asarray(read), jnp.asarray(row0)
    assert np.array_equal(got, np.asarray(
        jsv.sw_score_batch(jg, jr, params, j0)))
    assert np.array_equal(got, np.asarray(
        sw_score_batch_pallas(jg, jr, params, genome_row0=j0,
                              interpret=True)))
    for b in range(4):
        L = int((read[b] >= 0).sum())
        assert got[b] == jsv.sw_score_numpy(genome[b], read[b, :L], params,
                                            genome_row0=row0[b])


def test_interior_pad_rows_keep_state():
    """A READ_PAD row inside a read leaves H and B unchanged, as in the
    row-scan and Pallas engines (the anti-diagonal engine treats it as a
    mismatch row; the mapper never builds such reads)."""
    rng = np.random.default_rng(3)
    B, G, R = 24, 80, 40
    genome = rng.integers(0, 5, size=(B, G)).astype(np.int8)
    read = _mutated_reads(rng, genome, R, 30)
    read[:, 7] = jsv.READ_PAD
    got = tsv.sw_score_batch(torch.from_numpy(genome),
                             torch.from_numpy(read)).numpy()
    jg, jr = jnp.asarray(genome), jnp.asarray(read)
    assert np.array_equal(got, np.asarray(jsv.sw_score_batch_rows(jg, jr)))
    assert np.array_equal(got, np.asarray(
        sw_score_batch_pallas(jg, jr, interpret=True)))


def _gather_inputs(seed, G=128, R=56, C=200, L=20000):
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 5, L).astype(np.int8)
    plane = np.concatenate([genome, np.full(1 << 12, jsv.GENOME_PAD,
                                            np.int8)])
    wlen = rng.integers(G // 2, G + 1, C).astype(np.int32)
    lo = (rng.integers(0, L - G, C)).astype(np.int64)
    lo[:4] = L - wlen[:4]                      # windows ending at the plane end
    reads2 = np.full((16, 2, R), jsv.READ_PAD, np.int8)
    for b in range(16):
        n = int(rng.integers(R // 2, R + 1))
        reads2[b, :, :n] = rng.integers(0, 4, (2, n))
    rid = rng.integers(0, 16, C).astype(np.int32)
    st = rng.integers(0, 2, C).astype(np.int32)
    return plane, lo, wlen, rid, st, reads2


@pytest.mark.parametrize("seed", [1, 2])
def test_p1_gather_score_ls_equals_jax(seed):
    plane, lo, wlen, rid, st, reads2 = _gather_inputs(seed)
    G, p = 128, SWParams.letter_space()
    got = tsv.p1_gather_score_ls(
        *[torch.from_numpy(a) for a in (plane, lo, wlen, rid, st, reads2)],
        G, p).numpy()
    want = np.asarray(_p1_gather_score_ls(
        jnp.asarray(plane), jnp.asarray(lo.astype(np.int32)),
        jnp.asarray(wlen), jnp.asarray(rid), jnp.asarray(st),
        jnp.asarray(reads2), G, p))
    assert np.array_equal(got, want)


def _gather_inputs_cs(seed, G=128, R=56, C=200, L=10000):
    """fw||rc colour and letter planes (letters 0-4, so some row-0 codes
    are BASE_N) with a GENOME_PAD tail; windows in both halves, some
    ending at the plane's real end."""
    rng = np.random.default_rng(seed)
    pad = np.full(1 << 12, jsv.GENOME_PAD, np.int8)
    ls = rng.integers(0, 5, 2 * L).astype(np.int8)
    cs = rng.integers(0, 5, 2 * L).astype(np.int8)
    cs_cat = np.concatenate([cs, pad])
    ls_cat = np.concatenate([ls, pad])
    wlen = rng.integers(G // 2, G + 1, C).astype(np.int32)
    lo = rng.integers(0, 2 * L - G, C).astype(np.int64)
    lo[:4] = 2 * L - wlen[:4]
    reads2 = np.full((16, 2, R), jsv.READ_PAD, np.int8)
    for b in range(16):
        n = int(rng.integers(R // 2, R + 1))
        reads2[b, :, :n] = rng.integers(0, 4, (2, n))
    rid = rng.integers(0, 16, C).astype(np.int32)
    ist = np.zeros(C, np.int32)
    initbp = rng.integers(0, 4, C).astype(np.int8)
    return cs_cat, ls_cat, lo, wlen, rid, ist, initbp, reads2


@pytest.mark.parametrize("seed", [1, 2])
def test_p1_gather_score_cs_equals_jax(seed):
    """The colour-space gather: colour windows from cs_cat, row 0 from
    the letter window mapped through initbp (vect_params: a colour
    mismatch costs one crossover)."""
    args = _gather_inputs_cs(seed)
    G = 128
    p = SWParams.colour_space()
    p = p.with_(mismatch=p.match + p.crossover)
    got = tsv.p1_gather_score_cs(*[torch.from_numpy(a) for a in args], G,
                                 p).numpy()
    cs_cat, ls_cat, lo, wlen, rid, ist, initbp, reads2 = args
    want = np.asarray(_p1_gather_score_cs(
        jnp.asarray(cs_cat), jnp.asarray(ls_cat),
        jnp.asarray(lo.astype(np.int32)), jnp.asarray(wlen),
        jnp.asarray(rid), jnp.asarray(ist), jnp.asarray(initbp),
        jnp.asarray(reads2), G, p, engine="scan"))
    assert np.array_equal(got, want)
    assert (got > 0).all()


def test_plain_refuses_non_cpu_tensors():
    g = torch.zeros((2, 8), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="CPU tensors"):
        tsv.sw_score_batch(g, g)


def test_kernel_wrapper_refuses_cpu_tensors():
    g = torch.zeros((2, 8), dtype=torch.int8)
    with pytest.raises(ValueError, match="CUDA"):
        tsv.sw_score_batch_cuda(g, g)
    args = [torch.from_numpy(a) for a in _gather_inputs_cs(1, C=4)]
    with pytest.raises(ValueError, match="CUDA"):
        tsv.p1_gather_score_cs_cuda(*args, 128, SWParams.colour_space())
