"""The benchmark's frozen generators give what the program's copy
(`shrimp_tpu_torch/utils/synth.py`) gives at the benchmark's seeds."""

import numpy as np
import pytest

from gen import synth as frozen
from harness import data
from shrimp_tpu_torch.utils import synth as port

GENOME_SEED = 20260817          # both configurations' genome seed
SEEDS = [7, 2**31 + 11, 2**33 + 1234567]


@pytest.fixture(scope="module")
def genome():
    a = frozen.make_genome(np.random.default_rng(GENOME_SEED), 2_500_000)
    b = port.make_genome(np.random.default_rng(GENOME_SEED), 2_500_000)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    return type("Holder", (), {"genome": np.concatenate(a)})()


def test_the_full_genome_matches():
    a = frozen.make_genome(np.random.default_rng(GENOME_SEED), 100_000_000)
    b = port.make_genome(np.random.default_rng(GENOME_SEED), 100_000_000)
    assert len(a) == len(b) == 25
    assert all(np.array_equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", ["make_reads", "make_cs_reads",
                                  "make_pairs"])
def test_reads_match(genome, name, seed):
    a, ta = getattr(frozen, name)(genome, data.rng_for(seed), 300)
    b, tb = getattr(port, name)(genome, data.rng_for(seed), 300)
    assert a == b
    assert np.array_equal(ta, tb)
