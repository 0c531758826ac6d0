"""The PyTorch port's unpaired letter-space Mapper on the CPU: byte-equal
SAM against the SHRiMP2 goldens and against the JAX Mapper, and its
device state against the JAX mapper's resident plane.  Each package maps
with its own index, built from the same contigs."""

import os

import numpy as np
import pytest
import torch

from shrimp_tpu import index as jindex
from shrimp_tpu.io import fastx as jfastx
from shrimp_tpu.pipeline.mapper import Mapper as JaxMapper
from shrimp_tpu.pipeline.options import MapperConfig as JaxConfig
from shrimp_tpu_torch import dna
from shrimp_tpu_torch import index as gindex
from shrimp_tpu_torch.io import fastx
from shrimp_tpu_torch.ops.params import SWParams
from shrimp_tpu_torch.pipeline.mapper import DeviceIndex, Mapper
from shrimp_tpu_torch.pipeline.options import MapperConfig

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")

# (genome, reads, golden SAM, scoring) as tests/test_golden_*.py map them
GOLDENS = {
    "golden_unpaired": ("golden_genome.fa", "golden_reads.fq",
                        "golden_unpaired.sam", SWParams()),
    "golden_long_reads": ("golden_genome.fa", "long_reads.fq",
                          "golden_long_reads.sam", SWParams()),
    "med_ls": ("med_genome.fa", "med_reads.fq", "med_ls.sam",
               SWParams.letter_space()),
}


def _index(name):
    return gindex.build_index(
        list(fastx.iter_contigs(os.path.join(GOLDEN, name))))


def _jax_index(name):
    return jindex.build_index(
        list(jfastx.iter_contigs(os.path.join(GOLDEN, name))))


def _reads(name):
    return [(r.name, r.seq, r.qual)
            for r in fastx.iter_reads(os.path.join(GOLDEN, name))]


def _golden_body(name):
    with open(os.path.join(GOLDEN, name)) as fh:
        return [ln.rstrip("\n") for ln in fh if not ln.startswith("@")]


def _lines(mapper, results):
    return [rec.line() for re_e, hits in results
            for rec in mapper.sam_records(re_e, hits)]


def _map_golden(case, device="cpu"):
    genome, reads, _, params = GOLDENS[case]
    m = Mapper(_index(genome), MapperConfig(params=params, qual_delta=64),
               device=device)
    return _lines(m, m.map_batch(_reads(reads)))


@pytest.mark.parametrize("case", sorted(GOLDENS))
def test_golden_byte_equality(case):
    assert _map_golden(case) == _golden_body(GOLDENS[case][2])


def test_map_stream_equals_map_batch():
    """The pipelined stream (small batches, and a worker pool) gives the
    map_batch lines."""
    idx = _index("golden_genome.fa")
    reads = _reads("golden_reads.fq")
    want = _golden_body("golden_unpaired.sam")
    m = Mapper(idx, MapperConfig(qual_delta=64), device="cpu")
    assert _lines(m, m.map_stream(iter(reads), batch_size=48)) == want
    assert _lines(m, m.map_stream(iter(reads), batch_size=48,
                                  n_workers=2)) == want


def _random_corpus(seed=5, n=48):
    """(port index, JAX index, reads) of one random two-contig genome."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, 30000).astype(np.int8)
    genome[12000:12300] = genome[2000:2300]          # a repeat
    parts = (("c1", genome[:18000]), ("c2", genome[18000:]))
    idx = gindex.build_index([fastx.Contig(name=n_, codes=c)
                              for n_, c in parts])
    jidx = jindex.build_index([jfastx.Contig(name=n_, codes=c)
                               for n_, c in parts])
    reads = []
    for i in range(n):
        L = int(rng.integers(40, 90))
        p = int(rng.integers(0, len(genome) - L))
        r = genome[p:p + L].copy()
        for _ in range(int(rng.integers(0, 4))):
            q = int(rng.integers(0, L))
            r[q] = (r[q] + int(rng.integers(1, 4))) % 4
        if i % 5 == 0:
            r = np.delete(r, slice(10, 12))
        if rng.random() < 0.5:
            r = dna.reverse_complement(r)
        reads.append((f"r{i:03d}", dna.decode(r), "h" * len(r)))
    return idx, jidx, reads


@pytest.mark.parametrize("options", [
    {},
    {"anchor_width": -1, "global_alignment": False,
     "compute_mapping_qualities": False},
    {"strata": True, "num_outputs": 3, "sam_unaligned": True,
     "extra_sam_fields": True, "sam_read_group_name": "rg1"},
], ids=["default", "unbanded_local", "strata_xf"])
def test_same_sam_as_jax_mapper(options):
    idx, jidx, reads = _random_corpus()
    lines = []
    for make, config in ((lambda cfg: Mapper(idx, cfg, device="cpu"),
                          MapperConfig),
                         (lambda cfg: JaxMapper(jidx, cfg), JaxConfig)):
        cfg = config(qual_delta=64)
        for k, v in options.items():
            setattr(cfg, k, v)
        m = make(cfg)
        lines.append(_lines(m, m.map_batch(reads)))
    assert lines[0] == lines[1]
    assert len(lines[0]) >= len(reads) // 2


def test_device_index_equals_jax_plane():
    dix = DeviceIndex.from_index(_index("med_genome.fa"), "cpu")
    want = np.asarray(JaxMapper(_jax_index("med_genome.fa"),
                                JaxConfig())._genome_dev_plane())
    assert dix.plane.dtype == torch.int8
    assert np.array_equal(dix.plane.numpy(), want)
    assert dix.contig_offsets.dtype == torch.int64
    assert dix.contig_offsets.tolist() == [
        int(o) for o in _index("med_genome.fa").contig_offsets]


def test_gapless_option_set_equals_jax():
    """An option set with a gapless pass 1 (the sw_gapless diagonal score
    in place of the vector filter) maps as the JAX Mapper does."""
    idx, jidx, reads = _random_corpus(seed=8)
    lines = []
    for m in (Mapper(idx, MapperConfig(qual_delta=64), device="cpu"),
              JaxMapper(jidx, JaxConfig(qual_delta=64))):
        opts = m.cfg.unpaired_options()
        opts[0].pass1.gapless = True
        lines.append(_lines(m, m.map_batch(reads, options=opts)))
    assert lines[0] == lines[1]
    assert len(lines[0]) >= len(reads) // 2
