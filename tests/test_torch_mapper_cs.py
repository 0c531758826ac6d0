"""The PyTorch port's Mapper in colour space and gapless on the CPU:
byte-equal SAM against the SHRiMP2 goldens and against the JAX Mapper on
the same reads, and its resident colour-space planes against the JAX
mapper's.  Each package maps with its own index, built from the same
contigs."""

import os

import numpy as np
import pytest
import torch

from shrimp_tpu import index as jindex
from shrimp_tpu.io import fastx as jfastx
from shrimp_tpu.ops.params import SWParams as JaxParams
from shrimp_tpu.pipeline.mapper import Mapper as JaxMapper
from shrimp_tpu.pipeline.options import MapperConfig as JaxConfig
from shrimp_tpu_torch import index as gindex
from shrimp_tpu_torch.io import fastx
from shrimp_tpu_torch.ops.params import SWParams
from shrimp_tpu_torch.pipeline.mapper import DeviceIndex, Mapper
from shrimp_tpu_torch.pipeline.options import MapperConfig

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def _index(name, colour_space=True):
    return gindex.build_index(
        list(fastx.iter_contigs(os.path.join(GOLDEN, name))),
        colour_space=colour_space)


def _jax_index(name):
    return jindex.build_index(
        list(jfastx.iter_contigs(os.path.join(GOLDEN, name))),
        colour_space=True)


def _reads(name):
    return [(r.name, r.seq, r.qual)
            for r in fastx.iter_reads(os.path.join(GOLDEN, name))]


def _golden_body(name):
    with open(os.path.join(GOLDEN, name)) as fh:
        return [ln.rstrip("\n") for ln in fh if not ln.startswith("@")]


def _lines(mapper, results):
    return [rec.line() for re_e, hits in results
            for rec in mapper.sam_records(re_e, hits)]


def _cs_cfg(jax=False, **options):
    """A colour-space config of the port, or of the JAX package."""
    config, params = ((JaxConfig, JaxParams) if jax
                      else (MapperConfig, SWParams))
    cfg = config(colour_space=True, params=params.colour_space(),
                 qual_delta=33)
    for k, v in options.items():
        setattr(cfg, k, v)
    return cfg


@pytest.mark.parametrize("genome,reads,gold", [
    ("golden_genome.fa", "golden_reads_cs.fq", "golden_cs.sam"),
    ("med_genome.fa", "med_reads_cs.fq", "med_cs.sam"),
], ids=["golden_cs", "med_cs"])
def test_golden_byte_equality(genome, reads, gold):
    m = Mapper(_index(genome), _cs_cfg(), device="cpu")
    assert _lines(m, m.map_batch(_reads(reads))) == _golden_body(gold)


def test_map_stream_equals_golden():
    m = Mapper(_index("golden_genome.fa"), _cs_cfg(), device="cpu")
    assert _lines(m, m.map_stream(iter(_reads("golden_reads_cs.fq")),
                                  batch_size=64, n_workers=2)) == \
        _golden_body("golden_cs.sam")


# the CLI's -U --local bundle (gapless, no anchors, no gap opens)
_UNGAPPED = {"gapless": True, "anchor_width": 0, "global_alignment": False,
             "compute_mapping_qualities": False}


@pytest.mark.parametrize("options", [
    {"anchor_width": -1},
    {"indel_taboo_len": 6, "bfast": True, "num_outputs": 3},
    _UNGAPPED,
], ids=["unbanded", "taboo_bfast", "ungapped"])
def test_same_sam_as_jax_mapper(options):
    """Colour space through both mappers on the same reads: the unbanded
    pass 2 (the JAX package's K9, the port's full-band packed kernel),
    indel taboo with bfast qualities, and gapless pass 1."""
    reads = _reads("golden_reads_cs.fq")[:90]
    lines = []
    for jax in (False, True):
        cfg = _cs_cfg(jax, **options)
        if options.get("gapless"):
            cfg.params = cfg.params.with_(a_gap_open=-255, b_gap_open=-255)
        m = (JaxMapper(_jax_index("golden_genome.fa"), cfg) if jax
             else Mapper(_index("golden_genome.fa"), cfg, device="cpu"))
        lines.append(_lines(m, m.map_batch(reads)))
    assert lines[0] == lines[1]
    assert len(lines[0]) >= len(reads) // 2


def test_device_index_equals_jax_planes():
    idx = _index("med_genome.fa")
    dix = DeviceIndex.from_index(idx, "cpu", colour_space=True)
    jm = JaxMapper(_jax_index("med_genome.fa"), _cs_cfg(jax=True))
    cs_cat, ls_cat = (np.asarray(a) for a in jm._genome_dev_planes_cs())
    assert dix.plane is None
    assert dix.cs_cat.dtype == torch.int8 and dix.ls_cat.dtype == torch.int8
    assert np.array_equal(dix.cs_cat.numpy(), cs_cat)
    assert np.array_equal(dix.ls_cat.numpy(), ls_cat)
    # and what the port's Mapper keeps for the host gathers
    m = Mapper(idx, _cs_cfg(), device="cpu")
    assert np.array_equal(m.genome_cs_rc, jm.genome_cs_rc)
    assert np.array_equal(m.genome_rc, jm.genome_rc)
    assert vars(m.vect_params) == vars(jm.vect_params)


def test_letter_space_index_refused():
    with pytest.raises(ValueError, match="colour_space=True"):
        Mapper(_index("golden_genome.fa", colour_space=False), _cs_cfg(),
               device="cpu")
