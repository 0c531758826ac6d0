"""The port's index persistence on the CPU: the reference's `.genome` /
`.seed.N` projection (`shrimp_tpu_torch.io.refindex`), this package's npz
and mmap formats, and what a loaded index gives the mapper.

`tests/golden/refproj.*` was produced by the reference binary:
`gmapper-ls -S refproj golden_genome.fa`.  Both formats are gzip, whose
header carries an mtime, so two writes of one index are compared by their
decompressed bytes."""

import contextlib
import gzip
import io
import os
import warnings

import numpy as np
import pytest
import torch

from shrimp_tpu import index as jindex
from shrimp_tpu.io import fastx as jfastx
from shrimp_tpu.io import refindex as jrefindex
from shrimp_tpu_torch import gmapper
from shrimp_tpu_torch import index as gindex
from shrimp_tpu_torch.io import fastx, refindex
from shrimp_tpu_torch.ops import candidates_device as tcd
from shrimp_tpu_torch.pipeline.mapper import Mapper
from shrimp_tpu_torch.pipeline.options import MapperConfig

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
GENOME = os.path.join(GOLDEN, "golden_genome.fa")
PREFIX = os.path.join(GOLDEN, "refproj")
ARRAYS = ("contig_offsets", "contig_len", "genome", "genome_cs")


def build(colour=False):
    return gindex.build_index(list(fastx.iter_contigs(GENOME)),
                              colour_space=colour)


def jax_build(colour=False):
    return jindex.build_index(list(jfastx.iter_contigs(GENOME)),
                              colour_space=colour)


def assert_same_index(a, b):
    """Equal contigs, planes, seeds and posting lists, of equal dtypes."""
    assert a.contig_names == b.contig_names
    assert a.colour_space == b.colour_space
    for name in ARRAYS:
        x, y = getattr(a, name), getattr(b, name)
        assert (x is None) == (y is None), name
        if x is not None:
            assert x.dtype == y.dtype, name
            assert np.array_equal(x, y), name
    assert [s.pattern for s in a.seed_set.seeds] == \
        [s.pattern for s in b.seed_set.seeds]
    assert a.seed_set.use_hashing == b.seed_set.use_hashing
    assert len(a.offsets) == len(b.offsets)
    for x, y in zip(a.offsets + a.positions, b.offsets + b.positions):
        assert x.dtype == y.dtype
        assert np.array_equal(x, y)


def unzipped(prefix, n_seeds):
    names = [".genome"] + [f".seed.{sn}" for sn in range(n_seeds)]
    out = {}
    for nm in names:
        with gzip.open(prefix + nm, "rb") as fh:
            out[nm] = fh.read()
    return out


def test_reference_projection_loads_as_built():
    """The reference binary's -S projection loads equal to the index built
    from FASTA: contigs, planes, seeds, CSR, and the dtypes every consumer
    of a built index expects (int64 contig tables and offsets, uint32
    positions)."""
    assert_same_index(refindex.load(PREFIX), build())


def test_save_load_round_trip(tmp_path):
    """The reference format written and read back gives the index, with
    its dtypes."""
    ours = build()
    refindex.save(ours, str(tmp_path / "rt"))
    assert_same_index(refindex.load(str(tmp_path / "rt")), ours)


@pytest.mark.parametrize("colour", [False, True], ids=["ls", "cs"])
def test_writers_agree_with_the_jax_package(tmp_path, colour):
    """The port's writer and the JAX package's write the same decompressed
    bytes for the same index, and each reader loads the other's files
    into equal arrays."""
    ours, theirs = build(colour), jax_build(colour)
    refindex.save(ours, str(tmp_path / "port"))
    jrefindex.save(theirs, str(tmp_path / "jax"))
    n = len(ours.offsets)
    assert unzipped(str(tmp_path / "port"), n) == \
        unzipped(str(tmp_path / "jax"), n)
    assert_same_index(refindex.load(str(tmp_path / "jax")), ours)
    assert_same_index(jrefindex.load(str(tmp_path / "port")), theirs)


def test_reference_projection_is_recognised():
    assert refindex.is_reference_index(PREFIX)
    assert not refindex.is_reference_index(PREFIX + "_absent")


def test_cli_maps_from_reference_projection():
    """gmapper -L <reference projection> maps byte-identically to the
    reference's run on the FASTA (VERDICT round-trip criterion)."""
    so, se = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(so), contextlib.redirect_stderr(se):
        rc = gmapper.main(["gmapper", "-L", PREFIX, "-Q",
                           os.path.join(GOLDEN, "golden_reads.fq")],
                          device="cpu")
    assert rc == 0, se.getvalue()[-2000:]
    got = [ln for ln in so.getvalue().splitlines() if not ln.startswith("@")]
    with open(os.path.join(GOLDEN, "golden_unpaired.sam")) as fh:
        want = [ln.rstrip("\n") for ln in fh if not ln.startswith("@")]
    assert got == want
    # the settings echo is printed only when no projection is loaded
    assert "Settings:" not in se.getvalue()


@pytest.mark.parametrize("fmt", ["npz", "mmap"])
def test_loaded_indexes_keep_the_built_dtypes(tmp_path, fmt):
    """This package's two formats give the index back with its dtypes
    (the reference format: test_save_load_round_trip)."""
    ours = build()
    prefix = str(tmp_path / "i")
    if fmt == "npz":
        ours.save(prefix)
        back = gindex.GenomeIndex.load(prefix)
    else:
        ours.save_mmap(prefix)
        back = gindex.GenomeIndex.load_mmap(prefix)
    assert_same_index(back, ours)


def test_mmap_index_reaches_the_device_by_copies(tmp_path):
    """A --load-mmap index is read-only memory: the pass-1 planes and K10's
    postings are copies of it (no warning from torch, no tensor over the
    map), and the mapper gives the SAM of the built index, on host
    candidates and on K10's plain version."""
    ours = build()
    ours.save_mmap(str(tmp_path / "m"))
    back = gindex.GenomeIndex.load_mmap(str(tmp_path / "m"))
    assert not back.positions[0].flags.writeable
    reads = [(r.name, r.seq, r.qual) for r in fastx.iter_reads(
        os.path.join(GOLDEN, "golden_reads.fq"))]

    def sam(idx, dc):
        m = Mapper(idx, MapperConfig(qual_delta=64, device_candidates=dc),
                   device="cpu")
        return [rec.line() for e, hits in m.map_batch(reads)
                for rec in m.sam_records(e, hits)]

    with warnings.catch_warnings():
        warnings.simplefilter("error")
        dev = tcd.DeviceL3Index.from_host(back, "cpu")
        for t in (dev.positions, *dev.offsets):
            assert t.numpy().flags.writeable
        got = {dc: sam(back, dc) for dc in (False, True)}
    want = sam(ours, False)
    assert got[False] == want and got[True] == want
    assert torch.equal(dev.positions, tcd.DeviceL3Index.from_host(
        ours, "cpu").positions)
