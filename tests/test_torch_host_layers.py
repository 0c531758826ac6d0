"""The port's own copies of the host layers against their originals in the
JAX package, on the golden inputs: index arrays, read preparation and
host candidates (`anchors_batch` / `hit_list_batch`), the colour-space
posterior (`post_sw_batch`), SAM record lines, and the synthetic corpus
generators against the JAX bench's.  The copies change nothing but their
imports, so every comparison is exact (floats included: same operations
in the same order)."""

import dataclasses
import os
import sys

import numpy as np
import pytest

from shrimp_tpu import index as jindex
from shrimp_tpu import seeds as jseeds
from shrimp_tpu.io import fastx as jfastx
from shrimp_tpu.io import sam as jsam
from shrimp_tpu.ops import post_sw as jpost_sw
from shrimp_tpu.ops.params import ScoreProbs as JaxProbs
from shrimp_tpu.ops.params import SWParams as JaxParams
from shrimp_tpu.pipeline import candidates as jcand
from shrimp_tpu.pipeline import candidates_batch as jcb
from shrimp_tpu.pipeline.options import MapperConfig as JaxConfig
from shrimp_tpu_torch import index as gindex
from shrimp_tpu_torch import seeds as seedmod
from shrimp_tpu_torch.io import fastx, sam
from shrimp_tpu_torch.ops import post_sw
from shrimp_tpu_torch.ops.params import ScoreProbs, SWParams
from shrimp_tpu_torch.pipeline import candidates as cand
from shrimp_tpu_torch.pipeline import candidates_batch as cb
from shrimp_tpu_torch.pipeline.mapper import Mapper
from shrimp_tpu_torch.pipeline.options import MapperConfig
from shrimp_tpu_torch.utils import synth

# the JAX package's bench scripts: bench.py at the root of the repo,
# bench_grid.py under benchmarks/
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _p in (_REPO, os.path.join(_REPO, "benchmarks")):
    if _p not in sys.path:
        sys.path.insert(0, _p)
import bench  # noqa: E402
import bench_grid  # noqa: E402

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def _indexes(genome, colour_space=False, use_hashing=False, trim=None):
    """The port's and the JAX package's index of one genome file."""
    out = []
    for ix, fx, sd in ((gindex, fastx, seedmod), (jindex, jfastx, jseeds)):
        idx = ix.build_index(
            list(fx.iter_contigs(os.path.join(GOLDEN, genome))),
            sd.make_seed_set(None, use_hashing=use_hashing),
            colour_space=colour_space)
        if trim is not None:
            idx.trim(trim)
        out.append(idx)
    return out


@pytest.mark.parametrize("genome,colour_space,use_hashing,trim", [
    ("golden_genome.fa", False, False, None),
    ("golden_genome.fa", True, False, None),
    ("golden_genome.fa", False, True, None),
    ("med_genome.fa", False, False, 3),
], ids=["ls", "cs", "hashed", "med_trimmed"])
def test_index_arrays_equal(genome, colour_space, use_hashing, trim):
    idx, jidx = _indexes(genome, colour_space, use_hashing, trim)
    assert np.array_equal(idx.genome, jidx.genome)
    assert list(idx.contig_names) == list(jidx.contig_names)
    assert np.array_equal(idx.contig_offsets, jidx.contig_offsets)
    assert np.array_equal(idx.contig_len, jidx.contig_len)
    assert idx.total_len == jidx.total_len
    assert int(idx.list_cutoff) == int(jidx.list_cutoff)
    assert len(idx.offsets) == len(jidx.offsets) >= 1
    for sn in range(len(idx.offsets)):
        assert np.array_equal(idx.offsets[sn], jidx.offsets[sn]), sn
        assert np.array_equal(idx.positions[sn], jidx.positions[sn]), sn


def _entries(cand_mod, config, reads, colour_space, min_span):
    params = ((SWParams if cand_mod is cand else JaxParams).colour_space()
              if colour_space else None)
    cfg = config(qual_delta=33 if colour_space else 64,
                 colour_space=colour_space,
                 **({"params": params} if params else {}))
    recs = [(r.name, r.seq, r.qual) for r in
            fastx.iter_reads(os.path.join(GOLDEN, reads))]
    return cfg, cand_mod.prepare_reads(recs, cfg, min_span)


def _assert_batches_equal(got, want):
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            assert np.array_equal(np.asarray(a), b), f.name
        else:
            assert a == b, f.name


@pytest.mark.parametrize("colour_space", [False, True], ids=["ls", "cs"])
@pytest.mark.parametrize("st", [0, 1])
@pytest.mark.parametrize("use_regions", [False, True],
                         ids=["all", "regions"])
def test_anchors_and_hit_list_equal(colour_space, st, use_regions):
    idx, jidx = _indexes("golden_genome.fa", colour_space)
    reads = "golden_reads_cs.fq" if colour_space else "golden_reads.fq"
    cfg, entries = _entries(cand, MapperConfig, reads, colour_space,
                            idx.seed_set.min_span)
    jcfg, jentries = _entries(jcand, JaxConfig, reads, colour_space,
                              jidx.seed_set.min_span)
    assert len(entries) == len(jentries) > 100
    for e, je in zip(entries, jentries):
        assert (e.read_len, e.window_len, e.min_kmer_pos) == \
            (je.read_len, je.window_len, je.min_kmer_pos)
        assert np.array_equal(e.read[st], je.read[st])
    opts = cfg.unpaired_options()[0].hit_list
    jopts = jcfg.unpaired_options()[0].hit_list
    ab = cb.anchors_batch(entries, idx, st, collapse=True,
                          list_cutoff=idx.list_cutoff,
                          use_region_counts=use_regions)
    jab = jcb.anchors_batch(jentries, jidx, st, collapse=True,
                            list_cutoff=jidx.list_cutoff,
                            use_region_counts=use_regions)
    _assert_batches_equal(ab, jab)
    hb = cb.hit_list_batch(entries, idx, ab, opts, cfg)
    jhb = jcb.hit_list_batch(jentries, jidx, jab, jopts, jcfg)
    assert hb.n == jhb.n > 0
    _assert_batches_equal(hb, jhb)


def test_post_sw_batch_equal_on_colour_space(monkeypatch):
    """The posterior forward/backward of every colour-space hit of the
    golden_cs reads, as the port's Mapper hands them over."""
    idx = gindex.build_index(list(fastx.iter_contigs(
        os.path.join(GOLDEN, "golden_genome.fa"))), colour_space=True)
    calls = []
    orig = post_sw.post_sw_batch

    def record(items, probs, **kw):
        calls.append((items, kw))
        return orig(items, probs, **kw)

    monkeypatch.setattr(post_sw, "post_sw_batch", record)
    m = Mapper(idx, MapperConfig(colour_space=True,
                                 params=SWParams.colour_space(),
                                 qual_delta=33), device="cpu")
    m.map_batch([(r.name, r.seq, r.qual) for r in fastx.iter_reads(
        os.path.join(GOLDEN, "golden_reads_cs.fq"))])
    assert calls and sum(len(items) for items, _ in calls) > 100
    probs = ScoreProbs.from_scores(SWParams.colour_space(), True)
    jprobs = JaxProbs.from_scores(JaxParams.colour_space(), True)
    for items, kw in calls:
        assert orig(items, probs, **kw) == \
            jpost_sw.post_sw_batch(items, jprobs, **kw)


@pytest.mark.parametrize("reverse", [False, True])
def test_sam_record_line_equal(reverse):
    ops = np.array([0] * 20 + [1, 1] + [0] * 26 + [2] + [0] * 3, np.int8)
    kw = dict(name="r1", seq_text="ACGTN" * 10, qual="I" * 50,
              contig_name="chr2", contig_len=5000, genome_start0=1234,
              read_start0=0, rmapped=50, gmapped=49, insertions=1,
              deletions=2, mismatches=3, ops=ops, reverse_strand=reverse,
              score_full=412, mapq_v=37, z0=0.97, z1=0.5, qual_delta=64)
    line = sam.aligned_record_from_ops(**kw).line()
    assert line == jsam.aligned_record_from_ops(**kw).line()
    assert line.startswith("r1\t16\t" if reverse else "r1\t0\t")
    assert sam.unaligned_record_cs("r2", "T0123.1", "IIIII").line() == \
        jsam.unaligned_record_cs("r2", "T0123.1", "IIIII").line()


@pytest.fixture
def small_bench_genome(monkeypatch):
    monkeypatch.setattr(bench, "GENOME_BP", 250_000)
    return 250_000


def test_synth_genome_equals_bench(small_bench_genome):
    got = synth.make_genome(np.random.default_rng(20260817),
                            small_bench_genome)
    want = bench.make_genome(np.random.default_rng(20260817))
    assert len(got) == len(want) == 25
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


@pytest.mark.parametrize("gen", ["make_reads", "make_cs_reads",
                                 "make_pairs"])
def test_synth_reads_equal_bench(small_bench_genome, gen):
    chroms = synth.make_genome(np.random.default_rng(3), small_bench_genome)
    idx = gindex.build_index([fastx.Contig(name=f"chr{i + 1}", codes=g)
                              for i, g in enumerate(chroms)],
                             seedmod.make_seed_set(None))
    want_fn = {"make_reads": bench.make_reads,
               "make_cs_reads": bench_grid.make_cs_reads,
               "make_pairs": bench_grid.make_pairs}[gen]
    reads, truth = getattr(synth, gen)(idx, np.random.default_rng(7), 300)
    jreads, jtruth = want_fn(idx, np.random.default_rng(7), 300)
    assert reads == jreads
    assert np.array_equal(truth, jtruth)
