"""The port's `parallel/shard.py` held to the JAX package's on the CPU:
`ShardedMapper` against the JAX `ShardedMapper` and the port's
whole-genome `Mapper`, `make_mesh`, `merge_scores_across_shards` against
the JAX reduce inside a `shard_map`, and `sharded_pass1_step` /
`sharded_map_step` against the JAX steps on the 8-device CPU mesh of
`tests/conftest.py`, at the JAX dry run's shapes (B 16, S 2, G 64, R 32,
k 4, seed 1).  `top` and `stats` must be equal; z1 is held at rtol 1e-6
(float32 posteriors, summed in another order by the psum).  Pass 2 of
the port's map step runs K3+K4's plain version over the full band where
the JAX step runs the unbanded K5."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh
from jax.sharding import PartitionSpec as P

from shrimp_tpu import index as jindex
from shrimp_tpu.io import fastx as jfastx
from shrimp_tpu.parallel import shard as jshard
from shrimp_tpu.pipeline.options import MapperConfig as JaxConfig
from shrimp_tpu_torch import index as gindex
from shrimp_tpu_torch.io import fastx
from shrimp_tpu_torch.parallel import shard
from shrimp_tpu_torch.pipeline.mapper import Mapper
from shrimp_tpu_torch.pipeline.options import MapperConfig

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
B, G, R, K = 16, 64, 32, 4


def _dry_run_inputs(S: int):
    rng = np.random.default_rng(1)
    windows = rng.integers(0, 4, size=(B, S, G)).astype(np.int8)
    reads = rng.integers(0, 4, size=(B, 1, R)).astype(np.int8)
    return windows, reads


def test_sharded_mapper_equals_jax_and_whole():
    """Per-contig shards of the golden genome: the port's ShardedMapper
    gives the JAX ShardedMapper's hits and MQVs, and the whole-genome
    Mapper's placements, scores and MQVs."""
    path = os.path.join(GOLDEN, "golden_genome.fa")
    contigs = list(fastx.iter_contigs(path))
    jcontigs = list(jfastx.iter_contigs(path))
    reads = [(r.name, r.seq, r.qual) for r in fastx.iter_reads(
        os.path.join(GOLDEN, "mini_reads.fq"))]

    whole = Mapper(gindex.build_index(contigs), MapperConfig(qual_delta=64),
                   device="cpu")
    ours = shard.ShardedMapper([gindex.build_index([c]) for c in contigs],
                               MapperConfig(qual_delta=64), device="cpu")
    theirs = jshard.ShardedMapper([jindex.build_index([c])
                                   for c in jcontigs],
                                  JaxConfig(qual_delta=64))
    res_w = whole.map_batch(reads)
    res_o = ours.map_batch(reads)
    res_t = theirs.map_batch(reads)
    n_hits = 0
    for (e_w, hw), (_, ho), (_, ht) in zip(res_w, res_o, res_t):
        assert len(ho) == len(ht) == len(hw), e_w.name
        for w, (so, o), (st, t) in zip(hw, ho, ht):
            key_o = (ours.contig_name(so, o.cn), o.gen_st,
                     o.g_off + o.genome_start, o.score_full, o.mqv)
            assert key_o == (theirs.contig_name(st, t.cn), t.gen_st,
                             t.g_off + t.genome_start, t.score_full, t.mqv)
            assert key_o == (whole.index.contig_names[w.cn], w.gen_st,
                             w.g_off + w.genome_start, w.score_full, w.mqv)
            assert o.z1 == t.z1
            n_hits += 1
    assert n_hits > 30


def test_make_mesh_shapes_and_replication():
    cards = [torch.device("cuda", i) for i in range(3)]
    m = shard.make_mesh(8, genome_shards=2, devices=cards)
    assert m.shape == {shard.READS_AXIS: 4, shard.GENOME_AXIS: 2}
    assert m.axis_names == (shard.READS_AXIS, shard.GENOME_AXIS)
    flat = [d for row in m.devices for d in row]
    assert flat == [cards[i % 3] for i in range(8)]     # round-robin
    one = shard.make_mesh(4, genome_shards=4, devices=["cpu"])
    assert one.shape == {shard.READS_AXIS: 1, shard.GENOME_AXIS: 4}
    assert all(d == torch.device("cpu") for d in one.devices[0])
    assert shard.make_mesh(genome_shards=1, devices=cards).shape == \
        {shard.READS_AXIS: 3, shard.GENOME_AXIS: 1}
    with pytest.raises(ValueError, match="not divisible"):
        shard.make_mesh(6, genome_shards=4, devices=["cpu"])


def test_merge_scores_across_shards_equals_jax():
    S, H, k = 4, 24, 6
    rng = np.random.default_rng(3)
    scores = rng.integers(0, 200, size=(S, H)).astype(np.int32)
    posts = rng.random((S, H)).astype(np.float32)
    mesh = JaxMesh(np.array(jax.devices()[:S]), (jshard.GENOME_AXIS,))
    fn = jax.jit(jax.shard_map(
        lambda s, p: jshard.merge_scores_across_shards(s[0], p[0], k),
        mesh=mesh, in_specs=(P(jshard.GENOME_AXIS), P(jshard.GENOME_AXIS)),
        out_specs=(P(), P()), check_vma=False))
    top_j, z1_j = fn(jnp.asarray(scores), jnp.asarray(posts))
    top, z1 = shard.merge_scores_across_shards(
        [torch.from_numpy(s) for s in scores],
        [torch.from_numpy(p) for p in posts], k)
    assert top.tolist() == np.asarray(top_j).tolist()
    np.testing.assert_allclose(float(z1), float(z1_j), rtol=1e-6)


@pytest.mark.parametrize("n, S", [(4, 2), (2, 2)], ids=["2x2", "1x2"])
def test_sharded_steps_equal_jax(n, S):
    windows, reads = _dry_run_inputs(S)
    jm = jshard.make_mesh(n, genome_shards=S)
    with jm:
        top_j, z1_j = jshard.sharded_pass1_step(jm, k=K)(windows, reads)
        stats_j, z1b_j = jshard.sharded_map_step(jm)(windows, reads)
    tm = shard.make_mesh(n, genome_shards=S, devices=["cpu"])
    top, z1 = shard.sharded_pass1_step(tm, k=K)(windows, reads)
    stats, z1b = shard.sharded_map_step(tm)(windows, reads)
    assert top.shape == (B, min(K, S)) and stats.shape == (B, 10)
    assert np.array_equal(top.numpy(), np.asarray(top_j))
    assert np.array_equal(stats.numpy(), np.asarray(stats_j))
    np.testing.assert_allclose(z1.numpy(), np.asarray(z1_j), rtol=1e-6)
    np.testing.assert_allclose(z1b.numpy(), np.asarray(z1b_j), rtol=1e-6)


def test_first_argmax_takes_the_first_of_tied_maxima():
    rng = np.random.default_rng(4)
    x = rng.integers(0, 3, size=(200, 5)).astype(np.int32)   # many ties
    got = shard.first_argmax(torch.from_numpy(x)).numpy()
    assert np.array_equal(got, np.argmax(x, axis=1))
    assert np.array_equal(got, np.asarray(jnp.argmax(jnp.asarray(x),
                                                     axis=1)))


def test_map_step_with_tied_window_scores_equals_jax():
    """Every read matches both shards' windows exactly, at different
    columns: the pass-1 scores tie, the winning shard (the first, as
    jnp.argmax takes it) decides the stats' genome start."""
    rng = np.random.default_rng(9)
    S = 2
    windows = rng.integers(0, 4, size=(B, S, G)).astype(np.int8)
    reads = rng.integers(0, 4, size=(B, 1, R)).astype(np.int8)
    windows[:, 0, 5:5 + R] = reads[:, 0]
    windows[:, 1, 20:20 + R] = reads[:, 0]
    tm = shard.make_mesh(2, genome_shards=S, devices=["cpu"])
    stats, _ = shard.sharded_map_step(tm)(windows, reads)
    jm = jshard.make_mesh(2, genome_shards=S)
    with jm:
        stats_j, _ = jshard.sharded_map_step(jm)(windows, reads)
    assert np.array_equal(stats.numpy(), np.asarray(stats_j))
    assert (stats.numpy()[:, 2] == 5).all()      # genome start: shard 0
