"""The port's `MeshMapper` (`parallel/mesh.py`) on the CPU, against both
the port's single-device mapper and the JAX package's mesh mapper on the
same corpus (`build_corpus` of tests/test_mesh_mapper.py): 4 genome
shards, the mesh against the file workflow (`ShardedMapper` over
per-contig shards), and colour space.  SAM lines are compared byte for
byte, so every MQV is bit-equal.  The paired mesh is
tests/test_torch_mesh_paired.py."""

import os
import sys

from shrimp_tpu.parallel import mesh as jmesh
from shrimp_tpu.parallel import shard as jshard
from shrimp_tpu.pipeline.options import MapperConfig as JaxConfig
from shrimp_tpu_torch import index as gindex
from shrimp_tpu_torch.io import fastx
from shrimp_tpu_torch.ops.params import SWParams
from shrimp_tpu_torch.parallel import mesh, shard
from shrimp_tpu_torch.pipeline.mapper import Mapper
from shrimp_tpu_torch.pipeline.options import MapperConfig

sys.path.insert(0, os.path.dirname(__file__))
from test_mesh_mapper import build_corpus  # noqa: E402

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def _port_contigs(contigs):
    return [fastx.Contig(name=c.name, codes=c.codes) for c in contigs]


def _cpu_mesh(S):
    return shard.make_mesh(S, genome_shards=S, devices=["cpu"])


def _lines(mapper, results):
    return [rec.line() for e, hits in results
            for rec in mapper.sam_records(e, hits)]


def test_mesh_equals_single_device_and_jax_mesh():
    jcontigs, reads = build_corpus()
    contigs = _port_contigs(jcontigs)
    shards = mesh.split_index_shards(contigs, 4)
    assert len(shards) == 4
    single = Mapper(gindex.build_index(contigs), MapperConfig(qual_delta=64),
                    device="cpu")
    mm = mesh.MeshMapper(shards, MapperConfig(qual_delta=64),
                         mesh=_cpu_mesh(4))
    assert mm.cfg.device_candidates is False          # "auto" -> host
    jm = jmesh.MeshMapper(jmesh.split_index_shards(jcontigs, 4),
                          JaxConfig(qual_delta=64),
                          mesh=jshard.make_mesh(8, genome_shards=4))
    got = _lines(mm, mm.map_batch(reads))
    assert got == _lines(single, single.map_batch(reads))
    assert got == _lines(jm, jm.map_batch(reads))
    assert len(got) == len(reads)
    assert mm.tel.f1.invocs == jm.tel.f1.invocs


def test_mesh_matches_file_workflow():
    """The in-process merge equals the offline splitdb + per-shard map +
    merge algebra (same hits, scores, MQVs), in the port and in JAX."""
    jcontigs, reads = build_corpus(seed=33)
    contigs = _port_contigs(jcontigs)
    mm = mesh.MeshMapper(mesh.split_index_shards(contigs, 4),
                         MapperConfig(qual_delta=64), mesh=_cpu_mesh(4))
    sm = shard.ShardedMapper([gindex.build_index([c]) for c in contigs],
                             MapperConfig(qual_delta=64), device="cpu")
    jm = jmesh.MeshMapper(jmesh.split_index_shards(jcontigs, 4),
                          JaxConfig(qual_delta=64),
                          mesh=jshard.make_mesh(4, genome_shards=4))
    res_mesh = mm.map_batch(reads)
    res_file = sm.map_batch(reads)
    res_jax = jm.map_batch(reads)

    def keyed(m, res):
        return [[(m.contig_name(s, h.cn), h.gen_st, h.g_off + h.genome_start,
                  h.score_full, h.mqv) for s, h in hits] for _, hits in res]

    assert keyed(mm, res_mesh) == keyed(sm, res_file) == keyed(jm, res_jax)


def test_colour_space_mesh_equals_single_device():
    """Colour space across 3 genome shards (the JAX suites hold no
    colour-space mesh case): the golden colour-space reads against the
    golden genome's two contigs and four random ones, byte-equal to the
    single-device mapper."""
    jcontigs, _ = build_corpus(n_contigs=4, contig_len=6_000)
    cfg = dict(colour_space=True, params=SWParams.colour_space(),
               qual_delta=33)
    reads = [(r.name, r.seq, r.qual) for r in fastx.iter_reads(
        os.path.join(GOLDEN, "golden_reads_cs.fq"))]
    contigs = list(fastx.iter_contigs(os.path.join(
        GOLDEN, "golden_genome.fa"))) + _port_contigs(jcontigs)
    single = Mapper(gindex.build_index(contigs, colour_space=True),
                    MapperConfig(**cfg), device="cpu")
    mm = mesh.MeshMapper(
        mesh.split_index_shards(contigs, 3, colour_space=True),
        MapperConfig(**cfg), mesh=_cpu_mesh(3))
    assert mm.S == 3
    got = _lines(mm, mm.map_batch(reads))
    assert got == _lines(single, single.map_batch(reads))
    assert sum(ln.split("\t")[2] != "*" for ln in got) > 50
