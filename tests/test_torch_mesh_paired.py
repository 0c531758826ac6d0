"""The port's `MeshPairedMapper` (`parallel/mesh.py`) on the CPU, against
both the port's single-device `PairedMapper` and the JAX package's mesh
mapper on the same corpus (`build_pair_corpus` of
tests/test_mesh_mapper.py), with the `--strata` / `--max-alignments`
policies it applies across shards; and the paired hooks it needs
(`PairedMapper.mqv_total_len`, `map_pair_batch(compute_mqv=False)`)
against the JAX `PairedMapper`.  SAM lines are compared byte for byte,
so every MQV is bit-equal."""

import os
import sys

import pytest

from shrimp_tpu import index as jindex
from shrimp_tpu.io import fastx as jfastx
from shrimp_tpu.parallel import mesh as jmesh
from shrimp_tpu.parallel import shard as jshard
from shrimp_tpu.pipeline.options import MapperConfig as JaxConfig
from shrimp_tpu.pipeline.paired import PairedConfig as JaxPairedConfig
from shrimp_tpu.pipeline.paired import PairedMapper as JaxPairedMapper
from shrimp_tpu_torch import index as gindex
from shrimp_tpu_torch.io import fastx
from shrimp_tpu_torch.parallel import mesh
from shrimp_tpu_torch.pipeline.options import MapperConfig
from shrimp_tpu_torch.pipeline.paired import PairedConfig, PairedMapper

sys.path.insert(0, os.path.dirname(__file__))
from test_mesh_mapper import build_pair_corpus  # noqa: E402
from test_torch_mesh import _cpu_mesh, _port_contigs  # noqa: E402

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
PAIRING = dict(pair_mode=1, min_insert_size=0, max_insert_size=500)


def _pair_lines(mapper, results):
    return [rec.line() for pr, tp, tu in results
            for rec in mapper.sam_records_pair(pr, tp, tu)]


def test_mesh_paired_equals_single_device_and_jax_mesh():
    jcontigs, pairs = build_pair_corpus()
    contigs = _port_contigs(jcontigs)
    single = PairedMapper(gindex.build_index(contigs),
                          MapperConfig(qual_delta=64),
                          PairedConfig(**PAIRING), device="cpu")
    mm = mesh.MeshPairedMapper(mesh.split_index_shards(contigs, 4),
                               MapperConfig(qual_delta=64),
                               PairedConfig(**PAIRING), mesh=_cpu_mesh(4))
    jm = jmesh.MeshPairedMapper(jmesh.split_index_shards(jcontigs, 4),
                                JaxConfig(qual_delta=64),
                                JaxPairedConfig(**PAIRING),
                                mesh=jshard.make_mesh(8, genome_shards=4))
    want = [rec.line() for pr in single.map_pair_batch(pairs)
            for rec in single.sam_records_pair(pr)]
    got = _pair_lines(mm, mm.map_pair_batch(pairs))
    assert got == want
    assert got == _pair_lines(jm, jm.map_pair_batch(pairs))
    assert mm._z_collective_checked
    assert mm._merge_mapper.mqv_total_len == sum(len(c.codes)
                                                 for c in contigs)


@pytest.mark.parametrize("policy", [{"strata": True},
                                    {"max_alignments": 2}],
                         ids=["strata", "max_alignments"])
def test_mesh_paired_policies_equal_single_and_jax(policy):
    """--strata / --max-alignments act on the CROSS-shard candidate set:
    shard funnels run them neutralized, the merge applies them."""
    jcontigs, pairs = build_pair_corpus(n_pairs=40, seed=55)
    contigs = _port_contigs(jcontigs)
    single = PairedMapper(gindex.build_index(contigs),
                          MapperConfig(qual_delta=64, **policy),
                          PairedConfig(**PAIRING), device="cpu")
    mm = mesh.MeshPairedMapper(mesh.split_index_shards(contigs, 4),
                               MapperConfig(qual_delta=64, **policy),
                               PairedConfig(**PAIRING), mesh=_cpu_mesh(4))
    jm = jmesh.MeshPairedMapper(jmesh.split_index_shards(jcontigs, 4),
                                JaxConfig(qual_delta=64, **policy),
                                JaxPairedConfig(**PAIRING),
                                mesh=jshard.make_mesh(8, genome_shards=4))
    got = _pair_lines(mm, mm.map_pair_batch(pairs))
    assert got == [rec.line() for pr in single.map_pair_batch(pairs)
                   for rec in single.sam_records_pair(pr)]
    assert got == _pair_lines(jm, jm.map_pair_batch(pairs))


def test_mqv_total_len_and_deferred_mqv_equal_jax(monkeypatch):
    """The paired hooks a genome-shard merge needs, against the JAX
    PairedMapper's: map_pair_batch(compute_mqv=False) leaves every MQV
    unset and the SAM otherwise equal; then `_paired_mqv` on a PairResult
    that holds paired hits and half-paired hits at once (what a merge of
    two shards' results can hold; the only case where the class priors
    reach an MQV) scales them by mqv_total_len."""
    path = os.path.join(GOLDEN, "golden_genome.fa")
    contig0 = list(fastx.iter_contigs(path))[:1]
    recs = [(r.name, r.seq, r.qual) for r in fastx.iter_reads(
        os.path.join(GOLDEN, "golden_pairs.fq"))]
    pairs = [(recs[i], recs[i + 1]) for i in range(0, len(recs) - 1, 2)]
    ours = PairedMapper(gindex.build_index(contig0),
                        MapperConfig(qual_delta=64, half_paired=True),
                        PairedConfig(**PAIRING), device="cpu")
    theirs = JaxPairedMapper(
        jindex.build_index(list(jfastx.iter_contigs(path))[:1]),
        JaxConfig(qual_delta=64, half_paired=True),
        JaxPairedConfig(**PAIRING))
    assert ours.mqv_total_len is None and theirs.mqv_total_len is None

    def mqvs(res):
        return [[fh.mqv for fh0, fh1, _ in pr.paired_hits
                 for fh in (fh0, fh1)] + [fh.mqv for _, fh in
                                          pr.unpaired_hits] for pr in res]

    res_o = ours.map_pair_batch(pairs, compute_mqv=False)
    res_t = theirs.map_pair_batch(pairs, compute_mqv=False)
    assert mqvs(res_o) == mqvs(res_t)
    assert {q for row in mqvs(res_o) for q in row} == {255}    # unset

    def mixed(res):
        pa = next(pr for pr in res if pr.paired_hits)
        pb = next(pr for pr in res if pr.unpaired_hits)
        return type(pa)(re=pa.re, paired_hits=list(pa.paired_hits),
                        unpaired_hits=list(pb.unpaired_hits))

    def merged_mqvs():
        got = []
        for total_len in (None, 10 ** 4, 10 ** 16):
            ours.mqv_total_len = theirs.mqv_total_len = total_len
            mo, mt = mixed(res_o), mixed(res_t)
            ours._paired_mqv(mo)
            theirs._paired_mqv(mt)
            assert mqvs([mo]) == mqvs([mt]), total_len
            got.append(mqvs([mo])[0])
        return got

    merged_mqvs()
    # the golden reads' random-mapping probabilities are so small that
    # no genome length moves an MQV: with 10^(-score/50), the class
    # priors pr_top_random * total_len come into range
    from shrimp_tpu import mapq as jmapq
    from shrimp_tpu_torch import mapq
    for mod in (mapq, jmapq):
        monkeypatch.setattr(mod, "pr_random_mapping_given_score",
                            lambda rlen, score, *a: 10.0 ** (-score / 50))
    got = merged_mqvs()
    assert got[1] != got[2]        # the priors moved the MQVs
