"""The packed colour-space posterior (`ops/post_sw.py::post_sw_packed`)
on the CPU: its plain version equals `post_sw_batch` on the rendered
alignments bit for bit, posterior floats and QUAL strings, on every
colour-space hit of golden_cs as the Mapper hands them over and on
hand-made ops that reach the edges of the column derivation
(`utils/post_sw_cases.py`); rows under their threshold are left out."""

import os

import numpy as np
import pytest
import torch

from shrimp_tpu_torch import index as gindex
from shrimp_tpu_torch.io import fastx
from shrimp_tpu_torch.ops import post_sw
from shrimp_tpu_torch.ops.params import ScoreProbs, SWParams
from shrimp_tpu_torch.pipeline.mapper import Mapper
from shrimp_tpu_torch.pipeline.options import MapperConfig
from shrimp_tpu_torch.utils import post_sw_cases

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
PROBS = ScoreProbs.from_scores(SWParams.colour_space(), True)

# (case, qual_vector_offset, quals, use_sanger_qvs)
CASES = {
    "sanger": (0, "mixed", True),
    "non_sanger": (0, "mixed", False),
    "qual_offset": (2, "mixed", True),
    "no_quals": (0, "none", True),
}


def _assert_equal_to_batch(args, kw, rows, items):
    posterior, qv = post_sw.post_sw_packed(*args, PROBS, **kw)
    assert posterior.dtype == torch.float64 and qv.dtype == torch.uint8
    want = post_sw.post_sw_batch(items, PROBS, **kw)
    posterior, qv = posterior.numpy(), qv.numpy()
    for n, (p, q33) in zip(rows, want):
        assert posterior[n] == p, n
        assert (qv[n, :len(q33)] + 33).tobytes().decode() == q33, n
        assert not qv[n, len(q33):].any()
    left_out = np.setdiff1d(np.arange(len(posterior)), rows)
    assert not posterior[left_out].any() and not qv[left_out].any()


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("R", [24, 56])
def test_packed_plain_equals_batch_on_edges(case, R):
    off, quals, sanger = CASES[case]
    c = post_sw_cases.packed_case(np.random.default_rng(R * 31 + off), 200,
                                  R, qual_vector_offset=off, quals=quals)
    rows, items = post_sw_cases.rendered_items(c)
    # every hand-made edge is present: kept, or left out under threshold
    kept = set(rows)
    for n, kind in enumerate(post_sw_cases.EDGES):
        assert (n in kept) == (kind not in ("below_threshold",
                                            "zero_score")), kind
    assert len(rows) > 150
    kw = dict(qual_delta=post_sw_cases.QUAL_DELTA, qual_vector_offset=off,
              use_sanger_qvs=sanger)
    _assert_equal_to_batch(c["args"], kw, rows, items)


def test_packed_plain_no_rows():
    c = post_sw_cases.packed_case(np.random.default_rng(5), 12, 16)
    args = list(c["args"])
    args[5] = torch.full_like(args[5], 10_000)       # every row under
    posterior, qv = post_sw.post_sw_packed(*args, PROBS)
    assert not posterior.any() and not qv.any()
    assert qv.shape == (12, 16)


def test_packed_plain_refuses_a_device_tensor():
    c = post_sw_cases.packed_case(np.random.default_rng(6), 12, 16)
    args = list(c["args"])
    args[0] = args[0].to("meta")
    with pytest.raises(ValueError):
        post_sw.post_sw_packed_plain(*args, PROBS)


@pytest.mark.parametrize("ignore_qvs", [False, True],
                         ids=["quals", "ignore_qvs"])
def test_mapper_hands_golden_cs_to_the_packed_posterior(monkeypatch,
                                                        ignore_qvs):
    """Every colour-space hit of golden_cs as the Mapper hands it to the
    packed posterior: equal to post_sw_batch on the rows rendered, and the
    Mapper counts those rows in posterior_rows."""
    idx = gindex.build_index(list(fastx.iter_contigs(
        os.path.join(GOLDEN, "golden_genome.fa"))), colour_space=True)
    calls = []
    orig = post_sw.post_sw_packed

    def record(*args, **kw):
        calls.append((args, kw))
        return orig(*args, **kw)

    monkeypatch.setattr(post_sw, "post_sw_packed", record)
    m = Mapper(idx, MapperConfig(colour_space=True,
                                 params=SWParams.colour_space(),
                                 qual_delta=33, ignore_qvs=ignore_qvs),
               device="cpu")
    m.map_batch([(r.name, r.seq, r.qual) for r in fastx.iter_reads(
        os.path.join(GOLDEN, "golden_reads_cs.fq"))])
    assert len(calls) == 1
    args, kw = calls[0]
    rows, items = _mapper_items(args, m)
    assert len(rows) == m.stats["posterior_rows"] > 100
    assert all((it["qual"] is None) == ignore_qvs for it in items)
    _assert_equal_to_batch(args[:10], kw, rows, items)


def _mapper_items(args, mapper):
    """The Mapper's packed arguments as `rendered_items` takes a case: the
    reads' lengths from the colours' pads, their qualities from the bytes
    where the Mapper uses them."""
    colours, qual, has_qual = (t.numpy() for t in args[6:9])
    read_len = (colours != post_sw_cases.READ_PAD).sum(axis=1).tolist()
    off = mapper.cfg.qual_vector_offset
    quals = [bytes(qual[b, :off + read_len[b]]).decode("latin-1")
             if has_qual[b] else None for b in range(len(read_len))]
    return post_sw_cases.rendered_items(
        {"args": list(args[:10]), "read_len": read_len, "quals": quals})


def test_packed_cuda_wrapper_refuses_cpu_tensors():
    """The kernel's wrapper takes CUDA tensors only: CPU ones go to the
    plain version through post_sw_packed, never to the kernel."""
    c = post_sw_cases.packed_case(np.random.default_rng(7), 12, 16)
    before = post_sw.LAUNCHES.value
    with pytest.raises(ValueError, match="CUDA"):
        post_sw.post_sw_packed_cuda(*c["args"], PROBS)
    assert post_sw.LAUNCHES.value == before
