"""The port's genome axis across processes
(`shrimp_tpu_torch.parallel.genome_axis`) on the CPU: two ranks of a
gloo group, each holding one genome-index shard, map the FULL read
stream; z1 crosses the group as an exact float64 all-gather summed in
shard order (with the all-reduce as a self-check), the paired results
merge at rank 0; the assembled SAM equals the single-process
whole-genome goldens byte for byte (the four cases of
tests/test_genome_axis.py; the option-set case against the port's own
single-process CLI)."""

import contextlib
import io
import os

import pytest

from shrimp_tpu_torch import gmapper
from test_torch_multihost import GOLDEN, body, golden_body, run_ranks

CASES = {
    "unpaired": ([], "golden_reads.fq", "golden_unpaired.sam"),
    "paired": (["-p", "opp-in", "-I", "0,500"], "golden_pairs.fq",
               "golden_paired.sam"),
    "cs": (["--mode", "cs"], "golden_reads_cs.fq", "golden_cs.sam"),
}
OSET = ("0;true/true,true,false/true,false,2,60%/"
        "true,60%,90%,2,false,20/60%,false,true,4/0")


def _genome_axis(tmp_path, flags, reads):
    out = str(tmp_path / "ga.sam")
    for rc, err in run_ranks(out, ["--genome-axis"], ["-Q", *flags, reads,
                             os.path.join(GOLDEN, "golden_genome.fa")]):
        assert rc == 0, err[-2000:]
    return body(out)


@pytest.mark.parametrize("case", sorted(CASES))
def test_genome_axis_goldens(case, tmp_path):
    flags, reads, gold = CASES[case]
    got = _genome_axis(tmp_path, flags, os.path.join(GOLDEN, reads))
    assert got == golden_body(gold)


def test_genome_axis_unpaired_option_set(tmp_path):
    """A non-default --unpaired-options string (one round, custom
    thresholds and output count) over the genome axis: byte-equal to the
    port's single-process run with the same string."""
    reads = os.path.join(GOLDEN, "golden_reads.fq")
    extra = ["--unpaired-options", OSET, "-o", "4"]
    so, se = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(so), contextlib.redirect_stderr(se):
        rc = gmapper.main(["gmapper", "-Q", *extra, reads,
                           os.path.join(GOLDEN, "golden_genome.fa")],
                          device="cpu")
    assert rc == 0, se.getvalue()[-2000:]
    want = [ln for ln in so.getvalue().splitlines()
            if ln and not ln.startswith("@")]
    assert _genome_axis(tmp_path, extra, reads) == want
    assert len(want) > 100
