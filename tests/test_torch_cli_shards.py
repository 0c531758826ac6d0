"""The port's CLI with `--genome-shards` / `--devices`, on the CPU: the four
golden cases of the JAX package's CLI suite (tests/test_cli.py, letter and
colour space, unpaired and paired, two genome shards), four shards on one
device (the golden genome has two contigs, so two shards), and the error
exits of the shard branches, as the JAX CLI takes them."""

import contextlib
import io
import os

import pytest

from shrimp_tpu_torch import gmapper

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def run(args):
    so, se = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(so), contextlib.redirect_stderr(se):
        rc = gmapper.main(["gmapper"] + list(args), device="cpu")
    return rc, so.getvalue(), se.getvalue()


def body(text):
    return [ln for ln in text.splitlines() if ln and not ln.startswith("@")]


def golden_body(name):
    with open(os.path.join(GOLDEN, name)) as fh:
        return [ln.rstrip("\n") for ln in fh if not ln.startswith("@")]


def g(name):
    return os.path.join(GOLDEN, name)


# tests/test_cli.py:93-131
SHARD_GOLDENS = {
    "unpaired": (["-Q"], "golden_reads.fq", "golden_unpaired.sam"),
    "paired": (["-Q", "-p", "opp-in"], "golden_pairs.fq",
               "golden_paired.sam"),
    "cs": (["--mode", "cs", "-Q"], "golden_reads_cs.fq", "golden_cs.sam"),
    "cs_paired": (["--mode", "cs", "-Q", "-p", "opp-in"],
                  "pairs_cs_opp-in.fq", "golden_cs_opp-in.sam"),
}


@pytest.mark.parametrize("case", sorted(SHARD_GOLDENS))
def test_genome_shards_goldens(case):
    flags, reads, gold = SHARD_GOLDENS[case]
    rc, out, err = run(flags + ["--genome-shards", "2", g(reads),
                                g("golden_genome.fa")])
    assert rc == 0, err[-2000:]
    assert body(out) == golden_body(gold)
    # the shards' @SQ lines in shard order: the whole genome's
    with open(g("golden_genome.fa")) as fh:
        names = [ln[1:].split()[0] for ln in fh if ln.startswith(">")]
    assert [ln.split("\t")[1] for ln in out.splitlines()
            if ln.startswith("@SQ")] == [f"SN:{n}" for n in names]


def test_four_shards_on_one_device():
    rc, out, err = run(["-Q", "--genome-shards", "4", "--devices", "1",
                        g("golden_reads.fq"), g("golden_genome.fa")])
    assert rc == 0, err[-2000:]
    assert "note: only 2 contig groups; using 2 genome shards" in err
    assert body(out) == golden_body("golden_unpaired.sam")


@pytest.mark.parametrize("flags, message", [
    (["-S", "PREFIX", g("golden_genome.fa")],
     "--genome-shards maps directly from genome FASTA"),
    (["--save-mmap", "PREFIX", g("golden_genome.fa")],
     "--genome-shards maps directly from genome FASTA"),
    (["-L", g("refproj"), "-Q", g("golden_reads.fq")],
     "--genome-shards maps directly from genome FASTA"),
    (["--shrimp-format", "-Q", g("mini_reads.fq"), g("golden_genome.fa")],
     "--genome-shards emits SAM"),
], ids=["save", "save-mmap", "load", "shrimp-format"])
def test_genome_shards_error_exits(flags, message, tmp_path):
    flags = [str(tmp_path / "idx") if f == "PREFIX" else f for f in flags]
    rc, out, err = run(["--genome-shards", "2"] + flags)
    assert rc == 1
    assert f"error: {message}" in err
    assert body(out) == []
    assert os.listdir(tmp_path) == []          # nothing saved


def test_genome_shards_must_be_positive():
    rc, out, err = run(["--genome-shards", "0", g("golden_reads.fq"),
                        g("golden_genome.fa")])
    assert rc == 1
    assert "error: --genome-shards must be >= 1" in err
    assert out == ""
