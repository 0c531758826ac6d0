"""The PyTorch port's gmapper entry point (`shrimp_tpu_torch.gmapper.main`),
run in-process on the CPU, which it maps on only when asked."""

import contextlib
import io
import os

import pytest
import torch

from shrimp_tpu_torch import gmapper
from shrimp_tpu_torch.utils import golden_cli

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def run(args, device="cpu"):
    so, se = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(so), contextlib.redirect_stderr(se):
        rc = gmapper.main(["gmapper"] + list(args), device=device)
    return rc, so.getvalue(), se.getvalue()


def body(text):
    return [ln for ln in text.splitlines() if ln and not ln.startswith("@")]


def golden_body(name):
    with open(os.path.join(GOLDEN, name)) as fh:
        return [ln.rstrip("\n") for ln in fh if not ln.startswith("@")]


def test_unpaired_golden():
    rc, out, err = run(["-Q", os.path.join(GOLDEN, "golden_reads.fq"),
                        os.path.join(GOLDEN, "golden_genome.fa"), "-N", "1"])
    assert rc == 0, err[-2000:]
    assert body(out) == golden_body("golden_unpaired.sam")
    assert out.startswith("@HD\tVN:1.0\tSO:unsorted\n")
    assert "Statistics:" in err


def test_read_group_and_extra_fields():
    rc, out, err = run(["-Q", "--read-group", "grp,smp",
                        "--extra-sam-fields",
                        os.path.join(GOLDEN, "med_reads.fq"),
                        os.path.join(GOLDEN, "med_genome.fa")])
    assert rc == 0, err[-2000:]
    assert "@RG\tID:grp\tSM:smp" in out.splitlines()
    lines = body(out)
    assert lines and all("\tRG:Z:grp" in ln for ln in lines)
    assert any("\tZE:Z:" in ln for ln in lines)


# (program name, flags, reads, genome, golden) as the JAX package's CLI
# tests run them
CLI_GOLDENS = {
    "golden_cs": ("gmapper-cs", ["-Q"], "golden_reads_cs.fq",
                  "golden_genome.fa", "golden_cs.sam"),
    "golden_cs_bfast": ("gmapper", ["--mode", "cs", "-Q", "--bfast"],
                        "mini_reads_cs.fq", "golden_genome.fa",
                        "golden_cs_bfast.sam"),
    "golden_messy_cs": ("gmapper", ["--mode", "cs", "-Q"],
                        "messy_reads_cs.fq", "messy_genome.fa",
                        "golden_messy_cs.sam"),
    "golden_sqf_cs": ("gmapper", ["--mode", "cs", "-Q",
                                  "--enable-seed-qual-filter"],
                      "sqf_reads_cs.fq", "golden_genome.fa",
                      "golden_sqf_cs.sam"),
    "golden_cs_mirna": ("gmapper", ["--mode", "cs", "-Q", "-M", "mirna"],
                        "golden_reads_cs.fq", "golden_genome.fa",
                        "golden_cs_mirna.sam"),
    "golden_cs_ungapped": ("gmapper", ["--mode", "cs", "-Q", "-U",
                                       "--local"],
                           "golden_reads_cs.fq", "golden_genome.fa",
                           "golden_cs_ungapped.sam"),
    "golden_ungapped": ("gmapper", ["--mode", "ls", "-Q", "-U", "--local"],
                        "mini_reads.fq", "golden_genome.fa",
                        "golden_ungapped.sam"),
    "golden_mirna": ("gmapper", ["--mode", "ls", "-Q", "-M", "mirna"],
                     "golden_reads.fq", "golden_genome.fa",
                     "golden_mirna.sam"),
}


@pytest.mark.parametrize("case", sorted(CLI_GOLDENS))
def test_colour_space_and_gapless_goldens(case):
    prog, flags, reads, genome, gold = CLI_GOLDENS[case]
    so, se = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(so), contextlib.redirect_stderr(se):
        rc = gmapper.main([prog] + flags + [os.path.join(GOLDEN, reads),
                                            os.path.join(GOLDEN, genome)],
                          device="cpu")
    assert rc == 0, se.getvalue()[-2000:]
    assert body(so.getvalue()) == golden_body(gold)


@pytest.mark.parametrize("case", sorted(golden_cli.UNPAIRED))
def test_unpaired_goldens_of_the_jax_suites(case, tmp_path):
    """The unpaired goldens that the JAX package's suites hold its CLI to
    (thresholds, local mode, gap symmetry, hashed seeds, read groups,
    extra SAM fields, messy inputs, the seed-quality filter), with their
    flags, through the port's CLI."""
    spec = golden_cli.UNPAIRED[case]
    rc, out, err = golden_cli.run_case(spec, str(tmp_path), device="cpu")
    assert rc == 0, err[-2000:]
    assert golden_cli.compared(out, spec[4]) == golden_cli.expected(spec[4])


def test_ungapped_needs_local():
    rc, out, err = run(["--mode", "cs", "-Q", "-U",
                        os.path.join(GOLDEN, "golden_reads_cs.fq"),
                        os.path.join(GOLDEN, "golden_genome.fa")])
    assert rc == 1
    assert "cannot use global (or bfast) and ungapped mode" in err
    assert out == ""


@pytest.mark.parametrize("flags", [["-x", "-20"], ["-v", "40"], ["-B"]],
                         ids=lambda f: f[0])
def test_colour_space_options_refused_in_letter_space(flags):
    rc, out, err = run(flags + ["reads.fq", "genome.fa"])
    assert rc == 1
    assert "is a colour-space option" in err
    assert out == ""


def test_maps_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    """Without a CUDA device and without a request for the CPU the CLI
    exits 1 before any output; SHRIMP_TPU_TORCH_DEVICE=cpu maps there."""
    monkeypatch.delenv("SHRIMP_TPU_TORCH_DEVICE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = ["-Q", os.path.join(GOLDEN, "golden_reads.fq"),
            os.path.join(GOLDEN, "golden_genome.fa")]
    rc, out, err = run(args, device=None)
    assert rc == 1
    assert "no CUDA device" in err
    assert out == ""
    monkeypatch.setenv("SHRIMP_TPU_TORCH_DEVICE", "cpu")
    rc, out, err = run(args, device=None)
    assert rc == 0, err[-2000:]
    assert "PyTorch port on cpu" in err
    assert body(out) == golden_body("golden_unpaired.sam")


def test_reports_the_l3_path():
    """-D prints the L3 verdict of the mapper and its fallback count in
    the statistics block."""
    rc, out, err = run(["-Q", "-D", os.path.join(GOLDEN, "golden_reads.fq"),
                        os.path.join(GOLDEN, "golden_genome.fa")])
    assert rc == 0, err[-2000:]
    assert "L3 path:" in err and "Device-L3 fallbacks:" in err
