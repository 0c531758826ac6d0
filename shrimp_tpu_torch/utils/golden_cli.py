"""The golden runs of the gmapper CLI that the port is held to: the flags
each golden was made with (the reference binary's, as the JAX package's
own tests pass them), and how its bytes are compared.  Shared by the CPU
tests (`tests/test_torch_paired*.py`, `tests/test_torch_cli.py`) and by
`chip_smoke.py`, which runs the same cases on the card.

A case is (program name, flags, reads, genome, golden); reads and genome
are files of `tests/golden/` unless the case makes its own corpus
(`DRAFT`: 5,000 tiny contigs, made by `write_draft_corpus`).  A SAM
golden compares every line but `@PG` where the golden kept its header,
else the records alone; a legacy `.out` golden compares every byte.
"""

from __future__ import annotations

import contextlib
import io
import os

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
GOLDEN = os.path.join(REPO, "tests", "golden")
DRAFT = "<draft corpus>"

# --paired-options strings of the reference runs (tests/test_paired_options.py)
_S1 = ("opp-in,150,250,30,50.0,10,60.0,2,85.0,0,1;"
       "1/1,1,1,0/1,0,2,60.0/1,55.0,90.0,2,0,1/30.0;"
       "1/1,1,1,0/1,0,2,60.0/1,55.0,90.0,2,0,1/30.0")
_S2 = ("opp-in,50,600,30,50.0,10,50.0,1,70.0,0,1;"
       "0/0/0/1,50.0,90.0,1,0,1/25.0;"
       "0/0/0/1,50.0,90.0,1,0,1/25.0")
_S3 = ("opp-in,0,2000,40,45.0,10,40.0,0,50.0,1,1;"
       "1/1,1,0,0/1,0,1,50.0/1,45.0,80.0,1,0,1/20.0;"
       "1/1,1,0,0/1,0,1,50.0/1,45.0,80.0,1,0,1/20.0")
_RA = ("opp-in,100,300,30,50.0,10,50.0,1,80.0,0,1;"
       "1/1,1,1,0/1,0,2,55.0/1,50.0,90.0,2,0,1/25.0;"
       "1/1,1,1,0/1,0,2,55.0/1,50.0,90.0,2,0,1/25.0")
_RB = ("opp-in,0,1500,30,50.0,10,40.0,0,50.0,0,1;"
       "0/0/0/0/20.0;0/0/0/0/20.0")
_CS1 = ("opp-in,100,300,30,47.0,10,50.0,1,90.0,0,1;"
        "1/1,1,1,0/1,0,2,55.0/1,47.0,90.0,2,0,1/25.0;"
        "1/1,1,1,0/1,0,2,55.0/1,47.0,90.0,2,0,1/25.0")
_CS2 = ("opp-in,0,1200,30,47.0,10,40.0,0,50.0,0,1;"
        "1/1,1,1,0/1,0,2,50.0/1,45.0,90.0,1,0,1/20.0;"
        "1/1,1,1,0/1,0,2,50.0/1,45.0,90.0,1,0,1/20.0")

_GP = ("golden_pairs.fq", "golden_genome.fa")

# letter-space paired goldens
PAIRED_LS = {
    "golden_paired": ("gmapper", ["-Q", "-p", "opp-in"], *_GP,
                      "golden_paired.sam"),
    **{f"golden_{m}": ("gmapper", ["-Q", "-p", m], f"pairs_{m}.fq",
                       "golden_genome.fa", f"golden_{m}.sam")
       for m in ("opp-out", "col-fw", "col-bw")},
    **{f"golden_pairing_{m}": ("gmapper", ["--mode", "ls", "-Q", "-p", m],
                               "pairing_reads.fq", "pairing_genome.fa",
                               f"golden_pairing_{m}.sam")
       for m in ("opp-in", "opp-out", "col-fw", "col-bw")},
    **{f"golden_paired_{k}": ("gmapper", ["-Q", "-p", "opp-in", "-N", "1",
                                          *extra], *_GP,
                              f"golden_paired_{k}.sam")
       for k, extra in (("n2", ["-n", "2"]), ("n3", ["-n", "3"]),
                        ("nhp", ["--no-half-paired"]),
                        ("n3nhp", ["-n", "3", "--no-half-paired"]),
                        ("r2", ["--sam-r2"]),
                        ("allcontigs", ["--all-contigs"]))},
    "golden_po_3set": ("gmapper", ["-Q", "-p", "opp-in", "-N", "1",
                                   "--paired-options", _S1,
                                   "--paired-options", _S2,
                                   "--paired-options", _S3], *_GP,
                       "golden_po_3set.sam"),
    "golden_po_reuse": ("gmapper", ["-Q", "-p", "opp-in", "-N", "1",
                                    "--paired-options", _RA,
                                    "--paired-options", _RB], *_GP,
                        "golden_po_reuse.sam"),
    "med_paired": ("gmapper", ["-Q", "-p", "opp-in"], "med_pairs.fq",
                   "med_genome.fa", "med_paired.sam"),
    "golden_draft_paired": ("gmapper", ["-Q", "-p", "opp-in", "-I", "0,500"],
                            DRAFT, DRAFT, "golden_draft_paired.sam"),
    "golden_messy_paired": ("gmapper", ["--mode", "ls", "-Q", "-p", "opp-in",
                                        "-I", "0,500"],
                            "messy_pairs.fq", "messy_genome.fa",
                            "golden_messy_paired.sam"),
    "golden_sqf_paired": ("gmapper", ["--mode", "ls", "-Q", "-p", "opp-in",
                                      "-I", "0,500",
                                      "--enable-seed-qual-filter"],
                          "sqf_pairs.fq", "golden_genome.fa",
                          "golden_sqf_paired.sam"),
}

# colour-space paired goldens
PAIRED_CS = {
    **{f"golden_cs_{m}": ("gmapper", ["--mode", "cs", "-Q", "-p", m],
                          f"pairs_cs_{m}.fq", "golden_genome.fa",
                          f"golden_cs_{m}.sam")
       for m in ("opp-in", "col-fw")},
    "golden_po_cs2set": ("gmapper", ["--mode", "cs", "-Q", "-p", "opp-in",
                                     "-N", "1", "--qv-offset", "33",
                                     "--paired-options", _CS1,
                                     "--paired-options", _CS2],
                         "pairs_cs_opp-in.fq", "golden_genome.fa",
                         "golden_po_cs2set.sam"),
    "golden_sqf_cs_paired": ("gmapper", ["--mode", "cs", "-Q", "-p",
                                         "opp-in", "-I", "0,500",
                                         "--enable-seed-qual-filter"],
                             "sqf_pairs_cs.fq", "golden_genome.fa",
                             "golden_sqf_cs_paired.sam"),
}

# the legacy SHRiMP format (--shrimp-format, -R)
LEGACY = {
    "golden_legacy_ls": ("gmapper", ["--mode", "ls", "-Q", "--shrimp-format"],
                         "mini_reads.fq", "golden_genome.fa",
                         "golden_legacy_ls.out"),
    "golden_legacy_cs": ("gmapper", ["--mode", "cs", "-Q", "--shrimp-format"],
                         "mini_reads_cs.fq", "golden_genome.fa",
                         "golden_legacy_cs.out"),
    "golden_legacy_paired": ("gmapper", ["--mode", "ls", "-Q",
                                         "--shrimp-format", "-R", "-p",
                                         "opp-in"],
                             "mini_pairs.fq", "golden_genome.fa",
                             "golden_legacy_paired.out"),
}

_MED = ("med_reads.fq", "med_genome.fa")
_GR = ("golden_reads.fq", "golden_genome.fa")

# unpaired goldens of the JAX package's suites (test_modes.py,
# test_golden_medium.py, test_messy_inputs.py, test_seed_qual_filter.py)
UNPAIRED = {
    "golden_h80": ("gmapper", ["--mode", "ls", "-Q", "-h", "80%"], *_GR,
                   "golden_h80.sam"),
    "golden_r80": ("gmapper", ["--mode", "ls", "-Q", "-r", "80%"], *_GR,
                   "golden_r80.sam"),
    "golden_habs": ("gmapper", ["--mode", "ls", "-Q", "-h", "1200"], *_GR,
                    "golden_habs.sam"),
    "golden_local": ("gmapper", ["--mode", "ls", "-Q", "--local"],
                     "mini_reads.fq", "golden_genome.fa", "golden_local.sam"),
    "golden_med_gapsym": ("gmapper", ["-Q", "-N", "1", "-g", "-400", "-e",
                                      "-70"], *_MED, "golden_med_gapsym.sam"),
    "golden_med_h16": ("gmapper", ["-Q", "-N", "1", "-H", "-s", "w16"],
                       *_MED, "golden_med_h16.sam"),
    "golden_med_rg": ("gmapper", ["-Q", "-N", "1", "--read-group",
                                  "rg1,sample1"], *_MED, "golden_med_rg.sam"),
    "golden_med_xf": ("gmapper", ["-Q", "-N", "1", "--extra-sam-fields"],
                      *_MED, "golden_med_xf.sam"),
    "golden_messy_unpaired": ("gmapper", ["--mode", "ls", "-Q"],
                              "messy_reads.fq", "messy_genome.fa",
                              "golden_messy_unpaired.sam"),
    "golden_sqf_unpaired": ("gmapper", ["--mode", "ls", "-Q",
                                        "--enable-seed-qual-filter"],
                            "sqf_reads.fq", "golden_genome.fa",
                            "golden_sqf_unpaired.sam"),
    "golden_sqf_n2": ("gmapper", ["--mode", "ls", "-Q", "-n", "2",
                                  "--enable-seed-qual-filter"],
                      "sqf_reads.fq", "golden_genome.fa", "golden_sqf_n2.sam"),
}

# colour-space unpaired goldens (tests/test_torch_cli.py holds them on the
# CPU; chip_smoke.py adds them to its card run)
UNPAIRED_CS = {
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
}


def write_draft_corpus(directory: str) -> tuple[str, str]:
    """The scaffold-heavy draft genome (5,000 contigs of 400-1,200 bp) and
    its 300 opp-in pairs, seed 42, as the JAX package's
    `tests/test_draft_genome.py` writes them; returns (genome, reads)."""
    rng = np.random.default_rng(42)
    code = "ACGT"
    contigs = []
    gpath = os.path.join(directory, "draft_genome.fa")
    rpath = os.path.join(directory, "draft_pairs.fq")
    with open(gpath, "w") as fh:
        for i in range(5000):
            L = int(rng.integers(400, 1200))
            seq = "".join(code[b] for b in rng.integers(0, 4, L))
            contigs.append(seq)
            fh.write(f">scaf{i:05d}\n")
            for j in range(0, L, 80):
                fh.write(seq[j:j + 80] + "\n")
    comp = str.maketrans("ACGT", "TGCA")
    with open(rpath, "w") as fh:
        n = 0
        for _ in range(300):
            ci = int(rng.integers(0, 5000))
            seq = contigs[ci]
            if len(seq) < 260:
                continue
            p = int(rng.integers(0, len(seq) - 250))
            isz = int(rng.integers(150, 250))
            r1 = seq[p:p + 50]
            r2 = seq[p + isz - 50:p + isz].translate(comp)[::-1]
            fh.write(f"@dp{n:04d}\n{r1}\n+\n{'Z' * 50}\n"
                     f"@dp{n:04d}\n{r2}\n+\n{'Z' * 50}\n")
            n += 1
    return gpath, rpath


def run_case(case: tuple, tmpdir: str, device=None) -> tuple[int, str, str]:
    """Run one case through `shrimp_tpu_torch.gmapper.main` in this
    process on `device` (None: the CLI's own default); returns (rc,
    stdout, stderr).  `tmpdir` takes the draft corpus."""
    from shrimp_tpu_torch import gmapper
    prog, flags, reads, genome, _ = case
    if reads == DRAFT:
        genome, reads = write_draft_corpus(tmpdir)
    else:
        reads = os.path.join(GOLDEN, reads)
        genome = os.path.join(GOLDEN, genome)
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = gmapper.main([prog, *flags, reads, genome], device=device)
    return rc, out.getvalue(), err.getvalue()


def expected(golden: str) -> str | list[str]:
    """What a run must print: the legacy golden's bytes, or the SAM
    golden's lines as `compared` cuts them."""
    with open(os.path.join(GOLDEN, golden)) as fh:
        text = fh.read()
    return text if golden.endswith(".out") else compared(text, golden)


def compared(stdout: str, golden: str) -> str | list[str]:
    """The part of a run's output that is held to `golden`."""
    if golden.endswith(".out"):
        return stdout
    with open(os.path.join(GOLDEN, golden)) as fh:
        with_header = fh.read(1) == "@"
    return [ln for ln in stdout.splitlines()
            if ln and not ln.startswith("@PG" if with_header else "@")]


def first_difference(got, want) -> int:
    """Index of the first differing line (or byte, for text)."""
    return next((k for k, (a, b) in enumerate(zip(got, want)) if a != b),
                min(len(got), len(want)))
