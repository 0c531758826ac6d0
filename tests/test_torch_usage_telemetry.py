"""The JAX package's usage and telemetry suites (tests/test_usage.py,
tests/test_telemetry.py) held against the port's CLI on the CPU: the
reference binary's usage() text, the settings echo and the statistics
block with timing values masked, the -X insert histogram in both modes,
-Y's genome-map table, and with --genome-shards one -Y table per shard."""

import contextlib
import io
import os
import re

import pytest

from shrimp_tpu_torch import gmapper

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def run(args):
    so, se = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(so), contextlib.redirect_stderr(se):
        try:
            rc = gmapper.main(["gmapper"] + list(args), device="cpu")
        except SystemExit as e:
            rc = e.code if isinstance(e.code, int) else 1
    return rc, so.getvalue(), se.getvalue()


def _golden(name):
    with open(os.path.join(GOLDEN, name)) as fh:
        return fh.read()


def _diff(want, got):
    return "\n".join(f"{w!r} != {g!r}" for w, g in
                     zip(want + [""] * len(got), got + [""] * len(want))
                     if w != g)


# ---- tests/test_usage.py ----
def _usage_lines(stderr: str):
    lines = stderr.splitlines()
    for i, ln in enumerate(lines):
        if ln.startswith("error:") or ln.startswith("usage:"):
            return lines[i:]
    return lines


@pytest.mark.parametrize("args, golden", [
    (["--mode", "ls", "-?"], "golden_usage_ls_full.txt"),
    (["--mode", "cs", "-?"], "golden_usage_cs_full.txt"),
    (["--mode", "ls"], "golden_usage_ls_short.txt"),
], ids=["full_ls", "full_cs", "short_no_args"])
def test_usage(args, golden):
    rc, _, err = run(args)
    assert rc == 1
    want = _golden(golden).splitlines()
    got = _usage_lines(err)
    assert got == want, _diff(want, got)


# ---- tests/test_telemetry.py ----
TIMING = re.compile(
    r"(Time:|Run-time:|per hour:|per core-hour:|Cells per Second:"
    r"|Thread \d|thrd:\d|Genomemap:)")


def mask(text: str, section_start: str, section_end: str | None = None):
    """A stderr section with timing-dependent values masked."""
    lines = []
    on = False
    for ln in text.splitlines():
        if ln.startswith(section_start):
            on = True
        if on and section_end and ln.startswith(section_end):
            break
        if not on:
            continue
        lines.append(re.sub(r"[\d,.]+", "#", ln) if TIMING.search(ln)
                     else ln)
    return lines


def _golden_run():
    return run(["--mode", "ls", "-Q", "-D",
                os.path.join(GOLDEN, "golden_reads.fq"),
                os.path.join(GOLDEN, "golden_genome.fa")])


def test_settings_echo_parity():
    rc, _, err = _golden_run()
    assert rc == 0, err[-2000:]
    want = mask(_golden("golden_stderr_D.txt"), "Settings:", "- Processing")
    got = mask(err, "Settings:", "- Processing")
    assert got == want, _diff(want, got)


def test_statistics_block_parity():
    """The statistics block line for line, timing values and the
    per-thread / memory lines masked; the reference's thrd: aggregate and
    allocator lines, and the engine block that -D adds here, are
    filtered, as tests/test_telemetry.py filters them."""
    rc, _, err = _golden_run()
    assert rc == 0, err[-2000:]

    def stats_lines(text):
        out = []
        skip_engine = 0
        for ln in mask(text, "Statistics:"):
            if ln.lstrip().startswith("TPU Engine Choices:"):
                skip_engine = 5
                continue
            if skip_engine:
                skip_engine -= 1
                continue
            if ln.startswith(("thrd:", "crt_mem:", "mem_")):
                continue
            if TIMING.search(ln) or ln.lstrip().startswith("Thread"):
                continue
            out.append(ln)
        return out

    want = stats_lines(_golden("golden_stderr_D.txt"))
    got = stats_lines(err)
    assert got == want, _diff(want, got)


def test_insert_histogram_format():
    """-X paired: the exact [lo-hi]: pct% histogram (gmapper.c:670-679)."""
    rc, _, err = run(["--mode", "ls", "-Q", "-X", "-p", "opp-in", "-I",
                      "0,500", os.path.join(GOLDEN, "golden_pairs.fq"),
                      os.path.join(GOLDEN, "golden_genome.fa")])
    assert rc == 0, err[-2000:]
    hist = [ln for ln in err.splitlines()
            if re.match(r"\[\d+-\d+\]: [\d.]+%$", ln)]
    assert len(hist) == 100
    assert hist[0].startswith("[0-5]:")   # bucket size ceil(501/100) = 6


def test_insert_histogram_unpaired_warns():
    rc, _, err = run(["--mode", "ls", "-Q", "-X",
                      os.path.join(GOLDEN, "golden_reads.fq"),
                      os.path.join(GOLDEN, "golden_genome.fa")])
    assert rc == 0
    assert "insert histogram not available in unpaired mode" in err


def _y_tables(err):
    """Each 'Genome Map stats:' table of -Y, with its sn:/[ rows."""
    lines = err.splitlines()
    tables = []
    for i, ln in enumerate(lines):
        if ln == "Genome Map stats:":
            end = i + 1
            while end < len(lines) and re.match(r"(sn:\d|\[\d)", lines[end]):
                end += 1
            tables.append(lines[i:end])
    return tables


def test_genomemap_stats_parity():
    """-Y: exact print_genomemap_stats format (genome.c:834-903)."""
    rc, _, err = run(["--mode", "ls", "-N", "1", "-Y", "-Q",
                      os.path.join(GOLDEN, "golden_reads.fq"),
                      os.path.join(GOLDEN, "golden_genome.fa")])
    assert rc == 0, err[-2000:]
    tables = _y_tables(err)
    want = _golden("golden_Y.txt").splitlines()
    assert len(tables) == 1
    assert tables[0] == want, _diff(want, tables[0])


def test_genomemap_stats_one_table_per_shard():
    """-Y with --genome-shards 2: one table per shard, in shard order,
    each the table of an index of that shard's contigs alone."""
    from shrimp_tpu_torch import index as gindex
    from shrimp_tpu_torch.io import fastx
    from shrimp_tpu_torch.utils import telemetry
    genome = os.path.join(GOLDEN, "golden_genome.fa")
    rc, out, err = run(["--mode", "ls", "-N", "1", "-Y", "-Q",
                        "--genome-shards", "2",
                        os.path.join(GOLDEN, "golden_reads.fq"), genome])
    assert rc == 0, err[-2000:]
    tables = _y_tables(err)
    assert len(tables) == 2
    contigs = list(fastx.iter_contigs(genome))
    whole = gindex.build_index(contigs)
    cutoff = max(1000, (100 * whole.total_len)
                 // (4 ** max(s.weight for s in whole.seed_set.seeds)))
    for table, contig in zip(tables, contigs):
        idx = gindex.build_index([contig])
        idx.trim(cutoff)                   # the whole genome's cutoff
        want = []
        telemetry.print_genomemap_stats(want.append, idx)
        want = "\n".join(want).splitlines()
        assert table == want, _diff(want, table)
    assert [ln for ln in out.splitlines() if not ln.startswith("@")] == [
        ln for ln in _golden("golden_unpaired.sam").splitlines()
        if not ln.startswith("@")]
