"""The port's prettyprint tool (`shrimp_tpu_torch.tools.prettyprint`) and
gmapper's `-P`, on the CPU: the reference binaries' goldens, and every
record's re-alignment against the JAX tool's own unbanded call.  The port
runs the records on the pass-2 kernels over the full band, many records a
launch; those launches must give each record the stats and ops of the JAX
package's unbanded K5 / K9 on that record alone, padded as the JAX tool
pads it, and of the port's own one-record launch with that padding."""

import contextlib
import io
import os

import numpy as np
import pytest
import torch

from shrimp_tpu.ops import sw_full as jsf
from shrimp_tpu.ops import sw_full_cs as jcs
from shrimp_tpu_torch import dna, gmapper
from shrimp_tpu_torch.io import fastx, legacy
from shrimp_tpu_torch.ops import sw_full as tsf
from shrimp_tpu_torch.ops import sw_full_cs as tcs
from shrimp_tpu_torch.ops.params import SWParams
from shrimp_tpu_torch.pipeline.candidates import cs_read_ls4
from shrimp_tpu_torch.tools import prettyprint

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
GENOME = os.path.join(GOLDEN, "golden_genome.fa")
# (legacy file, reads, tool golden) by space
CASES = {
    "ls": ("legacy_tiny.out", "mini_reads.fa", "golden_prettyprint_ls.out"),
    "cs": ("legacy_cs_tiny.out", "mini_reads_cs.fa",
           "golden_prettyprint_cs.out"),
}


def _run(main, argv, **kw):
    so, se = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(so), contextlib.redirect_stderr(se):
        rc = main(argv, **kw)
    return rc, so.getvalue(), se.getvalue()


def _tool_args(space, legacy_file=None):
    out, reads, _ = CASES[space]
    return ((["--mode", "cs"] if space == "cs" else [])
            + [legacy_file or os.path.join(GOLDEN, out), GENOME,
               os.path.join(GOLDEN, reads)])


@pytest.mark.parametrize("space", sorted(CASES))
def test_prettyprint_golden(space):
    """Byte-equal to the reference prettyprint's output, and the same
    warnings as the JAX tool (the colour-space records carry posterior
    scores, so each of them warns)."""
    from shrimp_tpu.tools import prettyprint as jax_prettyprint
    rc, out, err = _run(prettyprint.main,
                        ["prettyprint"] + _tool_args(space), device="cpu")
    assert rc == 0, err
    with open(os.path.join(GOLDEN, CASES[space][2])) as fh:
        assert out == fh.read()
    jrc, jout, jerr = _run(jax_prettyprint.main,
                           ["prettyprint"] + _tool_args(space))
    assert (rc, out, err) == (jrc, jout, jerr)
    assert err.count("score differs") == (7 if space == "cs" else 0)


def test_missing_data_warnings_keep_the_record_order(tmp_path):
    """Records whose read or contig is missing are skipped with the JAX
    tool's warning, in file order among the other warnings."""
    from shrimp_tpu.tools import prettyprint as jax_prettyprint
    with open(os.path.join(GOLDEN, "legacy_cs_tiny.out")) as fh:
        lines = fh.read().splitlines(True)
    lines[2] = lines[2].replace("csread001", "no_such_read")
    lines[4] = lines[4].replace("\tchr", "\tno_such_contig_", 1)
    path = tmp_path / "edited.out"
    path.write_text("".join(lines))
    got = _run(prettyprint.main, ["prettyprint"]
               + _tool_args("cs", str(path)), device="cpu")
    want = _run(jax_prettyprint.main,
                ["prettyprint"] + _tool_args("cs", str(path)))
    assert got == want
    assert got[2].count("missing data") == 2


def _record_inputs(space):
    """Each record's (window, read row, revcmpl) as the JAX tool builds
    them: letter codes, or in colour space qr4 [4, rlen]."""
    out, reads_file, _ = CASES[space]
    contigs = {c.name: (c.codes, dna.reverse_complement(c.codes))
               for c in fastx.iter_contigs(GENOME)}
    reads = {r.name: r.seq
             for r in fastx.iter_reads(os.path.join(GOLDEN, reads_file))}
    rows = []
    for rec in legacy.iter_records(os.path.join(GOLDEN, out)):
        if isinstance(rec, str):
            continue
        fw, rc = contigs[rec.contig]
        gstart = rec.genome_start - 1
        glen = rec.genome_end - rec.genome_start + 1
        if rec.revcmpl:
            gstart = len(fw) - (rec.genome_end - 1) - 1
        window = (rc if rec.revcmpl else fw)[gstart:gstart + glen]
        seq = reads[rec.read]
        row = (cs_read_ls4(dna.encode(seq[1:]),
                           int(dna.CHAR_TO_CODE[ord(seq[0])]))
               if space == "cs" else dna.encode(seq))
        rows.append((window, row, rec.revcmpl))
    assert len(rows) == 7
    return rows


def _jax_tool_call(space, window, row, revtie, params):
    """The JAX tool's own call on one record (`prettyprint.py:117,131`),
    with its padding: the window to max(len, 8) with GENOME_PAD, a letter
    read to max(rlen, 8) with READ_PAD."""
    gb = np.full((1, max(len(window), 8)), -1, np.int8)
    gb[0, :len(window)] = window
    rt = np.array([revtie])
    if space == "cs":
        qr4 = row[None]
        xover = np.full((1, row.shape[1]), params.crossover, np.int32)
        stats, ops = jcs.sw_full_cs_and_traceback_jax(gb, qr4, xover, rt,
                                                      params, True, 0)
    else:
        rb = np.full((1, max(len(row), 8)), -2, np.int8)
        rb[0, :len(row)] = row
        stats, ops = jsf.sw_full_and_traceback_jax(gb, rb, rt, params,
                                                   local_alignment=True)
    stats = np.asarray(stats)[0]
    return stats, np.asarray(ops)[0][:stats[9]], gb, (
        row[None] if space == "cs" else rb)


def _port_one_record(space, gb, rb, revtie, params):
    """The port's kernel call on one record padded as the JAX tool pads
    it, over the full band at W = round_up(G, 32)."""
    G, R = gb.shape[1], rb.shape[-1]
    wl = int((gb[0] != -1).sum())
    t = torch.from_numpy
    bxmin = t(np.zeros((1, R), np.int32))
    bxmax = t(np.full((1, R), wl - 1, np.int32))
    rt = t(np.array([revtie]))
    W = -(-G // 32) * 32
    if space == "cs":
        xover = t(np.full((1, R), params.crossover, np.int32))
        stats, ops = tcs.sw_full_cs_and_traceback_packed(
            t(gb), t(rb), xover, rt, bxmin, bxmax, params,
            local_alignment=True, taboo_len=0, W=W)
    else:
        stats, ops = tsf.sw_full_and_traceback_packed(
            t(gb), t(rb), rt, bxmin, bxmax, params, local_alignment=True,
            W=W)
    stats = stats.numpy()[0]
    return stats, ops.numpy()[0][:stats[9]]


@pytest.mark.parametrize("tflag", [False, True], ids=["", "T"])
@pytest.mark.parametrize("space", sorted(CASES))
def test_full_band_equals_jax_unbanded(space, tflag):
    """Per record: the JAX tool's unbanded K5 / K9 call, the port's
    one-record launch with the same padding, and the port's batched
    launch (all records, rows padded to the batch's G and R) give equal
    stats and ops; with -T the reverse-strand records break ties the
    other way."""
    params = (SWParams.colour_space() if space == "cs"
              else SWParams.letter_space())
    rows = _record_inputs(space)
    revtie = np.array([rc and tflag for _, _, rc in rows])
    assert revtie.any() == tflag
    batched = prettyprint.align_full_band(
        [w for w, _, _ in rows], [r for _, r, _ in rows], revtie, params,
        space == "cs", "cpu")
    for (window, row, _), rt, (b_stats, b_ops, _, _) in zip(rows, revtie,
                                                            batched):
        j_stats, j_ops, gb, rb = _jax_tool_call(space, window, row, rt,
                                                params)
        o_stats, o_ops = _port_one_record(space, gb, rb, rt, params)
        assert (o_stats == j_stats).all() and (o_ops == j_ops).all()
        assert (b_stats == j_stats).all() and (b_ops == j_ops).all()


def test_batches_of_few_records_equal_one_launch(monkeypatch):
    """Launches of up to BATCH records: the same output with 3 records a
    launch as with all of them in one."""
    args = ["prettyprint"] + _tool_args("ls")
    whole = _run(prettyprint.main, args, device="cpu")
    monkeypatch.setattr(prettyprint, "BATCH", 3)
    assert _run(prettyprint.main, args, device="cpu") == whole


def test_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    """Without a CUDA device and without a request for the CPU the tool
    exits 1 before any output; SHRIMP_TPU_TORCH_DEVICE=cpu runs there."""
    monkeypatch.delenv("SHRIMP_TPU_TORCH_DEVICE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = ["prettyprint"] + _tool_args("ls")
    rc, out, err = _run(prettyprint.main, args)
    assert (rc, out) == (1, "")
    assert "no CUDA device" in err
    monkeypatch.setenv("SHRIMP_TPU_TORCH_DEVICE", "cpu")
    rc, out, err = _run(prettyprint.main, args)
    assert rc == 0, err
    with open(os.path.join(GOLDEN, CASES["ls"][2])) as fh:
        assert out == fh.read()


def test_gmapper_pretty_flag():
    """-P: each legacy record followed by its pretty block."""
    rc, out, err = _run(gmapper.main, [
        "gmapper", "--mode", "ls", "-Q", "--shrimp-format", "-P",
        os.path.join(GOLDEN, "mini_reads.fq"), GENOME], device="cpu")
    assert rc == 0, err[-2000:]
    with open(os.path.join(GOLDEN, "golden_legacy_pretty.out")) as fh:
        assert out == fh.read()


def test_gmapper_pretty_then_sam_collides():
    """-P implies legacy output; a later -E re-enables SAM and collides,
    as in the reference (gmapper.c:2466-2474)."""
    rc, out, err = _run(gmapper.main, [
        "gmapper", "-P", "-E", os.path.join(GOLDEN, "mini_reads.fq"),
        GENOME], device="cpu")
    assert (rc, out) == (1, "")
    assert "-E and -P are incompatable" in err
