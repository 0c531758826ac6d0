"""prettyprint — re-align legacy hits and render pretty blocks
(prettyprint/prettyprint.c).

For each legacy record, re-runs the full Smith-Waterman (local, unbanded,
threshold = the recorded score) of the read against the recorded contig
range and prints the record line followed by the G/match/R (or G/|/T/R in
colour space) alignment block.

The alignments run on the pass-2 kernels of the mapper, K3+K4
(`ops/sw_full.py`) and K7+K8 (`ops/sw_full_cs.py`), over the full band:
every read row's band is the whole window, [0, len(window) - 1], at
W = round_up(G, 32), which is how `Mapper._pass2_dispatch` runs an
unbanded alignment.  The records go to the card in launches of up to
`BATCH` alignments, each row padded to its launch's G and R.  They run on
the first CUDA device unless the caller asks for the CPU (their plain
PyTorch versions): `main(argv, device="cpu")`, or the environment's
`SHRIMP_TPU_TORCH_DEVICE=cpu`.  Without a CUDA device and without such a
request the tool exits with rc 1.

Usage:
    python -m shrimp_tpu_torch.tools.prettyprint [--mode ls|cs]
        [-m/-i/-g/-q/-e/-f/-x N] [-R] [-T]
        shrimp_output_file genome_file reads_file
"""

from __future__ import annotations

import getopt
import os
import sys

import numpy as np

# alignments a launch at most
BATCH = 4096


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def align_full_band(windows: list, reads: list, revtie: np.ndarray,
                    params, colour: bool, device) -> list:
    """Local alignments of reads[i] against windows[i] over the full band,
    one kernel launch: windows are int8 letter codes; reads are int8
    codes, or in colour space qr4 int8 [4, rlen] with the crossover score
    of `params` on every row.  Returns per alignment (stats int32 [10] or
    [11], ops uint8 [ops_len], the padded window row, the padded read
    row: int8 [R], or [4, R] in colour space)."""
    import torch

    from shrimp_tpu_torch.ops import sw_full, sw_full_cs
    from shrimp_tpu_torch.ops.sw_vector import GENOME_PAD, READ_PAD

    N = len(windows)
    w_len = np.array([len(w) for w in windows], np.int64)
    r_len = np.array([r.shape[-1] for r in reads], np.int64)
    G = _round_up(max(1, int(w_len.max())), 128)
    R = _round_up(max(1, int(r_len.max())), 8)
    W = _round_up(G, 32)
    gb = np.full((N, G), GENOME_PAD, np.int8)
    for n, w in enumerate(windows):
        gb[n, :len(w)] = w
    band_xmin = np.zeros((N, R), np.int32)
    band_xmax = np.broadcast_to((w_len - 1).astype(np.int32)[:, None],
                                (N, R)).copy()

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    if colour:
        rb = np.full((N, 4, R), READ_PAD, np.int8)
        for n, q in enumerate(reads):
            rb[n, :, :q.shape[1]] = q
        xover = np.full((N, R), params.crossover, np.int32)
        stats, ops = sw_full_cs.sw_full_cs_and_traceback_packed(
            dev(gb), dev(rb), dev(xover), dev(revtie), dev(band_xmin),
            dev(band_xmax), params, local_alignment=True, taboo_len=0, W=W)
    else:
        rb = np.full((N, R), READ_PAD, np.int8)
        for n, r in enumerate(reads):
            rb[n, :len(r)] = r
        stats, ops = sw_full.sw_full_and_traceback_packed(
            dev(gb), dev(rb), dev(revtie), dev(band_xmin), dev(band_xmax),
            params, local_alignment=True, W=W)
    stats = stats.cpu().numpy()
    ops = ops.cpu().numpy()
    return [(stats[n], ops[n, :stats[n, 9]], gb[n], rb[n])
            for n in range(N)]


def main(argv=None, device=None) -> int:
    argv = list(sys.argv if argv is None else argv)
    prog = argv[0] if argv else "prettyprint"
    mode = "cs" if prog.endswith("-cs") else "ls"
    try:
        opts, args = getopt.gnu_getopt(argv[1:], "m:i:g:q:e:f:x:RT",
                                       ["mode="])
    except getopt.GetoptError as exc:
        sys.stderr.write(f"error: {exc}\n")
        return 1
    updates = {}
    rflag = False
    tflag = False
    for o, a in opts:
        if o == "--mode":
            mode = a
        elif o == "-m":
            updates["match"] = int(a)
        elif o == "-i":
            updates["mismatch"] = int(a)
        elif o == "-g":
            updates["a_gap_open"] = int(a)
        elif o == "-q":
            updates["b_gap_open"] = int(a)
        elif o == "-e":
            updates["a_gap_extend"] = int(a)
        elif o == "-f":
            updates["b_gap_extend"] = int(a)
        elif o == "-x":
            updates["crossover"] = int(a)
        elif o == "-R":
            rflag = True
        elif o == "-T":
            tflag = True
    if len(args) < 3:
        sys.stderr.write("usage: prettyprint [parameters] [options] "
                         "shrimp_output_file genome_file reads_file\n")
        return 1
    out_file, genome_file, reads_file = args[0], args[1], args[2]

    import torch

    device = torch.device(device or os.environ.get("SHRIMP_TPU_TORCH_DEVICE")
                          or "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        sys.stderr.write("error: no CUDA device; map on the CPU with "
                         "SHRIMP_TPU_TORCH_DEVICE=cpu\n")
        return 1

    from shrimp_tpu_torch import dna
    from shrimp_tpu_torch.io import fastx, legacy
    from shrimp_tpu_torch.ops import sw_full, sw_full_cs
    from shrimp_tpu_torch.ops.params import SWParams
    from shrimp_tpu_torch.pipeline.candidates import cs_read_ls4

    colour = mode == "cs"
    params = (SWParams.colour_space() if colour
              else SWParams.letter_space()).with_(**updates)

    contigs = {}
    for c in fastx.iter_contigs(genome_file):
        rc = dna.reverse_complement(c.codes)
        contigs[c.name] = (c.codes, rc)

    reads = {}
    for rec in fastx.iter_reads(reads_file):
        reads[rec.name] = rec.seq

    out = sys.stdout
    records = list(legacy.iter_records(out_file))
    seen_probs = any(not isinstance(r, str) and r.normodds is not None
                     for r in records)
    out.write(legacy.format_line(rflag)
              + (" normodds pgenome pchance" if seen_probs else "") + "\n")

    # the alignments first, in launches of up to BATCH records; then the
    # records in file order with their warnings
    jobs = {}
    for i, rec in enumerate(records):
        if isinstance(rec, str):
            continue
        if rec.contig not in contigs or rec.read not in reads:
            continue
        fw, rc = contigs[rec.contig]
        plane = rc if rec.revcmpl else fw
        gstart = rec.genome_start - 1
        glen = rec.genome_end - rec.genome_start + 1
        if rec.revcmpl:
            gstart = len(fw) - (rec.genome_end - 1) - 1
        seq = reads[rec.read]
        if colour:
            row = cs_read_ls4(dna.encode(seq[1:]),
                              int(dna.CHAR_TO_CODE[ord(seq[0])]))
        else:
            row = dna.encode(seq)
        jobs[i] = (plane, gstart, plane[gstart:gstart + glen], row,
                   rec.revcmpl and tflag)
    aligned = {}
    order = list(jobs)
    for lo in range(0, len(order), BATCH):
        part = order[lo:lo + BATCH]
        res = align_full_band(
            [jobs[i][2] for i in part], [jobs[i][3] for i in part],
            np.array([jobs[i][4] for i in part], bool), params, colour,
            device)
        aligned.update(zip(part, res))

    for i, rec in enumerate(records):
        if isinstance(rec, str):
            continue
        if i not in jobs:
            sys.stderr.write(f"warning: could not align read [{rec.read}] "
                             f"to contig [{rec.contig}] - missing data!\n")
            continue
        plane, gstart, _, row, _ = jobs[i]
        clen = len(plane)
        stats, ops_row, g_row, r_row = aligned[i]
        seq = reads[rec.read]
        score = int(stats[0])
        if colour:
            dbal, qral = sw_full_cs.render_alignment_cs(
                ops_row, g_row, r_row, int(stats[2]), int(stats[1]))
            read_len = row.shape[1]
            read_text = seq
        else:
            res = sw_full.SWAlignment(
                score=score, read_start=int(stats[1]),
                genome_start=int(stats[2]), ops=ops_row)
            sw_full.render_alignment(res, g_row, r_row)
            dbal, qral = res.dbalign, res.qralign
            read_len = len(row)
            read_text = None

        if score != rec.score:
            sys.stderr.write(
                f"warning: score differs from input file "
                f"(read=\"{rec.read}\", genome=\"{rec.contig}\")\n")

        genome_start0 = gstart + int(stats[2])
        line = legacy.output_normal(
            rec.read, rec.contig, genome_start0=genome_start0,
            gmapped=int(stats[8]), read_start0=int(stats[1]),
            rmapped=int(stats[7]), read_length=read_len, score=score,
            dbalign=dbal, qralign=qral, genome_len=clen,
            revcmpl=rec.revcmpl,
            read_seq=(seq if rflag else None))
        out.write(line)
        if rec.normodds is not None:
            out.write(f"\t{rec.normodds:e}")
        if rec.pgenome is not None:
            out.write(f"\t{rec.pgenome:e}")
        if rec.pchance is not None:
            out.write(f"\t{rec.pchance:e}")
        out.write("\n\n")
        out.write(legacy.output_pretty(
            genome_plane=plane, genome_len=clen,
            genome_start0=genome_start0, gmapped=int(stats[8]),
            read_start0=int(stats[1]), rmapped=int(stats[7]),
            read_len=read_len, dbalign=dbal, qralign=qral,
            revcmpl=rec.revcmpl, colour_space=colour,
            read_text_cs=read_text))
        out.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
