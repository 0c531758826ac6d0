"""Pass-2 kernels (K3+K4 `csrc/sw_full.cu` in letter space, K7+K8
`csrc/sw_full_cs.cu` in colour space: the banded DP and its traceback in
one launch) as a share of their roofline: the least time the card could
take for the window's launches over their device time.

Least time of a launch: the larger of its int32 operations over the
int32 peak and its bytes over the HBM peak.  Device time: the summed
durations of the profiler's `sw_full_kernel` / `sw_full_cs_kernel`
events in the traced window.  The counts come from each launch's inputs
alone, by the frozen functions below.

Peaks (NVIDIA H100 SXM5 data sheet): 132 SMs x 64 int32 operations a
clock (4 partitions x 16 INT32 lanes) x 1.98 GHz boost = 1.6727e13
int32 operations/s; HBM3 3.35e12 bytes/s.

Cells: the band cells of each alignment, the sum over its read rows of
band_xmax - band_xmin + 1 (not rows x band width).

Operations a band cell.  Letter space, 24: three states (diagonal,
north, west), each the max of its predecessors with their gap or match
score added and a pointer chosen with it (diagonal: 3 candidates, an
add and a compare-select each, plus the match/mismatch select: 10;
north and west: 2 candidates, an add and a compare-select each, plus
the best-cell update: 7 each).  Colour space, 144: four letter layers
of the three states, each state choosing among six candidates (its own
layer's three and the crossover from the other layers) with an add and
a compare-select each: 4 x 3 x 6 x 2.

Bytes: each input read once and each output written once: the genome
windows (B x G), the reads (letter space B x R; colour space the four
layer rows and the crossover row, B x R x (4 + 4)), the strand flags
(B), the bands (2 x 4 x B x R), the stats (4 x 10 or 11 x B) and the
traceback ops (B x (R + G)).
"""

PEAK_INT32_OPS = 132 * 64 * 1.98e9
PEAK_BYTES = 3.35e12
READ_PAD = -2
KERNELS = ("sw_full_kernel", "sw_full_cs_kernel")


def _band_cells(rows, bxmin, bxmax):
    import torch
    width = (bxmax.long() - bxmin.long() + 1).clamp_min(0)
    live = (torch.arange(width.shape[1], device=width.device)[None, :]
            < rows[:, None])
    return (width * live).sum()


def count_ls(genome, read, revcmpl, band_xmin, band_xmax, params,
             local_alignment, W):
    B, G = genome.shape
    R = read.shape[1]
    rows = (read != READ_PAD).sum(1)
    return {"ops_per_cell": 24,
            "cells": _band_cells(rows, band_xmin, band_xmax),
            "bytes": B * G + B * R + B + 8 * B * R + 40 * B + B * (R + G)}


def count_cs(genome, qr4, xover_row, revcmpl, band_xmin, band_xmax, params,
             local_alignment, taboo_len, W):
    B, G = genome.shape
    R = qr4.shape[2]
    rows = (qr4[:, 0] != READ_PAD).sum(1)
    return {"ops_per_cell": 144,
            "cells": _band_cells(rows, band_xmin, band_xmax),
            "bytes": (B * G + 4 * B * R + 4 * B * R + B + 8 * B * R
                      + 44 * B + B * (R + G))}


HOOKS = {
    "shrimp_tpu_torch.ops.sw_full:sw_full_and_traceback_packed_cuda":
        count_ls,
    "shrimp_tpu_torch.ops.sw_full_cs:sw_full_cs_and_traceback_packed_cuda":
        count_cs,
}


def least_seconds(launch) -> float:
    return max(launch["ops_per_cell"] * launch["cells"] / PEAK_INT32_OPS,
               launch["bytes"] / PEAK_BYTES)


def device_seconds(r) -> float:
    return sum(s for name, s in r["device"]["all_by_name"].items()
               if any(k in name for k in KERNELS))


def read(r):
    launches = r["launches"].get("pass2.roofline") or []
    dev = device_seconds(r)
    if not launches or dev <= 0:
        return None
    return 100.0 * sum(least_seconds(x) for x in launches) / dev
