"""Pass-1 kernel (K1 `csrc/sw_vector.cu`, with the K2 / K2-CS window
gathers fused in) as a share of its roofline: the least time the card
could take for the window's launches over their device time.

Least time of a launch: the larger of its int32 operations over the
int32 peak and its bytes over the HBM peak.  Device time: the summed
durations of the profiler's `sw_vector_kernel` events in the traced
window.  Neither depends on the kernel's own code: the counts come from
each launch's inputs alone, by the frozen functions below.

Peaks (NVIDIA H100 SXM5 data sheet): 132 SMs; each SM issues 64 int32
operations a clock (4 partitions x 16 INT32 lanes); boost clock
1.98 GHz; so 132 x 64 x 1.98e9 = 1.6727e13 int32 operations/s.  HBM3:
3.35e12 bytes/s.

Operations a DP cell: 12.  An affine-gap Smith-Waterman cell computes
E = max(E_left + ext, H_left + open+ext) and F = max(F_up + ext,
H_up + open+ext) (2 adds and a max each: 6), the diagonal H_diag +
s(read, genome) with the compare-and-select of s (3), and
H = max(E, F, diag, floor) (3 maxes): 12.  Cells of a window: its
length (at most the launch's G) times its read's length.

Bytes: each input byte read once and each output byte written once: the
window's bases from every plane it reads (1 letter plane; colour space:
the colour and letter planes), the reads matrix, the per-window starts
(8 B), lengths, read ids and strands (4 B each; colour space adds the
initial base, 1 B), and the int32 score out.
"""

PEAK_INT32_OPS = 132 * 64 * 1.98e9
PEAK_BYTES = 3.35e12
OPS_PER_CELL = 12
READ_PAD = -2
KERNELS = ("sw_vector_kernel",)


def _count(lo, wlen, rid, st, reads2, G, planes, per_window):
    import torch
    rl = (reads2 != READ_PAD).sum(-1)
    w = wlen.to(torch.int64).clamp(max=int(G))
    cells = (w * rl[rid.long(), st.long()]).sum()
    C = int(lo.shape[0])
    return {"cells": cells, "window_bytes": planes * w.sum(),
            "fixed_bytes": reads2.numel() + C * (per_window + 4)}


def count_ls(plane, lo, wlen, rid, st, reads2, G, params):
    return _count(lo, wlen, rid, st, reads2, G, 1, 8 + 4 * 3)


def count_cs(cs_cat, ls_cat, lo, wlen, rid, ist, initbp, reads2, G,
             params):
    return _count(lo, wlen, rid, ist, reads2, G, 2, 8 + 4 * 3 + 1)


HOOKS = {"shrimp_tpu_torch.ops.sw_vector:p1_gather_score_ls_cuda": count_ls,
         "shrimp_tpu_torch.ops.sw_vector:p1_gather_score_cs_cuda": count_cs}


def least_seconds(launch) -> float:
    ops = OPS_PER_CELL * launch["cells"]
    nbytes = launch["window_bytes"] + launch["fixed_bytes"]
    return max(ops / PEAK_INT32_OPS, nbytes / PEAK_BYTES)


def device_seconds(r) -> float:
    return sum(s for name, s in r["device"]["all_by_name"].items()
               if any(k in name for k in KERNELS))


def read(r):
    launches = r["launches"].get("pass1.roofline") or []
    dev = device_seconds(r)
    if not launches or dev <= 0:
        return None
    return 100.0 * sum(least_seconds(x) for x in launches) / dev
