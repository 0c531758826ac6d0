"""Gapless pass 1 (L2b), the counterpart of `shrimp_tpu/ops/sw_gapless.py`:
the -U / -M mirna pass-1 engine, `common/sw-gapless.c:sw_gapless`.

An optimal ungapped alignment score along ONE genome diagonal fixed by
the hit's anchor: per hit the score is Kadane's max-subarray sum of the
column scores, floored at 0, written as

    max(0, max_i (prefix_i - min(0, min_{j<i} prefix_j))).

Colour space overrides column 0 with the forced first colour
(sw-gapless.c:85-95); letter space scores column 0 like any other.

Two functions, each in two versions:
  * `p1_gather_gapless_ls` / `p1_gather_gapless_cs`, what the Mapper runs:
    the diagonals gathered from the planes that stay resident on the
    device (`DeviceIndex`) at int64 starts, the read rows picked from the
    batch's [B, 2, R] read matrix, and the colour-space forced first colour
    made from the letter plane, then scored; only O(hits) arrays and the
    read matrix cross to the device.  The plain versions
    (`p1_gather_gapless_*_plain`, CPU tensors) gather with PyTorch
    indexing; the CUDA kernel `csrc/sw_gapless.cu` (K6) gathers in the
    kernel, one thread a hit (`p1_gather_gapless_*_cuda`).
  * `gapless_score_batch`, the JAX package's function over diagonals
    gathered already (int8 [N, R] genome codes and read codes side by
    side): `gapless_score_batch_plain` (cumsum and cummin, as in the JAX
    function) and `gapless_score_batch_cuda` (the same kernel).
Each dispatcher picks by the device of its tensors.
"""

from __future__ import annotations

import ctypes

import torch

from shrimp_tpu_torch.ops import sw_vector
from shrimp_tpu_torch.ops.params import SWParams
from shrimp_tpu_torch import _build

GENOME_PAD = -1          # beyond-contig genome positions
READ_PAD = -2            # beyond-read positions (never equal to genome pad)
BASE_N = 15              # the forced colour of a letter that is not 0-3

# the kernel reads the Mapper's planes and read matrix, which are padded
# with sw_vector's codes
if (GENOME_PAD, READ_PAD) != (sw_vector.GENOME_PAD, sw_vector.READ_PAD):
    raise ImportError("sw_gapless and sw_vector disagree on the pad codes")

# launches of the sw_gapless kernel (every entry point)
LAUNCHES = _build.LaunchCounter()


def gapless_score_batch_plain(diag: torch.Tensor, reads: torch.Tensor,
                              params: SWParams,
                              s0: torch.Tensor | None = None) -> torch.Tensor:
    """Ungapped diagonal scores, plain version (CPU tensors): diag and
    reads int8 [N, R], s0 None or int32 [N].  Returns int32 [N]."""
    _build.require_cpu(diag, reads, s0)
    valid = (diag != GENOME_PAD) & (reads != READ_PAD)
    s = torch.where(diag == reads, params.match, params.mismatch)
    s = torch.where(valid, s, 0).to(torch.int32)
    N, R = s.shape
    if N == 0 or R == 0:
        return torch.zeros(N, dtype=torch.int32)
    if s0 is not None:
        s[:, 0] = s0.to(torch.int32)
    prefix = torch.cumsum(s, dim=1, dtype=torch.int32)
    runmin = torch.cummin(prefix, dim=1).values
    runmin = torch.cat([torch.zeros((N, 1), dtype=torch.int32),
                        runmin[:, :-1]], dim=1).clamp_max(0)
    return (prefix - runmin).amax(dim=1).clamp_min(0).to(torch.int32)


def _diagonals(plane, start, glen, r_left, rid, st, reads2):
    """The hits' diagonals, int8 [N, R] each: genome codes plane[start + t]
    for t < glen (GENOME_PAD past it or outside the plane), read codes
    reads2[rid, st, r_left + t] (READ_PAD outside the row)."""
    R = reads2.shape[2]
    cols = torch.arange(R, dtype=torch.int64)
    gi = start.to(torch.int64)[:, None] + cols
    inside = (cols < glen.to(torch.int64)[:, None]) & (gi >= 0) \
        & (gi < plane.shape[0])
    diag = torch.where(inside,
                       plane[gi.clamp(0, max(plane.shape[0] - 1, 0))],
                       torch.tensor(GENOME_PAD, dtype=torch.int8))
    rows = reads2[rid.to(torch.int64), st.to(torch.int64)]
    ri = r_left.to(torch.int64)[:, None] + cols
    rrow = torch.where((ri >= 0) & (ri < R),
                       rows.gather(1, ri.clamp(0, max(R - 1, 0))),
                       torch.tensor(READ_PAD, dtype=torch.int8))
    return diag, rrow


def p1_gather_gapless_ls_plain(plane, start, glen, r_left, rid, st, reads2,
                               params: SWParams) -> torch.Tensor:
    """Diagonal gather + gapless score, plain version (CPU tensors).

    plane int8 [L]; start, glen int64 [N] (the diagonal's first genome
    byte in the plane, and the genome columns left before the contig end);
    r_left, rid, st int32 [N] (the diagonal's first read column, the read,
    its strand); reads2 int8 [B, 2, R].  Returns int32 [N]."""
    _build.require_cpu(plane, start, glen, r_left, rid, st, reads2)
    N, R = start.shape[0], reads2.shape[2]
    if N == 0 or R == 0:
        return torch.zeros(N, dtype=torch.int32)
    diag, rrow = _diagonals(plane, start, glen, r_left, rid, st, reads2)
    return gapless_score_batch_plain(diag, rrow, params)


def p1_gather_gapless_cs_plain(cs_cat, ls_cat, start, glen, r_left, rid,
                               initbp, reads2,
                               params: SWParams) -> torch.Tensor:
    """Colour-space diagonal gather + gapless score, plain version (CPU
    tensors).

    cs_cat / ls_cat are the fw||rc colour and letter planes (a reverse hit
    starts one genome length in); the read row is the read as given
    (strand 0); initbp int8 [B] per read.  Where r_left == 0 column 0
    scores match if lstocs(ls_cat[start], initbp) equals the first colour,
    else 0: l ^ initbp for a letter l in 0-3, BASE_N for any other letter
    or past the contig end (sw-gapless.c:85-95).  Elsewhere column 0 is
    scored like the others."""
    _build.require_cpu(cs_cat, ls_cat, start, glen, r_left, rid, initbp,
                       reads2)
    N, R = start.shape[0], reads2.shape[2]
    if N == 0 or R == 0:
        return torch.zeros(N, dtype=torch.int32)
    diag, rrow, s0 = _diagonals_cs(cs_cat, ls_cat, start, glen, r_left, rid,
                                   initbp, reads2, params)
    return gapless_score_batch_plain(diag, rrow, params, s0)


def _diagonals_cs(cs_cat, ls_cat, start, glen, r_left, rid, initbp, reads2,
                  params: SWParams):
    """The colour-space hits' diagonals and the s0 column of
    `gapless_score_batch` (R > 0): the forced first colour where r_left ==
    0, else column 0's own score."""
    N = start.shape[0]
    zero = torch.zeros(N, dtype=torch.int32)
    diag, rrow = _diagonals(cs_cat, start, glen, r_left, rid, zero, reads2)
    start = start.to(torch.int64)
    in0 = (glen > 0) & (start >= 0) & (start < ls_cat.shape[0])
    letter = torch.where(in0, ls_cat[start.clamp(0, ls_cat.shape[0] - 1)],
                         torch.tensor(GENOME_PAD, dtype=torch.int8))
    colour = torch.where((letter >= 0) & (letter <= 3),
                         letter ^ initbp[rid.to(torch.int64)],
                         torch.tensor(BASE_N, dtype=torch.int8))
    col0 = torch.where((diag[:, 0] != GENOME_PAD) & (rrow[:, 0] != READ_PAD),
                       torch.where(diag[:, 0] == rrow[:, 0], params.match,
                                   params.mismatch), 0)
    s0 = torch.where(r_left == 0,
                     torch.where(colour == rrow[:, 0], params.match, 0),
                     col0).to(torch.int32)
    return diag, rrow, s0


# ---------------------------------------------------------------------------
# CUDA kernel wrappers
_LIB = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("sw_gapless")
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.sw_gapless_launch.restype = ctypes.c_int
        lib.sw_gapless_launch.argtypes = [vp, vp, vp, i, i, i, i, vp, vp]
        lib.sw_gapless_gather_launch.restype = ctypes.c_int
        lib.sw_gapless_gather_launch.argtypes = [
            vp, ll, vp, vp, vp, vp, vp, vp, ll, i, i, vp, vp, i, i, i, vp,
            vp]
        _LIB = lib
    return _LIB


def _launch_gather(plane, start, glen, r_left, rid, st, reads2,
                   params: SWParams, ls_plane=None,
                   initbp=None) -> torch.Tensor:
    dev = plane.device
    if dev.type != "cuda":
        raise ValueError(f"the sw_gapless kernel needs CUDA tensors; got {dev}")
    _build.check_tensor("plane", plane, torch.int8, 1, dev)
    N = start.shape[0]
    for name, t, dtype in (("start", start, torch.int64),
                           ("glen", glen, torch.int64),
                           ("r_left", r_left, torch.int32),
                           ("rid", rid, torch.int32),
                           ("st", st, torch.int32)):
        if t is None:
            continue
        _build.check_tensor(name, t, dtype, 1, dev)
        if t.shape[0] != N:
            raise ValueError(f"{name} has {t.shape[0]} rows, expected {N}")
    _build.check_tensor("reads2", reads2, torch.int8, 3, dev)
    if ls_plane is not None:
        _build.check_tensor("ls_plane", ls_plane, torch.int8, 1, dev)
        if ls_plane.shape[0] != plane.shape[0]:
            raise ValueError("ls_plane and the colour plane differ in length")
        _build.check_tensor("initbp", initbp, torch.int8, 1, dev)
        if initbp.shape[0] != reads2.shape[0]:
            raise ValueError(f"initbp has {initbp.shape[0]} rows, expected "
                             f"one a read ({reads2.shape[0]})")
    out = torch.zeros(N, dtype=torch.int32, device=dev)
    B, S, R = reads2.shape
    if N == 0 or R == 0:
        return out
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.sw_gapless_gather_launch(
            plane.data_ptr(), plane.shape[0], start.data_ptr(),
            glen.data_ptr(), r_left.data_ptr(), rid.data_ptr(),
            None if st is None else st.data_ptr(), reads2.data_ptr(),
            B * S * R, S, R,
            None if ls_plane is None else ls_plane.data_ptr(),
            None if initbp is None else initbp.data_ptr(), N, params.match,
            params.mismatch, out.data_ptr(), stream)
    _build.check_launch(lib, "sw_gapless", rc)
    LAUNCHES.add()
    return out


def p1_gather_gapless_ls_cuda(plane, start, glen, r_left, rid, st, reads2,
                              params: SWParams) -> torch.Tensor:
    """Fused diagonal gather + gapless score on the card (one launch),
    with the arguments of `p1_gather_gapless_ls_plain` on one CUDA device.
    Returns int32 [N], still in flight."""
    return _launch_gather(plane, start, glen, r_left, rid, st, reads2,
                          params)


def p1_gather_gapless_cs_cuda(cs_cat, ls_cat, start, glen, r_left, rid,
                              initbp, reads2,
                              params: SWParams) -> torch.Tensor:
    """Fused colour-space diagonal gather + gapless score on the card (one
    launch), with the arguments of `p1_gather_gapless_cs_plain`; the forced
    first colour is made in the kernel.  Returns int32 [N]."""
    return _launch_gather(cs_cat, start, glen, r_left, rid, None, reads2,
                          params, ls_plane=ls_cat, initbp=initbp)


def gapless_score_batch_cuda(diag: torch.Tensor, reads: torch.Tensor,
                             params: SWParams,
                             s0: torch.Tensor | None = None) -> torch.Tensor:
    """`gapless_score_batch` on the card, one launch: diag and reads int8
    [N, R], s0 None or int32 [N].  Returns int32 [N] on the same device."""
    dev = diag.device
    if dev.type != "cuda":
        raise ValueError(f"the sw_gapless kernel needs CUDA tensors; got {dev}")
    _build.check_tensor("diag", diag, torch.int8, 2, dev)
    _build.check_tensor("reads", reads, torch.int8, 2, dev)
    N, R = diag.shape
    if tuple(reads.shape) != (N, R):
        raise ValueError(f"reads is {tuple(reads.shape)}, expected {(N, R)}")
    if s0 is not None:
        _build.check_tensor("s0", s0, torch.int32, 1, dev)
        if s0.shape[0] != N:
            raise ValueError(f"s0 has {s0.shape[0]} rows, expected {N}")
    out = torch.zeros(N, dtype=torch.int32, device=dev)
    if N == 0 or R == 0:
        return out
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.sw_gapless_launch(
            diag.data_ptr(), reads.data_ptr(),
            None if s0 is None else s0.data_ptr(), N, R, params.match,
            params.mismatch, out.data_ptr(), stream)
    _build.check_launch(lib, "sw_gapless", rc)
    LAUNCHES.add()
    return out


def p1_gather_gapless_ls(plane, start, glen, r_left, rid, st, reads2,
                         params: SWParams) -> torch.Tensor:
    """The letter-space gapless pass 1 of `Mapper._gapless_scores`: the
    fused kernel for CUDA tensors, the plain version for CPU ones."""
    if plane.device.type == "cuda":
        return p1_gather_gapless_ls_cuda(plane, start, glen, r_left, rid, st,
                                         reads2, params)
    return p1_gather_gapless_ls_plain(plane, start, glen, r_left, rid, st,
                                      reads2, params)


def p1_gather_gapless_cs(cs_cat, ls_cat, start, glen, r_left, rid, initbp,
                         reads2, params: SWParams) -> torch.Tensor:
    """The colour-space gapless pass 1 of `Mapper._gapless_scores`: the
    fused kernel for CUDA tensors, the plain version for CPU ones."""
    if cs_cat.device.type == "cuda":
        return p1_gather_gapless_cs_cuda(cs_cat, ls_cat, start, glen, r_left,
                                         rid, initbp, reads2, params)
    return p1_gather_gapless_cs_plain(cs_cat, ls_cat, start, glen, r_left,
                                      rid, initbp, reads2, params)


def gapless_score_batch(diag: torch.Tensor, reads: torch.Tensor,
                        params: SWParams,
                        s0: torch.Tensor | None = None) -> torch.Tensor:
    """Counterpart of `shrimp_tpu.ops.sw_gapless.gapless_score_batch`: the
    kernel for CUDA tensors, the plain version for CPU ones."""
    if diag.device.type == "cuda":
        return gapless_score_batch_cuda(diag, reads, params, s0)
    return gapless_score_batch_plain(diag, reads, params, s0)
