"""Pass-1 vector Smith-Waterman (L2a), the counterpart of
`shrimp_tpu/ops/sw_vector.py` and `sw_vector_pallas.py`.

Local affine-gap alignment, score only, for a batch of (genome window,
read) pairs — the reference's `common/sw-vector.c:68-220` contract:
H floored at 0, score = max over all cells, the A-gap consumes genome
and the B-gap consumes read with their own open/extend costs, codes match
iff equal (N == N), padding never matches, and a READ_PAD row leaves the
state unchanged.

Two versions of the same function:
  * the plain PyTorch version (`sw_score_batch`, `p1_gather_score_ls_plain`)
    — the row scan of `sw_score_batch_rows` written with `torch.cummax`;
    it runs for CPU tensors only;
  * the CUDA kernel `csrc/sw_vector.cu` (K1 with the window gather K2
    fused in), through `p1_gather_score_ls_cuda` (windows gathered from
    the resident genome plane), `p1_gather_score_cs_cuda` (colour space:
    colour and letter windows gathered from the resident fw||rc planes,
    the row-0 plane made in the kernel) and `sw_score_batch_cuda`
    (windows given).
`p1_gather_score_ls` and `p1_gather_score_cs` pick by the device of the
genome plane; `p1_gather_score_cs_plain` is the plain colour-space form.
"""

from __future__ import annotations

import ctypes

import torch

from shrimp_tpu_torch.ops.params import SWParams
from shrimp_tpu_torch import _build

NEG_INF = -(1 << 28)

GENOME_PAD = -1
READ_PAD = -2
BASE_N = 15

# launches of the sw_vector kernel: letter-space and given-window
# wrappers, and the colour-space gather (K2-CS) apart
LAUNCHES = _build.LaunchCounter()
CS_LAUNCHES = _build.LaunchCounter()


def sw_score_batch(genome: torch.Tensor, read: torch.Tensor,
                   params: SWParams = SWParams(),
                   genome_row0: torch.Tensor | None = None) -> torch.Tensor:
    """Local affine SW scores for a batch of (genome window, read) pairs —
    the plain version (CPU tensors).

    genome: int8/int32 [B, G] codes padded with GENOME_PAD; read:
    int8/int32 [B, R] padded with READ_PAD; genome_row0: optional [B, G]
    plane that read row 0 matches against instead of `genome`.
    Returns int32 [B] (>= 0).

    Row scan over the read (as `sw_score_batch_rows`): the within-row
    A-gap recurrence A[j] = max(H[j-1] - aoe, A[j-1] - ae) collapses into
    one tilted running max, A[j] = max_{k<j}(H0[k] + ae*k) - aoe -
    ae*(j-1), which is exact for affine costs."""
    _build.require_cpu(genome, read, genome_row0)
    genome = genome.to(torch.int32)
    read = read.to(torch.int32)
    B, G = genome.shape
    R = read.shape[1]
    best = torch.zeros(B, dtype=torch.int32)
    if B == 0 or G == 0:
        return best
    i32 = lambda v: torch.tensor(v, dtype=torch.int32)  # noqa: E731
    m, x = i32(params.match), i32(params.mismatch)
    aoe = -(params.a_gap_open + params.a_gap_extend)
    ae = -params.a_gap_extend
    boe = -(params.b_gap_open + params.b_gap_extend)
    be = -params.b_gap_extend

    jj = torch.arange(G, dtype=torch.int32)
    tilt = ae * jj
    a_off = -aoe - ae * (jj - 1)
    g_first = genome if genome_row0 is None else genome_row0.to(torch.int32)
    zero_col = torch.zeros((B, 1), dtype=torch.int32)
    neg_col = torch.full((B, 1), NEG_INF, dtype=torch.int32)

    H = torch.zeros((B, G), dtype=torch.int32)
    Bg = torch.full((B, G), NEG_INF, dtype=torch.int32)
    for i in range(R):
        rc = read[:, i:i + 1]
        gplane = g_first if i == 0 else genome
        ms = torch.where(gplane == rc, m, x)
        Hdiag = torch.cat([zero_col, H[:, :-1]], dim=1) + ms
        Bg_n = torch.maximum(H - boe, Bg - be)
        H0 = torch.maximum(Hdiag.clamp_min(0), Bg_n)
        run = torch.cummax(H0 + tilt, dim=1).values
        A = torch.cat([neg_col, run[:, :-1]], dim=1) + a_off
        H_n = torch.maximum(H0, A)
        is_pad = rc == READ_PAD
        H = torch.where(is_pad, H, H_n)
        Bg = torch.where(is_pad, Bg, Bg_n)
        best = torch.maximum(best, H.amax(dim=1))
    return best


def p1_gather_score_ls_plain(plane, lo, wlen, rid, st, reads2, G: int,
                             params: SWParams) -> torch.Tensor:
    """Window gather + pass-1 score, plain version (CPU tensors).

    Window c is plane[lo[c] : lo[c] + G] with columns >= wlen[c] (or
    outside the plane) read as GENOME_PAD; its read row is
    reads2[rid[c], st[c]]."""
    _build.require_cpu(plane, lo, wlen, rid, st, reads2)
    win = _gather(plane, lo, wlen, G)
    rb = reads2[rid.to(torch.int64), st.to(torch.int64)]
    return sw_score_batch(win, rb, params)


def _gather(plane, lo, wlen, G: int) -> torch.Tensor:
    """plane[lo[c] : lo[c] + G] per row, GENOME_PAD at columns >= wlen[c]
    or outside the plane."""
    cols = torch.arange(G, dtype=torch.int64)
    idx = lo.to(torch.int64)[:, None] + cols
    inside = (idx >= 0) & (idx < plane.shape[0]) \
        & (cols < wlen.to(torch.int64)[:, None])
    return torch.where(inside,
                       plane[idx.clamp(0, max(plane.shape[0] - 1, 0))],
                       torch.tensor(GENOME_PAD, dtype=torch.int8))


def p1_gather_score_cs_plain(cs_cat, ls_cat, lo, wlen, rid, ist, initbp,
                             reads2, G: int, params: SWParams) -> torch.Tensor:
    """Colour-space window gather + pass-1 score, plain version (CPU
    tensors).

    cs_cat / ls_cat are the fw||rc colour and letter planes; window c is
    cut from both at lo[c] (columns >= wlen[c] read GENOME_PAD).  Read row 0
    scores against the letter window mapped through the read's primer:
    l ^ initbp[c] for letters 0-3, GENOME_PAD kept, anything else BASE_N
    (lstocs, sw-vector.c:111-147)."""
    _build.require_cpu(cs_cat, ls_cat, lo, wlen, rid, ist, initbp, reads2)
    win_cs = _gather(cs_cat, lo, wlen, G)
    win_ls = _gather(ls_cat, lo, wlen, G)
    row0 = torch.where(
        (win_ls >= 0) & (win_ls <= 3),
        win_ls ^ initbp.to(torch.int8)[:, None],
        torch.where(win_ls == GENOME_PAD,
                    torch.tensor(GENOME_PAD, dtype=torch.int8),
                    torch.tensor(BASE_N, dtype=torch.int8)))
    rb = reads2[rid.to(torch.int64), ist.to(torch.int64)]
    return sw_score_batch(win_cs, rb, params, row0)


# ---------------------------------------------------------------------------
# CUDA kernel wrappers
_LIB = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("sw_vector")
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.sw_vector_launch.restype = ctypes.c_int
        lib.sw_vector_launch.argtypes = [
            vp, ll, vp, vp, vp, vp, vp, i, i, vp, vp, vp, i, i,
            i, i, i, i, i, i, vp, vp, vp]
        lib.sw_vector_scratch_bytes.restype = ll
        lib.sw_vector_scratch_bytes.argtypes = [i, i, i, i]
        _LIB = lib
    return _LIB


def _launch(plane, lo, wlen, rid, st, reads, row0, G: int,
            params: SWParams, ls_plane=None, initbp=None) -> torch.Tensor:
    dev = plane.device
    if dev.type != "cuda":
        raise ValueError(f"the sw_vector kernel needs CUDA tensors; got {dev}")
    _build.check_tensor("plane", plane, torch.int8, 1, dev)
    _build.check_tensor("lo", lo, torch.int64, 1, dev)
    B = lo.shape[0]
    for name, t in (("wlen", wlen), ("rid", rid), ("st", st)):
        _build.check_tensor(name, t, torch.int32, 1, dev)
        if t.shape[0] != B:
            raise ValueError(f"{name} has {t.shape[0]} rows, expected {B}")
    _build.check_tensor("reads", reads, torch.int8, 3, dev)
    if row0 is not None:
        _build.check_tensor("genome_row0", row0, torch.int8, 2, dev)
        if tuple(row0.shape) != (B, G):
            raise ValueError(f"genome_row0 is {tuple(row0.shape)}, "
                             f"expected {(B, G)}")
    if ls_plane is not None:
        _build.check_tensor("ls_plane", ls_plane, torch.int8, 1, dev)
        if ls_plane.shape[0] != plane.shape[0]:
            raise ValueError("ls_plane and the colour plane differ in length")
        _build.check_tensor("initbp", initbp, torch.int8, 1, dev)
        if initbp.shape[0] != B:
            raise ValueError(f"initbp has {initbp.shape[0]} rows, "
                             f"expected {B}")
    if G < 0:
        raise ValueError(f"G must be >= 0, got {G}")
    out = torch.empty(B, dtype=torch.int32, device=dev)
    if B == 0:
        return out
    lib = _lib()
    R = reads.shape[2]
    # row boundaries of reads too long for shared memory live here
    nbytes = lib.sw_vector_scratch_bytes(
        B, G, R, int(row0 is not None or ls_plane is not None))
    scratch = (torch.empty(nbytes, dtype=torch.uint8, device=dev)
               if nbytes else None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        p = params
        rc = lib.sw_vector_launch(
            plane.data_ptr(), plane.shape[0], lo.data_ptr(),
            wlen.data_ptr(), rid.data_ptr(), st.data_ptr(),
            reads.data_ptr(), reads.shape[1], reads.shape[2],
            None if row0 is None else row0.data_ptr(),
            None if ls_plane is None else ls_plane.data_ptr(),
            None if initbp is None else initbp.data_ptr(), B, G,
            p.match, p.mismatch, p.a_gap_open, p.a_gap_extend,
            p.b_gap_open, p.b_gap_extend,
            None if scratch is None else scratch.data_ptr(), out.data_ptr(),
            stream)
    _build.check_launch(lib, "sw_vector", rc)
    (LAUNCHES if ls_plane is None else CS_LAUNCHES).add()
    return out


def p1_gather_score_ls_cuda(plane, lo, wlen, rid, st, reads2, G: int,
                            params: SWParams) -> torch.Tensor:
    """Fused window gather + pass-1 score on the card (one launch).

    plane int8 [L] resident genome plane; lo int64 [C] absolute window
    starts; wlen/rid/st int32 [C]; reads2 int8 [B, 2, R].  Returns int32
    [C] on the plane's device."""
    return _launch(plane, lo, wlen, rid, st, reads2, None, G, params)


def p1_gather_score_cs_cuda(cs_cat, ls_cat, lo, wlen, rid, ist, initbp,
                            reads2, G: int, params: SWParams) -> torch.Tensor:
    """Fused colour-space window gather + pass-1 score on the card (one
    launch): cs_cat / ls_cat int8 [2L + pad] resident fw||rc planes; lo
    int64 [C]; wlen/rid/ist int32 [C]; initbp int8 [C]; reads2 int8
    [B, 2, R].  The row-0 plane is made in the kernel.  Returns int32 [C]."""
    return _launch(cs_cat, lo, wlen, rid, ist, reads2, None, G, params,
                   ls_plane=ls_cat, initbp=initbp)


def sw_score_batch_cuda(genome: torch.Tensor, read: torch.Tensor,
                        params: SWParams = SWParams(),
                        genome_row0: torch.Tensor | None = None
                        ) -> torch.Tensor:
    """`sw_score_batch` on the card: int8 [B, G] windows, int8 [B, R]
    reads, optional int8 [B, G] row-0 plane.  Returns int32 [B]."""
    dev = genome.device
    _build.check_tensor("genome", genome, torch.int8, 2, dev)
    _build.check_tensor("read", read, torch.int8, 2, dev)
    B, G = genome.shape
    if read.shape[0] != B:
        raise ValueError(f"read has {read.shape[0]} rows, expected {B}")
    lo = torch.arange(B, dtype=torch.int64, device=dev) * G
    wlen = torch.full((B,), G, dtype=torch.int32, device=dev)
    rid = torch.arange(B, dtype=torch.int32, device=dev)
    st = torch.zeros(B, dtype=torch.int32, device=dev)
    return _launch(genome.reshape(-1), lo, wlen, rid, st,
                   read.reshape(B, 1, read.shape[1]), genome_row0, G, params)


def p1_gather_score_ls(plane, lo, wlen, rid, st, reads2, G: int,
                       params: SWParams) -> torch.Tensor:
    """Counterpart of `shrimp_tpu.pipeline.mapper._p1_gather_score_ls`:
    the fused kernel for CUDA tensors, the plain version for CPU ones."""
    if plane.device.type == "cuda":
        return p1_gather_score_ls_cuda(plane, lo, wlen, rid, st, reads2, G,
                                       params)
    return p1_gather_score_ls_plain(plane, lo, wlen, rid, st, reads2, G,
                                    params)


def p1_gather_score_cs(cs_cat, ls_cat, lo, wlen, rid, ist, initbp, reads2,
                       G: int, params: SWParams) -> torch.Tensor:
    """Counterpart of `shrimp_tpu.pipeline.mapper._p1_gather_score_cs`:
    the fused kernel for CUDA tensors, the plain version for CPU ones."""
    if cs_cat.device.type == "cuda":
        return p1_gather_score_cs_cuda(cs_cat, ls_cat, lo, wlen, rid, ist,
                                       initbp, reads2, G, params)
    return p1_gather_score_cs_plain(cs_cat, ls_cat, lo, wlen, rid, ist,
                                    initbp, reads2, G, params)
