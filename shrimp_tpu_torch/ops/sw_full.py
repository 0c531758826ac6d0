"""Pass-2 full Smith-Waterman with traceback (L2c), the counterpart of the
band-packed letter-space path of `shrimp_tpu/ops/sw_full.py`.

Covers `common/sw-full-ls.c`: the 3-state affine DP (NW arrived
diagonally, N by a gap in the genome consuming a read char, W by a gap in
the read consuming a genome char; gaps open only from NW), local or
glocal mode, strand-dependent tie-breaking, and the pointer walk that
yields the edit ops and alignment statistics.  The DP runs in packed band
coordinates u = j - band_xmin[i] at width W (the reference's banded
"necks").

Two versions of `sw_full_and_traceback_packed`:
  * the plain PyTorch version (`sw_full_batch_packed` +
    `traceback_batch_packed`), a row loop and a walk loop mirroring
    `sw_full_batch_packed` / `traceback_batch_packed_jax`; CPU tensors
    only;
  * the CUDA kernel `csrc/sw_full.cu` (K3 + K4 in one launch: a tile of
    lanes an alignment sweeping each row's band only, its shape and tiers
    fixed by the launcher from (G, R, W), `launch_plan`), through
    `sw_full_and_traceback_packed_cuda`.
The NumPy helpers (`compute_band`, `SWAlignment`, `render_alignment`, the
op and pointer codes) are carried over unchanged.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, field

import numpy as np
import torch

from shrimp_tpu_torch.ops.params import SWParams
from shrimp_tpu_torch import _build
from shrimp_tpu_torch.ops.sw_vector import GENOME_PAD, NEG_INF

# back-pointer codes, 2 bits per state (0 = stop/none)
NW_FROM_NW, NW_FROM_N, NW_FROM_W = 1, 2, 3
N_FROM_N, N_FROM_NW = 1, 2
W_FROM_W, W_FROM_NW = 1, 2

STATE_NW, STATE_N, STATE_W = 0, 1, 2

# edit ops produced by traceback (aligned-column order)
OP_MATCH = 0      # genome char aligned to read char
OP_INS = 1        # genome char vs gap in read (reference "insertion")
OP_DEL = 2        # read char vs gap in genome (reference "deletion")

# launches of the sw_full kernel
LAUNCHES = _build.LaunchCounter()


@dataclass
class SWAlignment:
    """One full-SW alignment (reference `sw_full_results`,
    common/sw-full-common.h)."""

    score: int = 0
    read_start: int = 0
    genome_start: int = 0      # relative to the window
    rmapped: int = 0
    gmapped: int = 0
    matches: int = 0
    mismatches: int = 0
    insertions: int = 0
    deletions: int = 0
    ops: np.ndarray = field(default_factory=lambda: np.zeros(0, np.uint8))
    dbalign: str = ""
    qralign: str = ""


def compute_band(rect_x: np.ndarray, rect_y: np.ndarray, rect_len: np.ndarray,
                 rect_width: np.ndarray, glen: np.ndarray,
                 R: int) -> tuple[np.ndarray, np.ndarray]:
    """Per-row band limits from an anchor rectangle (anchor_get_x_range,
    common/anchors.c:67-96).  The rectangle is the already-joined+widened
    parallelogram: origin (x, y), diagonal extent `len`, anti-diagonal
    extent `width`.  Returns (x_min[B, R], x_max[B, R])."""
    B = len(rect_x)
    i = np.arange(R)[None, :]
    rx = rect_x[:, None].astype(np.int64)
    ry = rect_y[:, None].astype(np.int64)
    rl = rect_len[:, None].astype(np.int64)
    rw = rect_width[:, None].astype(np.int64)
    gl = glen[:, None].astype(np.int64)

    x_min = np.where(i < ry, 0,
                     np.where(i <= ry + rl - 1, rx + (i - ry), rx + rl))
    x_min = np.clip(x_min, 0, gl - 1)
    yw = ry - (rw - 1)
    x_max = np.where(i < yw, rx + rw - 2,
                     np.where(i <= yw + rl - 1, rx + (rw - 1) + (i - yw),
                              gl - 1))
    x_max = np.clip(x_max, 0, gl - 1)
    return x_min.astype(np.int32), x_max.astype(np.int32)


def render_alignment(res: SWAlignment, genome_row: np.ndarray,
                     read_row: np.ndarray) -> None:
    """Fill dbalign/qralign strings (pretty_print, sw-full-ls.c:524-560)."""
    from shrimp_tpu_torch import dna

    d_chars, q_chars = [], []
    gi, ri = res.genome_start, res.read_start
    for op in res.ops:
        if op == OP_MATCH:
            d_chars.append(dna.LS_CHARS[genome_row[gi] & 15])
            q_chars.append(dna.LS_CHARS[read_row[ri] & 15])
            gi += 1
            ri += 1
        elif op == OP_INS:
            d_chars.append(dna.LS_CHARS[genome_row[gi] & 15])
            q_chars.append(ord("-"))
            gi += 1
        else:
            d_chars.append(ord("-"))
            q_chars.append(dna.LS_CHARS[read_row[ri] & 15])
            ri += 1
    res.dbalign = bytes(d_chars).decode()
    res.qralign = bytes(q_chars).decode()


def shift_max(G: int) -> int:
    """The packed DP's clip on row shifts and band starts: the smallest
    power of two >= G (at least 2), minus one — the bound of the TPU
    kernel's log-decomposed shift, kept so both versions agree on any
    band."""
    pad = 2
    while pad < G:
        pad <<= 1
    return pad - 1


def _pick(*score_ptr_pairs):
    """max with tie preference for earlier args (strictly-greater replaces)."""
    best, which = score_ptr_pairs[0]
    for s, p in score_ptr_pairs[1:]:
        take = s > best
        best = torch.where(take, s, best)
        which = torch.where(take, p, which)
    return best, which


def sw_full_batch_packed(genome: torch.Tensor, read: torch.Tensor,
                         revcmpl: torch.Tensor, band_xmin: torch.Tensor,
                         band_xmax: torch.Tensor,
                         params: SWParams = SWParams(),
                         local_alignment: bool = True, W: int = 32):
    """Band-packed 3-state DP, plain version (CPU tensors).

    genome int8/int32 [B, G] (GENOME_PAD-padded), read [B, R]
    (READ_PAD-padded), revcmpl bool [B], band_xmin/band_xmax int32
    [B, R].  Returns (score[B], best_i[B], best_j[B], states[B, 3],
    bits uint8 [R, B, W]) with bits[i, b, j - band_xmin[b, i]] for cell
    (i, j), as `shrimp_tpu.ops.sw_full.sw_full_batch_packed`."""
    _build.require_cpu(genome, read, revcmpl, band_xmin, band_xmax)
    genome = genome.to(torch.int32)
    read = read.to(torch.int32)
    B, G = genome.shape
    R = read.shape[1]
    rc = revcmpl.to(torch.bool)[:, None]
    loc = bool(local_alignment)
    i32 = lambda v: torch.tensor(v, dtype=torch.int32)  # noqa: E731

    m, x = i32(params.match), i32(params.mismatch)
    aoe = -(params.a_gap_open + params.a_gap_extend)
    ae = -params.a_gap_extend
    boe = -(params.b_gap_open + params.b_gap_extend)
    be = -params.b_gap_extend
    a_go, b_go = params.a_gap_open, params.b_gap_open

    rlen = (read >= 0).sum(dim=1)
    glen = (genome >= 0).sum(dim=1)
    fill_s = 0 if loc else NEG_INF
    # border triple for out-of-band cells / outside the previous band
    bor_nw = 0 if loc else NEG_INF
    bor_n = b_go if loc else NEG_INF
    bor_w = a_go if loc else NEG_INF
    bor3 = torch.tensor([bor_nw, bor_n, bor_w],
                        dtype=torch.int32)[:, None, None].expand(3, B, 1)
    smax = shift_max(G)

    uu = torch.arange(W, dtype=torch.int32)[None, :]
    u64 = uu.to(torch.int64)
    genome_ext = torch.cat(
        [genome, torch.full((B, 1), GENOME_PAD, dtype=torch.int32)], dim=1)
    tilt1 = ae * (uu + 1)
    chain_off = -aoe - ae * uu
    w_border = bor_w - ae * (uu + 1)
    col = lambda v: torch.full((B, 1), v, dtype=torch.int32)  # noqa: E731
    u8 = lambda v: torch.tensor(v, dtype=torch.uint8)  # noqa: E731

    plane = lambda v: torch.full((B, W), v, dtype=torch.int32)  # noqa: E731
    nw_p, n_p, w_p = plane(NEG_INF), plane(NEG_INF), plane(NEG_INF)
    xmin_p = torch.zeros(B, dtype=torch.int32)
    best = torch.zeros(B, dtype=torch.int32)
    best_i = torch.zeros(B, dtype=torch.int32)
    best_j = torch.zeros(B, dtype=torch.int32)
    best_states = torch.zeros((B, 3), dtype=torch.int32)
    bits = torch.zeros((R, B, W), dtype=torch.uint8)
    bxmin = band_xmin.to(torch.int32)
    bxmax = band_xmax.to(torch.int32)
    zeros_bw = plane(0)

    for i in range(R):
        xc, xx, rch = bxmin[:, i], bxmax[:, i], read[:, i]
        if i == 0:
            # virtual row -1 carries the local-style init in both modes
            p_d_nw, p_d_n, p_d_w = zeros_bw, plane(b_go), plane(a_go)
            p_n_nw, p_n_n = zeros_bw, plane(b_go)
        else:
            # predecessor rows in current-packed coordinates:
            # ext = [border | T | border], S_d[u] = ext[u + d] (diagonal),
            # S_n[u] = ext[u + 1 + d] (north)
            d = (xc - xmin_p).clamp(0, smax).to(torch.int64)[:, None]
            T = torch.stack([nw_p, n_p, w_p])
            ext = torch.cat([bor3, T, bor3], dim=2)
            idx_d = (u64 + d).clamp(max=W + 1).expand(3, B, W)
            idx_n = (u64 + 1 + d).clamp(max=W + 1).expand(3, B, W)
            S_d = torch.gather(ext, 2, idx_d)
            S_n = torch.gather(ext, 2, idx_n)
            p_d_nw, p_d_n, p_d_w = S_d[0], S_d[1], S_d[2]
            p_n_nw, p_n_n = S_n[0], S_n[1]

        gsh = xc.clamp(0, smax).to(torch.int64)[:, None]
        gchar = torch.gather(genome_ext, 1, (u64 + gsh).clamp(max=G))
        ms = torch.where(gchar == rch[:, None], m, x)

        # --- NW state (diagonal preds only) ---
        fs, fp = _pick((p_d_nw + ms, u8(NW_FROM_NW)),
                       (p_d_n + ms, u8(NW_FROM_N)),
                       (p_d_w + ms, u8(NW_FROM_W)))
        rs, rp = _pick((p_d_w + ms, u8(NW_FROM_W)),
                       (p_d_n + ms, u8(NW_FROM_N)),
                       (p_d_nw + ms, u8(NW_FROM_NW)))
        s_nw = torch.where(rc, rs, fs)
        p_nw = torch.where(rc, rp, fp)
        if loc:
            z = s_nw <= 0
            s_nw = torch.where(z, 0, s_nw)
            p_nw = torch.where(z, u8(0), p_nw)

        # --- N state (north preds only) ---
        fs, fp = _pick((p_n_nw - boe, u8(N_FROM_NW)),
                       (p_n_n - be, u8(N_FROM_N)))
        rs, rp = _pick((p_n_n - be, u8(N_FROM_N)),
                       (p_n_nw - boe, u8(N_FROM_NW)))
        s_n = torch.where(rc, rs, fs)
        p_n = torch.where(rc, rp, fp)
        if loc:
            z = s_n <= 0
            s_n = torch.where(z, 0, s_n)
            p_n = torch.where(z, u8(0), p_n)

        # --- W state: tilted cummax over [border_nw; floored NW row],
        # then max with the pure border-W extension chain ---
        run = torch.cummax(torch.cat([col(bor_nw), s_nw + tilt1], dim=1),
                           dim=1).values
        s_w = torch.maximum(run[:, :W] + chain_off, w_border)
        # pointer: exact per-cell comparison of (NW[j-1]-aoe, W[j-1]-ae)
        w_floored = s_w.clamp_min(0) if loc else s_w
        c_nw = torch.cat([col(bor_nw), s_nw[:, :-1]], dim=1) - aoe
        c_w = torch.cat([col(bor_w), w_floored[:, :-1]], dim=1) - ae
        p_w_f = torch.where(c_nw >= c_w, u8(W_FROM_NW), u8(W_FROM_W))
        p_w_r = torch.where(c_w >= c_nw, u8(W_FROM_W), u8(W_FROM_NW))
        p_w = torch.where(rc, p_w_r, p_w_f)
        if loc:
            z = s_w <= 0
            s_w = torch.where(z, 0, s_w)
            p_w = torch.where(z, u8(0), p_w)

        # --- band-width masking within the row, then grid validity ---
        in_band = uu <= (xx - xc)[:, None]
        s_nw = torch.where(in_band, s_nw, bor_nw)
        s_n = torch.where(in_band, s_n, bor_n)
        s_w = torch.where(in_band, s_w, bor_w)
        valid = ((xc[:, None] + uu) < glen[:, None]) & (i < rlen)[:, None]
        keep = in_band & valid
        s_nw = torch.where(valid, s_nw, fill_s)
        s_n = torch.where(valid, s_n, fill_s)
        s_w = torch.where(valid, s_w, fill_s)
        p_nw = torch.where(keep, p_nw, u8(0))
        p_n = torch.where(keep, p_n, u8(0))
        p_w = torch.where(keep, p_w, u8(0))

        # --- best tracking: rows in order == row-major first-strict-max
        # (within a row argmax takes the lowest packed u = lowest j) ---
        cell = torch.maximum(torch.maximum(s_nw, s_n), s_w)
        eligible = valid if loc else valid & (i == rlen - 1)[:, None]
        cell = torch.where(eligible, cell, NEG_INF)
        row_best, slot = cell.max(dim=1)
        improved = row_best > best
        best = torch.where(improved, row_best, best)
        best_i = torch.where(improved, i32(i), best_i)
        best_j = torch.where(improved, xc + slot.to(torch.int32), best_j)
        sl = slot[:, None]
        cand_states = torch.cat([s_nw.gather(1, sl), s_n.gather(1, sl),
                                 s_w.gather(1, sl)], dim=1)
        best_states = torch.where(improved[:, None], cand_states,
                                  best_states)

        bits[i] = p_nw | (p_n << 2) | (p_w << 4)
        nw_p, n_p, w_p, xmin_p = s_nw, s_n, s_w, xc
    if not loc:
        best = best.clamp_min(0)
    return best, best_i, best_j, best_states, bits


def traceback_batch_packed(bits: torch.Tensor, band_xmin: torch.Tensor,
                           bi: torch.Tensor, bj: torch.Tensor,
                           states: torch.Tensor, genome: torch.Tensor,
                           read: torch.Tensor, score: torch.Tensor) -> dict:
    """Pointer walk over the packed (R, B, W) bits plane, plain version
    (CPU tensors); cell (i, j) lives at bits[i, b, j - band_xmin[b, i]].
    Same walk and outputs as `traceback_batch_packed_jax`."""
    _build.require_cpu(bits, band_xmin, bi, bj, states, genome, read, score)
    R_, B, W = bits.shape
    G = genome.shape[1]
    max_steps = R_ + G
    lanes = torch.arange(B)
    xmin = band_xmin.to(torch.int64)

    s_nw, s_n, s_w = states[:, 0], states[:, 1], states[:, 2]
    state = torch.full((B,), STATE_NW, dtype=torch.int64)
    take = s_w > s_nw
    state = torch.where(take, STATE_W, state)
    sbest = torch.where(take, s_w, s_nw)
    state = torch.where(s_n > sbest, STATE_N, state)

    genome64 = genome.to(torch.int64)
    read64 = read.to(torch.int64)
    i = bi.to(torch.int64)
    j = bj.to(torch.int64)
    active = score > 0
    zeros = lambda: torch.zeros(B, dtype=torch.int64)  # noqa: E731
    rs, gs, mt, mm, ins, dl, nops = (zeros() for _ in range(7))
    ops_steps = torch.zeros((max_steps, B), dtype=torch.uint8)

    for step in range(max_steps):
        if not bool(active.any()):
            break
        ii = i.clamp(0, R_ - 1)
        jj = j.clamp(0, G - 1)
        # a predecessor step can point at an out-of-band cell; those read
        # pointer 0 (the walk stops)
        u_raw = jj - xmin[lanes, ii]
        inb = (u_raw >= 0) & (u_raw < W)
        cell = torch.where(inb, bits[ii, lanes, u_raw.clamp(0, W - 1)],
                           torch.tensor(0, dtype=torch.uint8)).to(torch.int64)
        ptr = torch.where(state == STATE_NW, cell & 3,
                          torch.where(state == STATE_N, (cell >> 2) & 3,
                                      (cell >> 4) & 3))
        step_active = active & (ptr != 0)
        is_nw = step_active & (state == STATE_NW)
        is_n = step_active & (state == STATE_N)
        is_w = step_active & (state == STATE_W)

        op = torch.where(is_n, OP_DEL, torch.where(is_w, OP_INS, OP_MATCH))
        ops_steps[step] = op.to(torch.uint8)
        nops = nops + step_active

        eq = genome64[lanes, jj] == read64[lanes, ii]
        mt = mt + (is_nw & eq)
        mm = mm + (is_nw & ~eq)
        dl = dl + is_n
        ins = ins + is_w
        rs = torch.where(is_nw | is_n, i, rs)
        gs = torch.where(is_nw | is_w, j, gs)
        i = i - (is_nw | is_n).to(torch.int64)
        j = j - (is_nw | is_w).to(torch.int64)

        nxt = torch.where(
            is_nw,
            torch.where(ptr == NW_FROM_NW, STATE_NW,
                        torch.where(ptr == NW_FROM_N, STATE_N, STATE_W)),
            torch.where(is_n,
                        torch.where(ptr == N_FROM_N, STATE_N, STATE_NW),
                        torch.where(ptr == W_FROM_W, STATE_W, STATE_NW)))
        state = torch.where(step_active, nxt, state)
        active = step_active & (i >= 0) & (j >= 0)

    ops = ops_steps.T
    k = torch.arange(max_steps)[None, :]
    src = (nops[:, None] - 1 - k).clamp(0, max(max_steps - 1, 0))
    ops_rev = torch.gather(ops, 1, src)
    ops_rev = torch.where(k < nops[:, None], ops_rev,
                          torch.tensor(0, dtype=torch.uint8))
    return {
        "read_start": rs, "genome_start": gs,
        "matches": mt, "mismatches": mm,
        "insertions": ins, "deletions": dl,
        "rmapped": mt + mm + dl, "gmapped": mt + mm + ins,
        "ops": ops_rev, "ops_len": nops,
    }


def sw_full_and_traceback_packed_plain(genome, read, revcmpl, band_xmin,
                                       band_xmax, params: SWParams,
                                       local_alignment: bool, W: int):
    """DP + walk, plain version (CPU tensors): (stats int32 [B, 10],
    ops uint8 [B, R + G])."""
    score, bi, bj, states, bits = sw_full_batch_packed(
        genome, read, revcmpl, band_xmin, band_xmax, params,
        local_alignment, W)
    tb = traceback_batch_packed(bits, band_xmin, bi, bj, states, genome,
                                read, score)
    stats = torch.stack([
        score.to(torch.int64), tb["read_start"], tb["genome_start"],
        tb["matches"], tb["mismatches"], tb["insertions"], tb["deletions"],
        tb["rmapped"], tb["gmapped"], tb["ops_len"]], dim=1).to(torch.int32)
    return stats, tb["ops"]


# ---------------------------------------------------------------------------
# CUDA kernel wrapper
_LIB = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("sw_full")
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.sw_full_launch.restype = ctypes.c_int
        lib.sw_full_launch.argtypes = [
            vp, vp, vp, vp, vp, i, i, i, i, i, i,
            i, i, i, i, i, i, vp, vp, vp, vp]
        lib.sw_full_plan.restype = ctypes.c_int
        lib.sw_full_plan.argtypes = [i, i, i, ctypes.POINTER(ctypes.c_int)]
        _LIB = lib
    return _LIB


def launch_plan(G: int, R: int, W: int) -> dict:
    """The kernel's shape for alignments of G, R, W, as its launcher
    fixes it: lanes a tile, columns a lane, whether the per-row inputs and
    window are staged in shared memory, the shared pointer-plane budget
    and the global scratch bytes an alignment.  Raises when an alignment
    does not fit a block's shared memory."""
    out = (ctypes.c_int * 5)()
    if _lib().sw_full_plan(G, R, W, out):
        raise ValueError(f"sw_full: an alignment of G {G}, R {R}, W {W} "
                         "does not fit a block's shared memory")
    return dict(zip(("lanes", "cols", "staged", "plane_smem",
                     "scratch_per_alignment"), out))


def sw_full_and_traceback_packed_cuda(genome, read, revcmpl, band_xmin,
                                      band_xmax, params: SWParams,
                                      local_alignment: bool, W: int):
    """DP + walk on the card, one launch: genome int8 [B, G], read int8
    [B, R], revcmpl bool [B], band_xmin/band_xmax int32 [B, R].  Returns
    (stats int32 [B, 10], ops uint8 [B, R + G]) on the same device."""
    dev = genome.device
    if dev.type != "cuda":
        raise ValueError(f"the sw_full kernel needs CUDA tensors; got {dev}")
    _build.check_tensor("genome", genome, torch.int8, 2, dev)
    _build.check_tensor("read", read, torch.int8, 2, dev)
    _build.check_tensor("revcmpl", revcmpl, torch.bool, 1, dev)
    _build.check_tensor("band_xmin", band_xmin, torch.int32, 2, dev)
    _build.check_tensor("band_xmax", band_xmax, torch.int32, 2, dev)
    B, G = genome.shape
    R = read.shape[1]
    if read.shape[0] != B or revcmpl.shape[0] != B:
        raise ValueError("genome, read and revcmpl must have the same rows")
    if tuple(band_xmin.shape) != (B, R) or tuple(band_xmax.shape) != (B, R):
        raise ValueError(f"bands must be {(B, R)}")
    if W < 1:
        raise ValueError(f"W must be >= 1, got {W}")
    stats = torch.empty((B, 10), dtype=torch.int32, device=dev)
    ops = torch.empty((B, R + G), dtype=torch.uint8, device=dev)
    if B == 0:
        return stats, ops
    lib = _lib()
    per = launch_plan(G, R, W)["scratch_per_alignment"]
    scratch = (torch.empty(B * per, dtype=torch.uint8, device=dev)
               if per else None)
    p = params
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.sw_full_launch(
            genome.data_ptr(), read.data_ptr(), revcmpl.data_ptr(),
            band_xmin.data_ptr(), band_xmax.data_ptr(), B, G, R, W,
            shift_max(G), int(bool(local_alignment)), p.match, p.mismatch,
            p.a_gap_open, p.a_gap_extend, p.b_gap_open, p.b_gap_extend,
            None if scratch is None else scratch.data_ptr(),
            stats.data_ptr(), ops.data_ptr(), stream)
    _build.check_launch(lib, "sw_full", rc)
    LAUNCHES.add()
    return stats, ops


def sw_full_and_traceback_packed(genome, read, revcmpl, band_xmin,
                                 band_xmax, params: SWParams = SWParams(),
                                 local_alignment: bool = False, W: int = 32):
    """Counterpart of `sw_full_and_traceback_packed_jax`: the kernel for
    CUDA tensors, the plain version for CPU ones."""
    if genome.device.type == "cuda":
        return sw_full_and_traceback_packed_cuda(
            genome, read, revcmpl, band_xmin, band_xmax, params,
            local_alignment, W)
    return sw_full_and_traceback_packed_plain(
        genome, read, revcmpl, band_xmin, band_xmax, params,
        local_alignment, W)
