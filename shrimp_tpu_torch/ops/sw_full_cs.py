"""Colour-space pass-2 full Smith-Waterman with traceback (L2d), the
counterpart of the band-packed path of `shrimp_tpu/ops/sw_full_cs.py`.

Covers `common/sw-full-cs.c`: four affine DP layers, one per letter-space
decoding of the colour read (layer k decodes from letter
`(initbp + k) % 4`), joined by "crossover" transitions that model colour
sequencing errors, at a per-row cost `xover_row` (the global crossover
score, or the per-colour qv-derived one, gmapper.c:533-546):

  * 3 states per layer per cell: NW (diagonal), N (read char vs genome
    gap), W (genome char vs read gap); NW and N take same-layer and
    cross-layer predecessors (the latter pay the row's crossover), W
    same-layer only (sw-full-cs.c:535-538);
  * the match score is 0 when either character is N (BASE_N);
  * local floors are 0 for layer 0 and the row's crossover for layers
    1-3; the virtual top row uses the *global* crossover in both modes;
  * within the last `taboo_len` read rows no gap opens (indel taboo);
  * ties: forward order nw, n, w and reverse order w, n, nw per source
    layer, then same layer before the cross layers in ascending order;
    the best cell is the row-major first strict maximum over (i, j, k).

The DP runs in packed band coordinates u = j - band_xmin[i] at width W.
Two versions of `sw_full_cs_and_traceback_packed`:
  * the plain PyTorch version (`sw_full_cs_batch_packed` +
    `traceback_cs_batch_packed`), a row loop and a walk loop mirroring
    `sw_full_cs_batch_packed` / `traceback_cs_batch_packed_jax`; CPU
    tensors only;
  * the CUDA kernel `csrc/sw_full_cs.cu` (K7 + K8 in one launch: a tile
    of lanes an alignment sweeping each row's band only, pointers in a
    global scratch, its shape fixed by the launcher from (G, R, W),
    `launch_plan`), through `sw_full_cs_and_traceback_packed_cuda`.
Run at W = round_up(G, 32) over the full band [0, w_len - 1], the packed
form equals the unbanded `sw_full_cs_and_traceback_jax` (K9) bit for bit.
The NumPy helpers (codes, `cross_layers`, `render_alignment_cs`,
`CSAlignment`) are carried over unchanged: the JAX module imports jax at
module level, so it cannot be imported here.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, field

import numpy as np
import torch

from shrimp_tpu_torch.ops.params import SWParams
from shrimp_tpu_torch import _build
from shrimp_tpu_torch.ops.sw_full import shift_max
from shrimp_tpu_torch.ops.sw_vector import GENOME_PAD, NEG_INF

BASE_N = 15

STATE_NW, STATE_N, STATE_W = 0, 1, 2

# op codes in the traceback output (bits 0-1), matching ops/sw_full.py
OP_MATCH = 0      # genome char aligned to read char
OP_INS = 1        # genome char vs gap in read
OP_DEL = 2        # read char vs gap in genome
# bits 2-3: layer the column was emitted from; bit 4: crossover flag
OP_XOVER = 0x10

# launches of the sw_full_cs kernel
LAUNCHES = _build.LaunchCounter()


def _ptr(layer, src_state):
    """4-bit pointer payload: 0 = stop, else 1 + layer*3 + src_state."""
    return 1 + layer * 3 + src_state


def cross_layers(k, order):
    return [l for l in order if l != k]


def _pick(cands):
    """First strict maximum over ordered (score, ptr) pairs; ptr is an int
    or a tensor of the score's shape."""
    best, which = cands[0]
    if not torch.is_tensor(which):
        which = torch.full_like(best, which)
    for s, p in cands[1:]:
        take = s > best
        best = torch.where(take, s, best)
        which = torch.where(take, p, which)
    return best, which


def sw_full_cs_batch_packed(genome: torch.Tensor, qr4: torch.Tensor,
                            xover_row: torch.Tensor, revcmpl: torch.Tensor,
                            band_xmin: torch.Tensor, band_xmax: torch.Tensor,
                            params: SWParams = SWParams(),
                            local_alignment: bool = True,
                            taboo_len: int = 0, W: int = 32):
    """Band-packed 4-layer DP, plain version (CPU tensors).

    genome int8/int32 [B, G] letter codes (GENOME_PAD-padded), qr4 [B, 4, R]
    the read's four letter decodings (READ_PAD-padded), xover_row int32
    [B, R], revcmpl bool [B], band_xmin/band_xmax int32 [B, R].  Returns
    (score[B], best_i[B], best_j[B], best_k[B], states[B, 3], bits int16
    [R, B, 4, W]) with bits[i, b, k, j - band_xmin[b, i]] = p_nw | p_n << 4
    | p_w << 8 for cell (i, j, k), as the JAX `sw_full_cs_batch_packed`."""
    _build.require_cpu(genome, qr4, xover_row, revcmpl, band_xmin, band_xmax)
    genome = genome.to(torch.int32)
    qr4 = qr4.to(torch.int32)
    B, G = genome.shape
    R = qr4.shape[2]
    rc2 = revcmpl.to(torch.bool)[:, None]
    loc = bool(local_alignment)

    m, x = params.match, params.mismatch
    aoe = -(params.a_gap_open + params.a_gap_extend)
    ae = -params.a_gap_extend
    boe = -(params.b_gap_open + params.b_gap_extend)
    be = -params.b_gap_extend
    a_go, b_go = params.a_gap_open, params.b_gap_open
    gxp = params.crossover

    rlen = (qr4[:, 0, :] >= 0).sum(dim=1)
    glen = (genome >= 0).sum(dim=1)
    uu = torch.arange(W, dtype=torch.int32)[None, :]
    u64 = uu.to(torch.int64)
    genome_ext = torch.cat(
        [genome, torch.full((B, 1), GENOME_PAD, dtype=torch.int32)], dim=1)
    tilt = ae * torch.arange(W + 1, dtype=torch.int32)[None, :]
    k4 = torch.arange(4, dtype=torch.int32)[None, :]
    # virtual row -1: local-style init with the GLOBAL crossover
    # (sw-full-cs.c:266-268)
    top_nw = torch.where(k4 == 0, 0, gxp).to(torch.int32)
    top_tri = [t[:, :, None].expand(B, 4, W)
               for t in (top_nw, b_go + top_nw, a_go + top_nw)]
    smax = shift_max(G)
    neg = torch.tensor(NEG_INF, dtype=torch.int32)

    xp_all = xover_row.to(torch.int32)
    xp_prev = torch.cat([torch.zeros((B, 1), dtype=torch.int32),
                         xp_all[:, :-1]], dim=1)
    bxmin = band_xmin.to(torch.int32)
    bxmax = band_xmax.to(torch.int32)

    def plane():
        return torch.full((B, 4, W), NEG_INF, dtype=torch.int32)

    nw_p, n_p, w_p = plane(), plane(), plane()
    xmin_p = torch.zeros(B, dtype=torch.int32)
    best = torch.zeros(B, dtype=torch.int32)
    best_i = torch.zeros(B, dtype=torch.int32)
    best_j = torch.zeros(B, dtype=torch.int32)
    best_k = torch.zeros(B, dtype=torch.int32)
    best_states = torch.zeros((B, 3), dtype=torch.int32)
    bits = torch.zeros((R, B, 4, W), dtype=torch.int16)
    lanes = torch.arange(B)

    for i in range(R):
        xc, xx = bxmin[:, i], bxmax[:, i]
        ie_c = torch.where(k4 == 0, 0, xp_all[:, i:i + 1])     # [B, 4]
        ie_p = torch.where(k4 == 0, 0, xp_prev[:, i:i + 1])
        if loc:
            col = (ie_c, b_go + ie_c, a_go + ie_c)
            cm1 = (ie_p, b_go + ie_p, a_go + ie_p)
        else:
            col = cm1 = (torch.full((B, 4), NEG_INF, dtype=torch.int32),) * 3

        if i == 0:
            p_d_nw, p_d_n, p_d_w = top_tri
            p_n_nw, p_n_n = top_tri[0], top_tri[1]
        else:
            # previous-row planes in current-packed coordinates:
            # ext = [border | T | border], S_d[u] = ext[u + d] (diagonal),
            # S_n[u] = ext[u + 1 + d] (north), d clipped as the TPU kernel
            d = (xc - xmin_p).clamp(0, smax).to(torch.int64)[:, None, None]
            T = torch.stack([nw_p, n_p, w_p])                  # [3, B, 4, W]
            bor = torch.stack(cm1)[..., None]                  # [3, B, 4, 1]
            ext = torch.cat([bor, T, bor], dim=3)
            idx_d = (u64[None] + d).clamp(max=W + 1).expand(3, B, 4, W)
            idx_n = (u64[None] + 1 + d).clamp(max=W + 1).expand(3, B, 4, W)
            S_d = torch.gather(ext, 3, idx_d)
            S_n = torch.gather(ext, 3, idx_n)
            p_d_nw, p_d_n, p_d_w = S_d[0], S_d[1], S_d[2]
            p_n_nw, p_n_n = S_n[0], S_n[1]

        gsh = xc.clamp(0, smax).to(torch.int64)[:, None]
        gchar = torch.gather(genome_ext, 1, (u64 + gsh).clamp(max=G))
        g3 = gchar[:, None, :]
        q3 = qr4[:, :, i][:, :, None]
        ms = torch.where((g3 == BASE_N) | (q3 == BASE_N), 0,
                         torch.where(g3 == q3, m, x)).to(torch.int32)

        tok = (i < rlen - taboo_len)[:, None]                  # [B, 1]

        def guard(v):
            return torch.where(tok, v, neg)

        # per-source-layer first strict maxima, shared by every
        # destination layer, then per-destination 6-picks
        M_d, M_n = [], []
        for l in range(4):
            d_nw, d_n, d_w = p_d_nw[:, l], guard(p_d_n[:, l]), p_d_w[:, l]
            fs, fp = _pick([(d_nw, _ptr(l, STATE_NW)),
                            (d_n, _ptr(l, STATE_N)),
                            (d_w, _ptr(l, STATE_W))])
            rs, rp = _pick([(d_w, _ptr(l, STATE_W)),
                            (d_n, _ptr(l, STATE_N)),
                            (d_nw, _ptr(l, STATE_NW))])
            M_d.append((torch.where(rc2, rs, fs), torch.where(rc2, rp, fp)))
            n_nw, n_n = guard(p_n_nw[:, l] - boe), p_n_n[:, l] - be
            fs, fp = _pick([(n_nw, _ptr(l, STATE_NW)),
                            (n_n, _ptr(l, STATE_N))])
            rs, rp = _pick([(n_n, _ptr(l, STATE_N)),
                            (n_nw, _ptr(l, STATE_NW))])
            M_n.append((torch.where(rc2, rs, fs), torch.where(rc2, rp, fp)))

        xpk = xp_all[:, i:i + 1]                               # [B, 1]
        s_nw_l, p_nw_l, s_n_l, p_n_l, s_w_l, p_w_l = [], [], [], [], [], []
        for k in range(4):
            msk = ms[:, k]
            reset = ie_c[:, k:k + 1]                           # [B, 1]

            # --- NW state ---
            s_nw, p_nw = _pick(
                [(M_d[k][0] + msk, M_d[k][1])]
                + [(M_d[l][0] + msk + xpk, M_d[l][1])
                   for l in cross_layers(k, range(4))])
            if loc:
                z = s_nw <= reset
                s_nw = torch.where(z, reset, s_nw)
                p_nw = torch.where(z, 0, p_nw)

            # --- N state ---
            s_n, p_n = _pick(
                [M_n[k]] + [(M_n[l][0] + xpk, M_n[l][1])
                            for l in cross_layers(k, range(4))])
            if loc:
                z = s_n <= reset
                s_n = torch.where(z, reset, s_n)
                p_n = torch.where(z, 0, p_n)

            # --- W state: per-layer tilted cummax over the floored NW
            # row (taboo rows exclude every gap-open candidate, leaving
            # only the border-W extension chain) ---
            c_nw_k = col[0][:, k:k + 1]
            c_w_k = col[2][:, k:k + 1]
            cand = guard(torch.cat([c_nw_k, s_nw], dim=1))     # [B, W + 1]
            run = torch.cummax(cand + tilt, dim=1).values
            chain = run[:, :-1] - aoe - ae * uu
            s_w = torch.maximum(chain, c_w_k - ae * (uu + 1))
            w_floored = torch.maximum(s_w, reset) if loc else s_w
            nw_west = torch.cat([c_nw_k, s_nw[:, :-1]], dim=1)
            w_west = torch.cat([c_w_k, w_floored[:, :-1]], dim=1)
            cd_nw = guard(nw_west - aoe)
            cd_w = w_west - ae
            p_w_f = torch.where(cd_nw >= cd_w, _ptr(k, STATE_NW),
                                _ptr(k, STATE_W))
            p_w_r = torch.where(cd_w >= cd_nw, _ptr(k, STATE_W),
                                _ptr(k, STATE_NW))
            p_w = torch.where(rc2, p_w_r, p_w_f)
            if loc:
                z = s_w <= reset
                s_w = torch.where(z, reset, s_w)
                p_w = torch.where(z, 0, p_w)

            s_nw_l.append(s_nw)
            p_nw_l.append(p_nw)
            s_n_l.append(s_n)
            p_n_l.append(p_n)
            s_w_l.append(s_w)
            p_w_l.append(p_w)

        s_nw = torch.stack(s_nw_l, dim=1).to(torch.int32)      # [B, 4, W]
        s_n = torch.stack(s_n_l, dim=1).to(torch.int32)
        s_w = torch.stack(s_w_l, dim=1).to(torch.int32)
        p_nw = torch.stack(p_nw_l, dim=1).to(torch.int32)
        p_n = torch.stack(p_n_l, dim=1).to(torch.int32)
        p_w = torch.stack(p_w_l, dim=1).to(torch.int32)

        # --- band-width + grid masking to the row border values ---
        in_band = uu <= (xx - xc)[:, None]
        valid = in_band & ((xc[:, None] + uu) < glen[:, None]) \
            & (i < rlen)[:, None]
        outside = ~valid[:, None, :]
        s_nw = torch.where(outside, col[0][:, :, None], s_nw)
        s_n = torch.where(outside, col[1][:, :, None], s_n)
        s_w = torch.where(outside, col[2][:, :, None], s_w)
        p_nw = torch.where(outside, 0, p_nw)
        p_n = torch.where(outside, 0, p_n)
        p_w = torch.where(outside, 0, p_w)

        # --- best tracking: rows in order == row-major first strict max
        # over (i, j, k); the layer reduce first (lowest k), then the slot
        # (lowest u = lowest j) ---
        cell = torch.maximum(torch.maximum(s_nw, s_n), s_w)
        eligible = valid if loc else valid & (i == rlen - 1)[:, None]
        cell = torch.where(eligible[:, None, :], cell, neg)
        cell_bk, lane_best_k = cell.max(dim=1)
        row_best, slot = cell_bk.max(dim=1)
        cand_k = lane_best_k.gather(1, slot[:, None])[:, 0]
        improved = row_best > best
        best = torch.where(improved, row_best, best)
        best_i = torch.where(improved, i, best_i)
        best_j = torch.where(improved, xc + slot.to(torch.int32), best_j)
        best_k = torch.where(improved, cand_k.to(torch.int32), best_k)
        cand_states = torch.stack([s_nw[lanes, cand_k, slot],
                                   s_n[lanes, cand_k, slot],
                                   s_w[lanes, cand_k, slot]], dim=1)
        best_states = torch.where(improved[:, None], cand_states,
                                  best_states)

        bits[i] = (p_nw | (p_n << 4) | (p_w << 8)).to(torch.int16)
        nw_p, n_p, w_p, xmin_p = s_nw, s_n, s_w, xc
    return best, best_i, best_j, best_k, best_states, bits


def traceback_cs_batch_packed(bits: torch.Tensor, band_xmin: torch.Tensor,
                              bi: torch.Tensor, bj: torch.Tensor,
                              bk: torch.Tensor, states: torch.Tensor,
                              genome: torch.Tensor, qr4: torch.Tensor,
                              score: torch.Tensor) -> dict:
    """Pointer walk over the packed (R, B, 4, W) bits plane, plain version
    (CPU tensors); cell (i, j, k) lives at bits[i, b, k, j - band_xmin[b,
    i]].  Same walk and outputs as `traceback_cs_batch_packed_jax`: ops are
    type | layer << 2 | OP_XOVER, in alignment order."""
    _build.require_cpu(bits, band_xmin, bi, bj, bk, states, genome, qr4,
                       score)
    R_, B, _, W = bits.shape
    G = genome.shape[1]
    max_steps = R_ + G
    lanes = torch.arange(B)
    xmin = band_xmin.to(torch.int64)

    s_nw, s_n, s_w = states[:, 0], states[:, 1], states[:, 2]
    st = torch.full((B,), STATE_NW, dtype=torch.int64)
    take = s_w > s_nw
    st = torch.where(take, STATE_W, st)
    sbest = torch.where(take, s_w, s_nw)
    st = torch.where(s_n > sbest, STATE_N, st)

    genome64 = genome.to(torch.int64)
    qr64 = qr4.to(torch.int64)
    i = bi.to(torch.int64)
    j = bj.to(torch.int64)
    k = bk.to(torch.int64)
    active = score > 0

    def zeros():
        return torch.zeros(B, dtype=torch.int64)

    rs, gs, mt, mm, ins, dl, xo, nops = (zeros() for _ in range(8))
    ops_steps = torch.zeros((max_steps, B), dtype=torch.uint8)

    for step in range(max_steps):
        if not bool(active.any()):
            break
        ii = i.clamp(0, R_ - 1)
        jj = j.clamp(0, G - 1)
        # out-of-band predecessors read pointer 0 (the walk stops)
        u_raw = jj - xmin[lanes, ii]
        inb = (u_raw >= 0) & (u_raw < W)
        cell = torch.where(inb, bits[ii, lanes, k, u_raw.clamp(0, W - 1)],
                           torch.tensor(0, dtype=torch.int16)) \
            .to(torch.int64)
        ptr = (cell >> (4 * st)) & 15
        step_active = active & (ptr != 0)
        src_layer = torch.div(ptr - 1, 3, rounding_mode="floor")
        src_state = torch.remainder(ptr - 1, 3)

        is_nw = step_active & (st == STATE_NW)
        is_n = step_active & (st == STATE_N)
        is_w = step_active & (st == STATE_W)
        xover = step_active & (src_layer != k)

        gch = genome64[lanes, jj]
        qch = qr64[lanes, k, ii]
        eq = (gch == qch) | (gch == BASE_N) | (qch == BASE_N)
        mt = mt + (is_nw & eq)
        mm = mm + (is_nw & ~eq)
        dl = dl + is_n
        ins = ins + is_w
        xo = xo + xover
        rs = torch.where(is_nw | is_n, i, rs)
        gs = torch.where(is_nw | is_w, j, gs)

        op = (torch.where(is_n, OP_DEL, torch.where(is_w, OP_INS, OP_MATCH))
              | (k << 2) | torch.where(xover, OP_XOVER, 0))
        ops_steps[step] = op.to(torch.uint8)
        nops = nops + step_active

        i = i - (is_nw | is_n).to(torch.int64)
        j = j - (is_nw | is_w).to(torch.int64)
        k = torch.where(step_active, src_layer, k)
        st = torch.where(step_active, src_state, st)
        active = step_active & (i >= 0) & (j >= 0)

    ops = ops_steps.T
    kidx = torch.arange(max_steps)[None, :]
    src = (nops[:, None] - 1 - kidx).clamp(0, max(max_steps - 1, 0))
    ops_rev = torch.gather(ops, 1, src)
    ops_rev = torch.where(kidx < nops[:, None], ops_rev,
                          torch.tensor(0, dtype=torch.uint8))
    # an alignment that begins in a non-primary layer costs one more
    # crossover, flagged on its first column (sw-full-cs.c:935-939)
    final_x = (k != 0) & (nops > 0)
    ops_rev[:, 0] |= torch.where(final_x, OP_XOVER, 0).to(torch.uint8)
    xo = xo + final_x
    return {
        "read_start": rs, "genome_start": gs,
        "matches": mt, "mismatches": mm,
        "insertions": ins, "deletions": dl, "crossovers": xo,
        "rmapped": mt + mm + dl, "gmapped": mt + mm + ins,
        "ops": ops_rev, "ops_len": nops,
    }


def sw_full_cs_and_traceback_packed_plain(genome, qr4, xover_row, revcmpl,
                                          band_xmin, band_xmax,
                                          params: SWParams,
                                          local_alignment: bool,
                                          taboo_len: int, W: int):
    """DP + walk, plain version (CPU tensors): (stats int32 [B, 11], ops
    uint8 [B, R + G]); stats columns are (score, read_start, genome_start,
    matches, mismatches, insertions, deletions, rmapped, gmapped, ops_len,
    crossovers)."""
    score, bi, bj, bk, states, bits = sw_full_cs_batch_packed(
        genome, qr4, xover_row, revcmpl, band_xmin, band_xmax, params,
        local_alignment, taboo_len, W)
    tb = traceback_cs_batch_packed(bits, band_xmin, bi, bj, bk, states,
                                   genome, qr4, score)
    stats = torch.stack([
        score.to(torch.int64), tb["read_start"], tb["genome_start"],
        tb["matches"], tb["mismatches"], tb["insertions"], tb["deletions"],
        tb["rmapped"], tb["gmapped"], tb["ops_len"], tb["crossovers"]],
        dim=1).to(torch.int32)
    return stats, tb["ops"]


# ---------------------------------------------------------------------------
# CUDA kernel wrapper
_LIB = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("sw_full_cs")
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.sw_full_cs_launch.restype = ctypes.c_int
        lib.sw_full_cs_launch.argtypes = [
            vp, vp, vp, vp, vp, vp, i, i, i, i, i, i, i,
            i, i, i, i, i, i, i, vp, vp, vp, vp]
        lib.sw_full_cs_plan.restype = ctypes.c_int
        lib.sw_full_cs_plan.argtypes = [i, i, i,
                                        ctypes.POINTER(ctypes.c_int)]
        _LIB = lib
    return _LIB


def launch_plan(G: int, R: int, W: int) -> dict:
    """The kernel's shape for alignments of G, R, W, as its launcher
    fixes it: lanes a tile, whether the per-row inputs and window are
    staged in shared memory, and the global scratch bytes an alignment
    (the pointer plane, R * W * 8, and when not staged the per-row
    inputs).  Raises when an alignment does not fit a block's shared
    memory."""
    out = (ctypes.c_int * 3)()
    if _lib().sw_full_cs_plan(G, R, W, out):
        raise ValueError(f"sw_full_cs: an alignment of G {G}, R {R}, "
                         f"W {W} does not fit a block's shared memory")
    return dict(zip(("lanes", "staged", "scratch_per_alignment"), out))


def sw_full_cs_and_traceback_packed_cuda(genome, qr4, xover_row, revcmpl,
                                         band_xmin, band_xmax,
                                         params: SWParams,
                                         local_alignment: bool,
                                         taboo_len: int, W: int):
    """DP + walk on the card, one launch: genome int8 [B, G], qr4 int8
    [B, 4, R], xover_row int32 [B, R], revcmpl bool [B], band_xmin /
    band_xmax int32 [B, R].  Returns (stats int32 [B, 11], ops uint8
    [B, R + G]) on the same device."""
    dev = genome.device
    if dev.type != "cuda":
        raise ValueError(f"the sw_full_cs kernel needs CUDA tensors; got {dev}")
    _build.check_tensor("genome", genome, torch.int8, 2, dev)
    _build.check_tensor("qr4", qr4, torch.int8, 3, dev)
    _build.check_tensor("xover_row", xover_row, torch.int32, 2, dev)
    _build.check_tensor("revcmpl", revcmpl, torch.bool, 1, dev)
    _build.check_tensor("band_xmin", band_xmin, torch.int32, 2, dev)
    _build.check_tensor("band_xmax", band_xmax, torch.int32, 2, dev)
    B, G = genome.shape
    R = qr4.shape[2]
    if qr4.shape[:2] != (B, 4) or revcmpl.shape[0] != B:
        raise ValueError(f"qr4 must be {(B, 4, R)} and revcmpl {(B,)}")
    for name, t in (("xover_row", xover_row), ("band_xmin", band_xmin),
                    ("band_xmax", band_xmax)):
        if tuple(t.shape) != (B, R):
            raise ValueError(f"{name} is {tuple(t.shape)}, expected {(B, R)}")
    if W < 1:
        raise ValueError(f"W must be >= 1, got {W}")
    stats = torch.empty((B, 11), dtype=torch.int32, device=dev)
    ops = torch.empty((B, R + G), dtype=torch.uint8, device=dev)
    if B == 0:
        return stats, ops
    lib = _lib()
    per = launch_plan(G, R, W)["scratch_per_alignment"]
    scratch = torch.empty(B * per, dtype=torch.uint8, device=dev)
    p = params
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.sw_full_cs_launch(
            genome.data_ptr(), qr4.data_ptr(), xover_row.data_ptr(),
            revcmpl.data_ptr(), band_xmin.data_ptr(), band_xmax.data_ptr(),
            B, G, R, W, shift_max(G), int(bool(local_alignment)),
            int(taboo_len), p.match, p.mismatch, p.a_gap_open,
            p.a_gap_extend, p.b_gap_open, p.b_gap_extend, p.crossover,
            scratch.data_ptr(), stats.data_ptr(), ops.data_ptr(), stream)
    _build.check_launch(lib, "sw_full_cs", rc)
    LAUNCHES.add()
    return stats, ops


def sw_full_cs_and_traceback_packed(genome, qr4, xover_row, revcmpl,
                                    band_xmin, band_xmax,
                                    params: SWParams = SWParams(),
                                    local_alignment: bool = True,
                                    taboo_len: int = 0, W: int = 32):
    """Counterpart of `sw_full_cs_and_traceback_packed_jax`: the kernel for
    CUDA tensors, the plain version for CPU ones."""
    if genome.device.type == "cuda":
        return sw_full_cs_and_traceback_packed_cuda(
            genome, qr4, xover_row, revcmpl, band_xmin, band_xmax, params,
            local_alignment, taboo_len, W)
    return sw_full_cs_and_traceback_packed_plain(
        genome, qr4, xover_row, revcmpl, band_xmin, band_xmax, params,
        local_alignment, taboo_len, W)


def render_alignment_cs(ops: np.ndarray, genome_row: np.ndarray,
                        qr4_row: np.ndarray, genome_start: int,
                        read_start: int) -> tuple[str, str]:
    """dbalign/qralign from the op array (pretty_print, sw-full-cs.c:948-1070).

    genome_row is the letter-space window; qr4_row is [4, R] letter decodings.
    Crossover columns render lowercase; an N read letter in a match column is
    replaced by the genome letter (same case rule)."""
    from shrimp_tpu_torch import dna

    ops = np.asarray(ops, dtype=np.int32)
    typ = ops & 3
    k = (ops >> 2) & 3
    xov = (ops & OP_XOVER) != 0
    consumes_g = typ != OP_DEL
    consumes_r = typ != OP_INS
    gi = int(genome_start) + np.cumsum(consumes_g) - consumes_g
    ri = int(read_start) + np.cumsum(consumes_r) - consumes_r
    gcode = np.asarray(genome_row)[np.minimum(gi, len(genome_row) - 1)] & 15
    dch = dna.LS_CHARS[gcode]
    dch = np.where(consumes_g, dch, np.uint8(ord("-")))
    qr4_row = np.asarray(qr4_row)
    qcode = qr4_row[k, np.minimum(ri, qr4_row.shape[1] - 1)] & 15
    # N read letters in match columns copy the genome letter
    qcode = np.where((typ == OP_MATCH) & (qcode == 15), gcode, qcode)
    qch = dna.LS_CHARS[qcode]
    qch = np.where(xov, qch + 32, qch)           # lowercase crossovers
    qch = np.where(consumes_r, qch, np.uint8(ord("-")))
    return (dch.astype(np.uint8).tobytes().decode("ascii"),
            qch.astype(np.uint8).tobytes().decode("ascii"))


@dataclass
class CSAlignment:
    score: int = 0
    read_start: int = 0
    genome_start: int = 0
    rmapped: int = 0
    gmapped: int = 0
    matches: int = 0
    mismatches: int = 0
    insertions: int = 0
    deletions: int = 0
    crossovers: int = 0
    dbalign: str = ""
    qralign: str = ""
    ops: np.ndarray = field(default_factory=lambda: np.zeros(0, np.uint8))
