"""The port's CUDA kernels against their plain PyTorch versions, and the
goldens through the kernels.  The kernel tests carry the `cuda` marker
and skip without a CUDA device.  This file imports no jax, so it also runs
on a GPU host without it:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

The build tests run everywhere: a failed build raises and never falls
back to the plain version, and the K10 wrapper refuses an index that is
not on a CUDA device."""

import os
import stat

import numpy as np
import pytest
import torch

from shrimp_tpu_torch import _build, dna, gmapper
from shrimp_tpu_torch import index as gindex
from shrimp_tpu_torch import seeds as seedmod
from shrimp_tpu_torch.io import fastx
from shrimp_tpu_torch.ops import candidates_device as tcd
from shrimp_tpu_torch.ops import sw_full as tsf
from shrimp_tpu_torch.ops import sw_full_cs as tcs
from shrimp_tpu_torch.ops import sw_gapless as tsg
from shrimp_tpu_torch.ops import sw_vector as tsv
from shrimp_tpu_torch.ops.params import SWParams
from shrimp_tpu_torch.pipeline import candidates as cand
from shrimp_tpu_torch.pipeline import candidates_batch as cb
from shrimp_tpu_torch.pipeline.candidates import cs_read_ls4
from shrimp_tpu_torch.pipeline.mapper import Mapper
from shrimp_tpu_torch.pipeline.options import MapperConfig
from shrimp_tpu_torch.utils import gapless_cases, golden_cli

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
LS = SWParams.letter_space()
CS = SWParams.colour_space()
# the colour-space pass-1 filter's scoring (Mapper.vect_params)
CS_VECT = CS.with_(mismatch=CS.match + CS.crossover)
ASYM = SWParams(match=5, mismatch=-4, a_gap_open=-10, a_gap_extend=-1,
                b_gap_open=-6, b_gap_extend=-2)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _pass1_inputs(seed, G, R, C=192, L=50000):
    rng = np.random.default_rng(seed)
    plane = np.concatenate([rng.integers(0, 5, L).astype(np.int8),
                            np.full(1 << 12, tsv.GENOME_PAD, np.int8)])
    wlen = rng.integers(G // 2, G + 1, C).astype(np.int32)
    lo = rng.integers(0, L - G, C).astype(np.int64)
    lo[:4] = L - wlen[:4]
    reads2 = np.full((24, 2, R), tsv.READ_PAD, np.int8)
    for b in range(24):
        n = int(rng.integers(R // 2, R + 1))
        reads2[b, :, :n] = rng.integers(0, 4, (2, n))
    rid = rng.integers(0, 24, C).astype(np.int32)
    st = rng.integers(0, 2, C).astype(np.int32)
    return [torch.from_numpy(a) for a in (plane, lo, wlen, rid, st, reads2)]


def _pass2_inputs(seed, B, G, R, rlen, W):
    rng = np.random.default_rng(seed)
    gb = rng.integers(0, 4, (B, G)).astype(np.int8)
    glen = rng.integers(rlen + 8, G + 1, B)
    for b in range(B):
        gb[b, glen[b]:] = -1
    rb = np.full((B, R), -2, np.int8)
    for b in range(B):
        s = int(rng.integers(0, glen[b] - rlen))
        r = gb[b, s:s + rlen].copy()
        for _ in range(int(rng.integers(0, 6))):
            q = int(rng.integers(0, rlen))
            r[q] = (r[q] + int(rng.integers(1, 4))) % 4
        rb[b, :rlen] = r
    rev = rng.random(B) < 0.5
    bxmin, bxmax = tsf.compute_band(
        rng.integers(0, G - rlen, B), rng.integers(0, 8, B),
        np.full(B, rlen // 2), rng.integers(W // 4, W // 2, B), glen, R)
    bxmax = np.minimum(bxmax, bxmin + W - 1).astype(np.int32)
    return [torch.from_numpy(a) for a in (gb, rb, rev, bxmin, bxmax)]


def _cs_pass2_inputs(seed, B, G, R, rlen, W=None, per_colour=False,
                     n_rate=0.0, band="anchor"):
    """Colour reads cut from their windows with 15% colour noise (N
    colours at n_rate), global or per-colour crossover costs, and bands
    from compute_band ("anchor", cut to width W), with jumps past the
    shift clip ("jump"), or over the whole window ("full")."""
    rng = np.random.default_rng(seed)
    gb = rng.integers(0, 4, (B, G)).astype(np.int8)
    glen = rng.integers(rlen + 8, G + 1, B)
    for b in range(B):
        gb[b, glen[b]:] = -1
    qr4 = np.full((B, 4, R), -2, np.int8)
    xover = np.full((B, R), CS.crossover, np.int32)
    starts = np.zeros(B, np.int64)
    for b in range(B):
        s = starts[b] = int(rng.integers(0, glen[b] - rlen))
        initbp = int(rng.integers(0, 4))
        letters = np.concatenate(([initbp], gb[b, s:s + rlen]))
        colours = np.where(rng.random(rlen) < 0.15,
                           rng.integers(0, 4, rlen),
                           letters[:-1] ^ letters[1:]).astype(np.int8)
        colours[rng.random(rlen) < n_rate] = 4
        qr4[b, :, :rlen] = cs_read_ls4(colours, initbp)
        if per_colour:
            xover[b, :rlen] = -rng.integers(20, 181, rlen)
    rev = rng.random(B) < 0.5
    if band == "full":
        bxmin = np.zeros((B, R), np.int32)
        bxmax = np.broadcast_to((glen - 1).astype(np.int32)[:, None],
                                (B, R)).copy()
    elif band == "jump":
        bxmin = np.zeros((B, R), np.int32)
        for b in range(B):
            steps = np.where(rng.random(R) < 0.08,
                             rng.integers(20, 3 * G // 2, R),
                             rng.integers(0, 2, R))
            bxmin[b] = np.cumsum(steps) - steps[0]
        bxmax = bxmin + rng.integers(8, 24, (B, 1))
    else:
        ay = rng.integers(0, 10, B)
        bxmin, bxmax = tsf.compute_band(
            starts + ay + rng.integers(-3, 4, B), ay,
            np.full(B, rlen // 2), rng.integers(W // 4, W // 2, B), glen, R)
        bxmax = np.minimum(bxmax, bxmin + W - 1)
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in
            (gb, qr4, xover, rev, bxmin.astype(np.int32),
             bxmax.astype(np.int32))]


@pytest.mark.cuda
@pytest.mark.parametrize("G,R", [(128, 56), (100, 37), (640, 408),
                                 (1408, 1000)])
def test_sw_vector_fused_gather_equals_plain(cuda_device, G, R):
    args = _pass1_inputs(G + R, G, R)
    want = tsv.p1_gather_score_ls_plain(*args, G, LS)
    got = tsv.p1_gather_score_ls(*[a.to(cuda_device) for a in args], G, LS)
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("params", [LS, ASYM], ids=["ls", "asymmetric"])
def test_sw_vector_row0_plane_equals_plain(cuda_device, params):
    rng = np.random.default_rng(9)
    B, G, R = 48, 1408, 1000
    genome = rng.integers(0, 5, (B, G)).astype(np.int8)
    read = np.full((B, R), tsv.READ_PAD, np.int8)
    for b in range(B):
        n = int(rng.integers(500, R + 1))
        s = int(rng.integers(0, G - n))
        read[b, :n] = np.where(genome[b, s:s + n] > 3, 0, genome[b, s:s + n])
    row0 = rng.integers(0, 4, (B, G)).astype(np.int8)
    t = [torch.from_numpy(a) for a in (genome, read, row0)]
    want = tsv.sw_score_batch(t[0], t[1], params, t[2])
    got = tsv.sw_score_batch_cuda(t[0].to(cuda_device),
                                  t[1].to(cuda_device), params,
                                  t[2].to(cuda_device))
    assert torch.equal(got.cpu(), want)


# a positive mismatch: pads past the window can raise a score, so the
# kernel must sweep the full width there
ODD = SWParams(match=3, mismatch=1, a_gap_open=-2, a_gap_extend=-1,
               b_gap_open=-2, b_gap_extend=-1)


def _windows_case(seed, B, G, R, interior_pads=0, row0_pad=False):
    """Windows (GENOME_PAD past a random wlen) laid end to end in one
    plane, reads cut from them (some longer than their window), pads
    inside the reads or at row 0, and a row-0 plane."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 5, (B, G)).astype(np.int8)
    wlen = rng.integers(max(G // 2, 1), G + 1, B).astype(np.int32)
    for b in range(B):
        genome[b, wlen[b]:] = tsv.GENOME_PAD
    read = np.full((B, R), tsv.READ_PAD, np.int8)
    for b in range(B):
        L = int(rng.integers(1, R + 1))
        s = int(rng.integers(0, max(int(wlen[b]) - L, 0) + 1))
        seg = genome[b, s:s + L]
        read[b, :len(seg)] = np.where(seg < 0, 0, seg)
        read[b, len(seg):L] = rng.integers(0, 4, L - len(seg))
        for _ in range(int(rng.integers(0, 4))):
            read[b, int(rng.integers(L))] = rng.integers(0, 4)
        for _ in range(interior_pads):
            read[b, int(rng.integers(L))] = tsv.READ_PAD
    if row0_pad:
        read[::2, 0] = tsv.READ_PAD
    row0 = rng.integers(0, 4, (B, G)).astype(np.int8)
    return genome, read, wlen, row0


@pytest.mark.cuda
@pytest.mark.parametrize("B,G,R,params,pads,row0_pad", [
    (96, 20, 24, LS, 0, False), (64, 1, 8, ASYM, 0, False),
    (48, 640, 1000, LS, 0, False), (96, 96, 40, ASYM, 3, False),
    (96, 64, 32, ASYM, 2, True), (96, 70, 50, ASYM, 0, False),
    (96, 60, 60, ODD, 0, False), (200, 128, 56, LS, 0, False)],
    ids=["g_below_32", "g_1", "r_1000", "interior_pads", "row0_pad",
         "asym", "positive_mismatch", "main_path"])
def test_sw_vector_cases_equal_plain(cuda_device, B, G, R, params, pads,
                                     row0_pad):
    """The one-thread-per-pair kernel through the fused gather (windows
    cut at wlen, so the sweep stops there) and through the given-window
    form with a row-0 plane, against the plain versions."""
    genome, read, wlen, row0 = _windows_case(B + G + R, B, G, R, pads,
                                             row0_pad)
    plane = torch.from_numpy(genome.reshape(-1).copy())
    lo = torch.arange(B, dtype=torch.int64) * G
    args = [plane, lo, torch.from_numpy(wlen),
            torch.arange(B, dtype=torch.int32),
            torch.zeros(B, dtype=torch.int32),
            torch.from_numpy(read).reshape(B, 1, R)]
    want = tsv.p1_gather_score_ls_plain(*args, G, params)
    got = tsv.p1_gather_score_ls_cuda(*[a.to(cuda_device) for a in args], G,
                                      params)
    assert torch.equal(got.cpu(), want)
    t = [torch.from_numpy(a) for a in (genome, read, row0)]
    want = tsv.sw_score_batch(t[0], t[1], params, t[2])
    got = tsv.sw_score_batch_cuda(*[a.to(cuda_device) for a in t[:2]],
                                  params, t[2].to(cuda_device))
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("loc", [True, False], ids=["local", "glocal"])
@pytest.mark.parametrize("B,G,R,rlen,W", [
    (256, 128, 56, 50, 64), (128, 640, 408, 400, 192),
    (64, 128, 56, 50, 128)])
def test_sw_full_equals_plain(cuda_device, loc, B, G, R, rlen, W):
    args = _pass2_inputs(B + G, B, G, R, rlen, W)
    want = tsf.sw_full_and_traceback_packed_plain(*args, LS, loc, W)
    got = tsf.sw_full_and_traceback_packed(
        *[a.to(cuda_device) for a in args], LS, loc, W)
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])


def _full_band(args):
    """The bands of a case replaced by the full band [0, glen - 1]."""
    gb = args[0]
    B, R = args[-1].shape
    glen = (gb >= 0).sum(1).to(torch.int32)
    return (*args[:-2], torch.zeros((B, R), dtype=torch.int32),
            (glen - 1)[:, None].expand(B, R).contiguous())


@pytest.mark.cuda
@pytest.mark.parametrize("B,G,R,rlen,W,params,full", [
    (256, 128, 56, 50, 64, ASYM, False), (256, 128, 56, 50, 64, ODD, False),
    (0, 128, 56, 50, 64, LS, False), (1, 128, 56, 50, 64, LS, False),
    (13, 128, 56, 50, 64, ASYM, False), (77, 128, 56, 50, 32, LS, False),
    (96, 256, 100, 90, 96, ODD, False), (64, 640, 408, 400, 192, ASYM, False),
    (16, 640, 80, 70, 640, LS, True), (24, 1408, 1000, 1000, 64, LS, False),
    (3, 6144, 6000, 6000, 64, LS, False)],
    ids=["asym", "odd", "b0", "b1", "b13", "w32", "w96", "w192",
         "full_g640", "r1000", "r6000"])
@pytest.mark.parametrize("loc", [True, False], ids=["local", "glocal"])
def test_sw_full_cases_equal_plain(cuda_device, loc, B, G, R, rlen, W,
                                   params, full):
    """The tiled kernel at every tile shape it picks from W (32 to 640),
    for batches that fill no whole warp, with its pointer planes in
    shared memory (the 50-row reads), in the global scratch (1,000-row
    reads, the full band at G 640), and with 6,000-row reads, whose
    per-row inputs do not fit a block beside a second tile."""
    args = _pass2_inputs(B + G + W, max(B, 1), G, R, rlen, W)
    args = [a[:B] for a in (_full_band(args) if full else args)]
    want = tsf.sw_full_and_traceback_packed_plain(*args, params, loc, W)
    before = tsf.LAUNCHES.value
    got = tsf.sw_full_and_traceback_packed(
        *[a.to(cuda_device) for a in args], params, loc, W)
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])
    assert tsf.LAUNCHES.value == before + (B > 0)


@pytest.mark.cuda
def test_pass2_launch_plans(cuda_device):
    """The launchers' tiers: the main path's alignments (R 56, W 64)
    staged two to a warp, letter space with its plane budget and a global
    plane allocated for the alignments that overflow it; 6,000-row reads
    one to a warp, their per-row inputs in the scratch; too large a read
    refused before any launch."""
    assert tsf.launch_plan(128, 56, 64) == {
        "lanes": 16, "cols": 2, "staged": 1, "plane_smem": 2048,
        "scratch_per_alignment": 56 * 64}
    assert tsf.launch_plan(640, 408, 192)["lanes"] == 32
    assert tsf.launch_plan(6144, 6000, 64) == {
        "lanes": 32, "cols": 2, "staged": 0, "plane_smem": 0,
        "scratch_per_alignment": 6000 * 16 + 6000 * 64}
    assert tcs.launch_plan(128, 56, 64) == {
        "lanes": 16, "staged": 1, "scratch_per_alignment": 56 * 64 * 8}
    assert tcs.launch_plan(128, 56, 96)["lanes"] == 32
    assert tcs.launch_plan(6144, 6000, 64) == {
        "lanes": 32, "staged": 0,
        "scratch_per_alignment": 6000 * 64 * 8 + 6000 * 20}
    with pytest.raises(ValueError):
        tsf.launch_plan(120_000, 120_000, 64)
    with pytest.raises(ValueError):
        tcs.launch_plan(120_000, 120_000, 64)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    dict(B=256, G=128, R=56, rlen=50, W=64, per_colour=True, taboo=6),
    dict(B=13, G=128, R=56, rlen=50, W=64, n_rate=0.05),
    dict(B=1, G=96, R=64, rlen=50, band="jump", taboo=3),
    dict(B=48, G=256, R=100, rlen=90, W=96),
    dict(B=16, G=640, R=80, rlen=70, band="full"),
    dict(B=8, G=1408, R=1000, rlen=1000, W=64, per_colour=True),
    dict(B=3, G=6144, R=6000, rlen=6000, W=64, per_colour=True, taboo=4),
], ids=["anchor", "b13_n", "b1_jump", "w96", "full_g640", "r1000", "r6000"])
@pytest.mark.parametrize("loc", [True, False], ids=["local", "glocal"])
def test_sw_full_cs_tiers_equal_plain(cuda_device, loc, case):
    """The colour-space kernel with its per-row inputs staged in shared
    memory, two tiles a warp (W <= 64) or one, and with 6,000-row reads,
    whose per-row inputs stay in the global scratch."""
    case = dict(case)
    taboo = case.pop("taboo", 0)
    args = _cs_pass2_inputs(11, **case)
    bw = int((args[5] - args[4]).max()) + 1
    G = case["G"]
    W = -(-G // 32) * 32 if case.get("band") == "full" else -(-bw // 32) * 32
    want = tcs.sw_full_cs_and_traceback_packed_plain(*args, CS, loc, taboo, W)
    got = tcs.sw_full_cs_and_traceback_packed(
        *[a.to(cuda_device) for a in args], CS, loc, taboo, W)
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("G,R", [(128, 56), (640, 408), (20, 24),
                                 (100, 1000)])
def test_sw_vector_cs_gather_equals_plain(cuda_device, G, R):
    """K2-CS: colour and letter windows from fw||rc planes, the row-0
    plane made in the kernel."""
    rng = np.random.default_rng(G * R)
    L, C = 40000, 192
    pad = np.full(1 << 12, tsv.GENOME_PAD, np.int8)
    cs_cat = np.concatenate([rng.integers(0, 5, 2 * L).astype(np.int8), pad])
    ls_cat = np.concatenate([rng.integers(0, 5, 2 * L).astype(np.int8), pad])
    wlen = rng.integers(G // 2, G + 1, C).astype(np.int32)
    lo = rng.integers(0, 2 * L - G, C).astype(np.int64)
    lo[:4] = 2 * L - wlen[:4]
    reads2 = np.full((24, 2, R), tsv.READ_PAD, np.int8)
    for b in range(24):
        n = int(rng.integers(R // 2, R + 1))
        reads2[b, :, :n] = rng.integers(0, 4, (2, n))
    rid = rng.integers(0, 24, C).astype(np.int32)
    ist = np.zeros(C, np.int32)
    initbp = rng.integers(0, 4, C).astype(np.int8)
    args = [torch.from_numpy(a) for a in
            (cs_cat, ls_cat, lo, wlen, rid, ist, initbp, reads2)]
    want = tsv.p1_gather_score_cs_plain(*args, G, CS_VECT)
    before = tsv.CS_LAUNCHES.value
    got = tsv.p1_gather_score_cs(*[a.to(cuda_device) for a in args], G,
                                 CS_VECT)
    assert torch.equal(got.cpu(), want)
    assert tsv.CS_LAUNCHES.value == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("R", [50, 100, 1000])
@pytest.mark.parametrize("with_s0", [False, True], ids=["ls", "cs_s0"])
def test_sw_gapless_equals_plain(cuda_device, R, with_s0):
    rng = np.random.default_rng(R)
    N = 4096
    diag = rng.integers(0, 5, (N, R)).astype(np.int8)
    reads = np.where(rng.random((N, R)) < 0.8, np.minimum(diag, 3),
                     rng.integers(0, 4, (N, R))).astype(np.int8)
    for n in range(N):
        diag[n, int(rng.integers(0, R + 1)):] = tsg.GENOME_PAD
        reads[n, int(rng.integers(0, R + 1)):] = tsg.READ_PAD
    s0 = (torch.from_numpy(rng.choice([0, CS.match, CS.mismatch], N)
                           .astype(np.int32)) if with_s0 else None)
    args = [torch.from_numpy(diag), torch.from_numpy(reads)]
    want = tsg.gapless_score_batch(*args, CS, s0)
    got = tsg.gapless_score_batch(
        *[a.to(cuda_device) for a in args], CS,
        None if s0 is None else s0.to(cuda_device))
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("R,N", [(8, 2000), (37, 2000), (56, 8000),
                                 (1000, 1024), (5000, 256), (512, 40000),
                                 (56, 0), (56, 1)])
@pytest.mark.parametrize("cs", [False, True], ids=["ls", "cs"])
def test_gapless_gather_equals_plain(cuda_device, cs, R, N):
    """The fused gather-and-score kernel against its plain version: both
    strands, d0 < 0, contig ends (the last contig's too), the forced first
    colour on N, mixed read lengths, R not a multiple of 4 or 16, long
    reads, many hits on 512-column reads, and launches of 0 and 1 hit (no
    launch for 0)."""
    args = gapless_cases.gather_case(np.random.default_rng(R * 7 + N), N, R,
                                     cs, B=48, L=60_000)
    plain, kernel = ((tsg.p1_gather_gapless_cs_plain,
                      tsg.p1_gather_gapless_cs) if cs else
                     (tsg.p1_gather_gapless_ls_plain,
                      tsg.p1_gather_gapless_ls))
    params = CS_VECT if cs else LS
    want = plain(*args, params)
    before = tsg.LAUNCHES.value
    got = kernel(*[a.to(cuda_device) for a in args], params)
    assert got.device == cuda_device and got.dtype == torch.int32
    assert torch.equal(got.cpu(), want)
    assert tsg.LAUNCHES.value == before + (1 if N else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cs", [False, True], ids=["ls", "cs"])
def test_gapless_pass1_one_launch_per_call(cuda_device, cs):
    """-U --local through the Mapper on the card: one launch of the fused
    kernel per pass-1 call, the same SAM as on the CPU."""
    idx = gindex.build_index(
        list(fastx.iter_contigs(os.path.join(GOLDEN, "golden_genome.fa"))),
        colour_space=cs)
    params = (CS if cs else LS).with_(a_gap_open=-255, b_gap_open=-255)
    recs = [(r.name, r.seq, r.qual) for r in fastx.iter_reads(os.path.join(
        GOLDEN, "golden_reads_cs.fq" if cs else "mini_reads.fq"))]
    lines = []
    for dev in (cuda_device, "cpu"):
        m = Mapper(idx, MapperConfig(colour_space=cs, params=params,
                                     qual_delta=33 if cs else 64,
                                     gapless=True, anchor_width=0,
                                     global_alignment=False), device=dev)
        calls = []
        orig = m._gapless_scores
        m._gapless_scores = lambda *a, **k: calls.append(1) or orig(*a, **k)
        before = tsg.LAUNCHES.value
        lines.append([rec.line() for e, hits in m.map_batch(recs)
                      for rec in m.sam_records(e, hits)])
        if dev == cuda_device:
            assert calls and tsg.LAUNCHES.value - before == len(calls)
    assert lines[0] == lines[1] and lines[0]


@pytest.mark.cuda
@pytest.mark.parametrize("loc", [True, False], ids=["local", "glocal"])
@pytest.mark.parametrize("case", [
    dict(B=256, G=128, R=56, rlen=50, W=64),
    dict(B=256, G=128, R=56, rlen=50, W=64, per_colour=True, taboo=6),
    dict(B=128, G=128, R=56, rlen=50, W=64, n_rate=0.05),
    dict(B=64, G=640, R=408, rlen=400, W=192, per_colour=True),
    dict(B=64, G=96, R=64, rlen=50, band="jump", taboo=3),
    dict(B=128, G=128, R=56, rlen=50, band="full", taboo=4),
], ids=["anchor", "per_colour_taboo", "n_colours", "long", "jump", "full"])
def test_sw_full_cs_equals_plain(cuda_device, loc, case):
    case = dict(case)
    taboo = case.pop("taboo", 0)
    args = _cs_pass2_inputs(7, **case)
    bw = int((args[5] - args[4]).max()) + 1
    W = (-(-case["G"] // 32) * 32 if case.get("band") == "full"
         else -(-bw // 32) * 32)
    want = tcs.sw_full_cs_and_traceback_packed_plain(*args, CS, loc, taboo, W)
    got = tcs.sw_full_cs_and_traceback_packed(
        *[a.to(cuda_device) for a in args], CS, loc, taboo, W)
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("genome,reads,gold", [
    ("golden_genome.fa", "golden_reads_cs.fq", "golden_cs.sam"),
    ("med_genome.fa", "med_reads_cs.fq", "med_cs.sam"),
])
def test_cs_goldens_through_the_kernels(cuda_device, genome, reads, gold):
    idx = gindex.build_index(
        list(fastx.iter_contigs(os.path.join(GOLDEN, genome))),
        colour_space=True)
    m = Mapper(idx, MapperConfig(colour_space=True, params=CS,
                                 qual_delta=33), device=cuda_device)
    recs = [(r.name, r.seq, r.qual)
            for r in fastx.iter_reads(os.path.join(GOLDEN, reads))]
    before = (tsv.CS_LAUNCHES.value, tcs.LAUNCHES.value)
    lines = [rec.line() for e, hits in m.map_batch(recs)
             for rec in m.sam_records(e, hits)]
    with open(os.path.join(GOLDEN, gold)) as fh:
        assert lines == [ln.rstrip("\n") for ln in fh
                         if not ln.startswith("@")]
    assert tsv.CS_LAUNCHES.value > before[0]
    assert tcs.LAUNCHES.value > before[1]


@pytest.mark.cuda
@pytest.mark.parametrize("flags,reads,gold", [
    (["--mode", "cs", "-M", "mirna"], "golden_reads_cs.fq",
     "golden_cs_mirna.sam"),
    (["--mode", "cs", "-U", "--local"], "golden_reads_cs.fq",
     "golden_cs_ungapped.sam"),
    (["-U", "--local"], "mini_reads.fq", "golden_ungapped.sam"),
    (["-M", "mirna"], "golden_reads.fq", "golden_mirna.sam"),
], ids=["cs_mirna", "cs_ungapped", "ungapped", "mirna"])
def test_gapless_goldens_through_the_kernels(cuda_device, capsys, flags,
                                             reads, gold):
    """The CLI maps on the card when there is one; gapless pass 1 runs
    the sw_gapless kernel."""
    before = tsg.LAUNCHES.value
    rc = gmapper.main(["gmapper", "-Q", *flags,
                       os.path.join(GOLDEN, reads),
                       os.path.join(GOLDEN, "golden_genome.fa")])
    out = capsys.readouterr().out
    assert rc == 0
    with open(os.path.join(GOLDEN, gold)) as fh:
        assert [ln for ln in out.splitlines() if ln and ln[0] != "@"] == \
            [ln.rstrip("\n") for ln in fh if not ln.startswith("@")]
    assert tsg.LAUNCHES.value > before


@pytest.mark.cuda
@pytest.mark.parametrize("genome,reads,gold", [
    ("golden_genome.fa", "golden_reads.fq", "golden_unpaired.sam"),
    ("golden_genome.fa", "long_reads.fq", "golden_long_reads.sam"),
    ("med_genome.fa", "med_reads.fq", "med_ls.sam"),
])
def test_goldens_through_the_kernels(cuda_device, genome, reads, gold):
    idx = gindex.build_index(
        list(fastx.iter_contigs(os.path.join(GOLDEN, genome))))
    m = Mapper(idx, MapperConfig(qual_delta=64), device=cuda_device)
    recs = [(r.name, r.seq, r.qual)
            for r in fastx.iter_reads(os.path.join(GOLDEN, reads))]
    before = (tsv.LAUNCHES.value, tsf.LAUNCHES.value)
    lines = [rec.line() for e, hits in m.map_batch(recs)
             for rec in m.sam_records(e, hits)]
    with open(os.path.join(GOLDEN, gold)) as fh:
        assert lines == [ln.rstrip("\n") for ln in fh
                         if not ln.startswith("@")]
    assert tsv.LAUNCHES.value > before[0] and tsf.LAUNCHES.value > before[1]


def _l3_inputs(seed, use_hashing=False, contig_len=60_000, n_reads=256,
               st=0, threshold=55.0, repeat=0, read_len=50):
    """A random three-contig index and device_candidates' read arrays for
    one strand of `read_len`-base reads drawn from it (up to two
    substitutions each).  With `repeat`, that many more copies of one 2 kb
    stretch, and every fourth read drawn from it: reads with thousands of
    postings."""
    rng = np.random.default_rng(seed)
    contigs = [rng.integers(0, 4, contig_len).astype(np.int8)
               for _ in range(3)]
    if repeat:
        unit = contigs[0][:2000].copy()
        for k in range(repeat):
            p = int(rng.integers(2000, contig_len - 2000))
            contigs[k % 3][p:p + 2000] = unit
    idx = gindex.build_index(
        [fastx.Contig(name=f"c{i}", codes=c) for i, c in enumerate(contigs)],
        seedmod.make_seed_set(None, use_hashing=use_hashing))
    reads = []
    for i in range(n_reads):
        p = (int(rng.integers(0, 2000 - read_len)) if repeat and i % 4 == 0
             else int(rng.integers(0, len(idx.genome) - read_len)))
        r = idx.genome[p:p + read_len].copy()
        for _ in range(int(rng.integers(0, 3))):
            q = int(rng.integers(0, read_len))
            r[q] = (r[q] + int(rng.integers(1, 4))) % 4
        if rng.random() < 0.5:
            r = dna.reverse_complement(r)
        reads.append((f"r{i}", dna.decode(r), None))
    cfg = MapperConfig(qual_delta=64)
    entries = cand.prepare_reads(reads, cfg, idx.seed_set.min_span)
    B = len(entries)
    codes = np.zeros((B, max(64, -(-read_len // 16) * 16)), np.int8)
    rlen, minpos, wlen, thr = (np.zeros(B, np.int32) for _ in range(4))
    for b, e in enumerate(entries):
        codes[b, :e.read_len] = e.read[st]
        rlen[b], minpos[b], wlen[b] = e.read_len, e.min_kmer_pos, e.window_len
        if threshold >= 0:
            thr[b] = int(min(e.read_len, e.window_len) * cfg.params.match
                         * (threshold / 100.0))
    return idx, (codes, rlen, minpos, wlen, thr)


def _l3_kw(idx, **kw):
    return {"a_cap": 1 << 21, "a2_cap": 1 << 17, "h_cap": 1 << 18,
            "n_regions": (idx.total_len >> cb.REGION_BITS) + 1,
            "num_contigs": idx.num_contigs, **kw}


# id -> (_l3_inputs kwargs, device_candidates keywords)
L3_CASES = {
    "dense_regions": ({"seed": 3}, {"use_region_counts": True}),
    "dense_regions_rc": ({"seed": 3, "st": 1}, {"use_region_counts": True}),
    "sparse_regions": ({"seed": 23}, {"use_region_counts": True,
                                      "dense_region_cap": 0}),
    "collapse_off": ({"seed": 29}, {"use_region_counts": True,
                                    "collapse": False}),
    "hashed": ({"seed": 5, "use_hashing": True}, {}),
    "gapless": ({"seed": 11}, {"match_mode": 1, "gapless": True}),
    "match_mode_1": ({"seed": 9}, {"match_mode": 1}),
    "list_cutoff": ({"seed": 17, "contig_len": 8_000}, {"list_cutoff": 2}),
    "absolute_threshold": ({"seed": 37, "threshold": -300.0},
                           {"threshold": -300.0}),
    "overflow": ({"seed": 13}, {"a_cap": 256}),
    "a2_cut": ({"seed": 7}, {"use_region_counts": True, "a2_cap": 300}),
    "h_cut": ({"seed": 19}, {"h_cap": 40}),
    # reads past both shared-memory tiers: the global-memory tier
    "repeats": ({"seed": 41, "repeat": 100, "contig_len": 200_000,
                 "n_reads": 64}, {"use_region_counts": True}),
    # 950-base reads: with the rows' offsets (34 KB) the shared memory of
    # the per-read kernels passes 48 KB
    "long_reads": ({"seed": 43, "read_len": 950, "n_reads": 32},
                   {"use_region_counts": True}),
}
# the cases cut at a capacity, which report an overflow
L3_CUT = {"overflow", "a2_cut", "h_cut"}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(L3_CASES))
def test_candidates_device_equals_plain(cuda_device, case):
    """K10 on the card against its plain version: every output exact."""
    inp_kw, kw = L3_CASES[case]
    idx, args = _l3_inputs(**inp_kw)
    kw = _l3_kw(idx, **kw)
    before = tcd.LAUNCHES.value
    tiers = tcd.GLOBAL_TIER_READS.value
    got = tcd.device_candidates(
        *args, tcd.DeviceL3Index.from_host(idx, cuda_device), **kw)
    torch.cuda.synchronize()
    assert tcd.LAUNCHES.value == before + 1
    want = tcd.device_candidates(
        *args, tcd.DeviceL3Index.from_host(idx, "cpu"), **kw)
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k].cpu(), v), k
    assert bool(got["overflow"]) == (case in L3_CUT)
    assert int(got["n"]) > 0
    assert (tcd.GLOBAL_TIER_READS.value > tiers) == (case == "repeats")


@pytest.mark.cuda
def test_candidates_device_empty_batch(cuda_device):
    idx, args = _l3_inputs(3, n_reads=8)
    args = tuple(a[:0] for a in args)
    kw = _l3_kw(idx, use_region_counts=True)
    got = tcd.device_candidates(
        *args, tcd.DeviceL3Index.from_host(idx, cuda_device), **kw)
    want = tcd.device_candidates(
        *args, tcd.DeviceL3Index.from_host(idx, "cpu"), **kw)
    for k, v in want.items():
        assert torch.equal(got[k].cpu(), v), k
    assert int(got["n"]) == 0 and not bool(got["overflow"])


@pytest.mark.cuda
def test_candidates_device_workspace_reused_after_growth(cuda_device):
    """A workspace serves a call with small capacities, grows for larger
    ones, and is then reused without allocating; every call equals the
    plain version."""
    idx, args = _l3_inputs(13)
    dev = tcd.DeviceL3Index.from_host(idx, cuda_device)
    dev_cpu = tcd.DeviceL3Index.from_host(idx, "cpu")
    ws = tcd.L3Workspace()
    allocs = []
    for a_cap in (256, 1 << 21, 1 << 21, 256):
        kw = _l3_kw(idx, a_cap=a_cap, use_region_counts=True)
        got = tcd.device_candidates(*args, dev, workspace=ws, **kw)
        want = tcd.device_candidates(*args, dev_cpu, **kw)
        for k, v in want.items():
            assert torch.equal(got[k].cpu(), v), (a_cap, k)
        allocs.append(ws.allocations)
    assert allocs[1] > allocs[0]
    assert allocs[3] == allocs[2] == allocs[1]


@pytest.mark.cuda
def test_candidates_device_one_sync_per_call(cuda_device):
    """With a warm workspace, a call synchronises with the host once (the
    counters read-back); copying the windows out is the second."""
    import warnings
    idx, args = _l3_inputs(3)
    dev = tcd.DeviceL3Index.from_host(idx, cuda_device)
    ws = tcd.L3Workspace()
    kw = _l3_kw(idx, use_region_counts=True)
    tcd.device_candidates(*args, dev, workspace=ws, **kw)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            out = tcd.device_candidates(*args, dev, workspace=ws, **kw)
            n = int(out["n"])
            after_call = sum("synchroniz" in str(w.message) for w in rec)
            torch.stack([out[f][:n] for f in tcd.COLUMNS]).cpu()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    syncs = [w for w in rec if "synchroniz" in str(w.message)]
    assert after_call == 1 and len(syncs) == 2, [str(w.message) for w in rec]


def test_candidates_device_kernels_refuse_a_cpu_index():
    """The K10 wrapper launches on a CUDA index or raises; it never runs
    the plain version."""
    idx, args = _l3_inputs(3, n_reads=8)
    tensors = [torch.from_numpy(a) for a in args]
    with pytest.raises(ValueError, match="CUDA index"):
        tcd.device_candidates_cuda(
            *tensors, tcd.DeviceL3Index.from_host(idx, "cpu"), a_cap=1 << 12,
            a2_cap=1 << 12, h_cap=1 << 12, num_contigs=idx.num_contigs)


@pytest.mark.cuda
@pytest.mark.parametrize("genome,reads,gold,colour", [
    ("golden_genome.fa", "golden_reads.fq", "golden_unpaired.sam", False),
    ("med_genome.fa", "med_reads.fq", "med_ls.sam", False),
    ("golden_genome.fa", "golden_reads_cs.fq", "golden_cs.sam", True),
])
def test_goldens_through_device_candidates(cuda_device, genome, reads, gold,
                                           colour):
    idx = gindex.build_index(
        list(fastx.iter_contigs(os.path.join(GOLDEN, genome))),
        colour_space=colour)
    m = Mapper(idx, MapperConfig(params=CS if colour else LS,
                                 colour_space=colour,
                                 qual_delta=33 if colour else 64,
                                 device_candidates=True), device=cuda_device)
    recs = [(r.name, r.seq, r.qual)
            for r in fastx.iter_reads(os.path.join(GOLDEN, reads))]
    before = tcd.LAUNCHES.value
    lines = [rec.line() for e, hits in m.map_batch(recs)
             for rec in m.sam_records(e, hits)]
    with open(os.path.join(GOLDEN, gold)) as fh:
        assert lines == [ln.rstrip("\n") for ln in fh
                         if not ln.startswith("@")]
    assert tcd.LAUNCHES.value > before
    assert m.stats["device_l3_fallbacks"] == 0


# ---------------------------------------------------------------------------
# the paired path's launches: rows at input strand 1, both mates in one
# pass-2 launch with R from the longer one, bands as wide as the window
@pytest.mark.cuda
@pytest.mark.parametrize("G,R", [(128, 56), (128, 88)])
def test_sw_vector_cs_gather_at_input_strand_1_equals_plain(cuda_device, G,
                                                            R):
    """K2-CS on rows at input strand 1 (a reversed mate's: the read row
    is reads2[rid, 1]), mixed with rows at input strand 0."""
    rng = np.random.default_rng(G + R)
    L, C = 40000, 256
    pad = np.full(1 << 12, tsv.GENOME_PAD, np.int8)
    cs_cat = np.concatenate([rng.integers(0, 5, 2 * L).astype(np.int8), pad])
    ls_cat = np.concatenate([rng.integers(0, 5, 2 * L).astype(np.int8), pad])
    wlen = rng.integers(G // 2, G + 1, C).astype(np.int32)
    lo = rng.integers(0, 2 * L - G, C).astype(np.int64)
    reads2 = np.full((32, 2, R), tsv.READ_PAD, np.int8)
    for b in range(32):
        n = int(rng.integers(R // 2, R + 1))
        reads2[b, :, :n] = rng.integers(0, 4, (2, n))
    rid = rng.integers(0, 32, C).astype(np.int32)
    ist = (rid % 2).astype(np.int32)
    initbp = rng.integers(0, 4, C).astype(np.int8)
    args = [torch.from_numpy(a) for a in
            (cs_cat, ls_cat, lo, wlen, rid, ist, initbp, reads2)]
    want = tsv.p1_gather_score_cs_plain(*args, G, CS_VECT)
    got = tsv.p1_gather_score_cs(*[a.to(cuda_device) for a in args], G,
                                 CS_VECT)
    assert torch.equal(got.cpu(), want)
    at_0 = tsv.p1_gather_score_cs_plain(
        *args[:5], torch.zeros_like(args[5]), *args[6:], G, CS_VECT)
    assert not torch.equal(want, at_0)      # the strand-1 rows differ


def _mates_batch(seed, cs: bool, G=128, R=88):
    """Both mates' feet of one paired pass-2 launch: 50-base and 80-base
    mates at R 88 (the longer mate's), a random half with the full band
    [0, glen - 1], so W = G = 128."""
    if cs:
        a = _cs_pass2_inputs(seed, 48, G, R, 50, W=64)
        b = _cs_pass2_inputs(seed + 1, 48, G, R, 80, W=64)
    else:
        a = _pass2_inputs(seed, 48, G, R, 50, 64)
        b = _pass2_inputs(seed + 1, 48, G, R, 80, 64)
    args = [torch.cat([x, y]) for x, y in zip(a, b)]
    full = list(_full_band(args))
    wide = torch.from_numpy(np.random.default_rng(seed).random(96) < 0.5)
    for k in (-2, -1):
        args[k] = torch.where(wide[:, None], full[k], args[k]).contiguous()
    return args


@pytest.mark.cuda
@pytest.mark.parametrize("loc", [True, False], ids=["local", "glocal"])
def test_sw_full_mates_at_full_band_equal_plain(cuda_device, loc):
    """K3+K4 on a paired launch: two mate lengths, half the rows at full
    band (where the JAX package runs its unbanded K5), W = G."""
    args = _mates_batch(31, cs=False)
    want = tsf.sw_full_and_traceback_packed_plain(*args, LS, loc, 128)
    got = tsf.sw_full_and_traceback_packed(
        *[a.to(cuda_device) for a in args], LS, loc, 128)
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("loc", [True, False], ids=["local", "glocal"])
def test_sw_full_cs_mates_at_full_band_equal_plain(cuda_device, loc):
    """K7+K8 on a paired launch: two mate lengths, half the rows at full
    band (where the JAX package runs its unbanded K9), W = G."""
    args = _mates_batch(37, cs=True)
    want = tcs.sw_full_cs_and_traceback_packed_plain(*args, CS, loc, 0, 128)
    got = tcs.sw_full_cs_and_traceback_packed(
        *[a.to(cuda_device) for a in args], CS, loc, 0, 128)
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["golden_paired", "golden_cs_col-fw",
                                  "golden_legacy_paired"])
def test_paired_goldens_through_the_kernels(cuda_device, case, tmp_path):
    """The paired CLI on the card: pass 1 and pass 2 of both mates through
    the kernels, byte-equal to the reference."""
    spec = {**golden_cli.PAIRED_LS, **golden_cli.PAIRED_CS,
            **golden_cli.LEGACY}[case]
    cs = "--mode" in spec[1] and "cs" in spec[1]
    p1, p2 = ((tsv.CS_LAUNCHES, tcs.LAUNCHES) if cs
              else (tsv.LAUNCHES, tsf.LAUNCHES))
    before = (p1.value, p2.value)
    rc, out, err = golden_cli.run_case(spec, str(tmp_path))
    assert rc == 0, err[-2000:]
    assert "PyTorch port on cuda" in err
    assert golden_cli.compared(out, spec[4]) == golden_cli.expected(spec[4])
    assert p1.value > before[0] and p2.value > before[1]


def test_build_failure_raises(tmp_path, monkeypatch):
    """A compiler error is raised with its output; nothing falls back."""
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: no such target' >&2\nexit 3\n")
    fake.chmod(fake.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "_libs", {})
    with pytest.raises(RuntimeError, match="no such target"):
        _build.load("sw_full")
    assert not os.listdir(tmp_path / "build")


def test_launch_counter():
    c = _build.LaunchCounter()
    for _ in range(3):
        c.add()
    assert c.value == 3
    c.reset()
    assert c.value == 0
