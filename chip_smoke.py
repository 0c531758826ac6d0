#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (`shrimp_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Phases, each a function; any failure raises and the script exits
nonzero.  There is no CPU path: without a CUDA device it stops at once.

  1. device   the card's name and power limit (nvidia-smi)
  2. build    nvcc builds the five kernel sources of csrc/ (sm_90a), one
              nvcc process per source, all started together
  3. kernels  each kernel against its plain PyTorch version on random
              inputs (pads, asymmetric gaps, row-0 plane, local/glocal;
              for pass 1 also G below 32 and G = 1, 1,000-row reads, pad
              rows inside a read and at row 0, a positive mismatch;
              revcmpl, the goldens' band shapes, a wide-jump band; for
              pass 2 also asymmetric and positive-mismatch scoring,
              batches of 0, 1 and 13, W 32 / 96 / 192 / 640 (every tile
              width), 1,000-row reads (the global pointer tier), 6,000-row
              reads (per-row inputs in the global scratch); in colour
              space also per-row crossovers, indel taboo, N codes, a band
              jumping past the shift clip, the full band; gapless
              pre-gathered with and without the s0 override, and the fused
              gapless gather in both spaces: both strands, diagonals
              starting late in the read, ending at or before their contig's
              end or at the plane's last bytes, the forced first colour on
              N letters and N colours, reads of mixed length, R of 8, 37,
              56, 512, 1,000 and 5,000, launches of 0 and 1 hit); integer
              outputs must be exactly equal
  4. goldens  golden_unpaired / golden_long_reads / med_ls, then
              golden_cs / med_cs, mapped through the kernels, and the
              gapless golden_cs_mirna / golden_cs_ungapped /
              golden_ungapped / golden_mirna through the gmapper CLI on
              the card, byte-equal to the reference SAM
  5. kernels-l3  the on-device candidate generation (K10) against its
              plain version on random small indexes: dense and sparse
              region counts, collapse on and off, -H hashing, gapless,
              match mode 1, a list cut-off, an absolute threshold, cuts
              at a_cap, a2_cap and h_cap, reads too large for shared
              memory (the global-memory tier), and 950-base reads; every
              output exactly equal
  6. goldens-l3  golden_unpaired, med_ls and golden_cs mapped with
              device_candidates=True, byte-equal to the reference SAM
  7. goldens-paired  through the gmapper CLI on the card
              (utils/golden_cli.py): every paired golden of both spaces
              (the four pair modes, the reference's pairing fixture,
              match modes, --sam-r2, --all-contigs, --paired-options
              rounds, the medium, draft-genome, messy and seed-quality
              corpora), the three legacy SHRiMP-format goldens, the
              unpaired goldens of the JAX suites that phases 4 and 6 do
              not map, and golden_cs_bfast / golden_messy_cs /
              golden_sqf_cs; byte-equal minus @PG (the unpaired and
              two legacy ones in two worker processes meanwhile); the
              paired runs' launches, and each kernel against its plain
              version at their largest paired launch; then golden_paired
              and golden_cs_opp-in with no band (-a -1: pass 2 at the
              full band, W = G), SAM equal to the plain versions' and the
              kernels held to them at those launches
  8. size     the main path at a real size: the port's generator
              (utils/synth.py, the JAX bench's) at 100 Mbp (C. elegans
              class), 16,384 mutated 50 bp reads through Mapper.map_stream
              in batches of 2,048, the genome plane resident on the card,
              candidates on the host (device_candidates=False); launch
              counts of that run; then the first 2,048 reads again through
              the plain versions (CPU tensors), SAM lines identical; a warm
              run of 8,192 reads under torch.profiler (device busy and
              idle share); then each kernel timed against its plain
              version on the inputs of the main path's largest launch
  9. size-l3  the same index and reads with device_candidates=True: the
              CSR postings resident on the card, K10 for every batch; SAM
              lines and windows/read equal to the size run's; stage split,
              ship, peak memory, capacity growth, fallbacks, K10's host
              syncs per strand call (at most 2) and its largest plane;
              the same profiled warm run; what "auto"
              chooses on the first two batches; K10 timed against its
              plain version on the largest call
 10. size-gapless  the same index and reads as `gmapper -U --local`
              maps them (gapless pass 1, anchor width 0, local), device
              candidates on the postings size-l3 made resident; the pass-1
              stage split into dispatch, wait and finish, launches, peak
              memory, quality, the SAM digest; the first 2,048 reads again
              through the plain versions; the gapless kernel timed against
              its plain version on the largest call
 11. size-paired  paired mapping on the same index: 4,096 opp-in pairs
              of the grid bench's generator (synth.make_pairs, seed 17,
              50 bp mates, insert 150-450), PairedConfig(opp-in, 50, 600),
              host candidates, PairedMapper.map_pair_stream in batches of
              1,024 pairs after one warm batch, twice (SAM digests equal);
              reads/s, stage seconds (summed over the stream's two worker
              threads), pairs matched and top-pair recall (the grid
              bench's), launches, peak memory, a profiled warm run of
              2,048 pairs; K1 and K3+K4 timed against their plain versions
              at the largest paired launch
 12. size-cs  the colour-space path on the same contigs: a colour-space
              index, 8,192 SOLiD reads (synth.make_cs_reads, seed 23,
              50 bp) in batches of 2,048, the fw||rc colour and letter
              planes resident on the card, host candidates; launch counts;
              the first 1,024 reads again through the plain versions;
              each colour-space kernel timed against its plain version
 13. size-cs-gapless  that index and those reads with -U --local, host
              candidates: what size-gapless reports, the first 1,024
              reads through the plain versions, the gapless kernel timed
              on the largest call

Each timing line gives a kernel's `ms` (CUDA events around 20 calls of
its wrapper: where a kernel's device time is below its wrapper's host
time, this is the host's rate); for K3+K4, K6 and K7+K8 also `device_ms`
(each call queued behind a spin kernel, so the events see only the
device's work), for K10 `device_span_ms` (torch.profiler: first kernel
start to last kernel end of one call).

Each kernel's entry in the kernels line carries `bound_ms`, the least
time an H100 SXM could take for the same work on the same inputs: the
larger of the bytes the function must move over 3.35 TB/s and its int32
operations (counted per DP cell from the recurrence, or per row and
posting for K10) over the int32 instruction rate of 132 SMs x 64 lanes x
1.98 GHz.  No single PyTorch call computes any of these functions, so
`library_ms` is null.

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(REPO, "tests", "golden")
SIZE_GENOME_BP = 100_000_000
SIZE_READS = 16_384
SIZE_BATCH = 2_048
SIZE_CS_READS = 8_192
SIZE_CS_PLAIN = 1_024
# reads of the warm run under torch.profiler in the size phases
SIZE_PROFILE_READS = 8_192
# the size-paired phase: opp-in pairs of the grid bench (seed 17), in
# batches of 1,024 pairs; pairs of its profiled warm run
SIZE_PAIRS = 4_096
SIZE_PAIR_BATCH = 1_024
SIZE_PROFILE_PAIRS = 2_048

KERNELS = {
    "sw_vector": {"source": "shrimp_tpu_torch/csrc/sw_vector.cu",
                  "replaces": "shrimp_tpu/ops/sw_vector_pallas.py:100"},
    "sw_vector_cs": {"source": "shrimp_tpu_torch/csrc/sw_vector.cu",
                     "replaces": "shrimp_tpu/pipeline/mapper.py:74"},
    "sw_full": {"source": "shrimp_tpu_torch/csrc/sw_full.cu",
                "replaces": "shrimp_tpu/ops/sw_full.py:297"},
    "sw_full_cs": {"source": "shrimp_tpu_torch/csrc/sw_full_cs.cu",
                   "replaces": "shrimp_tpu/ops/sw_full_cs.py:383"},
    "sw_gapless": {"source": "shrimp_tpu_torch/csrc/sw_gapless.cu",
                   "replaces": "shrimp_tpu/ops/sw_gapless.py:37"},
    "candidates_device": {
        "source": "shrimp_tpu_torch/csrc/candidates_device.cu",
        "replaces": "shrimp_tpu/ops/candidates_device.py:200"},
}

# H100 SXM peaks for bound_ms (NVIDIA's data sheet): HBM3 bytes/s, and
# int32 throughput, 132 SMs x 64 INT32 lanes x 1.98 GHz boost clock
PEAK_BYTES_PER_S = 3.35e12
PEAK_INT32_OPS_PER_S = 132 * 64 * 1.98e9
# int32 operations per DP cell, counted from each recurrence (the least
# the function needs; the kernels execute more): pass 1 scores one cell in
# about 12 (score pick, B gap, clamp, tilted running max, A gap, best);
# the 3-state pass 2 picks 3 predecessors per state with pointers (24);
# the colour-space pass 2 picks 6 per state in 12 states (144); the
# gapless score is a masked prefix sum and running minimum (8)
OPS_PER_CELL = {"sw_vector": 12, "sw_vector_cs": 12, "sw_full": 24,
                "sw_full_cs": 144, "sw_gapless": 8}
GENOME_PAD, READ_PAD = -1, -2


def launch_counters() -> dict:
    """Each kernel's launch counter, by the names of KERNELS."""
    from shrimp_tpu_torch.ops import (candidates_device, sw_full, sw_full_cs,
                                      sw_gapless, sw_vector)
    return {"sw_vector": sw_vector.LAUNCHES,
            "sw_vector_cs": sw_vector.CS_LAUNCHES,
            "sw_full": sw_full.LAUNCHES, "sw_full_cs": sw_full_cs.LAUNCHES,
            "sw_gapless": sw_gapless.LAUNCHES,
            "candidates_device": candidates_device.LAUNCHES}


def reset_launches() -> None:
    for c in launch_counters().values():
        c.reset()


def read_launches(names) -> dict:
    """The counts of `names`; raises if any of them is 0."""
    counters = launch_counters()
    out = {n: counters[n].value for n in names}
    if min(out.values()) <= 0:
        raise AssertionError(f"a kernel of the path was not launched: {out}")
    return out


def log(msg: str) -> None:
    print(msg, flush=True)


class Recorder:
    """Replaces a kernel wrapper of an ops module by one that keeps the
    arguments of its largest call (by rows; the first such call, or with
    `last` the last), then calls it unchanged."""

    def __init__(self, module, name: str, rows, last: bool = False):
        self.module, self.name, self.rows = module, name, rows
        self.last = last
        self.args = None
        self.kw = {}
        self.best = -1

    def __enter__(self):
        orig = self.orig = getattr(self.module, self.name)

        def wrapper(*args, **kw):
            n = self.rows(args)
            if n > self.best or (self.last and n == self.best):
                self.best, self.args, self.kw = n, args, kw
            return orig(*args, **kw)

        setattr(self.module, self.name, wrapper)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def cuda_ms(fn, reps: int = 20) -> float:
    """Mean milliseconds of one call, from CUDA events around `reps`
    calls after one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int = 20) -> float:
    """Mean milliseconds of one call's device work: each call is queued
    behind a spin kernel of about a millisecond, long enough to hide the
    wrapper's host time, between two CUDA events.  Only for wrappers that
    never wait on the device."""
    import torch
    fn()
    torch.cuda.synchronize()
    marks = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for start, end in marks:
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in marks) / reps


def host_ms(fn) -> tuple[float, object]:
    t0 = time.perf_counter()
    out = fn()
    return (time.perf_counter() - t0) * 1e3, out


def bound(nbytes: float, ops: float) -> dict:
    """bound_ms: the larger of the bytes over the HBM rate and the int32
    operations over the int32 instruction rate, and which of the two it is."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_INT32_OPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": int(nbytes), "int32_ops": int(ops)}


def _nbytes(*tensors) -> int:
    return sum(int(t.numel() * t.element_size()) for t in tensors
               if t is not None)


def _gather_bound(name, windows, wlen, rid, st, reads2, G, planes,
                  outs) -> dict:
    """Pass-1 gathers: each window's bytes from `planes` planes, the
    per-window columns and the reads in, one score out; cells are the
    window length times the read length."""
    import torch
    w = wlen.cpu().to(torch.int64).clamp_max(G)
    rl = (reads2.cpu() != READ_PAD).sum(-1)[rid.cpu().long(), st.cpu().long()]
    return bound(planes * int(w.sum()) + _nbytes(reads2, *windows)
                 + _nbytes(*outs),
                 OPS_PER_CELL[name] * int((w * rl).sum()))


def _band_bound(name, read_rows, bxmin, bxmax, ins, outs) -> dict:
    """Pass 2: the band cells of each alignment's read rows."""
    import torch
    width = (bxmax.cpu().long() - bxmin.cpu().long() + 1).clamp_min(0)
    rows = torch.arange(width.shape[1])[None, :] < read_rows.cpu()[:, None]
    return bound(_nbytes(*ins) + _nbytes(*outs),
                 OPS_PER_CELL[name] * int((width * rows).sum()))


def profile_map(mapper, reads: list, batch: int) -> dict:
    """One warm map_stream of `reads` (a PairedMapper: map_pair_stream of
    read pairs) under torch.profiler (CPU and CUDA activities): wall
    seconds, device busy time (every kernel and copy on the card), the
    idle share, and the device time by kernel name."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    stream = getattr(mapper, "map_pair_stream", mapper.map_stream)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        for _ in stream(iter(reads), batch):
            pass
        torch.cuda.synchronize()
        wall = time.time() - t0
    by_name = {}
    for evt in prof.key_averages():
        # the kernels and copies themselves: a CPU op's device time is
        # that of the kernels it launched, which appear here too
        if evt.device_type == DeviceType.CUDA and evt.self_device_time_total:
            by_name[evt.key] = (evt.self_device_time_total / 1e3, evt.count)
    busy_ms = sum(ms for ms, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    return {"reads": len(reads), "wall_secs": round(wall, 3),
            "device_busy_ms": round(busy_ms, 3),
            "device_idle_share": (None if busy_ms == 0
                                  else 1.0 - busy_ms / (wall * 1e3)),
            "top_device_ms": {k[:60]: [round(ms, 3), n]
                              for k, (ms, n) in top}}


def max_abs_err(a, b) -> int:
    import torch
    a = a.cpu().to(torch.int64)
    b = b.cpu().to(torch.int64)
    if a.shape != b.shape:
        raise AssertionError(f"shapes differ: {tuple(a.shape)} vs "
                             f"{tuple(b.shape)}")
    return int((a - b).abs().max()) if a.numel() else 0


# ---------------------------------------------------------------------------
def phase_device() -> dict:
    import torch
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    log(f"device: {name}")
    log(smi)
    return {"name": name, "smi": smi, "count": torch.cuda.device_count()}


def phase_build() -> None:
    from shrimp_tpu_torch import _build
    from shrimp_tpu_torch.ops import (candidates_device, sw_full, sw_full_cs,
                                      sw_gapless, sw_vector)
    t0 = time.time()
    mods = (sw_vector, sw_full, sw_full_cs, sw_gapless, candidates_device)
    _build.load_all(m.__name__.rsplit(".", 1)[1] for m in mods)
    for m in mods:
        m._lib()
    log(f"build: {time.time() - t0:.2f} s "
        + json.dumps({k: round(v, 2) for k, v in _build.BUILD_SECS.items()}))
    for name, text in _build.BUILD_LOG.items():
        for ln in text.splitlines():
            if "registers" in ln or "spill" in ln or "smem" in ln:
                log(f"  ptxas[{name}]: {ln.strip()}")


def _pass1_case(rng, B: int, G: int, R: int):
    genome = rng.integers(0, 5, size=(B, G)).astype(np.int8)
    read = np.full((B, R), -2, np.int8)
    for b in range(B):
        glen = int(rng.integers(G // 2, G + 1))
        genome[b, glen:] = -1
        L = int(rng.integers(min(16, R), R + 1))
        s = int(rng.integers(0, max(glen - L, 0) + 1))
        seg = genome[b, s:s + L]
        read[b, :len(seg)] = np.where(seg < 0, 0, seg)
        for _ in range(int(rng.integers(0, 6))):
            read[b, int(rng.integers(len(seg) or 1))] = rng.integers(0, 4)
    row0 = rng.integers(0, 4, size=(B, G)).astype(np.int8)
    return genome, read, row0


def _windows_case(rng, B: int, G: int, R: int, pads: int = 0,
                  row0_pad: bool = False):
    """Windows with GENOME_PAD past a random wlen, reads cut from them
    (some longer than their window), `pads` pad rows inside each read,
    row 0 a pad in every other read, and a row-0 plane."""
    genome = rng.integers(0, 5, (B, G)).astype(np.int8)
    wlen = rng.integers(max(G // 2, 1), G + 1, B).astype(np.int32)
    for b in range(B):
        genome[b, wlen[b]:] = GENOME_PAD
    read = np.full((B, R), READ_PAD, np.int8)
    for b in range(B):
        L = int(rng.integers(1, R + 1))
        s = int(rng.integers(0, max(int(wlen[b]) - L, 0) + 1))
        seg = genome[b, s:s + L]
        read[b, :len(seg)] = np.where(seg < 0, 0, seg)
        read[b, len(seg):L] = rng.integers(0, 4, L - len(seg))
        for _ in range(int(rng.integers(0, 4))):
            read[b, int(rng.integers(L))] = rng.integers(0, 4)
        for _ in range(pads):
            read[b, int(rng.integers(L))] = READ_PAD
    if row0_pad:
        read[::2, 0] = READ_PAD
    row0 = rng.integers(0, 4, (B, G)).astype(np.int8)
    return genome, read, wlen, row0


def _pass2_case(rng, B: int, G: int, R: int, rlen: int, W: int):
    """Reads drawn from their windows with mutations, and compute_band
    bands of anchors inside the window, cut to width <= W."""
    from shrimp_tpu_torch.ops import sw_full
    gb = rng.integers(0, 4, (B, G)).astype(np.int8)
    glen = rng.integers(max(rlen, G * 3 // 4), G + 1, B)
    for b in range(B):
        gb[b, glen[b]:] = -1
    rb = np.full((B, R), -2, np.int8)
    for b in range(B):
        s = int(rng.integers(0, glen[b] - rlen + 1))
        r = gb[b, s:s + rlen].copy()
        for _ in range(int(rng.integers(0, 6))):
            q = int(rng.integers(0, rlen))
            r[q] = (r[q] + int(rng.integers(1, 4))) % 4
        rb[b, :rlen] = r
    rev = rng.random(B) < 0.5
    ax = rng.integers(0, np.maximum(glen - rlen, 1)).astype(np.int64)
    ay = rng.integers(0, max(rlen // 4, 1), B).astype(np.int64)
    al = np.full(B, max(rlen // 2, 1), np.int64)
    aw = rng.integers(1, max(W // 2, 2), B).astype(np.int64)
    bxmin, bxmax = sw_full.compute_band(ax - 4, ay + 4, al, aw + 8,
                                        glen.astype(np.int64), R)
    bxmax = np.minimum(bxmax, bxmin + W - 1).astype(np.int32)
    return gb, rb, rev, bxmin, bxmax


def phase_kernels() -> None:
    """Each kernel against its plain version at the main path's bounds."""
    import torch

    from shrimp_tpu_torch.ops.params import SWParams
    from shrimp_tpu_torch.ops import sw_full, sw_vector
    cuda = torch.device("cuda", 0)
    rng = np.random.default_rng(20261016)
    asym = SWParams.letter_space().with_(a_gap_open=-100, a_gap_extend=-1,
                                         b_gap_open=-20, b_gap_extend=-9)
    n = 0
    for G in (128, 640, 1408):
        for R in (56, 408, 1000):
            for params, with_row0 in ((SWParams.letter_space(), False),
                                      (asym, True)):
                genome, read, row0 = _pass1_case(rng, 48, G, R)
                r0 = torch.from_numpy(row0) if with_row0 else None
                want = sw_vector.sw_score_batch(
                    torch.from_numpy(genome), torch.from_numpy(read), params,
                    r0)
                got = sw_vector.sw_score_batch_cuda(
                    torch.from_numpy(genome).to(cuda),
                    torch.from_numpy(read).to(cuda), params,
                    None if r0 is None else r0.to(cuda))
                err = max_abs_err(got, want)
                if err:
                    raise AssertionError(f"sw_vector G={G} R={R} "
                                         f"row0={with_row0}: err {err}")
                n += 1
            # the fused gather: windows sliced from one plane at int64
            # starts, wlen-masked, reads picked by (rid, strand)
            plane = rng.integers(0, 5, 200_000).astype(np.int8)
            C = 96
            lo = rng.integers(0, len(plane) - G, C).astype(np.int64)
            wlen = rng.integers(G // 2, G + 1, C).astype(np.int32)
            reads2 = rng.integers(0, 4, (8, 2, R)).astype(np.int8)
            reads2[:, :, R * 3 // 4:] = -2
            rid = rng.integers(0, 8, C).astype(np.int32)
            st = rng.integers(0, 2, C).astype(np.int32)
            args = [torch.from_numpy(a) for a in
                    (plane, lo, wlen, rid, st, reads2)]
            want = sw_vector.p1_gather_score_ls_plain(
                *args, G, SWParams.letter_space())
            got = sw_vector.p1_gather_score_ls_cuda(
                *[a.to(cuda) for a in args], G, SWParams.letter_space())
            err = max_abs_err(got, want)
            if err:
                raise AssertionError(f"sw_vector gather G={G} R={R}: {err}")
            n += 1
    # the one-thread-per-pair sweep's edges: G below 32 and G = 1, reads
    # of 1,000 rows (row boundaries in global scratch), pad rows inside a
    # read and at row 0 under a row-0 plane, and a positive mismatch (no
    # stop at the window's length); windows cut at wlen, then given whole
    odd = SWParams(match=3, mismatch=1, a_gap_open=-2, a_gap_extend=-1,
                   b_gap_open=-2, b_gap_extend=-1)
    for B, G, R, params, pads, row0_pad in (
            (96, 20, 24, SWParams.letter_space(), 0, False),
            (64, 1, 8, asym, 0, False),
            (48, 640, 1000, SWParams.letter_space(), 0, False),
            (96, 96, 40, asym, 3, False), (96, 64, 32, asym, 2, True),
            (96, 60, 60, odd, 0, False)):
        genome, read, wlen, row0 = _windows_case(rng, B, G, R, pads,
                                                 row0_pad)
        args = [torch.from_numpy(genome.reshape(-1).copy()),
                torch.arange(B, dtype=torch.int64) * G,
                torch.from_numpy(wlen), torch.arange(B, dtype=torch.int32),
                torch.zeros(B, dtype=torch.int32),
                torch.from_numpy(read).reshape(B, 1, R)]
        want = sw_vector.p1_gather_score_ls_plain(*args, G, params)
        got = sw_vector.p1_gather_score_ls_cuda(
            *[a.to(cuda) for a in args], G, params)
        t = [torch.from_numpy(a) for a in (genome, read, row0)]
        want2 = sw_vector.sw_score_batch(t[0], t[1], params, t[2])
        got2 = sw_vector.sw_score_batch_cuda(t[0].to(cuda), t[1].to(cuda),
                                             params, t[2].to(cuda))
        err = max(max_abs_err(got, want), max_abs_err(got2, want2))
        if err:
            raise AssertionError(f"sw_vector B={B} G={G} R={R} pads={pads} "
                                 f"row0_pad={row0_pad}: err {err}")
        n += 1
    torch.cuda.synchronize()
    log(f"kernels: sw_vector equal to its plain version in {n} cases")

    # pass 2: the goldens' call shapes (B, G, R, read length, W), the
    # full band (W = round_up(G, 32), also at G = 640), a wide-jump band;
    # the asymmetric and positive-mismatch scorings; batches that fill no
    # whole warp (B 0, 1, 13); W 32 / 96 / 192 / 640 (tiles of 16 and 32
    # lanes); 1,000-row reads, whose pointers take the global tier, and
    # 6,000-row reads, whose per-row inputs stay in the global scratch
    n = 0
    ls = SWParams.letter_space()
    shapes = [(256, 128, 56, 50, 64, ls), (128, 640, 408, 400, 192, ls),
              (512, 128, 80, 70, 64, ls), (64, 128, 56, 50, 128, ls),
              (256, 128, 56, 50, 64, asym), (256, 128, 56, 50, 64, odd),
              (0, 128, 56, 50, 64, ls), (1, 128, 56, 50, 64, ls),
              (13, 128, 56, 50, 64, asym), (77, 128, 56, 50, 32, ls),
              (96, 256, 100, 90, 96, odd), (16, 640, 80, 70, 640, ls),
              (24, 1408, 1000, 1000, 64, ls), (3, 6144, 6000, 6000, 64, ls)]
    for B, G, R, rlen, W, params in shapes:
        for loc in (True, False):
            gb, rb, rev, bxmin, bxmax = _pass2_case(rng, B, G, R, rlen, W)
            if W >= G:
                glen = (gb >= 0).sum(axis=1)
                bxmin = np.zeros((B, R), np.int32)
                bxmax = np.broadcast_to((glen - 1).astype(np.int32)[:, None],
                                        (B, R)).copy()
            _check_pass2(gb, rb, rev, bxmin, bxmax, loc, W,
                         f"B={B} G={G} R={R} W={W} local={loc} {params}",
                         params)
            n += 1
    rng2 = np.random.default_rng(7)
    B, G, R, rlen = 32, 96, 64, 50
    gb = rng2.integers(0, 4, (B, G)).astype(np.int8)
    rb = np.full((B, R), -2, np.int8)
    for b in range(B):
        s = int(rng2.integers(0, G - rlen))
        rb[b, :rlen] = gb[b, s:s + rlen]
    rev = rng2.random(B) < 0.5
    bxmin, bxmax = sw_full.compute_band(
        rng2.integers(10, 40, B).astype(np.int64),
        rng2.integers(0, 10, B).astype(np.int64), np.full(B, 30, np.int64),
        rng2.integers(9, 17, B).astype(np.int64), np.full(B, G, np.int64), R)
    W = int((bxmax - bxmin).max()) + 1
    for loc in (True, False):
        _check_pass2(gb, rb, rev, bxmin, bxmax, loc, W,
                     f"wide-jump band local={loc}")
        n += 1
    torch.cuda.synchronize()
    log(f"kernels: sw_full equal to its plain version in {n} cases")


def _check_pass2(gb, rb, rev, bxmin, bxmax, loc, W, what,
                 p=None) -> None:
    import torch

    from shrimp_tpu_torch.ops.params import SWParams
    from shrimp_tpu_torch.ops import sw_full
    cuda = torch.device("cuda", 0)
    args = [torch.from_numpy(np.ascontiguousarray(a))
            for a in (gb, rb, rev, bxmin, bxmax)]
    p = p or SWParams.letter_space()
    s_want, o_want = sw_full.sw_full_and_traceback_packed_plain(
        *args, p, loc, W)
    s_got, o_got = sw_full.sw_full_and_traceback_packed_cuda(
        *[a.to(cuda) for a in args], p, loc, W)
    err = max(max_abs_err(s_got, s_want), max_abs_err(o_got, o_want))
    if err:
        bad = (s_got.cpu() != s_want).any(dim=1).nonzero().flatten()[:3]
        raise AssertionError(f"sw_full {what}: err {err}; rows "
                             f"{bad.tolist()}: kernel "
                             f"{s_got.cpu()[bad].tolist()} plain "
                             f"{s_want[bad].tolist()}")


def _golden_body(name: str) -> list[str]:
    with open(os.path.join(GOLDEN, name)) as fh:
        return [ln.rstrip("\n") for ln in fh if not ln.startswith("@")]


def _sam_lines(mapper, results) -> list[str]:
    return [rec.line() for re_e, hits in results
            for rec in mapper.sam_records(re_e, hits)]


def sam_digest(lines: list[str]) -> dict:
    """The SAM lines' count and the sha256 of their text."""
    return {"sam_lines": len(lines), "sam_sha256": hashlib.sha256(
        "\n".join(lines).encode()).hexdigest()}


def phase_goldens() -> dict:
    """The three letter-space goldens through the kernels, byte-exact."""
    import torch

    from shrimp_tpu_torch import index as gindex
    from shrimp_tpu_torch.io import fastx
    from shrimp_tpu_torch.pipeline.options import MapperConfig
    from shrimp_tpu_torch.ops import sw_full, sw_vector
    from shrimp_tpu_torch.pipeline.mapper import Mapper
    sw_vector.LAUNCHES.reset()
    sw_full.LAUNCHES.reset()
    rec1 = Recorder(sw_vector, "p1_gather_score_ls_cuda",
                    lambda a: a[1].shape[0])
    rec2 = Recorder(sw_full, "sw_full_and_traceback_packed_cuda",
                    lambda a: a[0].shape[0])
    with rec1, rec2:
        for genome, reads, gold in (
                ("golden_genome.fa", "golden_reads.fq",
                 "golden_unpaired.sam"),
                ("golden_genome.fa", "long_reads.fq",
                 "golden_long_reads.sam"),
                ("med_genome.fa", "med_reads.fq", "med_ls.sam")):
            idx = gindex.build_index(
                list(fastx.iter_contigs(os.path.join(GOLDEN, genome))))
            m = Mapper(idx, MapperConfig(qual_delta=64), device="cuda")
            recs = [(r.name, r.seq, r.qual) for r in
                    fastx.iter_reads(os.path.join(GOLDEN, reads))]
            lines = _sam_lines(m, m.map_batch(recs))
            want = _golden_body(gold)
            if lines != want:
                i = next((k for k, (a, b) in enumerate(zip(lines, want))
                          if a != b), min(len(lines), len(want)))
                raise AssertionError(
                    f"{gold}: SAM differs at line {i} ({len(lines)} vs "
                    f"{len(want)} lines)")
            log(f"goldens: {gold} byte-equal ({len(lines)} lines, "
                f"{m.stats['pass1_windows']} pass-1 / "
                f"{m.stats['pass2_windows']} pass-2 windows)")
    torch.cuda.synchronize()
    counts = {"sw_vector": sw_vector.LAUNCHES.value,
              "sw_full": sw_full.LAUNCHES.value}
    if min(counts.values()) <= 0:
        raise AssertionError(f"goldens did not launch every kernel: {counts}")
    log(f"goldens: launches {json.dumps(counts)}")
    return {"sw_vector": rec1.args, "sw_full": rec2.args}


def size_contigs() -> tuple[list, float]:
    """The synthetic 100 Mbp genome (seed 20260817, the JAX bench's),
    shared by the size phases, and the seconds it took to make."""
    from shrimp_tpu_torch.io import fastx
    from shrimp_tpu_torch.utils import synth
    t0 = time.time()
    chroms = synth.make_genome(np.random.default_rng(20260817),
                               SIZE_GENOME_BP)
    contigs = [fastx.Contig(name=f"chr{i + 1}", codes=g)
               for i, g in enumerate(chroms)]
    return contigs, time.time() - t0


def top_hit_quality(idx, results, truth) -> dict:
    """matched / recall / precision of the top hit, true when its SAM
    position is within 8 bp of the generator's."""
    n_done = len(results)
    n_matched = n_correct = 0
    coffs = idx.contig_offsets
    for ri, (_, hits) in enumerate(results):
        if not hits:
            continue
        n_matched += 1
        h = hits[0]
        gs0 = h.g_off + h.genome_start
        if h.gen_st == 0:
            gpos = int(coffs[h.cn]) + gs0
        else:
            # SAM POS formula for reverse hits (io/sam.py:171-173)
            gpos = (int(coffs[h.cn]) + (int(idx.contig_len[h.cn]) - gs0)
                    - h.gmapped)
        n_correct += abs(gpos - truth[ri]) <= 8
    if n_matched == 0:
        raise AssertionError(f"mapped {n_done} reads, none matched")
    return {"matched_frac": round(n_matched / n_done, 4),
            "recall_top_hit": round(n_correct / n_done, 4),
            "precision_top_hit": round(n_correct / n_matched, 4)}


def size_index(contigs: list, gen_secs: float):
    """The letter-space index of the size phases (automatic list trim),
    its 16,384 reads with their true starts, and its build seconds."""
    from shrimp_tpu_torch import index as gindex
    from shrimp_tpu_torch import seeds as seedmod
    from shrimp_tpu_torch.utils import synth
    t0 = time.time()
    idx = gindex.build_index(contigs, seedmod.make_seed_set(None))
    max_w = max(s.weight for s in idx.seed_set.seeds)
    idx.trim(max(1000, (100 * idx.total_len) // (4 ** max_w)))
    index_secs = time.time() - t0
    reads, truth = synth.make_reads(idx, np.random.default_rng(7),
                                    SIZE_READS)
    log(f"size: {idx.total_len} bp in {idx.num_contigs} contigs, genome "
        f"{gen_secs:.1f} s, index {index_secs:.1f} s")
    return idx, reads, truth, index_secs


def _first_difference(a: list, b: list) -> int:
    return next((k for k, (x, y) in enumerate(zip(a, b)) if x != y),
                min(len(a), len(b)))


def phase_size(device: dict, idx, reads, truth,
               index_secs: float) -> tuple[dict, dict, dict, list]:
    """The main path at 100 Mbp with host candidates: map, count
    launches, check quality, and check the first batch against the plain
    versions.  Returns the launches, the recorded largest calls, the
    stats and the SAM lines."""
    import torch

    from shrimp_tpu_torch.ops import sw_full, sw_vector
    from shrimp_tpu_torch.pipeline.mapper import Mapper
    from shrimp_tpu_torch.pipeline.options import MapperConfig

    def cfg():
        return MapperConfig(qual_delta=64, device_candidates=False)

    torch.cuda.reset_peak_memory_stats()
    mapper = Mapper(idx, cfg(), device="cuda")
    torch.cuda.synchronize()
    rec1 = Recorder(sw_vector, "p1_gather_score_ls_cuda",
                    lambda a: a[1].shape[0])
    rec2 = Recorder(sw_full, "sw_full_and_traceback_packed_cuda",
                    lambda a: a[0].shape[0])
    reset_launches()
    with rec1, rec2:
        t0 = time.time()
        results = list(mapper.map_stream(iter(reads), SIZE_BATCH))
        torch.cuda.synchronize()
        map_secs = time.time() - t0
    launches = read_launches(("sw_vector", "sw_full"))
    peak = torch.cuda.max_memory_allocated()

    n_done = len(results)
    if n_done != SIZE_READS:
        raise AssertionError(f"mapped {n_done} of {SIZE_READS} reads")
    stats = {
        "card": device["name"], "nvidia_smi": device["smi"],
        "genome_bp": int(idx.total_len), "reads": n_done,
        "index_build_secs": round(index_secs, 3),
        "map_secs": round(map_secs, 3),
        "reads_per_sec": round(n_done / map_secs, 1),
        "windows_per_read": mapper.tel.f1.invocs / n_done,
        **top_hit_quality(idx, results, truth),
        "stage_secs": {k: round(v.secs, 3)
                       for k, v in mapper.tel.stages.items() if v.secs},
        "pass1_windows": mapper.stats["pass1_windows"],
        "pass2_windows": mapper.stats["pass2_windows"],
        "launches": launches,
        "max_memory_allocated": int(peak),
    }
    lines = _sam_lines(mapper, results)
    stats.update(sam_digest(lines))
    log("size: " + json.dumps(stats))

    # the first batch again through the plain versions (CPU tensors)
    first = _sam_lines(mapper, results[:SIZE_BATCH])
    plain = Mapper(idx, cfg(), device="cpu")
    t0 = time.time()
    again = _sam_lines(plain, plain.map_stream(iter(reads[:SIZE_BATCH]),
                                               SIZE_BATCH))
    plain_secs = time.time() - t0
    if again != first:
        raise AssertionError("plain versions disagree at SAM line "
                             f"{_first_difference(again, first)}")
    log(f"size: first {SIZE_BATCH} reads identical through the plain "
        f"versions ({len(first)} SAM lines; plain map {plain_secs:.1f} s on "
        f"the host CPU)")
    log("size: profile " + json.dumps(
        profile_map(mapper, reads[:SIZE_PROFILE_READS], SIZE_BATCH)))
    return launches, {"sw_vector": rec1.args, "sw_full": rec2.args}, \
        stats, lines


def _cpu(args) -> list:
    import torch
    return [x.cpu() if torch.is_tensor(x) else x for x in args]


def time_kernels(args: dict, reps: int = 20) -> dict:
    """Kernel (CUDA events) against plain version (host clock, CPU
    tensors) on recorded main-path inputs; outputs must agree."""
    from shrimp_tpu_torch.ops import sw_full, sw_vector
    out = {}
    a = args["sw_vector"]
    got = sw_vector.p1_gather_score_ls_cuda(*a)
    ms = cuda_ms(lambda: sw_vector.p1_gather_score_ls_cuda(*a), reps)
    ca = _cpu(a)
    plain_ms, want = host_ms(lambda: sw_vector.p1_gather_score_ls_plain(*ca))
    plane, lo, wlen, rid, st, reads2, G = a[:7]
    out["sw_vector"] = {
        "shape": {"windows": int(lo.shape[0]), "G": int(G),
                  "R": int(reads2.shape[2])},
        "max_abs_err": max_abs_err(got, want), "ms": ms,
        "plain_ms": plain_ms,
        **_gather_bound("sw_vector", (lo, wlen, rid, st), wlen, rid, st,
                        reads2, G, 1, (got,))}
    a = args["sw_full"]
    s_got, o_got = sw_full.sw_full_and_traceback_packed_cuda(*a)
    ms = cuda_ms(lambda: sw_full.sw_full_and_traceback_packed_cuda(*a), reps)
    ca = _cpu(a)
    plain_ms, (s_want, o_want) = host_ms(
        lambda: sw_full.sw_full_and_traceback_packed_plain(*ca))
    gb, rb, rev, bxmin, bxmax = a[:5]
    R, W = int(rb.shape[1]), int(a[7])
    out["sw_full"] = {
        "shape": {"alignments": int(gb.shape[0]), "G": int(gb.shape[1]),
                  "R": R, "W": W,
                  "plan": sw_full.launch_plan(int(gb.shape[1]), R, W)},
        "max_abs_err": max(max_abs_err(s_got, s_want),
                           max_abs_err(o_got, o_want)),
        "ms": ms, "plain_ms": plain_ms,
        "device_ms": device_ms(
            lambda: sw_full.sw_full_and_traceback_packed_cuda(*a), reps),
        **_band_bound("sw_full", (rb.cpu() != READ_PAD).sum(1), bxmin,
                      bxmax, (gb, rb, rev, bxmin, bxmax), (s_got, o_got))}
    for name, row in out.items():
        if row["max_abs_err"]:
            raise AssertionError(f"{name} disagrees with its plain version "
                                 f"on main-path inputs: {row}")
    return out

# ---------------------------------------------------------------------------
# colour space and gapless
def _cs_params():
    """(scoring, the pass-1 filter's scoring: a colour mismatch costs one
    crossover, Mapper.vect_params)."""
    from shrimp_tpu_torch.ops.params import SWParams
    cs = SWParams.colour_space()
    return cs, cs.with_(mismatch=cs.match + cs.crossover)


def _cs_pass2_case(rng, B: int, G: int, R: int, rlen: int, W: int = 64,
                   per_colour: bool = False, n_rate: float = 0.0,
                   band: str = "anchor"):
    """Colour reads cut from their windows with 15% colour noise (N
    colours at n_rate) as four letter decodings, global or per-colour
    crossover costs, random strands, and compute_band bands cut to width
    W ("anchor"), starts leaping past the shift clip ("jump"), or the
    full band [0, glen - 1] ("full")."""
    from shrimp_tpu_torch.pipeline.candidates import cs_read_ls4
    from shrimp_tpu_torch.ops import sw_full
    cs, _ = _cs_params()
    gb = rng.integers(0, 4, (B, G)).astype(np.int8)
    glen = rng.integers(rlen + 8, G + 1, B)
    for b in range(B):
        gb[b, glen[b]:] = -1
    qr4 = np.full((B, 4, R), -2, np.int8)
    xover = np.full((B, R), cs.crossover, np.int32)
    starts = np.zeros(B, np.int64)
    for b in range(B):
        st = starts[b] = int(rng.integers(0, glen[b] - rlen))
        initbp = int(rng.integers(0, 4))
        letters = np.concatenate(([initbp], gb[b, st:st + rlen]))
        colours = np.where(rng.random(rlen) < 0.15,
                           rng.integers(0, 4, rlen),
                           letters[:-1] ^ letters[1:]).astype(np.int8)
        colours[rng.random(rlen) < n_rate] = 4
        qr4[b, :, :rlen] = cs_read_ls4(colours, initbp)
        if per_colour:
            xover[b, :rlen] = -rng.integers(20, 181, rlen)
    rev = rng.random(B) < 0.5
    if band == "full":
        bxmin = np.zeros((B, R), np.int64)
        bxmax = np.broadcast_to((glen - 1)[:, None], (B, R)).copy()
    elif band == "jump":
        bxmin = np.zeros((B, R), np.int64)
        for b in range(B):
            steps = np.where(rng.random(R) < 0.08,
                             rng.integers(20, 3 * G // 2, R),
                             rng.integers(0, 2, R))
            bxmin[b] = np.cumsum(steps) - steps[0]
        bxmax = bxmin + rng.integers(8, 24, (B, 1))
    else:
        ay = rng.integers(0, 10, B)
        bxmin, bxmax = sw_full.compute_band(
            starts + ay + rng.integers(-3, 4, B), ay, np.full(B, rlen // 2),
            rng.integers(max(W // 4, 1), max(W // 2, 2), B), glen, R)
        bxmax = np.minimum(bxmax, bxmin + W - 1)
    return (gb, qr4, xover, rev, bxmin.astype(np.int32),
            bxmax.astype(np.int32))


def _check_pass2_cs(case, loc: bool, taboo: int, W: int, what: str) -> None:
    import torch

    from shrimp_tpu_torch.ops import sw_full_cs
    cuda = torch.device("cuda", 0)
    cs, _ = _cs_params()
    args = [torch.from_numpy(np.ascontiguousarray(a)) for a in case]
    s_want, o_want = sw_full_cs.sw_full_cs_and_traceback_packed_plain(
        *args, cs, loc, taboo, W)
    s_got, o_got = sw_full_cs.sw_full_cs_and_traceback_packed_cuda(
        *[a.to(cuda) for a in args], cs, loc, taboo, W)
    err = max(max_abs_err(s_got, s_want), max_abs_err(o_got, o_want))
    if err:
        bad = (s_got.cpu() != s_want).any(dim=1).nonzero().flatten()[:3]
        raise AssertionError(f"sw_full_cs {what}: err {err}; rows "
                             f"{bad.tolist()}: kernel "
                             f"{s_got.cpu()[bad].tolist()} plain "
                             f"{s_want[bad].tolist()}")


def _gapless_case(rng, N: int, R: int):
    """Diagonal rows as the mapper gathers them: genome codes 0-4 with a
    GENOME_PAD tail, read codes 0-3 (80% matching) with a READ_PAD tail,
    and an s0 column of the colour-space override's values."""
    cs, _ = _cs_params()
    diag = rng.integers(0, 5, (N, R)).astype(np.int8)
    reads = np.where(rng.random((N, R)) < 0.8, np.minimum(diag, 3),
                     rng.integers(0, 4, (N, R))).astype(np.int8)
    cols = np.arange(R)[None, :]
    diag[cols >= rng.integers(0, R + 1, (N, 1))] = -1
    reads[cols >= rng.integers(0, R + 1, (N, 1))] = -2
    s0 = rng.choice([0, cs.match, cs.mismatch], N).astype(np.int32)
    return diag, reads, s0


def _check_gapless_gather(args, cs: bool, params, what: str) -> None:
    import torch

    from shrimp_tpu_torch.ops import sw_gapless
    cuda = torch.device("cuda", 0)
    plain, kernel = ((sw_gapless.p1_gather_gapless_cs_plain,
                      sw_gapless.p1_gather_gapless_cs_cuda) if cs else
                     (sw_gapless.p1_gather_gapless_ls_plain,
                      sw_gapless.p1_gather_gapless_ls_cuda))
    want = plain(*args, params)
    got = kernel(*[a.to(cuda) for a in args], params)
    err = max_abs_err(got, want)
    if err:
        bad = (got.cpu() != want).nonzero().flatten()[:3].tolist()
        raise AssertionError(f"sw_gapless gather {what}: err {err}; hits "
                             f"{bad}: kernel {got.cpu()[bad].tolist()} "
                             f"plain {want[bad].tolist()}")


def phase_kernels_cs() -> None:
    """The three new kernels against their plain versions, exact."""
    import torch

    from shrimp_tpu_torch.ops import sw_gapless, sw_vector
    from shrimp_tpu_torch.ops.params import SWParams
    from shrimp_tpu_torch.utils import gapless_cases
    cuda = torch.device("cuda", 0)
    cs, vect = _cs_params()
    rng = np.random.default_rng(20261017)

    n = 0
    for R in (50, 100, 1000):
        diag, reads, s0 = _gapless_case(rng, 4096, R)
        for with_s0 in (False, True):
            t = [torch.from_numpy(a) for a in (diag, reads, s0)]
            want = sw_gapless.gapless_score_batch_plain(
                t[0], t[1], cs, t[2] if with_s0 else None)
            got = sw_gapless.gapless_score_batch_cuda(
                t[0].to(cuda), t[1].to(cuda), cs,
                t[2].to(cuda) if with_s0 else None)
            err = max_abs_err(got, want)
            if err:
                raise AssertionError(f"sw_gapless R={R} s0={with_s0}: "
                                     f"err {err}")
            n += 1
    # the fused gather, both spaces (letter space also with a positive
    # mismatch): R of 8, 37, 56 and 1,000, long reads (few hits of R 5,000,
    # many of R 512), and launches of 0 and 1 hit
    odd = SWParams(match=3, mismatch=1)
    for R, N in ((8, 3000), (37, 3000), (56, 20000), (1000, 4096),
                 (56, 0), (56, 1), (5000, 512), (512, 40000)):
        for space_cs, params in ((False, SWParams.letter_space()),
                                 (False, odd), (True, vect)):
            args = gapless_cases.gather_case(rng, N, R, space_cs)
            _check_gapless_gather(args, space_cs, params,
                                  f"N={N} R={R} cs={space_cs} {params}")
            n += 1
    torch.cuda.synchronize()
    log(f"kernels: sw_gapless equal to its plain version in {n} cases")

    # K2-CS: colour and letter windows from fw||rc planes at int64 starts
    n = 0
    L = 100_000
    pad = np.full(1 << 12, -1, np.int8)
    cs_cat = np.concatenate([rng.integers(0, 5, 2 * L).astype(np.int8), pad])
    ls_cat = np.concatenate([rng.integers(0, 5, 2 * L).astype(np.int8), pad])
    for G, R in ((128, 56), (640, 408), (1408, 1000)):
        C = 96
        wlen = rng.integers(G // 2, G + 1, C).astype(np.int32)
        lo = rng.integers(0, 2 * L - G, C).astype(np.int64)
        lo[:4] = 2 * L - wlen[:4]            # windows ending at the end
        reads2 = np.full((8, 2, R), -2, np.int8)
        for b in range(8):
            k = int(rng.integers(R // 2, R + 1))
            reads2[b, :, :k] = rng.integers(0, 4, (2, k))
        args = [torch.from_numpy(a) for a in (
            cs_cat, ls_cat, lo, wlen, rng.integers(0, 8, C).astype(np.int32),
            np.zeros(C, np.int32), rng.integers(0, 4, C).astype(np.int8),
            reads2)]
        want = sw_vector.p1_gather_score_cs_plain(*args, G, vect)
        got = sw_vector.p1_gather_score_cs_cuda(
            *[a.to(cuda) for a in args], G, vect)
        err = max_abs_err(got, want)
        if err:
            raise AssertionError(f"sw_vector CS gather G={G} R={R}: {err}")
        n += 1
    torch.cuda.synchronize()
    log(f"kernels: sw_vector colour-space gather equal to its plain version "
        f"in {n} cases")

    # K7+K8: local / glocal x the main path's shapes, per-row crossovers,
    # indel taboo, N codes, a band leaping past the shift clip, the full
    # band at W = round_up(G, 32) (also at G = 640), batches that fill no
    # whole warp, W 96 (one tile a warp), 1,000-row reads, and 6,000-row
    # reads, whose per-row inputs stay in the global scratch
    n = 0
    cases = [
        ("anchor", dict(B=256, G=128, R=56, rlen=50, W=64), 0),
        ("per-colour taboo", dict(B=256, G=128, R=56, rlen=50, W=64,
                                  per_colour=True), 6),
        ("N codes", dict(B=128, G=128, R=56, rlen=50, W=64, n_rate=0.05), 0),
        ("long reads", dict(B=64, G=640, R=408, rlen=400, W=192,
                            per_colour=True), 0),
        ("jumping band", dict(B=64, G=96, R=64, rlen=50, band="jump"), 3),
        ("full band", dict(B=128, G=128, R=56, rlen=50, band="full"), 4),
        ("B 13", dict(B=13, G=128, R=56, rlen=50, W=64, n_rate=0.05), 2),
        ("B 1", dict(B=1, G=96, R=64, rlen=50, band="jump"), 0),
        ("W 96", dict(B=48, G=256, R=100, rlen=90, W=96), 0),
        ("full band G 640", dict(B=16, G=640, R=80, rlen=70, band="full"), 0),
        ("1,000-row reads", dict(B=8, G=1408, R=1000, rlen=1000, W=64,
                                 per_colour=True), 0),
        ("6,000-row reads", dict(B=3, G=6144, R=6000, rlen=6000, W=64,
                                 per_colour=True), 4),
    ]
    for what, kw, taboo in cases:
        case = _cs_pass2_case(rng, **kw)
        if kw.get("band") == "full":
            W = -(-kw["G"] // 32) * 32
        else:
            W = -(-(int((case[5] - case[4]).max()) + 1) // 32) * 32
        for loc in (True, False):
            _check_pass2_cs(case, loc, taboo, W,
                            f"{what} W={W} local={loc} taboo={taboo}")
            n += 1
    torch.cuda.synchronize()
    log(f"kernels: sw_full_cs equal to its plain version in {n} cases")


# (program name, flags, reads, genome, golden) of the gapless goldens,
# mapped through the gmapper CLI
GAPLESS_GOLDENS = (
    ("gmapper-cs", ["-Q", "-M", "mirna"], "golden_reads_cs.fq",
     "golden_genome.fa", "golden_cs_mirna.sam"),
    ("gmapper-cs", ["-Q", "-U", "--local"], "golden_reads_cs.fq",
     "golden_genome.fa", "golden_cs_ungapped.sam"),
    ("gmapper", ["-Q", "-U", "--local"], "mini_reads.fq",
     "golden_genome.fa", "golden_ungapped.sam"),
    ("gmapper", ["-Q", "-M", "mirna"], "golden_reads.fq",
     "golden_genome.fa", "golden_mirna.sam"),
)


def _check_lines(lines: list[str], gold: str) -> None:
    want = _golden_body(gold)
    if lines != want:
        i = next((k for k, (a, b) in enumerate(zip(lines, want))
                  if a != b), min(len(lines), len(want)))
        raise AssertionError(f"{gold}: SAM differs at line {i} "
                             f"({len(lines)} vs {len(want)} lines)")


def phase_goldens_cs() -> tuple[dict, dict]:
    """golden_cs and med_cs through the colour-space kernels, then the
    gapless goldens through the CLI on the card; byte-exact.  Returns
    the launch counts of the gapless run and the recorded largest calls."""
    import contextlib
    import io

    import torch

    from shrimp_tpu_torch import index as gindex
    from shrimp_tpu_torch.io import fastx
    from shrimp_tpu_torch.pipeline.options import MapperConfig
    from shrimp_tpu_torch import gmapper
    from shrimp_tpu_torch.ops import sw_full_cs, sw_gapless, sw_vector
    from shrimp_tpu_torch.pipeline.mapper import Mapper
    cs, _ = _cs_params()
    rec1 = Recorder(sw_vector, "p1_gather_score_cs_cuda",
                    lambda a: a[2].shape[0])
    rec2 = Recorder(sw_full_cs, "sw_full_cs_and_traceback_packed_cuda",
                    lambda a: a[0].shape[0])
    reset_launches()
    with rec1, rec2:
        for genome, reads, gold in (
                ("golden_genome.fa", "golden_reads_cs.fq", "golden_cs.sam"),
                ("med_genome.fa", "med_reads_cs.fq", "med_cs.sam")):
            idx = gindex.build_index(
                list(fastx.iter_contigs(os.path.join(GOLDEN, genome))),
                colour_space=True)
            m = Mapper(idx, MapperConfig(colour_space=True, params=cs,
                                         qual_delta=33), device="cuda")
            recs = [(r.name, r.seq, r.qual) for r in
                    fastx.iter_reads(os.path.join(GOLDEN, reads))]
            lines = _sam_lines(m, m.map_batch(recs))
            _check_lines(lines, gold)
            log(f"goldens: {gold} byte-equal ({len(lines)} lines, "
                f"{m.stats['pass1_windows']} pass-1 / "
                f"{m.stats['pass2_windows']} pass-2 windows)")
    torch.cuda.synchronize()
    log("goldens: colour-space launches "
        + json.dumps(read_launches(("sw_vector_cs", "sw_full_cs"))))

    rec3 = Recorder(sw_gapless, "p1_gather_gapless_ls_cuda",
                    lambda a: a[1].shape[0])
    reset_launches()
    with rec3:
        for prog, flags, reads, genome, gold in GAPLESS_GOLDENS:
            out, err = io.StringIO(), io.StringIO()
            with contextlib.redirect_stdout(out), \
                    contextlib.redirect_stderr(err):
                rc = gmapper.main([prog, *flags,
                                   os.path.join(GOLDEN, reads),
                                   os.path.join(GOLDEN, genome)])
            if rc != 0:
                raise AssertionError(f"{gold}: gmapper rc {rc}\n"
                                     + err.getvalue()[-2000:])
            if "PyTorch port on cuda" not in err.getvalue():
                raise AssertionError(f"{gold}: the CLI did not map on the "
                                     "card")
            lines = [ln for ln in out.getvalue().splitlines()
                     if ln and not ln.startswith("@")]
            _check_lines(lines, gold)
            log(f"goldens: {gold} byte-equal through the CLI "
                f"({prog} {' '.join(flags)}; {len(lines)} lines)")
    torch.cuda.synchronize()
    launches = read_launches(("sw_gapless",))
    log("goldens: gapless launches " + json.dumps(launches))
    return launches, {"sw_vector_cs": rec1.args, "sw_full_cs": rec2.args,
                      "sw_gapless": rec3.args}


# ---------------------------------------------------------------------------
# paired, legacy output and the JAX suites' other goldens
def _paired_recorders():
    """Recorders of the four kernels a paired run launches (pass 1 and
    pass 2, both spaces), largest call by rows."""
    from shrimp_tpu_torch.ops import sw_full, sw_full_cs, sw_vector
    return {"sw_vector": Recorder(sw_vector, "p1_gather_score_ls_cuda",
                                  lambda a: a[1].shape[0]),
            "sw_vector_cs": Recorder(sw_vector, "p1_gather_score_cs_cuda",
                                     lambda a: a[2].shape[0]),
            "sw_full": Recorder(sw_full, "sw_full_and_traceback_packed_cuda",
                                lambda a: a[0].shape[0]),
            "sw_full_cs": Recorder(sw_full_cs,
                                   "sw_full_cs_and_traceback_packed_cuda",
                                   lambda a: a[0].shape[0])}


def _run_goldens(cases: dict, tmpdir: str) -> None:
    """Each case through the gmapper CLI on the card, held to its golden
    (utils/golden_cli.py: minus @PG, legacy output byte for byte)."""
    from shrimp_tpu_torch.utils import golden_cli
    for name, case in cases.items():
        t0 = time.time()
        rc, out, err = golden_cli.run_case(case, tmpdir)
        if rc != 0:
            raise AssertionError(f"{name}: gmapper rc {rc}\n" + err[-2000:])
        if "PyTorch port on cuda" not in err:
            raise AssertionError(f"{name}: the CLI did not map on the card")
        got = golden_cli.compared(out, case[4])
        want = golden_cli.expected(case[4])
        if got != want:
            raise AssertionError(
                f"{name}: output differs from {case[4]} at "
                f"{golden_cli.first_difference(got, want)} "
                f"({len(got)} vs {len(want)})")
        log(f"goldens-paired: {name} byte-equal through the CLI "
            f"({' '.join(case[1][:8])}; {time.time() - t0:.1f} s)")


def phase_goldens_paired() -> dict:
    """The paired goldens of both spaces, the legacy-format goldens, the
    unpaired goldens of the JAX suites that the earlier phases do not run,
    and the colour-space goldens that had run only on the CPU, through the
    CLI on the card.  The paired runs' largest pass-1 and pass-2 launches
    are held to the plain versions; so are those of the paired goldens
    mapped with -a -1 (no band: the packed kernels over the full band at
    W = G, where the JAX package runs K5 / K9), whose SAM must also equal
    a run of the plain versions.  Returns the kernel rows."""
    import tempfile

    import torch

    from shrimp_tpu_torch.utils import golden_cli
    t_all = time.time()
    # the unpaired and letter/colour-space legacy goldens run in two worker
    # processes on the same card meanwhile (each CLI run is mostly host
    # work: index build, read intake)
    rest = [k for k in (*golden_cli.LEGACY, *golden_cli.UNPAIRED,
                        *golden_cli.UNPAIRED_CS)
            if k != "golden_legacy_paired"]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--golden-worker",
         *rest[w::2]], cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for w in range(2)]
    recs = _paired_recorders()
    reset_launches()
    try:
        with tempfile.TemporaryDirectory() as tmpdir, \
                recs["sw_vector"], recs["sw_vector_cs"], recs["sw_full"], \
                recs["sw_full_cs"]:
            _run_goldens({**golden_cli.PAIRED_LS, **golden_cli.PAIRED_CS,
                          "golden_legacy_paired":
                              golden_cli.LEGACY["golden_legacy_paired"]},
                         tmpdir)
        torch.cuda.synchronize()
        launches = read_launches(("sw_vector", "sw_vector_cs", "sw_full",
                                  "sw_full_cs"))
        log("goldens-paired: paired launches " + json.dumps(launches))
    except BaseException:
        for p in procs:
            p.kill()
        raise
    finally:
        outs = [p.communicate()[0] for p in procs]
    for p, out in zip(procs, outs):
        sys.stdout.write(out)
        if p.returncode != 0:
            raise AssertionError(f"goldens-paired: worker rc {p.returncode}")
    rows = {"paired": {**time_kernels(
                {k: recs[k].args for k in ("sw_vector", "sw_full")}, 5),
            **time_kernels_cs(
                {k: recs[k].args for k in ("sw_vector_cs", "sw_full_cs")},
                5)}}
    rows["full_band"] = phase_full_band_pairs()
    log("goldens-paired: kernels against their plain versions at the "
        "largest paired launches: " + json.dumps(rows))
    log(f"goldens-paired: {time.time() - t_all:.1f} s")
    return rows


def phase_full_band_pairs() -> dict:
    """golden_paired and golden_cs_opp-in with no band (anchor width -1):
    every pass-2 launch at the full band, W = G.  The SAM of the card run
    equals that of the plain versions; the largest launches are held to
    the plain versions."""
    import torch

    from shrimp_tpu_torch import index as gindex
    from shrimp_tpu_torch.io import fastx
    from shrimp_tpu_torch.pipeline.options import MapperConfig
    from shrimp_tpu_torch.pipeline.paired import PairedMapper
    cs_params, _ = _cs_params()
    out = {}
    for cs, reads in ((False, "golden_pairs.fq"),
                      (True, "pairs_cs_opp-in.fq")):
        idx = gindex.build_index(list(fastx.iter_contigs(
            os.path.join(GOLDEN, "golden_genome.fa"))), colour_space=cs)
        recs = [(r.name, r.seq, r.qual) for r in
                fastx.iter_reads(os.path.join(GOLDEN, reads))]
        pairs = list(zip(recs[0::2], recs[1::2]))

        def cfg():
            if cs:
                return MapperConfig(colour_space=True, params=cs_params,
                                    qual_delta=33, anchor_width=-1)
            return MapperConfig(qual_delta=64, anchor_width=-1)

        rec = _paired_recorders()
        names = ("sw_vector_cs", "sw_full_cs") if cs else ("sw_vector",
                                                          "sw_full")
        with rec[names[0]], rec[names[1]]:
            m = PairedMapper(idx, cfg(), device="cuda")
            lines = [r.line() for pr in m.map_pair_batch(pairs)
                     for r in m.sam_records_pair(pr)]
            torch.cuda.synchronize()
        plain = PairedMapper(idx, cfg(), device="cpu")
        want = [r.line() for pr in plain.map_pair_batch(pairs)
                for r in plain.sam_records_pair(pr)]
        if lines != want:
            raise AssertionError(
                f"full band ({reads}): card and plain SAM differ at line "
                f"{_first_difference(lines, want)}")
        a = rec[names[1]].args
        G, W = int(a[0].shape[1]), int(a[9] if cs else a[7])
        if W != G:
            raise AssertionError(f"full band ({reads}): W {W}, G {G}")
        args = {n: rec[n].args for n in names}
        row = (time_kernels_cs(args, 5) if cs else time_kernels(args, 5))
        out["cs" if cs else "ls"] = {"sam_lines": len(lines), **row}
        log(f"goldens-paired: {reads} with -a -1, {len(lines)} SAM lines "
            f"equal to the plain versions', pass 2 at W = G = {G}")
    return out


def phase_size_paired(device: dict, idx) -> tuple[dict, dict]:
    """Paired mapping at 100 Mbp: 4,096 opp-in pairs of the grid bench's
    generator (make_pairs, seed 17; 50 bp mates, insert 150-450) with
    PairedConfig(opp-in, 50, 600), host candidates, map_pair_stream in
    batches of 1,024 pairs after one warm batch; twice, the SAM equal;
    quality as the grid bench counts it; a profiled warm run.  Returns
    the stats and the largest K1 and K3+K4 launches."""
    import torch

    from shrimp_tpu_torch.ops import sw_full, sw_vector
    from shrimp_tpu_torch.pipeline.options import MapperConfig
    from shrimp_tpu_torch.pipeline.paired import (PAIR_OPP_IN, PairedConfig,
                                                  PairedMapper)
    from shrimp_tpu_torch.utils import synth, telemetry

    t0 = time.time()
    pairs, truth = synth.make_pairs(idx, np.random.default_rng(17),
                                    SIZE_PAIRS)
    gen_secs = time.time() - t0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    pm = PairedMapper(idx, MapperConfig(qual_delta=64,
                                        device_candidates=False),
                      PairedConfig(pair_mode=PAIR_OPP_IN, min_insert_size=50,
                                   max_insert_size=600), device="cuda")
    for _ in pm.map_pair_stream(iter(pairs[:SIZE_PAIR_BATCH]),
                                batch_size=SIZE_PAIR_BATCH):
        pass                                           # warm batch
    torch.cuda.synchronize()
    pm.tel = telemetry.Telemetry(lock=pm._stats_lock)
    coffs = idx.contig_offsets

    def run():
        t0 = time.time()
        res = list(pm.map_pair_stream(iter(pairs),
                                      batch_size=SIZE_PAIR_BATCH))
        torch.cuda.synchronize()
        return res, time.time() - t0

    rec1 = Recorder(sw_vector, "p1_gather_score_ls_cuda",
                    lambda a: a[1].shape[0])
    rec2 = Recorder(sw_full, "sw_full_and_traceback_packed_cuda",
                    lambda a: a[0].shape[0])
    reset_launches()
    with rec1, rec2:
        results, map_secs = run()
    launches = read_launches(("sw_vector", "sw_full"))
    peak = torch.cuda.max_memory_allocated()
    tel = pm.tel
    if len(results) != SIZE_PAIRS:
        raise AssertionError(f"mapped {len(results)} of {SIZE_PAIRS} pairs")
    # benchmarks/bench_grid.py's quality: the top mate-1 placement (best
    # paired hit, else the half-paired mate-1 hit) within 8 bp of truth
    n_pairs_matched = n_correct = 0
    for pi, pr in enumerate(results):
        fh0 = None
        if pr.paired_hits:
            n_pairs_matched += 1
            fh0 = pr.paired_hits[0][0]
        else:
            fh0 = next((fh for side, fh in pr.unpaired_hits if side == 0),
                       None)
        if fh0 is not None:
            gs0 = fh0.g_off + fh0.genome_start
            if fh0.gen_st == 0:
                gpos = int(coffs[fh0.cn]) + gs0
            else:
                clen = int(idx.contig_len[fh0.cn])
                gpos = int(coffs[fh0.cn]) + (clen - gs0) - fh0.gmapped
            n_correct += abs(gpos - truth[pi]) <= 8

    def digest(res):
        return sam_digest([r.line() for pr in res
                           for r in pm.sam_records_pair(pr)])

    sam1 = digest(results)
    del results
    results2, map_secs2 = run()
    sam2 = digest(results2)
    del results2
    if sam1 != sam2:
        raise AssertionError(f"size-paired: two runs differ: {sam1} {sam2}")
    reads_n = 2 * SIZE_PAIRS
    stage_names = ("readparse", "anchor_list", "hit_list", "pass1",
                   "get_vector_hits", "pass2", "pair_up", "hp_pass1",
                   "hp_pass2", "paired_mqv")
    stats = {
        "card": device["name"], "nvidia_smi": device["smi"],
        "genome_bp": int(idx.total_len), "pairs": SIZE_PAIRS,
        "reads": reads_n, "pairs_gen_secs": round(gen_secs, 3),
        "map_secs": round(map_secs, 3),
        "reads_per_sec": round(reads_n / map_secs, 1),
        "map_secs_run2": round(map_secs2, 3),
        "reads_per_sec_run2": round(reads_n / map_secs2, 1),
        "windows_per_read": tel.f1.invocs / reads_n,
        # stage seconds add up over the stream's two worker threads: the
        # pass-2 share is of their sum
        "pass2_share": round(
            sum(tel.stages[k].secs for k in ("pass2", "hp_pass2")
                if k in tel.stages)
            / max(sum(t.secs for t in tel.stages.values()), 1e-9), 4),
        "pairs_matched_frac": round(n_pairs_matched / SIZE_PAIRS, 4),
        "recall_top_pair": round(n_correct / SIZE_PAIRS, 4),
        "stage_secs": {k: round(tel.stages[k].secs, 3) for k in stage_names
                       if k in tel.stages and tel.stages[k].secs},
        "launches": launches,
        "max_memory_allocated": int(peak),
        **sam1, "sam_equal_run2": sam1 == sam2,
    }
    stats["profile"] = profile_map(pm, pairs[:SIZE_PROFILE_PAIRS],
                                   SIZE_PAIR_BATCH)
    log("size-paired: " + json.dumps(stats))
    return stats, {"sw_vector": rec1.args, "sw_full": rec2.args}


def size_cs_index(contigs: list):
    """The colour-space index of the size-cs phases on the same contigs
    (automatic list trim), its 8,192 SOLiD reads with their true starts."""
    from shrimp_tpu_torch import index as gindex
    from shrimp_tpu_torch import seeds as seedmod
    from shrimp_tpu_torch.utils import synth
    t0 = time.time()
    idx = gindex.build_index(contigs, seedmod.make_seed_set(None),
                             colour_space=True)
    max_w = max(s.weight for s in idx.seed_set.seeds)
    idx.trim(max(1000, (100 * idx.total_len) // (4 ** max_w)))
    index_secs = time.time() - t0
    reads, truth = synth.make_cs_reads(idx, np.random.default_rng(23),
                                       SIZE_CS_READS)
    log(f"size-cs: {idx.total_len} bp in {idx.num_contigs} contigs, "
        f"colour-space index {index_secs:.1f} s")
    return idx, reads, truth, index_secs


def phase_size_cs(device: dict, idx, reads, truth,
                  index_secs: float) -> tuple[dict, dict, dict]:
    """The colour-space path at 100 Mbp: map, count launches, check
    quality, and check the first reads against the plain versions."""
    import torch

    from shrimp_tpu_torch.pipeline.options import MapperConfig
    from shrimp_tpu_torch.ops import sw_full_cs, sw_vector
    from shrimp_tpu_torch.pipeline.mapper import Mapper

    cs, _ = _cs_params()

    def cfg():
        return MapperConfig(colour_space=True, params=cs, qual_delta=33,
                            device_candidates=False)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mapper = Mapper(idx, cfg(), device="cuda")
    torch.cuda.synchronize()
    rec1 = Recorder(sw_vector, "p1_gather_score_cs_cuda",
                    lambda a: a[2].shape[0])
    rec2 = Recorder(sw_full_cs, "sw_full_cs_and_traceback_packed_cuda",
                    lambda a: a[0].shape[0])
    reset_launches()
    with rec1, rec2:
        t0 = time.time()
        results = list(mapper.map_stream(iter(reads), SIZE_BATCH))
        torch.cuda.synchronize()
        map_secs = time.time() - t0
    launches = read_launches(("sw_vector_cs", "sw_full_cs"))
    peak = torch.cuda.max_memory_allocated()
    n_done = len(results)
    if n_done != SIZE_CS_READS:
        raise AssertionError(f"mapped {n_done} of {SIZE_CS_READS} reads")
    stats = {
        "card": device["name"], "nvidia_smi": device["smi"],
        "genome_bp": int(idx.total_len), "reads": n_done,
        "index_build_secs": round(index_secs, 3),
        "map_secs": round(map_secs, 3),
        "reads_per_sec": round(n_done / map_secs, 1),
        "windows_per_read": round(mapper.tel.f1.invocs / n_done, 1),
        **top_hit_quality(idx, results, truth),
        "stage_secs": {k: round(v.secs, 3)
                       for k, v in mapper.tel.stages.items() if v.secs},
        "post_sw_secs": round(mapper.tel.fwbw.secs, 3),
        "pass1_windows": mapper.stats["pass1_windows"],
        "pass2_windows": mapper.stats["pass2_windows"],
        "launches": launches,
        "max_memory_allocated": int(peak),
        **sam_digest(_sam_lines(mapper, results)),
    }
    log("size-cs: " + json.dumps(stats))

    first = _sam_lines(mapper, results[:SIZE_CS_PLAIN])
    plain = Mapper(idx, cfg(), device="cpu")
    t0 = time.time()
    again = _sam_lines(plain, plain.map_stream(iter(reads[:SIZE_CS_PLAIN]),
                                               SIZE_CS_PLAIN))
    plain_secs = time.time() - t0
    if again != first:
        raise AssertionError("size-cs: plain versions disagree at SAM line "
                             f"{_first_difference(again, first)}")
    log(f"size-cs: first {SIZE_CS_PLAIN} reads identical through the plain "
        f"versions ({len(first)} SAM lines; plain map {plain_secs:.1f} s on "
        f"the host CPU)")
    return launches, {"sw_vector_cs": rec1.args, "sw_full_cs": rec2.args}, \
        stats


def time_kernels_cs(args: dict, reps: int = 20) -> dict:
    """The colour-space kernels (CUDA events) against their plain versions
    (host clock, CPU tensors) on recorded inputs; outputs must agree."""
    from shrimp_tpu_torch.ops import sw_full_cs, sw_vector
    out = {}
    a = args["sw_vector_cs"]
    got = sw_vector.p1_gather_score_cs_cuda(*a)
    ms = cuda_ms(lambda: sw_vector.p1_gather_score_cs_cuda(*a), reps)
    ca = _cpu(a)
    plain_ms, want = host_ms(
        lambda: sw_vector.p1_gather_score_cs_plain(*ca))
    lo, wlen, rid, ist, initbp, reads2, G = a[2:9]
    out["sw_vector_cs"] = {
        "shape": {"windows": int(lo.shape[0]), "G": int(G),
                  "R": int(reads2.shape[2])},
        "max_abs_err": max_abs_err(got, want), "ms": ms,
        "plain_ms": plain_ms,
        **_gather_bound("sw_vector_cs", (lo, wlen, rid, ist, initbp), wlen,
                        rid, ist, reads2, G, 2, (got,))}
    a = args["sw_full_cs"]
    s_got, o_got = sw_full_cs.sw_full_cs_and_traceback_packed_cuda(*a)
    ms = cuda_ms(
        lambda: sw_full_cs.sw_full_cs_and_traceback_packed_cuda(*a), reps)
    ca = _cpu(a)
    plain_ms, (s_want, o_want) = host_ms(
        lambda: sw_full_cs.sw_full_cs_and_traceback_packed_plain(*ca))
    gb, qr4, xover, rev, bxmin, bxmax = a[:6]
    R, W = int(qr4.shape[2]), int(a[9])
    out["sw_full_cs"] = {
        "shape": {"alignments": int(gb.shape[0]), "G": int(gb.shape[1]),
                  "R": R, "W": W, "taboo_len": int(a[8]),
                  "plan": sw_full_cs.launch_plan(int(gb.shape[1]), R, W)},
        "max_abs_err": max(max_abs_err(s_got, s_want),
                           max_abs_err(o_got, o_want)),
        "ms": ms, "plain_ms": plain_ms,
        "device_ms": device_ms(
            lambda: sw_full_cs.sw_full_cs_and_traceback_packed_cuda(*a), reps),
        **_band_bound("sw_full_cs", (qr4[:, 0].cpu() != READ_PAD).sum(1),
                      bxmin, bxmax, (gb, qr4, xover, rev, bxmin, bxmax),
                      (s_got, o_got))}
    for name, row in out.items():
        if row["max_abs_err"]:
            raise AssertionError(f"{name} disagrees with its plain version: "
                                 f"{row}")
    return out


def time_gapless(a: tuple, cs: bool, reps: int = 20) -> dict:
    """The fused gapless pass 1 (CUDA events, and each call's device work
    behind a spin kernel) against its plain version (host clock, CPU
    tensors) on a recorded call; outputs must agree.  The bound counts
    each hit's framing arrays in and its score out, the genome bytes of
    its columns where both sides are in range (in colour space, where
    column 0 is forced, the letter-plane byte in place of column 0's
    colour byte), the read matrix and the primers once; 8 operations a
    column in range."""
    import torch

    from shrimp_tpu_torch.ops import sw_gapless
    kernel, plain = ((sw_gapless.p1_gather_gapless_cs_cuda,
                      sw_gapless.p1_gather_gapless_cs_plain) if cs else
                     (sw_gapless.p1_gather_gapless_ls_cuda,
                      sw_gapless.p1_gather_gapless_ls_plain))
    got = kernel(*a)
    ms = cuda_ms(lambda: kernel(*a), reps)
    dev_ms = device_ms(lambda: kernel(*a), reps)
    ca = _cpu(a)
    plain_ms, want = host_ms(lambda: plain(*ca))
    if cs:
        _, _, start, glen, r_left, rid, initbp, reads2 = ca[:8]
        per_hit, extra = (start, glen, r_left, rid), (initbp,)
        st = torch.zeros_like(rid)
    else:
        _, start, glen, r_left, rid, st, reads2 = ca[:7]
        per_hit, extra = (start, glen, r_left, rid, st), ()
    N, R = int(start.shape[0]), int(reads2.shape[2])
    diag, rrow = sw_gapless._diagonals(ca[0], start, glen, r_left, rid, st,
                                       reads2)
    in_range = (diag != GENOME_PAD) & (rrow != READ_PAD)
    cells = int(in_range.sum())
    genome_bytes = cells
    if cs and R:
        forced = r_left == 0
        genome_bytes += int((forced & (glen > 0)).sum()) \
            - int((forced & in_range[:, 0]).sum())
    row = {"shape": {"hits": N, "R": R, "reads": int(reads2.shape[0]),
                     "colour_space": cs, "columns_in_range": cells,
                     "genome_bytes": genome_bytes},
           "max_abs_err": max_abs_err(got, want), "ms": ms,
           "device_ms": dev_ms, "plain_ms": plain_ms,
           **bound(_nbytes(*per_hit, got, reads2, *extra) + genome_bytes,
                   OPS_PER_CELL["sw_gapless"] * cells)}
    if row["max_abs_err"]:
        raise AssertionError(f"sw_gapless disagrees with its plain version: "
                             f"{row}")
    return row


# ---------------------------------------------------------------------------
# gapless pass 1 at size (-U --local)
def gapless_cfg(cs: bool, device_candidates: bool):
    """What `gmapper -U --local` sets (gmapper.py, its -U and --local
    options): gapless pass 1, anchor width 0, gap opens of -255, local
    alignment; the colour-space scoring and PHRED+33 in colour space."""
    from shrimp_tpu_torch.ops.params import SWParams
    from shrimp_tpu_torch.pipeline.options import MapperConfig
    params = (_cs_params()[0] if cs else SWParams.letter_space()).with_(
        a_gap_open=-255, b_gap_open=-255)
    return MapperConfig(colour_space=cs, params=params,
                        qual_delta=33 if cs else 64, gapless=True,
                        anchor_width=0, global_alignment=False,
                        device_candidates=device_candidates)


class Pass1Split:
    """Wall seconds a Mapper spends in its pass-1 dispatch (the host
    framing, the copies in and the launch), apart from the rest of its
    `pass1` stage."""

    def __init__(self, mapper):
        self.mapper, self.secs = mapper, 0.0

    def __enter__(self):
        orig = self.mapper._pass1_dispatch

        def timed(*args, **kw):
            t0 = time.time()
            try:
                return orig(*args, **kw)
            finally:
                self.secs += time.time() - t0

        self.mapper._pass1_dispatch = timed
        return self

    def __exit__(self, *exc):
        del self.mapper._pass1_dispatch


# the gapless pass 1's wrapper by space, and the hit count of its arguments
GAPLESS_WRAPPERS = {False: ("p1_gather_gapless_ls_cuda",
                            lambda a: a[1].shape[0]),
                    True: ("p1_gather_gapless_cs_cuda",
                           lambda a: a[2].shape[0])}


def phase_size_gapless(name: str, device: dict, idx, reads, truth, cs: bool,
                       n_plain: int, dev_l3=None) -> tuple[dict, tuple, dict]:
    """-U --local at 100 Mbp on a size phase's index and reads (device
    candidates on `dev_l3`, the postings already resident, when given):
    map every read; the `pass1` stage split into the dispatch (host
    framing, copies in, launch), the wait for the scores and the finish;
    launches, peak memory, top-hit quality, the SAM lines' digest; then
    the first `n_plain` reads again through the plain versions, SAM lines
    identical.  Returns the launches, the largest gapless call's
    arguments and the stats."""
    import torch

    from shrimp_tpu_torch.ops import sw_gapless
    from shrimp_tpu_torch.pipeline.mapper import Mapper

    on_card = dev_l3 is not None
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mapper = Mapper(idx, gapless_cfg(cs, on_card), device="cuda")
    if on_card:
        mapper._dev_l3 = dev_l3
    torch.cuda.synchronize()
    rec = Recorder(sw_gapless, *GAPLESS_WRAPPERS[cs])
    split = Pass1Split(mapper)
    reset_launches()
    with rec, split:
        t0 = time.time()
        results = list(mapper.map_stream(iter(reads), SIZE_BATCH))
        torch.cuda.synchronize()
        map_secs = time.time() - t0
    launches = read_launches(
        ("sw_gapless", "sw_full_cs") if cs else
        ("sw_gapless", "candidates_device", "sw_full") if on_card else
        ("sw_gapless", "sw_full"))
    peak = torch.cuda.max_memory_allocated()
    n_done = len(results)
    if n_done != len(reads):
        raise AssertionError(f"{name}: mapped {n_done} of {len(reads)} reads")
    if mapper.stats["device_l3_fallbacks"]:
        raise AssertionError(f"{name}: batches fell back to host candidates")
    stage = {k: round(v.secs, 3) for k, v in mapper.tel.stages.items()
             if v.secs}
    pass1 = mapper.tel.stages["pass1"].secs
    wait = mapper.tel.f1.secs
    lines = _sam_lines(mapper, results)
    stats = {
        "card": device["name"], "nvidia_smi": device["smi"],
        "genome_bp": int(idx.total_len), "reads": n_done,
        "map_secs": round(map_secs, 3),
        "reads_per_sec": round(n_done / map_secs, 1),
        "windows_per_read": mapper.tel.f1.invocs / n_done,
        **top_hit_quality(idx, results, truth),
        "stage_secs": stage,
        "pass1_split_secs": {"dispatch": round(split.secs, 3),
                             "result_wait": round(wait, 3),
                             "finish": round(pass1 - split.secs - wait, 3)},
        "pass1_windows": mapper.stats["pass1_windows"],
        "pass2_windows": mapper.stats["pass2_windows"],
        "launches": launches,
        "max_memory_allocated": int(peak),
        **sam_digest(lines),
    }
    log(f"{name}: " + json.dumps(stats))

    first = _sam_lines(mapper, results[:n_plain])
    del mapper
    plain = Mapper(idx, gapless_cfg(cs, on_card), device="cpu")
    t0 = time.time()
    again = _sam_lines(plain, plain.map_stream(iter(reads[:n_plain]),
                                               SIZE_BATCH))
    plain_secs = time.time() - t0
    if again != first:
        raise AssertionError(f"{name}: plain versions disagree at SAM line "
                             f"{_first_difference(again, first)}")
    log(f"{name}: first {n_plain} reads identical through the plain "
        f"versions ({len(first)} SAM lines; plain map {plain_secs:.1f} s on "
        "the host CPU)")
    return launches, rec.args, stats


# ---------------------------------------------------------------------------
# on-device candidate generation (K10)
def _l3_corpus(seed: int, n_contigs: int = 3, contig_len: int = 60_000,
               n_reads: int = 256, read_len: int = 50,
               use_hashing: bool = False, repeat: int = 0):
    """A random genome's index (the port's), and the read entries of
    reads drawn from it with up to two substitutions, from both strands.
    With `repeat`, that many more copies of one 2 kb stretch, and every
    fourth read drawn from it (thousands of postings per read)."""
    from shrimp_tpu_torch import dna
    from shrimp_tpu_torch import index as gindex
    from shrimp_tpu_torch import seeds as seedmod
    from shrimp_tpu_torch.io import fastx
    from shrimp_tpu_torch.pipeline import candidates as cand
    from shrimp_tpu_torch.pipeline.options import MapperConfig
    rng = np.random.default_rng(seed)
    contigs = [rng.integers(0, 4, contig_len).astype(np.int8)
               for _ in range(n_contigs)]
    if repeat:
        unit = contigs[0][:2000].copy()
        for k in range(repeat):
            p = int(rng.integers(2000, contig_len - 2000))
            contigs[k % n_contigs][p:p + 2000] = unit
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
    return idx, cfg, cand.prepare_reads(reads, cfg, idx.seed_set.min_span)


def _l3_call(idx, cfg, entries, st: int, *, threshold: float = 55.0,
             match_mode: int = 2, gapless: bool = False,
             use_regions: bool = False, collapse: bool = True,
             list_cutoff: int = 0x7FFFFFFF, a_cap: int = 1 << 21,
             **extra) -> tuple[tuple, dict]:
    """device_candidates' arguments for one strand of `entries`, built as
    Mapper._candidates_device builds them."""
    from shrimp_tpu_torch.pipeline import candidates_batch as cb
    B = len(entries)
    R = -(-max(e.read_len for e in entries) // 16) * 16
    codes = np.zeros((B, R), np.int8)
    rlen, minpos, wlen, thr = (np.zeros(B, np.int32) for _ in range(4))
    p = cfg.params
    for b, e in enumerate(entries):
        codes[b, :e.read_len] = e.read[st]
        rlen[b] = e.read_len
        minpos[b] = e.min_kmer_pos
        wlen[b] = e.window_len
        if threshold >= 0:
            thr[b] = int(min(e.read_len, e.window_len) * p.match
                         * (threshold / 100.0))
    kw = dict(a_cap=a_cap, a2_cap=extra.pop("a2_cap", 1 << 17),
              h_cap=extra.pop("h_cap", 1 << 18),
              n_regions=(idx.total_len >> cb.REGION_BITS) + 1,
              use_region_counts=use_regions, region_bits=cb.REGION_BITS,
              region_overlap=cb.REGION_OVERLAP, collapse=collapse,
              gapless=gapless, match_mode=match_mode, threshold=threshold,
              match=p.match, b_gap_open=p.b_gap_open,
              b_gap_extend=p.b_gap_extend, list_cutoff=list_cutoff,
              num_contigs=idx.num_contigs, **extra)
    return (codes, rlen, minpos, wlen, thr), kw


def _l3_err(got: dict, want: dict) -> int:
    """The largest difference over every output of device_candidates."""
    import torch
    if set(got) != set(want):
        raise AssertionError(f"outputs differ: {sorted(got)} vs "
                             f"{sorted(want)}")
    return max(max_abs_err(torch.as_tensor(got[k]), torch.as_tensor(want[k]))
               for k in want)


# name -> (_l3_corpus kwargs, strands, _l3_call kwargs)
L3_CASES = {
    "dense regions": ({"seed": 3}, (0, 1), {"use_regions": True}),
    "sparse regions": ({"seed": 23}, (0, 1),
                       {"use_regions": True, "dense_region_cap": 0}),
    "no region counts": ({"seed": 5}, (0,), {}),
    "collapse off": ({"seed": 29}, (0,),
                     {"use_regions": True, "collapse": False}),
    "-H hashing": ({"seed": 5, "use_hashing": True}, (0, 1),
                   {"use_regions": True}),
    "gapless": ({"seed": 11}, (0,), {"match_mode": 1, "gapless": True}),
    "match mode 1": ({"seed": 9}, (1,), {"match_mode": 1}),
    "list cut-off": ({"seed": 17, "contig_len": 8_000}, (0,),
                     {"list_cutoff": 2}),
    "absolute threshold": ({"seed": 37}, (0,),
                           {"use_regions": True, "threshold": -300.0}),
    "forced overflow": ({"seed": 13}, (0,), {"a_cap": 256}),
    "a2_cap cut": ({"seed": 7}, (0,), {"use_regions": True, "a2_cap": 300}),
    "h_cap cut": ({"seed": 19}, (0,), {"h_cap": 40}),
    "global tier": ({"seed": 41, "repeat": 100, "contig_len": 200_000,
                     "n_reads": 64}, (0, 1), {"use_regions": True}),
    # 950-base reads: the rows' offsets alone take 34 KB of shared memory
    "long reads": ({"seed": 43, "read_len": 950, "n_reads": 32}, (0, 1),
                   {"use_regions": True}),
}
# the cases cut at a capacity, which must report an overflow
L3_CUT = ("forced overflow", "a2_cap cut", "h_cap cut")


def phase_kernels_l3() -> None:
    """K10 on the card against its plain version, every output exact."""
    from shrimp_tpu_torch.ops import candidates_device as cdv
    n = 0
    for name, (corpus_kw, strands, call_kw) in L3_CASES.items():
        idx, cfg, entries = _l3_corpus(**corpus_kw)
        dev = cdv.DeviceL3Index.from_host(idx, "cuda")
        dev_cpu = cdv.DeviceL3Index.from_host(idx, "cpu")
        for st in strands:
            args, kw = _l3_call(idx, cfg, entries, st, **call_kw)
            tier = cdv.GLOBAL_TIER_READS.value
            got = cdv.device_candidates(*args, dev, **kw)
            tier = cdv.GLOBAL_TIER_READS.value - tier
            want = cdv.device_candidates(*args, dev_cpu, **kw)
            err = _l3_err(got, want)
            if err:
                raise AssertionError(f"candidates_device {name} strand {st}: "
                                     f"err {err}")
            if bool(got["overflow"]) != (name in L3_CUT) or \
                    int(got["n"]) == 0:
                raise AssertionError(f"candidates_device {name}: overflow "
                                     f"{bool(got['overflow'])}, "
                                     f"{int(got['n'])} windows")
            if (tier > 0) != (name == "global tier"):
                raise AssertionError(f"candidates_device {name}: {tier} "
                                     "reads in the global-memory tier")
            if tier:
                log(f"kernels: candidates_device {name} strand {st}: {tier} "
                    "reads through the global-memory tier")
            n += 1
    log(f"kernels: candidates_device equal to its plain version in {n} "
        "cases")


def phase_goldens_l3() -> dict:
    """golden_unpaired, med_ls and golden_cs with device_candidates=True,
    byte-exact; returns the K10 launches."""
    import torch

    from shrimp_tpu_torch import index as gindex
    from shrimp_tpu_torch.io import fastx
    from shrimp_tpu_torch.ops.params import SWParams
    from shrimp_tpu_torch.pipeline.mapper import Mapper
    from shrimp_tpu_torch.pipeline.options import MapperConfig
    cs, _ = _cs_params()
    reset_launches()
    for genome, reads, gold, colour in (
            ("golden_genome.fa", "golden_reads.fq", "golden_unpaired.sam",
             False),
            ("med_genome.fa", "med_reads.fq", "med_ls.sam", False),
            ("golden_genome.fa", "golden_reads_cs.fq", "golden_cs.sam",
             True)):
        idx = gindex.build_index(
            list(fastx.iter_contigs(os.path.join(GOLDEN, genome))),
            colour_space=colour)
        cfg = MapperConfig(
            colour_space=colour,
            params=cs if colour else SWParams.letter_space(),
            qual_delta=33 if colour else 64, device_candidates=True)
        m = Mapper(idx, cfg, device="cuda")
        recs = [(r.name, r.seq, r.qual) for r in
                fastx.iter_reads(os.path.join(GOLDEN, reads))]
        lines = _sam_lines(m, m.map_batch(recs))
        _check_lines(lines, gold)
        if m._dev_l3 is None or m.stats["device_l3_fallbacks"]:
            raise AssertionError(f"{gold}: candidates did not stay on the "
                                 f"card ({m.stats['device_l3_fallbacks']} "
                                 "fallbacks)")
        log(f"goldens-l3: {gold} byte-equal with device candidates "
            f"({len(lines)} lines)")
    torch.cuda.synchronize()
    launches = read_launches(("candidates_device", "sw_vector", "sw_full",
                              "sw_vector_cs", "sw_full_cs"))
    log("goldens-l3: launches " + json.dumps(launches))
    return launches


def phase_size_l3(device: dict, idx, reads, size_stats: dict,
                  size_lines: list) -> tuple[dict, dict, dict, object]:
    """The size phase's index and reads with device_candidates=True: SAM
    lines and windows/read equal to the host-candidate run's; then what
    "auto" chooses on the first two batches.  Returns the launches, the
    recorded largest K10 call, the stats, and the resident postings."""
    import torch

    from shrimp_tpu_torch.ops import candidates_device as cdv
    from shrimp_tpu_torch.pipeline.mapper import Mapper
    from shrimp_tpu_torch.pipeline.options import MapperConfig

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mapper = Mapper(idx, MapperConfig(qual_delta=64, device_candidates=True),
                    device="cuda")
    torch.cuda.synchronize()
    t0 = time.time()
    mapper._dev_l3 = cdv.DeviceL3Index.from_host(idx, "cuda")
    torch.cuda.synchronize()
    ship_secs = time.time() - t0
    ship_bytes = _nbytes(mapper._dev_l3.positions, *mapper._dev_l3.offsets)
    rec = Recorder(cdv, "device_candidates_cuda", lambda a: a[0].shape[0],
                   last=True)
    reset_launches()
    cdv.GLOBAL_TIER_READS.reset()
    with rec:
        t0 = time.time()
        results = list(mapper.map_stream(iter(reads), SIZE_BATCH))
        torch.cuda.synchronize()
        map_secs = time.time() - t0
    launches = read_launches(("candidates_device", "sw_vector", "sw_full"))
    peak = torch.cuda.max_memory_allocated()
    n_done = len(results)
    lines = _sam_lines(mapper, results)
    if lines != size_lines:
        raise AssertionError("size-l3: SAM differs from the host-candidate "
                             f"run at line {_first_difference(lines, size_lines)}"
                             f" ({len(lines)} vs {len(size_lines)} lines)")
    wpr = mapper.tel.f1.invocs / n_done
    if wpr != size_stats["windows_per_read"]:
        raise AssertionError(f"size-l3: {wpr} windows/read, the host run "
                             f"{size_stats['windows_per_read']}")
    if mapper.stats["device_l3_fallbacks"]:
        raise AssertionError("size-l3: batches fell back to host candidates")
    stage = {k: round(v.secs, 3) for k, v in mapper.tel.stages.items()
             if v.secs}
    host_stage = size_stats["stage_secs"]
    stats = {
        "card": device["name"], "nvidia_smi": device["smi"],
        "reads": n_done, "map_secs": round(map_secs, 3),
        "reads_per_sec": round(n_done / map_secs, 1),
        "reads_per_sec_host_candidates": size_stats["reads_per_sec"],
        "windows_per_read": wpr,
        "anchor_list_secs": stage.get("anchor_list", 0.0),
        "hit_list_secs": stage.get("hit_list", 0.0),
        "anchor_list_secs_host": host_stage.get("anchor_list", 0.0),
        "hit_list_secs_host": host_stage.get("hit_list", 0.0),
        "stage_secs": stage,
        "ship_bytes": ship_bytes, "ship_secs": round(ship_secs, 3),
        "max_memory_allocated": int(peak),
        "launches": launches,
        "a_cap": [Mapper.DEVICE_L3_A_CAP, mapper._dev_l3_a_cap],
        "a2_cap": [Mapper.DEVICE_L3_A2_CAP, mapper._dev_l3_a2_cap],
        "device_l3_fallbacks": mapper.stats["device_l3_fallbacks"],
        # reads that K10's per-read kernels took in their global tier
        "k10_global_tier_reads": cdv.GLOBAL_TIER_READS.value,
    }
    stats.update(k10_syncs(mapper, reads[:2 * SIZE_BATCH]))
    # K10's device planes: the largest, against the dense (read, region)
    # table of int32 that a per-region count would take
    table = 4 * SIZE_BATCH * ((idx.total_len >> 11) + 1)
    stats["k10_largest_plane_bytes"] = mapper._dev_l3_ws.largest_bytes()
    stats["k10_region_table_bytes"] = table
    if stats["k10_largest_plane_bytes"] >= table:
        raise AssertionError("size-l3: K10 holds a plane as large as a "
                             "(read, region) table")
    log("size-l3: " + json.dumps(stats))
    log(f"size-l3: {len(lines)} SAM lines and {wpr} windows/read equal to "
        "the host-candidate run's")
    log("size-l3: profile " + json.dumps(
        profile_map(mapper, reads[:SIZE_PROFILE_READS], SIZE_BATCH)))
    caps = {"a_cap": mapper._dev_l3_a_cap, "a2_cap": mapper._dev_l3_a2_cap}
    dev_l3 = mapper._dev_l3
    del mapper
    torch.cuda.empty_cache()

    # the default, "auto", on the first two batches
    auto = Mapper(idx, MapperConfig(qual_delta=64), device="cuda")
    n_auto = 2 * SIZE_BATCH
    got = _sam_lines(auto, auto.map_stream(iter(reads[:n_auto]), SIZE_BATCH))
    want = _sam_lines(auto, results[:n_auto])
    if got != want:
        raise AssertionError("size-l3: \"auto\" differs from the host run "
                             f"at SAM line {_first_difference(got, want)}")
    log("size-l3: auto chose " + json.dumps(
        {"l3_choice": auto._l3_choice, "l3_reason": auto._l3_reason,
         "model": auto._l3_model,
         "device_l3_fallbacks": auto.stats["device_l3_fallbacks"]}))
    del auto
    torch.cuda.empty_cache()
    return (launches, {"args": rec.args, "kw": {**rec.kw, **caps}}, stats,
            dev_l3)


def k10_syncs(mapper, reads: list) -> dict:
    """Host synchronisations per K10 strand call: `reads` mapped again
    with torch's sync debug mode on inside the Mapper's device-candidate
    step only (its kernels' counters read-back and the copy of the
    windows out), against the strand calls made there."""
    import warnings

    import torch

    from shrimp_tpu_torch.ops import candidates_device as cdv
    orig = mapper._candidates_device
    n = {"syncs": 0, "calls": 0}

    def counted(entries, opts):
        calls = cdv.LAUNCHES.value
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as rec:
                warnings.simplefilter("always")
                out = orig(entries, opts)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        n["syncs"] += sum("synchroniz" in str(w.message) for w in rec)
        n["calls"] += cdv.LAUNCHES.value - calls
        return out

    mapper._candidates_device = counted
    try:
        for _ in mapper.map_stream(iter(reads), SIZE_BATCH):
            pass
    finally:
        del mapper._candidates_device
    per_call = n["syncs"] / max(n["calls"], 1)
    if n["calls"] == 0 or per_call > 2:
        raise AssertionError(f"K10: {n['syncs']} host syncs in {n['calls']} "
                             "strand calls")
    return {"k10_strand_calls": n["calls"], "k10_host_syncs": n["syncs"],
            "k10_host_syncs_per_strand_call": per_call}


def device_span(fn) -> dict:
    """One call of `fn` under torch.profiler: the milliseconds from its
    first kernel's start to its last one's end (the host's time before
    the first is not in it), and each kernel's and copy's device
    milliseconds."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name: dict = {}
    for e in ev:
        key = (e.name.replace("(anonymous namespace)::", "")
               .replace("void ", "").split("(")[0])[:48]
        by_name[key] = round(by_name.get(key, 0.0) + (e.time_range.end
                                                      - e.time_range.start)
                             / 1e3, 4)
    kern = [e for e in ev if not e.name.startswith("Memcpy")]
    span = (max(e.time_range.end for e in kern)
            - min(e.time_range.start for e in kern)) / 1e3 if kern else None
    return {"device_span_ms": span, "device_ms_by_kernel": by_name}


def time_kernels_l3(rec: dict, idx, reps: int = 5) -> dict:
    """K10 (CUDA events) against its plain version (host clock, a CPU
    index) on the largest recorded main-path call; outputs must agree."""
    from shrimp_tpu_torch.ops import candidates_device as cdv
    import torch
    args, kw = rec["args"], rec["kw"]
    got = cdv.device_candidates_cuda(*args, **kw)
    ms = cuda_ms(lambda: cdv.device_candidates_cuda(*args, **kw), reps)
    dev_cpu = cdv.DeviceL3Index.from_host(idx, "cpu")
    ca = [torch.as_tensor(a).cpu() for a in args[:5]]
    kw_plain = {k: v for k, v in kw.items() if k != "workspace"}
    plain_ms, want = host_ms(
        lambda: cdv.device_candidates_plain(*ca, dev_cpu, **kw_plain))
    del dev_cpu
    err = _l3_err(got, want)
    codes, rlen = ca[0], ca[1]
    dev = args[5]
    B, R = codes.shape
    total, n = int(got["n_total"]), int(got["n"])
    # valid (read, k-mer) rows of every seed: one offsets pair each
    rl = rlen.long()
    mp = ca[2].long()
    seed_rows = [int((rl - mp - span + 1).clamp(0, R - span + 1).sum())
                 for span in dev.spans]
    rows = sum(seed_rows)
    # in: codes, four int32 per read, two offsets per row, each posting;
    # out: the emitted windows' 11 int32 columns and emit flag
    nbytes = codes.numel() + 16 * B + 8 * rows + 4 * total + 45 * n
    # per row the k-mer id (3 per seed position) and list bounds (6); per
    # posting expansion and region key (6); per survivor the collapse and
    # pairing arithmetic (40, the scan's steps not counted)
    ops = (sum(3 * len(o) * r for o, r in zip(dev.ones, seed_rows))
           + 6 * rows + 6 * total + 40 * int(got["n_survivors"]))
    # per read: postings under a_cap and survivors under a2_cap (the
    # workspace's read offsets), which pick K10's tiers
    ws = kw["workspace"]
    per_read = {}
    for name, plane in (("postings_per_read", "kbase"),
                        ("survivors_per_read", "abase")):
        v = np.diff(ws.get(plane, B + 1, torch.int64, dev.device)
                    .cpu().numpy())
        per_read[name] = {"median": float(np.median(v)),
                          "p99": float(np.percentile(v, 99)),
                          "max": int(v.max())}
    out = {"candidates_device": {
        "shape": {"reads": B, "R": R, "postings": total,
                  "survivors": int(got["n_survivors"]), "windows": n,
                  "a_cap": kw["a_cap"], "a2_cap": kw["a2_cap"],
                  **per_read},
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        **bound(nbytes, ops),
        **device_span(lambda: cdv.device_candidates_cuda(*args, **kw))}}
    if err or bool(got["overflow"]):
        raise AssertionError(f"candidates_device on main-path inputs: "
                             f"{out}, overflow {bool(got['overflow'])}")
    return out


def golden_worker(names: list[str]) -> int:
    """`chip_smoke.py --golden-worker NAME...`: the named goldens of
    utils/golden_cli.py through the CLI on the card (phase_goldens_paired
    starts two of these)."""
    import tempfile

    from shrimp_tpu_torch.utils import golden_cli
    cases = {**golden_cli.LEGACY, **golden_cli.UNPAIRED,
             **golden_cli.UNPAIRED_CS}
    with tempfile.TemporaryDirectory() as tmpdir:
        _run_goldens({n: cases[n] for n in names}, tmpdir)
    return 0


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        sys.stderr.write("chip_smoke: no CUDA device; nothing to run\n")
        return 2
    sys.path.insert(0, REPO)
    import shrimp_tpu_torch  # noqa: F401  (fails outside the repo)
    if sys.argv[1:2] == ["--golden-worker"]:
        return golden_worker(sys.argv[2:])

    t_all = time.time()
    device = phase_device()
    phase_build()
    phase_kernels()
    phase_kernels_cs()
    phase_kernels_l3()
    golden_args = phase_goldens()
    golden_times = time_kernels(golden_args)
    log("kernel times at golden shapes (" + device["smi"] + "): "
        + json.dumps(golden_times))
    _, golden_cs_args = phase_goldens_cs()
    log("colour-space and gapless kernel times at golden shapes ("
        + device["smi"] + "): "
        + json.dumps({**time_kernels_cs(golden_cs_args),
                      "sw_gapless": time_gapless(golden_cs_args["sw_gapless"],
                                                 cs=False)}))
    l3_golden_launches = phase_goldens_l3()
    phase_goldens_paired()
    contigs, gen_secs = size_contigs()
    idx, reads, truth, index_secs = size_index(contigs, gen_secs)
    launches, size_args, size_stats, size_lines = phase_size(
        device, idx, reads, truth, index_secs)
    size_times = time_kernels(size_args)
    log("kernel times at 100 Mbp main-path shapes (" + device["smi"]
        + "): " + json.dumps(size_times))
    del size_args
    launches_l3, l3_rec, _, dev_l3 = phase_size_l3(
        device, idx, reads, size_stats, size_lines)
    size_times.update(time_kernels_l3(l3_rec, idx))
    log("candidates_device time at 100 Mbp main-path shapes ("
        + device["smi"] + "): "
        + json.dumps(size_times["candidates_device"]))
    del l3_rec, size_lines
    launches_gl, gl_args, _ = phase_size_gapless(
        "size-gapless", device, idx, reads, truth, False, SIZE_BATCH, dev_l3)
    size_times["sw_gapless"] = time_gapless(gl_args, cs=False)
    log("sw_gapless time at 100 Mbp size-gapless shapes (" + device["smi"]
        + "): " + json.dumps(size_times["sw_gapless"]))
    del gl_args, dev_l3, reads
    _, paired_args = phase_size_paired(device, idx)
    log("kernel times at 100 Mbp size-paired shapes (" + device["smi"]
        + "): " + json.dumps(time_kernels(paired_args)))
    del paired_args, idx
    cs_idx, cs_reads, cs_truth, cs_index_secs = size_cs_index(contigs)
    launches_cs, size_cs_args, _ = phase_size_cs(
        device, cs_idx, cs_reads, cs_truth, cs_index_secs)
    size_times.update(time_kernels_cs(size_cs_args))
    log("colour-space kernel times at 100 Mbp main-path shapes ("
        + device["smi"] + "): "
        + json.dumps({k: size_times[k] for k in size_cs_args}))
    del size_cs_args
    _, cs_gl_args, _ = phase_size_gapless(
        "size-cs-gapless", device, cs_idx, cs_reads, cs_truth, True,
        SIZE_CS_PLAIN)
    log("sw_gapless time at 100 Mbp size-cs-gapless shapes ("
        + device["smi"] + "): "
        + json.dumps(time_gapless(cs_gl_args, cs=True)))
    del cs_gl_args
    launches.update(launches_cs)
    launches["sw_gapless"] = launches_gl["sw_gapless"]
    launches["candidates_device"] = launches_l3["candidates_device"]
    log("candidates_device launches: goldens-l3 "
        f"{l3_golden_launches['candidates_device']}, size-l3 "
        f"{launches['candidates_device']}")
    log(f"total: {time.time() - t_all:.1f} s")
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", **KERNELS[name],
         "launches": launches[name],
         **{k: size_times[name][k] for k in keys},
         "library_ms": None}
        for name in KERNELS]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device["name"],
        "count": device["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
