#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (`shrimp_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Phases, each a function; any failure raises and the script exits
nonzero.  There is no CPU path: without a CUDA device it stops at once.

  1. device   the card's name and power limit (nvidia-smi)
  2. build    nvcc builds the four kernels from csrc/ (sm_90a), one
              nvcc process per source, all started together
  3. kernels  each kernel against its plain PyTorch version on random
              inputs (pads, asymmetric gaps, row-0 plane, local/glocal,
              revcmpl, the goldens' band shapes, a wide-jump band; in
              colour space also per-row crossovers, indel taboo, N
              codes, a band jumping past the shift clip and the full
              band; gapless with and without the s0 override); integer
              outputs must be exactly equal
  4. goldens  golden_unpaired / golden_long_reads / med_ls, then
              golden_cs / med_cs, mapped through the kernels, and the
              gapless golden_cs_mirna / golden_cs_ungapped /
              golden_ungapped / golden_mirna through the gmapper CLI on
              the card, byte-equal to the reference SAM
  5. size     the main path at a real size: bench.py's generator at
              100 Mbp (C. elegans class), 16,384 mutated 50 bp reads
              through Mapper.map_stream in batches of 2,048, the genome
              plane resident on the card; launch counts of that run;
              then the first 2,048 reads again through the plain
              versions (CPU tensors), SAM lines identical; then each
              kernel timed against its plain version on the inputs of
              the main path's largest launch
  6. size-cs  the colour-space path on the same contigs: a colour-space
              index, 8,192 SOLiD reads of benchmarks/bench_grid.py
              (seed 23, 50 bp) in batches of 2,048, the fw||rc colour
              and letter planes resident on the card; launch counts; the
              first 1,024 reads again through the plain versions; each
              new kernel timed against its plain version (the gapless
              kernel on a random batch of the largest pass-1 launch)

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

# the JAX package's import hook would create its compile-cache directory
# under $HOME; the port needs no JAX at all
os.environ.setdefault("SHRIMP_TPU_NO_COMPILE_CACHE", "1")

import numpy as np  # noqa: E402

REPO = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(REPO, "tests", "golden")
SIZE_GENOME_BP = 100_000_000
SIZE_READS = 16_384
SIZE_BATCH = 2_048
SIZE_CS_READS = 8_192
SIZE_CS_PLAIN = 1_024

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
}


def launch_counters() -> dict:
    """Each kernel's launch counter, by the names of KERNELS."""
    from shrimp_tpu_torch.ops import sw_full, sw_full_cs, sw_gapless, sw_vector
    return {"sw_vector": sw_vector.LAUNCHES,
            "sw_vector_cs": sw_vector.CS_LAUNCHES,
            "sw_full": sw_full.LAUNCHES, "sw_full_cs": sw_full_cs.LAUNCHES,
            "sw_gapless": sw_gapless.LAUNCHES}


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
    arguments of its largest call (by rows), then calls it unchanged."""

    def __init__(self, module, name: str, rows):
        self.module, self.name, self.rows = module, name, rows
        self.args = None
        self.best = -1

    def __enter__(self):
        orig = self.orig = getattr(self.module, self.name)

        def wrapper(*args):
            n = self.rows(args)
            if n > self.best:
                self.best, self.args = n, args
            return orig(*args)

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


def host_ms(fn) -> tuple[float, object]:
    t0 = time.perf_counter()
    out = fn()
    return (time.perf_counter() - t0) * 1e3, out


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
    from shrimp_tpu_torch.ops import sw_full, sw_full_cs, sw_gapless, sw_vector
    t0 = time.time()
    mods = (sw_vector, sw_full, sw_full_cs, sw_gapless)
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

    from shrimp_tpu.ops.params import SWParams
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
    torch.cuda.synchronize()
    log(f"kernels: sw_vector equal to its plain version in {n} cases")

    # pass 2: the goldens' call shapes (B, G, R, read length, W), the
    # full band (W = round_up(G, 32)), and a wide-jump band
    n = 0
    shapes = [(256, 128, 56, 50, 64), (128, 640, 408, 400, 192),
              (512, 128, 80, 70, 64), (64, 128, 56, 50, 128)]
    for B, G, R, rlen, W in shapes:
        for loc in (True, False):
            gb, rb, rev, bxmin, bxmax = _pass2_case(rng, B, G, R, rlen, W)
            if W >= G:
                glen = (gb >= 0).sum(axis=1)
                bxmin = np.zeros((B, R), np.int32)
                bxmax = np.broadcast_to((glen - 1).astype(np.int32)[:, None],
                                        (B, R)).copy()
            _check_pass2(gb, rb, rev, bxmin, bxmax, loc, W,
                         f"B={B} G={G} R={R} W={W} local={loc}")
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


def _check_pass2(gb, rb, rev, bxmin, bxmax, loc, W, what) -> None:
    import torch

    from shrimp_tpu.ops.params import SWParams
    from shrimp_tpu_torch.ops import sw_full
    cuda = torch.device("cuda", 0)
    args = [torch.from_numpy(np.ascontiguousarray(a))
            for a in (gb, rb, rev, bxmin, bxmax)]
    p = SWParams.letter_space()
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


def phase_goldens() -> dict:
    """The three letter-space goldens through the kernels, byte-exact."""
    import torch

    from shrimp_tpu import index as gindex
    from shrimp_tpu.io import fastx
    from shrimp_tpu.pipeline.options import MapperConfig
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
    """bench.py's 100 Mbp genome (seed 20260817), shared by both size
    phases, and the seconds it took to make."""
    import bench
    from shrimp_tpu.io import fastx
    bench.GENOME_BP = SIZE_GENOME_BP
    t0 = time.time()
    chroms = bench.make_genome(np.random.default_rng(20260817))
    contigs = [fastx.Contig(name=f"chr{i + 1}", codes=g)
               for i, g in enumerate(chroms)]
    return contigs, time.time() - t0


def top_hit_quality(idx, results, truth) -> dict:
    """matched / recall / precision of the top hit, true when its SAM
    position is within 8 bp of the generator's (bench_grid.run_cs)."""
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


def phase_size(device: dict, contigs: list,
               gen_secs: float) -> tuple[dict, dict, dict]:
    """The main path at 100 Mbp: map, count launches, check quality, and
    check the first batch against the plain versions."""
    import torch

    import bench
    from shrimp_tpu import index as gindex
    from shrimp_tpu import seeds as seedmod
    from shrimp_tpu.pipeline.options import MapperConfig
    from shrimp_tpu_torch.ops import sw_full, sw_vector
    from shrimp_tpu_torch.pipeline.mapper import Mapper

    card = {"card": device["name"], "nvidia_smi": device["smi"]}
    t0 = time.time()
    idx = gindex.build_index(contigs, seedmod.make_seed_set(None))
    max_w = max(s.weight for s in idx.seed_set.seeds)
    idx.trim(max(1000, (100 * idx.total_len) // (4 ** max_w)))
    index_secs = time.time() - t0
    reads, truth = bench.make_reads(idx, np.random.default_rng(7),
                                    SIZE_READS)
    log(f"size: {idx.total_len} bp in {idx.num_contigs} contigs, genome "
        f"{gen_secs:.1f} s, index {index_secs:.1f} s")

    torch.cuda.reset_peak_memory_stats()
    mapper = Mapper(idx, MapperConfig(qual_delta=64), device="cuda")
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
        **card,
        "genome_bp": int(idx.total_len), "reads": n_done,
        "index_build_secs": round(index_secs, 3),
        "map_secs": round(map_secs, 3),
        "reads_per_sec": round(n_done / map_secs, 1),
        "windows_per_read": round(mapper.tel.f1.invocs / n_done, 1),
        **top_hit_quality(idx, results, truth),
        "stage_secs": {k: round(v.secs, 3)
                       for k, v in mapper.tel.stages.items() if v.secs},
        "pass1_windows": mapper.stats["pass1_windows"],
        "pass2_windows": mapper.stats["pass2_windows"],
        "launches": launches,
        "max_memory_allocated": int(peak),
    }
    log("size: " + json.dumps(stats))

    # the first batch again through the plain versions (CPU tensors)
    first = _sam_lines(mapper, results[:SIZE_BATCH])
    plain = Mapper(idx, MapperConfig(qual_delta=64), device="cpu")
    t0 = time.time()
    again = _sam_lines(plain, plain.map_stream(iter(reads[:SIZE_BATCH]),
                                               SIZE_BATCH))
    plain_secs = time.time() - t0
    if again != first:
        i = next((k for k, (a, b) in enumerate(zip(again, first))
                  if a != b), min(len(again), len(first)))
        raise AssertionError(f"plain versions disagree at SAM line {i}")
    log(f"size: first {SIZE_BATCH} reads identical through the plain "
        f"versions ({len(first)} SAM lines; plain map {plain_secs:.1f} s on "
        f"the host CPU)")
    return launches, {"sw_vector": rec1.args, "sw_full": rec2.args}, stats


def time_kernels(args: dict, reps: int = 20) -> dict:
    """Kernel (CUDA events) against plain version (host clock, CPU
    tensors) on recorded main-path inputs; outputs must agree."""
    import torch

    from shrimp_tpu_torch.ops import sw_full, sw_vector
    out = {}
    a = args["sw_vector"]
    got = sw_vector.p1_gather_score_ls_cuda(*a)
    ms = cuda_ms(lambda: sw_vector.p1_gather_score_ls_cuda(*a), reps)
    cpu = [x.cpu() if torch.is_tensor(x) else x for x in a]
    plain_ms, want = host_ms(lambda: sw_vector.p1_gather_score_ls_plain(*cpu))
    out["sw_vector"] = {
        "shape": {"windows": int(a[1].shape[0]), "G": int(a[6]),
                  "R": int(a[5].shape[2])},
        "max_abs_err": max_abs_err(got, want), "ms": round(ms, 4),
        "plain_ms": round(plain_ms, 1)}
    a = args["sw_full"]
    s_got, o_got = sw_full.sw_full_and_traceback_packed_cuda(*a)
    ms = cuda_ms(lambda: sw_full.sw_full_and_traceback_packed_cuda(*a), reps)
    cpu = [x.cpu() if torch.is_tensor(x) else x for x in a]
    plain_ms, (s_want, o_want) = host_ms(
        lambda: sw_full.sw_full_and_traceback_packed_plain(*cpu))
    out["sw_full"] = {
        "shape": {"alignments": int(a[0].shape[0]), "G": int(a[0].shape[1]),
                  "R": int(a[1].shape[1]), "W": int(a[7])},
        "max_abs_err": max(max_abs_err(s_got, s_want),
                           max_abs_err(o_got, o_want)),
        "ms": round(ms, 4), "plain_ms": round(plain_ms, 1)}
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
    from shrimp_tpu.ops.params import SWParams
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
    from shrimp_tpu.pipeline.candidates import cs_read_ls4
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


def phase_kernels_cs() -> None:
    """The three new kernels against their plain versions, exact."""
    import torch

    from shrimp_tpu_torch.ops import sw_gapless, sw_vector
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
    # indel taboo, N codes, a band leaping past the shift clip, and the
    # full band at W = round_up(G, 32)
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

    from shrimp_tpu import index as gindex
    from shrimp_tpu.io import fastx
    from shrimp_tpu.pipeline.options import MapperConfig
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

    rec3 = Recorder(sw_gapless, "gapless_score_batch_cuda",
                    lambda a: a[0].shape[0])
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


def phase_size_cs(device: dict, contigs: list) -> tuple[dict, dict, dict]:
    """The colour-space path at 100 Mbp: map, count launches, check
    quality, and check the first reads against the plain versions."""
    import torch

    sys.path.insert(0, os.path.join(REPO, "benchmarks"))
    import bench_grid
    from shrimp_tpu import index as gindex
    from shrimp_tpu import seeds as seedmod
    from shrimp_tpu.pipeline.options import MapperConfig
    from shrimp_tpu_torch.ops import sw_full_cs, sw_vector
    from shrimp_tpu_torch.pipeline.mapper import Mapper

    cs, _ = _cs_params()
    t0 = time.time()
    idx = gindex.build_index(contigs, seedmod.make_seed_set(None),
                             colour_space=True)
    max_w = max(s.weight for s in idx.seed_set.seeds)
    idx.trim(max(1000, (100 * idx.total_len) // (4 ** max_w)))
    index_secs = time.time() - t0
    reads, truth = bench_grid.make_cs_reads(idx, np.random.default_rng(23),
                                            SIZE_CS_READS)
    log(f"size-cs: {idx.total_len} bp in {idx.num_contigs} contigs, "
        f"colour-space index {index_secs:.1f} s")

    def cfg():
        return MapperConfig(colour_space=True, params=cs, qual_delta=33)

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
    }
    log("size-cs: " + json.dumps(stats))

    first = _sam_lines(mapper, results[:SIZE_CS_PLAIN])
    plain = Mapper(idx, cfg(), device="cpu")
    t0 = time.time()
    again = _sam_lines(plain, plain.map_stream(iter(reads[:SIZE_CS_PLAIN]),
                                               SIZE_CS_PLAIN))
    plain_secs = time.time() - t0
    if again != first:
        i = next((k for k, (a, b) in enumerate(zip(again, first))
                  if a != b), min(len(again), len(first)))
        raise AssertionError(f"size-cs: plain versions disagree at SAM "
                             f"line {i}")
    log(f"size-cs: first {SIZE_CS_PLAIN} reads identical through the plain "
        f"versions ({len(first)} SAM lines; plain map {plain_secs:.1f} s on "
        f"the host CPU)")
    return launches, {"sw_vector_cs": rec1.args, "sw_full_cs": rec2.args}, \
        stats


def time_kernels_cs(args: dict, reps: int = 20) -> dict:
    """The colour-space and gapless kernels (CUDA events) against their
    plain versions (host clock, CPU tensors) on recorded inputs; outputs
    must agree.  Without a recorded gapless call the gapless kernel runs
    on a random batch as large as the largest pass-1 launch."""
    import torch

    from shrimp_tpu_torch.ops import sw_full_cs, sw_gapless, sw_vector

    def cpu(a):
        return [x.cpu() if torch.is_tensor(x) else x for x in a]

    out = {}
    a = args["sw_vector_cs"]
    got = sw_vector.p1_gather_score_cs_cuda(*a)
    ms = cuda_ms(lambda: sw_vector.p1_gather_score_cs_cuda(*a), reps)
    ca = cpu(a)
    plain_ms, want = host_ms(
        lambda: sw_vector.p1_gather_score_cs_plain(*ca))
    out["sw_vector_cs"] = {
        "shape": {"windows": int(a[2].shape[0]), "G": int(a[8]),
                  "R": int(a[7].shape[2])},
        "max_abs_err": max_abs_err(got, want), "ms": round(ms, 4),
        "plain_ms": round(plain_ms, 1)}
    a = args["sw_full_cs"]
    s_got, o_got = sw_full_cs.sw_full_cs_and_traceback_packed_cuda(*a)
    ms = cuda_ms(
        lambda: sw_full_cs.sw_full_cs_and_traceback_packed_cuda(*a), reps)
    ca = cpu(a)
    plain_ms, (s_want, o_want) = host_ms(
        lambda: sw_full_cs.sw_full_cs_and_traceback_packed_plain(*ca))
    out["sw_full_cs"] = {
        "shape": {"alignments": int(a[0].shape[0]), "G": int(a[0].shape[1]),
                  "R": int(a[1].shape[2]), "W": int(a[9]),
                  "taboo_len": int(a[8])},
        "max_abs_err": max(max_abs_err(s_got, s_want),
                           max_abs_err(o_got, o_want)),
        "ms": round(ms, 4), "plain_ms": round(plain_ms, 1)}
    a = args.get("sw_gapless")
    if a is None:
        cs, _ = _cs_params()
        diag, reads, s0 = _gapless_case(
            np.random.default_rng(5), int(args["sw_vector_cs"][2].shape[0]),
            int(args["sw_vector_cs"][7].shape[2]))
        a = (torch.from_numpy(diag).cuda(), torch.from_numpy(reads).cuda(),
             cs, torch.from_numpy(s0).cuda())
    got = sw_gapless.gapless_score_batch_cuda(*a)
    ms = cuda_ms(lambda: sw_gapless.gapless_score_batch_cuda(*a), reps)
    ca = cpu(a)
    plain_ms, want = host_ms(
        lambda: sw_gapless.gapless_score_batch_plain(*ca))
    out["sw_gapless"] = {
        "shape": {"hits": int(a[0].shape[0]), "R": int(a[0].shape[1]),
                  "s0": a[3] is not None},
        "max_abs_err": max_abs_err(got, want), "ms": round(ms, 4),
        "plain_ms": round(plain_ms, 1)}
    for name, row in out.items():
        if row["max_abs_err"]:
            raise AssertionError(f"{name} disagrees with its plain version: "
                                 f"{row}")
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        sys.stderr.write("chip_smoke: no CUDA device; nothing to run\n")
        return 2
    sys.path.insert(0, REPO)
    import bench  # noqa: F401  (fail before any output outside the repo)
    import shrimp_tpu_torch  # noqa: F401

    t_all = time.time()
    device = phase_device()
    phase_build()
    phase_kernels()
    phase_kernels_cs()
    golden_args = phase_goldens()
    golden_times = time_kernels(golden_args)
    log("kernel times at golden shapes (" + device["smi"] + "): "
        + json.dumps(golden_times))
    gapless_launches, golden_cs_args = phase_goldens_cs()
    log("colour-space and gapless kernel times at golden shapes ("
        + device["smi"] + "): "
        + json.dumps(time_kernels_cs(golden_cs_args)))
    contigs, gen_secs = size_contigs()
    launches, size_args, _ = phase_size(device, contigs, gen_secs)
    size_times = time_kernels(size_args)
    log("kernel times at 100 Mbp main-path shapes (" + device["smi"]
        + "): " + json.dumps(size_times))
    del size_args
    launches_cs, size_cs_args, _ = phase_size_cs(device, contigs)
    size_times.update(time_kernels_cs(size_cs_args))
    log("colour-space kernel times at 100 Mbp main-path shapes ("
        + device["smi"] + "): "
        + json.dumps({k: size_times[k] for k in size_cs_args}
                     | {"sw_gapless": size_times["sw_gapless"]}))
    launches.update(launches_cs)
    launches.update(gapless_launches)
    log(f"total: {time.time() - t_all:.1f} s")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", **KERNELS[name],
         "launches": launches[name],
         "max_abs_err": size_times[name]["max_abs_err"],
         "ms": size_times[name]["ms"],
         "plain_ms": size_times[name]["plain_ms"]}
        for name in KERNELS]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device["name"],
        "count": device["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
