"""Measurements behind the design of the pass-2 kernels (K3+K4 in
`csrc/sw_full.cu`, K7+K8 in `csrc/sw_full_cs.cu`), on one CUDA device.

    python -m shrimp_tpu_torch.utils.pass2_probe [--parent DIR] [--out FILE]

It records the inputs of the main path's largest pass-2 launches (the
100 Mbp corpora of `chip_smoke.py`'s size and size-cs phases, host
candidates), then for each kernel on those inputs:
  * times the shipped kernel (CUDA events) and checks it against its
    plain version, integer for integer;
  * sweeps the tile shapes (lanes x columns a lane) and, in letter
    space, the pointer tiers (global scratch, or a shared-memory budget
    an alignment), from a copy of the source with more shapes
    instantiated;
  * splits a warp's cycles into the DP and the walk with `clock64`
    stamps at the kernels' `PASS2_PROBE(k)` marks (empty in the shipped
    build), and reads the registers and the resident blocks an SM;
  * with `--parent DIR` (an unpacked earlier tree whose pass-2 kernels
    run a warp an alignment, the design these tiles replaced, and carry
    no marks), stamps those kernels at their fixed text, does the same
    split and times them side by side with the shipped ones (parent, new,
    new, parent).
The copies are built under `build/shrimp_tpu_torch/probe/` and never
shipped.  Prints one JSON object a kernel and writes them all to `--out`.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from shrimp_tpu_torch import _build
from shrimp_tpu_torch.ops import sw_full, sw_full_cs
from shrimp_tpu_torch.ops.params import SWParams

PROBE_DIR = os.path.join(_build.BUILD_DIR, "probe")
GENOME_BP, LS_READS, CS_READS, BATCH = 100_000_000, 16_384, 8_192, 2_048
# shapes swept besides the shipped ones: (lanes, columns a lane)
LS_SHAPES = [(8, 1), (16, 1), (32, 1), (8, 2), (8, 4), (4, 4), (4, 8),
             (16, 2), (16, 4), (32, 2)]
CS_LANES = [8, 16, 32]
# per-alignment shared-memory budgets of the letter-space pointer plane
LS_BUDGETS = (0, 2048)
VP, CI = ctypes.c_void_p, ctypes.c_int
# the entry points' argument types (the one-warp kernels took the same, a
# bits scratch where these take theirs)
ARGTYPES = {"sw_full": [VP] * 5 + [CI] * 12 + [VP] * 4,
            "sw_full_cs": [VP] * 6 + [CI] * 14 + [VP] * 4}
# the probe's own launcher over the swept shapes: (lanes, columns, plane
# budget, scratch an alignment) before the entry point's arguments
PROBE_PREFIX = {"sw_full": [CI] * 4, "sw_full_cs": [CI] * 2}


def log(msg: str) -> None:
    print(msg, flush=True)


def record_inputs() -> dict:
    """The arguments of the largest sw_full and sw_full_cs launches of the
    size and size-cs mapping runs (CPU tensors)."""
    from shrimp_tpu_torch import index as gindex
    from shrimp_tpu_torch import seeds as seedmod
    from shrimp_tpu_torch.io import fastx
    from shrimp_tpu_torch.pipeline.mapper import Mapper
    from shrimp_tpu_torch.pipeline.options import MapperConfig
    from shrimp_tpu_torch.utils import synth
    chroms = synth.make_genome(np.random.default_rng(20260817), GENOME_BP)
    contigs = [fastx.Contig(name=f"chr{i + 1}", codes=g)
               for i, g in enumerate(chroms)]
    out = {}
    for name, mod, cs in (("sw_full", sw_full, False),
                          ("sw_full_cs", sw_full_cs, True)):
        idx = gindex.build_index(contigs, seedmod.make_seed_set(None),
                                 colour_space=cs)
        max_w = max(s.weight for s in idx.seed_set.seeds)
        idx.trim(max(1000, (100 * idx.total_len) // (4 ** max_w)))
        if cs:
            reads, _ = synth.make_cs_reads(idx, np.random.default_rng(23),
                                           CS_READS)
            cfg = MapperConfig(colour_space=True,
                               params=SWParams.colour_space(),
                               qual_delta=33, device_candidates=False)
        else:
            reads, _ = synth.make_reads(idx, np.random.default_rng(7),
                                        LS_READS)
            cfg = MapperConfig(qual_delta=64, device_candidates=False)
        fn_name = name + "_and_traceback_packed_cuda"
        orig = getattr(mod, fn_name)
        best = {"rows": -1}

        def wrapper(*args, _orig=orig, _best=best):
            if args[0].shape[0] > _best["rows"]:
                _best["rows"] = args[0].shape[0]
                _best["args"] = [a.cpu() if torch.is_tensor(a) else a
                                 for a in args]
            return _orig(*args)

        setattr(mod, fn_name, wrapper)
        try:
            mapper = Mapper(idx, cfg, device="cuda")
            for _ in mapper.map_stream(iter(reads), BATCH):
                pass
        finally:
            setattr(mod, fn_name, orig)
        out[name] = best["args"]
    return out


def _instrumented(src: str) -> str:
    """This tree's source with its `PASS2_PROBE(k)` marks defined as
    clock64 stamps (start, before the tile's best-cell reduction, end),
    stored by each tile's first lane."""
    if any(src.count(f"PASS2_PROBE({k});") != 1 for k in range(3)):
        raise RuntimeError("the source does not carry the three probe marks")
    return ("__device__ long long* g_clk;\n"
            "#define PASS2_PROBE(k) do { if ((k) == 2) __syncwarp(); "
            "if (g_clk && tl == 0 && live) g_clk[3 * b + (k)] = clock64(); "
            "} while (0)\n" + src + _SET_CLK)


def _instrumented_parent(name: str, src: str) -> str:
    """A one-warp-an-alignment source (no marks) with the same stamps, at
    its fixed text: after the warp's exit test, before the best-cell
    reduction, at the kernel's end."""
    src = src.replace("namespace {\n",
                      "namespace {\n__device__ long long* g_clk;\n", 1)
    start = "if (b >= B) return;  // the whole warp leaves together"
    mid = "\n  // best cell: max score"
    end = "}\n\n}  // namespace"
    for anchor in (start, mid, end):
        if src.count(anchor) != 1:
            raise RuntimeError(f"{name}: not a one-warp source ({anchor!r})")
    src = src.replace(start, start + "\n  const long long t0 = clock64();")
    src = src.replace(mid, "\n  const long long t1 = clock64();" + mid)
    cut = src.rindex(end)
    src = (src[:cut] + "  __syncwarp();\n  if (lane == 0 && g_clk) {\n"
           "    g_clk[3 * b] = t0; g_clk[3 * b + 1] = t1;\n"
           "    g_clk[3 * b + 2] = clock64();\n  }\n" + src[cut:])
    return src + _SET_CLK


_SET_CLK = """
extern "C" int probe_set_clk(void* p) {
  long long* q = (long long*)p;
  return (int)cudaMemcpyToSymbol(g_clk, &q, sizeof(q));
}
"""


def _sweep_launcher(name: str, shapes) -> str:
    """A launcher over the swept shapes, staged, and the shared memory a
    tile takes (appended to the copy: it calls the source's own `launch`
    and `Layout`)."""
    if name == "sw_full":
        cases = "".join(
            f"  if (tile == {t} && cols == {c})\n"
            f"    return launch<{t}, {c}, true>(g, r, rc, x0, x1, B, G, R, W,"
            " shift_max, local, p, P, per, sc, st, op, s);\n"
            for t, c in shapes)
        return f"""
extern "C" int probe_launch(int tile, int cols, int P, int per,
    const void* genome, const void* read, const void* revcmpl,
    const void* band_xmin, const void* band_xmax, int B, int G, int R,
    int W, int shift_max, int local, int match, int mismatch,
    int a_gap_open, int a_gap_extend, int b_gap_open, int b_gap_extend,
    void* scratch, void* stats, void* ops, void* stream) {{
  const Params p = make_params(match, mismatch, a_gap_open, a_gap_extend,
                               b_gap_open, b_gap_extend);
  auto* g = (const int8_t*)genome; auto* r = (const int8_t*)read;
  auto* rc = (const uint8_t*)revcmpl;
  auto* x0 = (const int*)band_xmin; auto* x1 = (const int*)band_xmax;
  auto* sc = (uint8_t*)scratch; auto* st = (int*)stats;
  auto* op = (uint8_t*)ops; auto* s = (cudaStream_t)stream;
{cases}  return (int)cudaErrorInvalidValue;
}}
extern "C" int probe_tile_bytes(int G, int R, int W, int P) {{
  return Layout(G, R, W, P, true).bytes;
}}
"""
    cases = "".join(
        f"  if (tile == {t})\n"
        f"    return launch<{t}, true>(g, q, xo, rc, x0, x1, B, G, R, W,"
        " shift_max, local, taboo_len, p, per, sc, st, op, s);\n"
        for t, _ in shapes)
    return f"""
extern "C" int probe_launch(int tile, int per,
    const void* genome, const void* qr4, const void* xover,
    const void* revcmpl, const void* band_xmin, const void* band_xmax, int B,
    int G, int R, int W, int shift_max, int local, int taboo_len, int match,
    int mismatch, int a_gap_open, int a_gap_extend, int b_gap_open,
    int b_gap_extend, int crossover, void* scratch, void* stats, void* ops,
    void* stream) {{
  const Params p = make_params(match, mismatch, a_gap_open, a_gap_extend,
                               b_gap_open, b_gap_extend, crossover);
  auto* g = (const int8_t*)genome; auto* q = (const int8_t*)qr4;
  auto* xo = (const int*)xover; auto* rc = (const uint8_t*)revcmpl;
  auto* x0 = (const int*)band_xmin; auto* x1 = (const int*)band_xmax;
  auto* sc = (uint8_t*)scratch; auto* st = (int*)stats;
  auto* op = (uint8_t*)ops; auto* s = (cudaStream_t)stream;
{cases}  return (int)cudaErrorInvalidValue;
}}
extern "C" int probe_tile_bytes(int G, int R, int W, int P) {{
  return Layout(G, R, W, true).bytes;
}}
"""


def _occupancy_fn(kernel: str, tag: str) -> str:
    return f"""
extern "C" int probe_occupancy_{tag}(int threads, int smem, int* blocks,
                                   int* regs) {{
  cudaFuncAttributes at;
  cudaFuncGetAttributes(&at, {kernel});
  *regs = at.numRegs;
  if (smem > 48 * 1024)
    cudaFuncSetAttribute({kernel},
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, {kernel}, threads, smem);
}}
"""


def _build_copy(tag: str, src: str) -> tuple[ctypes.CDLL, str]:
    os.makedirs(PROBE_DIR, exist_ok=True)
    path = os.path.join(PROBE_DIR, f"{tag}.cu")
    so = os.path.join(PROBE_DIR, f"lib{tag}.so")
    with open(path, "w") as fh:
        fh.write(src)
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, path],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc failed on {path}:\n{r.stderr[-4000:]}")
    report = [ln.strip() for ln in (r.stdout + r.stderr).splitlines()
              if "Used" in ln or "spill" in ln]
    return ctypes.CDLL(os.path.abspath(so)), "; ".join(report)


def cuda_ms(fn, reps: int = 50) -> float:
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


class Launch:
    """One kernel of one library on the recorded inputs: through its entry
    point (`prefix` None: this tree's shipped launcher, or a parent's), or
    through the probe's launcher at a swept shape, `prefix` = (lanes,
    columns, plane budget, scratch an alignment) in letter space, (lanes,
    scratch an alignment) in colour space."""

    def __init__(self, lib, name, args, prefix=None):
        self.name, self.prefix = name, prefix
        entry = name + "_launch" if prefix is None else "probe_launch"
        self.fn = getattr(lib, entry)
        self.fn.argtypes = ((PROBE_PREFIX[name] if prefix else [])
                            + ARGTYPES[name])
        self.fn.restype = ctypes.c_int
        self.gpu = [a.cuda() for a in args if torch.is_tensor(a)]
        self.p = args[len(self.gpu)]
        self.rest = args[len(self.gpu) + 1:]     # (local, [taboo,] W)
        g, other = self.gpu[0], self.gpu[1]
        self.B, self.G = g.shape
        self.R = other.shape[-1]
        self.W = int(self.rest[-1])
        cs = name == "sw_full_cs"
        # room for any layout: the pointer plane (a byte a cell, 8 in
        # colour space; the one-warp kernels' bits planes are as large) and
        # per-row inputs
        per = -(-self.R * self.W * (8 if cs else 1) // 16) * 16 + 24 * self.R
        self.scratch = torch.empty(self.B * per, dtype=torch.uint8,
                                   device="cuda")
        self.stats = torch.empty((self.B, 11 if cs else 10),
                                 dtype=torch.int32, device="cuda")
        self.ops = torch.empty((self.B, self.R + self.G), dtype=torch.uint8,
                               device="cuda")
        self.stream = torch.cuda.current_stream().cuda_stream

    def __call__(self) -> None:
        p, rest = self.p, self.rest
        mode = [int(bool(rest[0]))] + ([int(rest[1])] if len(rest) == 3
                                      else [])
        scores = [p.match, p.mismatch, p.a_gap_open, p.a_gap_extend,
                  p.b_gap_open, p.b_gap_extend]
        if self.name == "sw_full_cs":
            scores.append(p.crossover)
        rc = self.fn(*(self.prefix or ()),
                     *[t.data_ptr() for t in self.gpu], self.B, self.G,
                     self.R, self.W, sw_full.shift_max(self.G), *mode,
                     *scores, self.scratch.data_ptr(), self.stats.data_ptr(),
                     self.ops.data_ptr(), self.stream)
        if rc:
            raise RuntimeError(f"{self.name} {self.prefix}: CUDA error {rc}")

    def exact(self, want) -> bool:
        self()
        torch.cuda.synchronize()
        return bool(torch.equal(self.stats.cpu(), want[0])
                    and torch.equal(self.ops.cpu(), want[1]))


def _split(lib, launch: Launch, tiles_per_warp: int) -> dict:
    """Mean clock64 cycles a warp spends in the DP and in the walk (the
    tiles of a warp run together: one tile stands for its warp)."""
    clk = torch.zeros(3 * launch.B, dtype=torch.int64, device="cuda")
    if lib.probe_set_clk(ctypes.c_void_p(clk.data_ptr())):
        raise RuntimeError("probe_set_clk failed")
    launch()
    torch.cuda.synchronize()
    c = clk.view(-1, 3).cpu().numpy()[::tiles_per_warp]
    dp, walk = c[:, 1] - c[:, 0], c[:, 2] - c[:, 1]
    return {"dp_cycles": float(dp.mean()), "walk_cycles": float(walk.mean()),
            "dp_share": float(dp.sum() / (dp.sum() + walk.sum())),
            "warps": int(len(c))}


def _occupancy(lib, tag, threads, smem) -> dict:
    blocks, regs = ctypes.c_int(), ctypes.c_int()
    getattr(lib, f"probe_occupancy_{tag}")(threads, smem,
                                           ctypes.byref(blocks),
                                           ctypes.byref(regs))
    return {"registers": regs.value, "block_threads": threads,
            "block_smem": smem, "blocks_per_sm": blocks.value,
            "warps_per_sm": blocks.value * threads // 32}


def probe(name: str, args: list, parent: str | None) -> dict:
    mod = sw_full if name == "sw_full" else sw_full_cs
    cs = name == "sw_full_cs"
    want = getattr(mod, name + "_and_traceback_packed_plain")(*args)
    with open(os.path.join(_build.CSRC, name + ".cu")) as fh:
        src = fh.read()
    W, R, G = int(args[-1]), args[1].shape[-1], args[0].shape[1]
    plan = mod.launch_plan(G, R, W)
    if not plan["staged"]:
        raise RuntimeError(f"{name}: the recorded launch is not staged")
    shapes = [(t, 1) for t in CS_LANES] if cs else LS_SHAPES
    if cs:
        kern = f"sw_full_cs_kernel<{plan['lanes']}, true>"
    else:
        kern = f"sw_full_kernel<{plan['lanes']}, {plan['cols']}, true>"
    lib, ptxas = _build_copy(name + "_new", _instrumented(src)
                             + _sweep_launcher(name, shapes)
                             + _occupancy_fn(kern, "new"))
    out = {"kernel": name, "card": torch.cuda.get_device_name(0),
           "alignments": int(args[0].shape[0]), "G": G, "R": R, "W": W,
           "plan": plan, "ptxas": ptxas}
    new = Launch(lib, name, args)
    out["exact"] = new.exact(want)
    sweep = []
    for t, c in shapes:
        if cs:
            runs = [((t, -(-R * W * 8 // 16) * 16), 0)]
        else:
            full = -(-R * W // 16) * 16
            runs = [((t, c, min(b, R * W), full), min(b, R * W))
                    for b in LS_BUDGETS]
        for prefix, budget in runs:
            lch = Launch(lib, name, args, prefix)
            sweep.append({"shape": [t, c], "plane_budget": budget,
                          "exact": lch.exact(want), "ms": cuda_ms(lch)})
    out["sweep"] = sweep
    tpw = 32 // plan["lanes"]
    smem = tpw * lib.probe_tile_bytes(G, R, W, plan.get("plane_smem", 0))
    out["new"] = {**_occupancy(lib, "new", 32, smem),
                  **_split(lib, new, tpw)}
    if parent:
        with open(os.path.join(parent, "shrimp_tpu_torch", "csrc",
                               name + ".cu")) as fh:
            psrc = fh.read()
        plib, pptx = _build_copy(name + "_parent", _instrumented_parent(
            name, psrc) + _occupancy_fn(f"{name}_kernel", "parent"))
        old = Launch(plib, name, args)
        per = (24 if cs else 6) * 4 * W + ((R + G + 15) & ~15)
        warps = max(1, min(8, (40 * 1024) // per))
        out["parent"] = {"exact": old.exact(want), "ptxas": pptx,
                         **_occupancy(plib, "parent", 32 * warps,
                                      warps * per),
                         **_split(plib, old, 1)}
        out["side_by_side_ms"] = [
            [who, cuda_ms(old if who == "parent" else new)]
            for who in ("parent", "new", "new", "parent")]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="an unpacked earlier tree whose "
                    "pass-2 kernels to measure side by side")
    ap.add_argument("--out", default=None, help="JSON file of the results")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.stderr.write("pass2_probe: no CUDA device\n")
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    log(smi)
    t0 = time.time()
    recorded = record_inputs()
    log(f"pass2_probe: inputs recorded in {time.time() - t0:.1f} s")
    results = []
    for name in ("sw_full", "sw_full_cs"):
        res = {"nvidia_smi": smi, **probe(name, recorded[name], a.parent)}
        log(json.dumps(res))
        results.append(res)
    if a.out:
        with open(a.out, "w") as fh:
            json.dump(results, fh, indent=1)
    return 0 if all(r["exact"] and all(s["exact"] for s in r["sweep"])
                    for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
