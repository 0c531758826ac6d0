#!/usr/bin/env python3
"""Measurements behind the design of the gapless pass-1 kernel (K6,
`shrimp_tpu_torch/csrc/sw_gapless.cu`), on one CUDA device.

    python3 scripts/gapless_probe.py [--parent DIR] [--out FILE]

It records the largest gapless pass-1 call of each space in two
`-U --local` mapping runs at 100 Mbp, on the corpora of `chip_smoke.py`'s
size-gapless phase (16,384 reads) and size-cs-gapless phase (8,192 SOLiD
reads), both with host candidates, which give the same hits as the
card's.  Then, on each recorded call and on two long-read launches cut
from the same plane (4,096 hits of R 1,000; 512 of R 5,000):
  * builds copies of the kernel source that read their streams in 1- or
    4-byte chunks (the shipped source's 16-byte `Stream` replaced by a
    width-generic one, under `build/shrimp_tpu_torch/probe/`, never
    shipped) and times them and the shipped library in turns (CUDA events
    around 50 calls, and each call's device work behind a spin kernel),
    each held to the plain version;
  * with `--parent DIR` (an unpacked earlier tree whose `sw_gapless_launch`
    scores diagonals gathered already, a warp a hit), times that kernel on
    the same hits' diagonals, gathered by the plain version beforehand,
    beside the shipped kernel on the same rows (its pre-gathered form) and
    on the fused call (parent, new, new, parent).
Prints one JSON object a call and writes them all to `--out`.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as smoke  # noqa: E402
from shrimp_tpu_torch import _build  # noqa: E402
from shrimp_tpu_torch.ops import sw_gapless  # noqa: E402

PROBE_DIR = os.path.join(_build.BUILD_DIR, "probe")
REPS = 50
VP, CI, CL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

# `Stream` for a chunk of LOAD = 1, 4 or 16 bytes: byte loads step one
# column at a time, wider chunks are cut with a funnel shift
GENERIC_STREAM = r"""struct Stream {
  uintptr_t next;
  uintptr_t use_lo, use_hi;
  uintptr_t lo, hi;
  unsigned cur[WORDS];
  int word, shift;

  __device__ __forceinline__ void init(uintptr_t p, int t_begin, int t_end,
                                       uintptr_t tensor_lo,
                                       uintptr_t tensor_hi) {
    use_lo = p + t_begin;
    use_hi = p + t_end;
    lo = tensor_lo;
    hi = tensor_hi;
    if (LOAD == 1) {
      next = use_lo;
      return;
    }
    const uintptr_t c0 = use_lo & ~(uintptr_t)(LOAD - 1);
    const int off = (int)(use_lo - c0);
    word = off >> 2;
    shift = (off & 3) * 8;
    load(c0, cur);
    next = c0 + LOAD;
  }

  __device__ __forceinline__ void load(uintptr_t c,
                                       unsigned (&w)[WORDS]) const {
#pragma unroll
    for (int j = 0; j < WORDS; ++j) w[j] = 0u;
    if (c + LOAD <= use_lo || c >= use_hi) return;
    if (c >= lo && c + LOAD <= hi) {
      if (LOAD == 16) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(c));
        w[0] = v.x;
        w[1] = v.y;
        w[2] = v.z;
        w[3] = v.w;
      } else if (LOAD == 4) {
        w[0] = __ldg(reinterpret_cast<const unsigned*>(c));
      } else {
        w[0] = __ldg(reinterpret_cast<const unsigned char*>(c));
      }
      return;
    }
#pragma unroll
    for (int i = 0; i < LOAD; ++i) {
      const uintptr_t b = c + i;
      if (b >= lo && b < hi)
        w[i >> 2] |= (unsigned)__ldg(reinterpret_cast<const unsigned char*>(b))
                     << (8 * (i & 3));
    }
  }

  __device__ __forceinline__ void step(unsigned (&out)[WORDS]) {
    if (LOAD == 1) {
      load(next, out);
      next += 1;
      return;
    }
    unsigned nxt[WORDS];
    load(next, nxt);
    next += LOAD;
    if (LOAD == 4) {
      out[0] = __funnelshift_r(cur[0], nxt[0], shift);
    } else {
      unsigned v[8];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[j] = cur[j];
        v[j + 4] = nxt[j];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const unsigned a = word == 0 ? v[j] : word == 1 ? v[j + 1]
                           : word == 2 ? v[j + 2] : v[j + 3];
        const unsigned b = word == 0 ? v[j + 1] : word == 1 ? v[j + 2]
                           : word == 2 ? v[j + 3] : v[j + 4];
        out[j] = __funnelshift_r(a, b, shift);
      }
    }
#pragma unroll
    for (int j = 0; j < WORDS; ++j) cur[j] = nxt[j];
  }
};
"""


def log(msg: str) -> None:
    print(msg, flush=True)


def width_source(src: str, load: int) -> str:
    """The shipped source with its chunk width set to `load` bytes."""
    out, n = re.subn(r"struct Stream \{.*?\n\};\n", lambda _: GENERIC_STREAM,
                     src, count=1, flags=re.S)
    for old, new in (("constexpr int LOAD = 16;",
                      f"constexpr int LOAD = {load};"),
                     ("constexpr int WORDS = LOAD / 4;",
                      "constexpr int WORDS = LOAD >= 4 ? LOAD / 4 : 1;")):
        if old not in out:
            raise RuntimeError(f"the kernel source has no `{old}`")
        out = out.replace(old, new)
    if n != 1:
        raise RuntimeError("the kernel source has no `struct Stream`")
    return out


def build_copy(tag: str, src: str) -> tuple[ctypes.CDLL, str]:
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
              if "Used" in ln]
    lib = ctypes.CDLL(os.path.abspath(so))
    lib.sw_gapless_launch.restype = CI
    lib.sw_gapless_launch.argtypes = [VP, VP, VP, CI, CI, CI, CI, VP, VP]
    if hasattr(lib, "sw_gapless_gather_launch"):
        lib.sw_gapless_gather_launch.restype = CI
        lib.sw_gapless_gather_launch.argtypes = [
            VP, CL, VP, VP, VP, VP, VP, VP, CL, CI, CI, VP, VP, CI, CI, CI,
            VP, VP]
    return lib, "; ".join(report)


def record_inputs() -> dict:
    """The arguments of the largest fused gapless call of each space's
    -U --local mapping run (tensors on the card)."""
    from shrimp_tpu_torch.pipeline.mapper import Mapper
    contigs, secs = smoke.size_contigs()
    out = {}
    for cs in (False, True):
        if cs:
            idx, reads, _, _ = smoke.size_cs_index(contigs)
        else:
            idx, reads, _, _ = smoke.size_index(contigs, secs)
        with smoke.Recorder(sw_gapless, *smoke.GAPLESS_WRAPPERS[cs]) as rec:
            mapper = Mapper(idx, smoke.gapless_cfg(cs, False), device="cuda")
            for _ in mapper.map_stream(iter(reads), smoke.SIZE_BATCH):
                pass
        out["cs" if cs else "ls"] = rec.args
        del mapper, idx
    return out


def long_reads(args: tuple, N: int, R: int, seed: int) -> tuple:
    """A letter-space launch of N hits on R-column reads over the recorded
    plane: reads cut from random places of it, with 2% substitutions, each
    hit on its read's diagonal or on a random one."""
    plane = args[0]
    rng = np.random.default_rng(seed)
    B = max(N // 16, 1)
    L = int(plane.shape[0]) - (1 << 12)
    cut = rng.integers(0, L - R, B)
    host = plane.cpu().numpy()
    reads2 = np.empty((B, 2, R), np.int8)
    for b in range(B):
        r = np.maximum(host[cut[b]:cut[b] + R], 0)
        r = np.where(rng.random(R) < 0.02, rng.integers(0, 4, R), r)
        reads2[b, 0] = reads2[b, 1] = r
    rid = np.sort(rng.integers(0, B, N)).astype(np.int32)
    start = np.where(rng.random(N) < 0.5, cut[rid],
                     rng.integers(0, L - R, N)).astype(np.int64)
    dev = plane.device
    t = (lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev))
    return (plane, t(start), t(np.full(N, 2 * R, np.int64)),
            t(np.zeros(N, np.int32)), t(rid), t(np.zeros(N, np.int32)),
            t(reads2), args[-1])


def fused_call(lib, a: tuple, cs: bool, out: torch.Tensor):
    """A call of `lib`'s fused entry point with a recorded call's
    arguments, as `ops.sw_gapless` makes it."""
    if cs:
        cs_cat, ls_cat, start, glen, r_left, rid, initbp, reads2, p = a
        plane, st = cs_cat, None
    else:
        plane, start, glen, r_left, rid, st, reads2, p = a
        ls_cat = initbp = None
    B, S, R = reads2.shape
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        rc = lib.sw_gapless_gather_launch(
            plane.data_ptr(), plane.shape[0], start.data_ptr(),
            glen.data_ptr(), r_left.data_ptr(), rid.data_ptr(),
            None if st is None else st.data_ptr(), reads2.data_ptr(),
            B * S * R, S, R,
            None if ls_cat is None else ls_cat.data_ptr(),
            None if initbp is None else initbp.data_ptr(), start.shape[0],
            p.match, p.mismatch, out.data_ptr(), stream)
        if rc:
            raise RuntimeError(f"sw_gapless_gather_launch: CUDA error {rc}")
    return call


def rows_call(lib, diag, rows, s0, p, out):
    """A call of `lib`'s pre-gathered entry point (sw_gapless_launch)."""
    stream = torch.cuda.current_stream().cuda_stream
    N, R = diag.shape

    def call():
        rc = lib.sw_gapless_launch(
            diag.data_ptr(), rows.data_ptr(),
            None if s0 is None else s0.data_ptr(), N, R, p.match, p.mismatch,
            out.data_ptr(), stream)
        if rc:
            raise RuntimeError(f"sw_gapless_launch: CUDA error {rc}")
    return call


def in_turns(calls: list) -> dict:
    """Each (name, call) timed in the given order (CUDA events around the
    calls, and each call's device work alone)."""
    return {"ms": [[k, smoke.cuda_ms(fn, REPS)] for k, fn in calls],
            "device_ms": [[k, smoke.device_ms(fn, REPS)] for k, fn in calls]}


def probe(name: str, a: tuple, cs: bool, libs: dict, parent) -> dict:
    ca = smoke._cpu(a)
    plain = (sw_gapless.p1_gather_gapless_cs_plain if cs
             else sw_gapless.p1_gather_gapless_ls_plain)
    want = plain(*ca)
    N = int(a[2 if cs else 1].shape[0])
    R = int(a[-2].shape[2])
    res = {"call": name, "hits": N, "R": R, "colour_space": cs}
    outs = {k: torch.empty(N, dtype=torch.int32, device="cuda")
            for k in libs}
    calls = {k: fused_call(lib, a, cs, outs[k]) for k, lib in libs.items()}
    for fn in calls.values():
        fn()
    torch.cuda.synchronize()
    res["exact"] = {k: bool(torch.equal(o.cpu(), want))
                    for k, o in outs.items()}
    order = list(libs)
    res["widths"] = in_turns([(k, calls[k]) for k in order + order[::-1]])
    if parent is not None:
        if cs:
            diag, rows, s0 = sw_gapless._diagonals_cs(*ca)
        else:
            diag, rows = sw_gapless._diagonals(*ca[:7])
            s0 = None
        g = [x.cuda() for x in (diag, rows)]
        s0g = None if s0 is None else s0.cuda()
        out_old = torch.empty(N, dtype=torch.int32, device="cuda")
        out_new = torch.empty(N, dtype=torch.int32, device="cuda")
        old = rows_call(parent, *g, s0g, a[-1], out_old)
        new = rows_call(libs["load16"], *g, s0g, a[-1], out_new)
        old()
        new()
        torch.cuda.synchronize()
        res["pregathered_exact"] = {
            "parent": bool(torch.equal(out_old.cpu(), want)),
            "new": bool(torch.equal(out_new.cpu(), want))}
        fused = calls["load16"]
        res["parent_vs_new"] = in_turns(
            [("parent_pregathered", old), ("new_pregathered", new),
             ("new_fused", fused), ("new_fused", fused),
             ("new_pregathered", new), ("parent_pregathered", old)])
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="an unpacked earlier tree whose "
                    "sw_gapless kernel to measure side by side")
    ap.add_argument("--out", default=None, help="JSON file of the results")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.stderr.write("gapless_probe: no CUDA device\n")
        return 2
    smi = smoke.phase_device()["smi"]
    with open(os.path.join(_build.CSRC, "sw_gapless.cu")) as fh:
        src = fh.read()
    libs, reports = {}, {}
    for n in (1, 4):
        libs[f"load{n}"], reports[f"load{n}"] = build_copy(
            f"sw_gapless_load{n}", width_source(src, n))
    libs["load16"], reports["load16"] = build_copy("sw_gapless_load16", src)
    parent = None
    if a.parent:
        with open(os.path.join(a.parent, "shrimp_tpu_torch", "csrc",
                               "sw_gapless.cu")) as fh:
            parent, reports["parent"] = build_copy("sw_gapless_parent",
                                                   fh.read())
    log("ptxas: " + json.dumps(reports))
    t0 = time.time()
    recorded = record_inputs()
    log(f"gapless_probe: inputs recorded in {time.time() - t0:.1f} s")
    results = []
    cases = [("size-gapless", recorded["ls"], False),
             ("size-cs-gapless", recorded["cs"], True),
             ("long reads R 1000", long_reads(recorded["ls"], 4096, 1000, 1),
              False),
             ("long reads R 5000", long_reads(recorded["ls"], 512, 5000, 2),
              False)]
    for name, args, cs in cases:
        res = {"nvidia_smi": smi, **probe(name, args, cs, libs, parent)}
        log(json.dumps(res))
        results.append(res)
    if a.out:
        with open(a.out, "w") as fh:
            json.dump({"calls": results}, fh, indent=1)
    ok = all(all(r["exact"].values())
             and all(r.get("pregathered_exact", {}).values())
             for r in results)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
