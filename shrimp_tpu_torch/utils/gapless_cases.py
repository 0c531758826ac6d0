"""Inputs of the fused gapless pass 1 (`ops.sw_gapless.p1_gather_gapless_ls`
/ `_cs`) that reach the edges of its gather, for holding the CUDA kernel
to its plain version: `tests/test_torch_cuda.py` and `chip_smoke.py`
draw their cases here."""

from __future__ import annotations

import numpy as np
import torch

from shrimp_tpu_torch.ops.sw_gapless import GENOME_PAD, READ_PAD


def gather_case(rng: np.random.Generator, N: int, R: int, cs: bool,
                B: int = 64, L: int = 100_000) -> list[torch.Tensor]:
    """The fused gapless pass 1's arguments (CPU tensors, scoring left
    out), framed as the Mapper frames them, over a plane of L letters (2L
    in colour space: fw||rc) with a GENOME_PAD tail: letters 0-3 with N
    (15) and IUPAC codes; B reads of mixed lengths up to R (READ_PAD
    tails), every fifth read's first colour BASE_N in colour space; N hits
    on both strands, an eighth starting late in the read (d0 < 0: r_left
    > 0, some past R), an eighth whose contig ends within R columns or
    before the diagonal starts, an eighth at the plane's last bytes (the
    last contig, some on into the pad tail), an eighth with r_left == 0 on
    an N, an eighth on the diagonal its read was cut from; the rest
    random."""
    total = 2 * L if cs else L
    pad = np.full(1 << 12, GENOME_PAD, np.int8)
    letters = rng.choice(np.array([0, 1, 2, 3, 15, 6], np.int8), total,
                         p=[0.24, 0.24, 0.24, 0.24, 0.02, 0.02])
    plane = np.concatenate([letters, pad])
    colours = np.concatenate([rng.choice(np.array([0, 1, 2, 3, 15], np.int8),
                                         total, p=[.245] * 4 + [.02]), pad])
    reads2 = np.full((B, 2, R), READ_PAD, np.int8)
    for b in range(B):
        n = int(rng.integers(max(R // 3, 1), R + 1))
        reads2[b, :, :n] = rng.integers(0, 4, (2, n))
        if cs and b % 5 == 0:
            reads2[b, 0, 0] = 15
    rid = np.sort(rng.integers(0, B, N)).astype(np.int32)
    st = rng.integers(0, 2, N).astype(np.int32)
    start = rng.integers(0, total - 2 * R, N).astype(np.int64)
    glen = rng.integers(R, 3 * R + 1, N).astype(np.int64)
    r_left = np.zeros(N, np.int32)
    k = N // 8
    r_left[:k] = rng.integers(1, R + 3, k)
    glen[k:2 * k] = rng.integers(-2, R, k)
    start[2 * k:3 * k] = total - rng.integers(1, R + 1, k)
    glen[2 * k:3 * k] = total - start[2 * k:3 * k]
    glen[2 * k:2 * k + k // 4] += R            # on into the pad tail
    n_pos = np.flatnonzero(letters > 3)
    start[3 * k:4 * k] = n_pos[rng.integers(0, len(n_pos), k)]
    # an eighth on the diagonal their read was cut from (long runs)
    cut = rng.integers(0, total - 2 * R, B)
    src = colours if cs else plane
    for b in range(0, B, 3):
        n = int((reads2[b, 0] != READ_PAD).sum())
        reads2[b, 0, 1:n] = np.maximum(src[cut[b] + 1:cut[b] + n], 0)
    sl = slice(4 * k, 5 * k)
    rid[sl] = rng.integers(0, (B + 2) // 3, k) * 3
    start[sl], st[sl], r_left[sl] = cut[rid[sl]], 0, 0
    initbp = rng.integers(0, 4, B).astype(np.int8)
    t = torch.from_numpy
    if cs:
        return [t(colours), t(plane), t(start), t(glen), t(r_left), t(rid),
                t(initbp), t(reads2)]
    return [t(plane), t(start), t(glen), t(r_left), t(rid), t(st),
            t(reads2)]
