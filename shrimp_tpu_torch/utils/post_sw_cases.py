"""Inputs of the packed colour-space posterior (`ops.post_sw.post_sw_packed`)
that reach the edges of its column derivation, for holding the plain
version to `post_sw_batch` and the CUDA kernel to the plain version:
`tests/test_torch_post_sw_packed.py`, `tests/test_torch_cuda.py` and
`chip_smoke.py` draw their cases here."""

from __future__ import annotations

import numpy as np
import torch

from shrimp_tpu_torch.ops import sw_full_cs
from shrimp_tpu_torch.ops.sw_full_cs import OP_DEL, OP_INS, OP_MATCH, OP_XOVER

GENOME_PAD, READ_PAD, BASE_N = -1, -2, 15
QUAL_DELTA = 33
# the hand-made rows at the head of every case, in order
EDGES = ("n_in_prefix", "n_in_column", "read_start", "del_first",
         "ins_first", "gap_runs", "crossovers", "below_threshold",
         "zero_score")


def _ops_row(rng, n_cols: int, kind: str) -> list[int]:
    """Ops of an alignment that consumes n_cols read colours: matches with
    gaps of both kinds, layers and crossovers as `kind` asks."""
    layer = int(rng.integers(0, 4)) if kind == "crossovers" else 0
    out: list[int] = []

    def op(typ, x=False):
        out.append(typ | layer << 2 | (OP_XOVER if x else 0))

    if kind == "del_first":
        op(OP_DEL)
    elif kind == "ins_first":
        op(OP_INS)
        op(OP_INS)
    used = sum(1 for o in out if o & 3 != OP_INS)
    while used < n_cols:
        u = rng.random()
        runs = kind == "gap_runs"
        if u < (0.12 if runs else 0.04) and used < n_cols - 1:
            for _ in range(int(rng.integers(1, 5 if runs else 3))):
                if used < n_cols:
                    op(OP_DEL)
                    used += 1
        elif u < (0.24 if runs else 0.08):
            for _ in range(int(rng.integers(1, 5 if runs else 3))):
                op(OP_INS)
        else:
            x = kind == "crossovers" and rng.random() < 0.2
            if x:
                layer = int(rng.integers(0, 4))
            op(OP_MATCH, x or (kind != "crossovers" and rng.random() < 0.03))
            used += 1
    if not any(o & 3 == OP_MATCH for o in out):
        out[-1] = OP_MATCH | layer << 2
    return out


def packed_case(rng: np.random.Generator, N: int, R: int, B: int = 32, *,
                qual_vector_offset: int = 0, quals: str = "mixed") -> dict:
    """The packed posterior's arguments (CPU tensors, `probs` and the
    keywords left out) for N rows over B reads of up to R colours: the
    rows of EDGES first, then random ones.  Reads have colours 0-3 with N
    (15), quality bytes from below QUAL_DELTA to 79 (`quals`: "mixed",
    some reads without; "none", every read without), primers 0-3; windows
    letters 0-3 with N and IUPAC codes and a GENOME_PAD tail; decodings
    0-3 with N.  Returns {"args": [...], "read_len": [...], "quals":
    [str | None]}, the last two per read."""
    G = R + 96
    read_len = rng.integers(max(R // 2, 1), R + 1, B)
    colours = np.full((B, R), READ_PAD, np.int8)
    Q = qual_vector_offset + R
    qual = np.zeros((B, Q), np.uint8)
    has_qual = np.ones(B, bool)
    if quals == "none":
        has_qual[:] = False
    else:
        has_qual[rng.random(B) < 0.2] = False
    for b in range(B):
        n = int(read_len[b])
        colours[b, :n] = rng.choice(np.array([0, 1, 2, 3, BASE_N], np.int8),
                                    n, p=[.2425] * 4 + [.03])
        qual[b, :qual_vector_offset + n] = rng.integers(
            QUAL_DELTA - 8, QUAL_DELTA + 47, qual_vector_offset + n)
    initbp = rng.integers(0, 4, B).astype(np.int8)

    genome = rng.choice(np.array([0, 1, 2, 3, 15, 6], np.int8), (N, G),
                        p=[.24] * 4 + [.02, .02])
    qr4 = rng.choice(np.array([0, 1, 2, 3, 15], np.int8), (N, 4, R),
                     p=[.2475] * 4 + [.01])
    ops = np.zeros((N, R + G), np.uint8)
    stats = np.zeros((N, 11), np.int32)
    thresh = rng.integers(10, 40, N).astype(np.int32)
    rid = rng.integers(0, B, N).astype(np.int32)
    for n in range(N):
        kind = EDGES[n] if n < len(EDGES) else "random"
        b = int(rid[n])
        if kind == "n_in_prefix":
            rs = min(3, int(read_len[b]) - 1)
            colours[b, min(1, rs - 1)] = BASE_N
        elif kind == "read_start":
            rs = int(rng.integers(1, max(int(read_len[b]) // 4, 2)))
        elif kind == "random":
            rs = int(rng.integers(0, max(int(read_len[b]) // 4, 1)))
        else:
            rs = 0
        n_cols = int(rng.integers(max((read_len[b] - rs) // 2, 1),
                                  read_len[b] - rs + 1))
        if kind == "n_in_column":
            colours[b, rs + n_cols // 2] = BASE_N
        row = _ops_row(rng, n_cols, kind)[:R + G]
        typ = np.array(row) & 3
        gs = int(rng.integers(0, 8))
        glen = gs + int((typ != OP_DEL).sum())
        genome[n, glen + int(rng.integers(0, 4)):] = GENOME_PAD
        qr4[n, :, read_len[b]:] = READ_PAD
        ops[n, :len(row)] = row
        score = int(rng.integers(thresh[n], 200))
        if kind == "below_threshold":
            score = int(thresh[n]) - 1
        elif kind == "zero_score":
            score = 0
        elif kind == "random" and rng.random() < 0.1:
            score = int(rng.integers(-5, int(thresh[n])))
        stats[n, 0] = score
        stats[n, 1] = rs
        stats[n, 2] = gs
        stats[n, 7] = int((typ != OP_INS).sum())
        stats[n, 8] = int((typ != OP_DEL).sum())
        stats[n, 9] = len(row)
    qstrs = [bytes(qual[b, :qual_vector_offset + read_len[b]]).decode(
        "latin-1") if has_qual[b] else None for b in range(B)]
    args = [torch.from_numpy(a) for a in (
        ops, stats, genome, qr4, rid, thresh, colours, qual, has_qual,
        initbp)]
    return {"args": args, "read_len": read_len.tolist(), "quals": qstrs}


def rendered_items(case: dict) -> tuple[list[int], list[dict]]:
    """The rows `post_sw_packed` computes and, for each, the item
    `post_sw_batch` takes: the alignment rendered from its ops
    (`render_alignment_cs`), as the port's Mapper rendered it before the
    packed form."""
    ops, stats, genome, qr4, rid, thresh, colours = (
        t.numpy() for t in case["args"][:7])
    initbp = case["args"][9].numpy()
    score = stats[:, 0].astype(np.int64)
    rows = np.flatnonzero((score > 0) & (score >= thresh)).tolist()
    items = []
    for n in rows:
        b = int(rid[n])
        db, qr = sw_full_cs.render_alignment_cs(
            ops[n, :stats[n, 9]], genome[n], qr4[n], int(stats[n, 2]),
            int(stats[n, 1]))
        items.append({"colours": colours[b, :case["read_len"][b]],
                      "initbp": int(initbp[b]), "qual": case["quals"][b],
                      "read_start": int(stats[n, 1]),
                      "dbalign": db, "qralign": qr})
    return rows, items
