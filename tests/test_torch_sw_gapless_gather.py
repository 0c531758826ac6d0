"""Gapless pass 1 with its diagonals gathered from the resident planes:
the port's plain `p1_gather_gapless_ls` / `p1_gather_gapless_cs`, and its
`Mapper._gapless_scores` on the CPU, against the JAX package's
`Mapper._gapless_scores`, which gathers every diagonal on the host.  Each
package builds its own index from the same FASTA; the hits come from a
numpy seed and reach both strands, diagonals that start before the read
(d0 < 0), run past the contig end (the last contig too) or start on an N
with the read's first colour, reads of mixed length and R of 8, 37, 56
and 1,000.

Then models of the kernel `csrc/sw_gapless.cu`, which cannot run here:
its per-thread scan order (Kadane's running max, columns that score 0
skipped) held to the plain prefix / running-minimum form on random and
extreme columns; and one thread's whole work, with both streams read in
aligned 16-byte chunks at any alignment of the tensors, held to the plain
versions.  Run this file after any change to the kernel's order.  Scores
are integers: every comparison is exact."""

import os
import zlib

import numpy as np
import pytest
import torch

from shrimp_tpu import index as jindex
from shrimp_tpu.io import fastx as jfastx
from shrimp_tpu.ops.params import SWParams as JaxParams
from shrimp_tpu.pipeline import candidates as jcand
from shrimp_tpu.pipeline.mapper import Mapper as JaxMapper
from shrimp_tpu.pipeline.options import MapperConfig as JaxConfig
from shrimp_tpu_torch import index as gindex
from shrimp_tpu_torch.io import fastx
from shrimp_tpu_torch.ops import sw_gapless as tsg
from shrimp_tpu_torch.ops import sw_vector as tsv
from shrimp_tpu_torch.ops.params import SWParams
from shrimp_tpu_torch.pipeline import candidates as cand
from shrimp_tpu_torch.pipeline.mapper import Mapper
from shrimp_tpu_torch.pipeline.options import MapperConfig

LS = SWParams.letter_space()
CS = SWParams.colour_space()
# a positive mismatch: every column in range raises the running sum
ODD = SWParams(match=3, mismatch=1)
# contig lengths; the last is the shortest, so diagonals run off its end
# into the plane's pad tail
CONTIGS = (1_500, 2_600, 700)
R_CASES = (8, 37, 56, 1000)


def _genome(rng) -> list[str]:
    """Random contigs with runs of N and a few other IUPAC codes."""
    out = []
    for n in CONTIGS:
        seq = rng.choice(list("ACGT"), n)
        for _ in range(4):
            p = int(rng.integers(0, n - 6))
            seq[p:p + int(rng.integers(1, 6))] = "N"
        seq[rng.integers(0, n, 3)] = rng.choice(list("RYK"), 3)
        out.append("".join(seq))
    return out


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    rng = np.random.default_rng(20261017)
    seqs = _genome(rng)
    path = os.path.join(tmp_path_factory.mktemp("gapless"), "genome.fa")
    with open(path, "w") as fh:
        for i, s in enumerate(seqs):
            fh.write(f">chr{i + 1}\n{s}\n")
    out = {}
    for cs in (False, True):
        idx = gindex.build_index(list(fastx.iter_contigs(path)),
                                 colour_space=cs)
        jidx = jindex.build_index(list(jfastx.iter_contigs(path)),
                                  colour_space=cs)
        if cs:
            cfg = MapperConfig(colour_space=True, params=CS, qual_delta=33)
            jcfg = JaxConfig(colour_space=True,
                             params=JaxParams.colour_space(), qual_delta=33)
        else:
            cfg, jcfg = MapperConfig(qual_delta=64), JaxConfig(qual_delta=64)
        out[cs] = (Mapper(idx, cfg, device="cpu"), JaxMapper(jidx, jcfg))
    return out


def _reads(rng, m: Mapper, R: int, B: int = 40) -> list:
    """B reads of mixed lengths up to R: in letter space half cut from the
    genome (high-scoring diagonals), in colour space a primer and colours,
    every fifth read's first colour a '.' (BASE_N)."""
    idx = m.index
    reads = []
    for b in range(B):
        n = int(rng.integers(max(1, R // 3), R + 1))
        if m.cfg.colour_space:
            cols = rng.choice(list("0123"), n)
            if b % 5 == 0:
                cols[0] = "."
            seq = str(rng.choice(list("ACGT"))) + "".join(cols)
        elif b % 2 == 0 and n <= idx.total_len:
            p = int(rng.integers(0, idx.total_len - n + 1))
            seq = "".join("ACGTN"[min(int(c), 4)]
                          for c in idx.genome[p:p + n])
        else:
            seq = "".join(rng.choice(list("ACGT"), n))
        reads.append((f"r{b}", seq, None if not m.cfg.colour_space
                      else "I" * (len(seq) - 1)))
    return reads


def _hits(rng, m: Mapper, entries, N: int) -> dict:
    """Pass-1 hit columns as `_pass1_dispatch` passes them: random, then
    the cases that matter forced in slices."""
    idx = m.index
    C = idx.num_contigs
    rlen_b = np.array([e.read_len for e in entries], np.int64)
    rid = np.sort(rng.integers(0, len(entries), N)).astype(np.int32)
    st = rng.integers(0, 2, N).astype(np.int8)
    cn = rng.integers(0, C, N).astype(np.int32)
    clen = idx.contig_len[cn].astype(np.int64)
    rlen = rlen_b[rid]
    w_len = (rlen + rng.integers(0, 24, N)).astype(np.int32)
    g_off = rng.integers(0, clen).astype(np.int64)
    ax = rng.integers(0, w_len).astype(np.int64)
    ay = rng.integers(0, rlen).astype(np.int64)
    al = rng.integers(1, 12, N).astype(np.int64)
    aw = rng.integers(1, 4, N).astype(np.int64)
    k = max(N // 8, 1)
    # d0 < 0: the diagonal starts at the contig's first column, the read
    # later
    sl = slice(0, k)
    g_off[sl], ax[sl] = 0, 0
    ay[sl] = rng.integers(0, np.maximum(rlen[sl], 1))
    # diagonals running past the contig end, half of them in the last
    sl = slice(k, 2 * k)
    cn[k:k + k // 2] = C - 1
    clen = idx.contig_len[cn].astype(np.int64)
    g_off[sl] = clen[sl] - rng.integers(1, 12, k)
    ax[sl] = 0
    ay[sl] = 0
    # r_left == 0 on an N (forward strand, so the frame is the contig's)
    n_pos = np.flatnonzero(idx.genome > 3)
    sl = slice(2 * k, 3 * k)
    pick = n_pos[rng.integers(0, len(n_pos), k)]
    cn[sl] = np.searchsorted(idx.contig_offsets, pick, side="right") - 1
    g_off[sl] = pick - idx.contig_offsets[cn[sl]]
    st[sl] = 0
    ax[sl] = ay[sl] = 0
    return dict(rid=rid, st=st, cn=cn, g_off_pos=g_off, ax=ax, ay=ay,
                al=al, aw=aw, w_len=w_len)


def _case(corpus, cs: bool, R: int, seed: int):
    m, jm = corpus[cs]
    rng = np.random.default_rng(seed)
    reads = _reads(rng, m, R)
    entries = cand.prepare_reads(reads, m.cfg, m.min_seed_span)
    jentries = jcand.prepare_reads(reads, jm.cfg, jm.min_seed_span)
    hits = _hits(rng, m, entries, 120 if R >= 1000 else 400)
    return m, jm, entries, jentries, hits


def _framing(m: Mapper, entries, h: dict):
    """start, glen, r_left of each hit, framed as `Mapper._gapless_scores`
    frames them (d0 from the anchor; colour space's reverse_hit), written
    out anew."""
    idx = m.index
    g_off, ax, ay = (h[k].astype(np.int64) for k in ("g_off_pos", "ax",
                                                      "ay"))
    clen = idx.contig_len[h["cn"]].astype(np.int64)
    half = np.zeros(len(g_off), np.int64)
    if m.cfg.colour_space:
        rev = h["st"] != 0
        wl = h["w_len"].astype(np.int64)
        rlen = np.array([e.read_len for e in entries], np.int64)[h["rid"]]
        al, aw = h["al"], h["aw"]
        g_off = np.where(rev, clen - g_off - wl, g_off)
        ax = np.where(rev, -ax + (wl - 1) - (al - 1) - (aw - 1), ax)
        ay = np.where(rev, -ay + (rlen - 1) - (al - 1) + (aw - 1), ay)
        half[rev] = idx.total_len
    d0 = g_off + ax - ay
    g_left = np.maximum(d0, 0)
    start = idx.contig_offsets[h["cn"]].astype(np.int64) + g_left + half
    return (torch.from_numpy(start), torch.from_numpy(clen - g_left),
            torch.from_numpy(np.maximum(-d0, 0).astype(np.int32)))


def _plain(m: Mapper, entries, h: dict, R: int) -> torch.Tensor:
    start, glen, r_left = _framing(m, entries, h)
    rid = torch.from_numpy(h["rid"].astype(np.int32))
    rb2 = torch.from_numpy(m._reads2_matrix(entries, R))
    dix = m.dev_index
    if not m.cfg.colour_space:
        return tsg.p1_gather_gapless_ls_plain(
            dix.plane, start, glen, r_left, rid,
            torch.from_numpy(h["st"].astype(np.int32)), rb2, m.vect_params)
    initbp = torch.tensor([e.initbp for e in entries], dtype=torch.int8)
    return tsg.p1_gather_gapless_cs_plain(
        dix.cs_cat, dix.ls_cat, start, glen, r_left, rid, initbp, rb2,
        m.vect_params)


@pytest.mark.parametrize("R", R_CASES)
@pytest.mark.parametrize("cs", [False, True], ids=["ls", "cs"])
def test_gather_equals_jax_gapless_scores(corpus, cs, R):
    m, jm, entries, jentries, h = _case(corpus, cs, R, seed=R)
    order = ("rid", "st", "cn", "g_off_pos", "ax", "ay", "al", "aw", "w_len")
    want = jm._gapless_scores(jentries, *(h[k] for k in order), R,
                              len(h["rid"]))
    got = m._gapless_scores(entries, *(h[k] for k in order), R)
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(_plain(m, entries, h, R).numpy(), want)
    # the cases are there: scores above 0, d0 < 0, past the contig end,
    # and (colour space) forced first colours that matched
    assert (want > 0).sum() > len(want) // 4
    if cs:
        start, glen, r_left = _framing(m, entries, h)
        assert ((r_left == 0) & (glen > 0)).any() and (r_left > 0).any()
        assert (glen < R).any()


def test_pad_codes_agree():
    assert (tsg.GENOME_PAD, tsg.READ_PAD) == (tsv.GENOME_PAD, tsv.READ_PAD)
    assert tsg.BASE_N == tsv.BASE_N


# ---------------------------------------------------------------------------
# the kernel's scan order
def scan_model(diag, reads, params, s0=None) -> np.ndarray:
    """Kadane's running scan, as each thread runs it: cur = max(cur, 0) +
    s_t, best = max(best, cur), from 0; column 0 takes s0; the columns
    from the first at which either side is a pad on to the end, and the
    leading ones where either side is a pad, are not visited."""
    diag = np.asarray(diag, np.int64)
    reads = np.asarray(reads, np.int64)
    N, R = diag.shape
    s = np.where(diag == reads, params.match, params.mismatch)
    s = np.where((diag != tsg.GENOME_PAD) & (reads != tsg.READ_PAD), s, 0)
    out = np.zeros(N, np.int64)
    for n in range(N):
        cur = best = 0
        t_begin = 0
        if s0 is not None:
            cur, best, t_begin = int(s0[n]), max(int(s0[n]), 0), 1
        for t in range(t_begin, R):
            cur = max(cur, 0) + int(s[n, t])
            best = max(best, cur)
        out[n] = best
    assert np.all(np.abs(out) < 2 ** 31)
    return out


def _columns(rng, kind: str, N: int, R: int):
    diag = rng.integers(0, 5, (N, R)).astype(np.int8)
    if kind == "matches":
        reads = diag.copy()
    elif kind == "mismatches":
        reads = ((diag.astype(np.int64) + 1) % 5).astype(np.int8)
    else:
        reads = np.where(rng.random((N, R)) < 0.7, diag,
                         rng.integers(0, 5, (N, R))).astype(np.int8)
        cols = np.arange(R)[None, :]
        diag[cols >= rng.integers(0, R + 1, (N, 1))] = tsg.GENOME_PAD
        reads[cols >= rng.integers(0, R + 1, (N, 1))] = tsg.READ_PAD
    return diag, reads


@pytest.mark.parametrize("kind", ["random", "matches", "mismatches"])
@pytest.mark.parametrize("params", [LS, CS, ODD], ids=["ls", "cs", "odd"])
@pytest.mark.parametrize("s0", [None, "scores", "limits"])
def test_scan_order_equals_prefix_form(kind, params, s0):
    rng = np.random.default_rng(zlib.crc32(f"{kind} {s0} {params}"
                                           .encode()))
    N, R = 200, 61
    diag, reads = _columns(rng, kind, N, R)
    s0v = None
    if s0 == "scores":
        s0v = rng.choice([0, params.match, params.mismatch], N)
    elif s0 == "limits":
        # the largest column-0 scores that leave a row's sums in int32
        lim = 2 ** 31 - 1 - R * max(abs(params.match), abs(params.mismatch))
        s0v = rng.choice([lim, -lim, lim - 1, 1 - lim], N)
    want = tsg.gapless_score_batch_plain(
        torch.from_numpy(diag), torch.from_numpy(reads), params,
        None if s0v is None else torch.from_numpy(s0v.astype(np.int32)))
    assert np.array_equal(scan_model(diag, reads, params, s0v),
                          want.numpy())


# ---------------------------------------------------------------------------
# one thread's work
def _funnel(lo: int, hi: int, sh: int) -> int:
    return (((hi << 32) | lo) >> (sh & 31)) & 0xFFFFFFFF


# the kernel's chunk: 16 bytes, four 32-bit words
LOAD = 16


class Stream:
    """`Stream` of csrc/sw_gapless.cu: the bytes at p + t for t =
    t_begin, ..., LOAD a step, read in aligned LOAD-byte chunks from a
    tensor `mem` at address `base`; a chunk is loaded only where it holds
    a byte of [p + t_begin, p + t_end), byte by byte where it reaches past
    the tensor."""

    def __init__(self, mem: np.ndarray, base: int, p: int, t_begin: int,
                 t_end: int):
        self.mem = mem.view(np.uint8)
        self.lo, self.hi = base, base + len(mem)
        self.use_lo, self.use_hi = p + t_begin, p + t_end
        self.loads = 0
        c0 = self.use_lo & ~(LOAD - 1)
        off = self.use_lo - c0
        self.word, self.shift = off >> 2, (off & 3) * 8
        self.cur = self._load(c0)
        self.next = c0 + LOAD

    def _load(self, c: int) -> list:
        w = [0] * (LOAD // 4)
        if c + LOAD <= self.use_lo or c >= self.use_hi:
            return w
        self.loads += 1
        for i in range(LOAD):
            if self.lo <= c + i < self.hi:
                w[i >> 2] |= int(self.mem[c + i - self.lo]) << (8 * (i & 3))
        return w

    def step(self) -> list:
        nxt = self._load(self.next)
        self.next += LOAD
        v = self.cur + nxt
        out = [_funnel(v[self.word + j], v[self.word + j + 1], self.shift)
               for j in range(4)]
        self.cur = nxt
        return out


def _i8(word: int, i: int) -> int:
    b = (word >> (8 * (i & 3))) & 0xFF
    return b - 256 if b >= 128 else b


def kernel_model(plane, start, glen, r_left, rid, st, reads2, params,
                 bases: tuple, ls_plane=None, initbp=None,
                 s0=None) -> np.ndarray:
    """sw_gapless_kernel, thread by thread, with the plane at address
    bases[0] and the read matrix at bases[1].  start None: the
    pre-gathered form (plane = the [N, R] diagonals, reads2 [N, 1, R])."""
    plane = plane.numpy()
    reads = reads2.numpy()
    B, S, R = reads.shape
    flat = reads.reshape(-1)
    N = B if start is None else len(start)
    out = np.zeros(N, np.int64)
    for n in range(N):
        if start is None:
            s, gl, rl, i_d, strand = n * R, R, 0, n, 0
        else:
            s, gl, rl = int(start[n]), int(glen[n]), int(r_left[n])
            i_d = int(rid[n])
            strand = 0 if st is None else int(st[n])
        g_lo = -s if s < 0 else 0
        g_hi = min(gl, len(plane) - s)
        r_lo = -rl if rl < 0 else 0
        r_hi = R - rl
        lo = min(max(g_lo, r_lo), R)
        hi = max(min(g_hi, r_hi, R), 0)
        row = (i_d * S + strand) * R
        cur = best = 0
        t_begin = lo
        if s0 is not None or (ls_plane is not None and rl == 0):
            if s0 is not None:
                v = int(s0[n])
            else:
                letter = (int(ls_plane[s]) if g_lo <= 0 < g_hi
                          else tsg.GENOME_PAD)
                colour = (letter ^ int(initbp[i_d]) if 0 <= letter <= 3
                          else tsg.BASE_N)
                r0 = int(flat[row]) if R > 0 else tsg.READ_PAD
                v = params.match if colour == r0 else 0
            cur, best, t_begin = v, max(v, 0), max(lo, 1)
        if t_begin < hi:
            g = Stream(plane, bases[0], bases[0] + s, t_begin, hi)
            r = Stream(flat, bases[1], bases[1] + row + rl, t_begin, hi)
            for t0 in range(t_begin, hi, LOAD):
                gw, rw = g.step(), r.step()
                for i in range(LOAD):
                    gc, rc = _i8(gw[i >> 2], i), _i8(rw[i >> 2], i)
                    sc = params.match if gc == rc else params.mismatch
                    if gc == tsg.GENOME_PAD or rc == tsg.READ_PAD \
                            or t0 + i >= hi:
                        sc = 0
                    cur = max(cur, 0) + sc
                    best = max(best, cur)
            # every chunk it loaded held a byte of a visited column
            assert g.loads <= -(-(hi - t_begin) // LOAD) + 1
        out[n] = best
    return out


# tensor addresses of every alignment a 16-byte chunk can meet
BASES = [(0x7F0000000000, 0x7F1000000000), (0x7F0000000003, 0x7F1000000009),
         (0x7F000000000E, 0x7F1000000005)]


@pytest.mark.parametrize("bases", range(len(BASES)))
@pytest.mark.parametrize("R", R_CASES)
@pytest.mark.parametrize("cs", [False, True], ids=["ls", "cs"])
def test_kernel_model_equals_plain(corpus, cs, R, bases):
    m, _, entries, _, h = _case(corpus, cs, R, seed=R + 7)
    n = 40 if R >= 1000 else 160
    h = {k: v[:n] for k, v in h.items()}
    want = _plain(m, entries, h, R)
    start, glen, r_left = _framing(m, entries, h)
    rb2 = torch.from_numpy(m._reads2_matrix(entries, R))
    dix = m.dev_index
    rid = h["rid"]
    if cs:
        initbp = np.array([e.initbp for e in entries], np.int64)
        got = kernel_model(dix.cs_cat, start, glen, r_left, rid, None, rb2,
                           m.vect_params, BASES[bases],
                           ls_plane=dix.ls_cat.numpy(), initbp=initbp)
    else:
        got = kernel_model(dix.plane, start, glen, r_left, rid, h["st"],
                           rb2, m.vect_params, BASES[bases])
    assert np.array_equal(got, want.numpy())


@pytest.mark.parametrize("R", [8, 37, 56])
def test_kernel_model_pregathered_equals_plain(R):
    """The pre-gathered form (gapless_score_batch): the [N, R] rows end at
    the tensors' ends, so the last chunks are read byte by byte."""
    rng = np.random.default_rng(R * LOAD)
    diag, reads = _columns(rng, "random", 97, R)
    s0 = rng.choice([0, CS.match, CS.mismatch], 97).astype(np.int32)
    for s0v in (None, s0):
        want = tsg.gapless_score_batch_plain(
            torch.from_numpy(diag), torch.from_numpy(reads), CS,
            None if s0v is None else torch.from_numpy(s0v))
        got = kernel_model(torch.from_numpy(diag.reshape(-1).copy()), None,
                           None, None, None, None,
                           torch.from_numpy(reads).reshape(97, 1, R), CS,
                           BASES[1], s0=s0v)
        assert np.array_equal(got, want.numpy())


def test_plain_empty_and_refusals():
    e = torch.zeros(0, dtype=torch.int64)
    z = torch.zeros(0, dtype=torch.int32)
    plane = torch.zeros(16, dtype=torch.int8)
    rb2 = torch.zeros((1, 2, 8), dtype=torch.int8)
    assert tsg.p1_gather_gapless_ls(plane, e, e, z, z, z, rb2,
                                    LS).shape == (0,)
    assert tsg.p1_gather_gapless_cs(plane, plane, e, e, z, z,
                                    torch.zeros(1, dtype=torch.int8), rb2,
                                    CS).shape == (0,)
    meta = torch.zeros(16, dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="CPU tensors"):
        tsg.p1_gather_gapless_ls_plain(meta, e, e, z, z, z, rb2, LS)
    with pytest.raises(ValueError, match="CUDA"):
        tsg.p1_gather_gapless_ls_cuda(plane, e, e, z, z, z, rb2, LS)
    with pytest.raises(ValueError, match="CUDA"):
        tsg.p1_gather_gapless_cs_cuda(plane, plane, e, e, z, z,
                                      torch.zeros(1, dtype=torch.int8), rb2,
                                      CS)
