"""Synthetic corpora for size runs: a genome with diverged repeats, and
mutated letter-space and colour-space reads and read pairs drawn from it
with their true positions.

The generators of the JAX package's bench (`bench.make_genome`,
`bench.mutate_read`, `bench.make_reads`) and grid bench
(`benchmarks/bench_grid.py::make_cs_reads`, `make_pairs`), kept here so
that the port needs nothing outside its own package; with the same seeds
they give the same arrays.  The genome size is an argument instead of a module global.
"""

from __future__ import annotations

import numpy as np

from shrimp_tpu_torch import dna

READ_LEN = 50


def make_genome(rng, genome_bp: int = 10**9):
    """`genome_bp` bases in 25 chromosomes with interspersed diverged
    repeats (~10% SINE-like, ~7% LINE-like, 5-15% divergence)."""
    sine = rng.integers(0, 4, 300).astype(np.int8)       # Alu-like
    line = rng.integers(0, 4, 6000).astype(np.int8)      # LINE-like
    chroms = []
    n_chrom = 25
    clen = genome_bp // n_chrom
    for ci in range(n_chrom):
        g = rng.integers(0, 4, clen).astype(np.int8)
        # all copies mutated as one matrix, scattered at once
        for elem, cover in ((sine, 0.10), (line, 0.07)):
            E = len(elem)
            n_copies = int(clen * cover / E)
            pos = rng.integers(0, clen - E, n_copies)
            copies = np.broadcast_to(elem, (n_copies, E)).copy()
            div = (rng.random((n_copies, 1)) * 0.10 + 0.05)
            mut = rng.random((n_copies, E)) < div
            copies[mut] = (copies[mut]
                           + rng.integers(1, 4, int(mut.sum()))) % 4
            g[pos[:, None] + np.arange(E)[None, :]] = copies
        chroms.append(g)
    return chroms


def mutate_read(seq_plus, rng, read_len=READ_LEN):
    """1 SNP + 1 indel (<= 5 bp) + 4% per-base error, applied to a
    base-code slice of >= read_len + 5 codes; returns read_len codes."""
    r = seq_plus.copy()
    q = int(rng.integers(0, read_len))
    r[q] = (r[q] + int(rng.integers(1, 4))) % 4
    ilen = int(rng.integers(1, 6))
    qi = int(rng.integers(5, read_len - 5))
    if rng.random() < 0.5:
        r = np.delete(r, slice(qi, qi + ilen))
    else:
        ins = rng.integers(0, 4, ilen).astype(r.dtype)
        r = np.insert(r, qi, ins)
    r = r[:read_len]
    err = rng.random(read_len) < 0.04
    r[err] = (r[err] + rng.integers(1, 4, int(err.sum()))) % 4
    return r


def make_reads(idx, rng, n_reads):
    """Mutated letter-space reads (mutate_read) from both strands of
    `idx.genome`, as (name, seq, qual) triples, and their true starts."""
    genome = idx.genome
    L = len(genome)
    reads = []
    truth = []
    for i in range(n_reads):
        p = int(rng.integers(0, L - READ_LEN - 8))
        r = mutate_read(genome[p:p + READ_LEN + 6], rng)
        rc = bool(rng.random() < 0.5)
        if rc:
            r = dna.reverse_complement(r)
        reads.append((f"r{i:05d}", dna.decode(r), "h" * len(r)))
        truth.append(p)
    return reads, np.array(truth)


def make_cs_reads(idx, rng, n_reads):
    """SOLiD-style colour-space reads (T primer + colour digits): the
    letter mutations of mutate_read applied before colour encoding, with
    PHRED+33 qualities 15-40; (name, seq, qual) triples and true starts."""
    genome = idx.genome
    L = len(genome)
    reads = []
    truth = []
    for i in range(n_reads):
        p = int(rng.integers(0, L - READ_LEN - 16))
        letters = mutate_read(genome[p:p + READ_LEN + 6].astype(np.int64),
                              rng)
        last = 3                                 # T primer
        cs = ["T"]
        for b in letters:
            cs.append(str(int(b) ^ last))
            last = int(b)
        qual = "".join(chr(33 + int(rng.integers(15, 41)))
                       for _ in range(READ_LEN))
        reads.append((f"c{i:05d}", "".join(cs), qual))
        truth.append(p)
    return reads, np.array(truth)


def make_pairs(idx, rng, n_pairs):
    """Opp-in read pairs, insert 150-450, each READ_LEN mate mutated by
    mutate_read (1 SNP + 1 indel + 4% error); ((name, seq, qual), (name,
    seq, qual)) pairs and the truth, mate 1's start."""
    genome = idx.genome
    L = len(genome)
    pairs = []
    truth = []
    for i in range(n_pairs):
        ins = int(rng.integers(150, 450))
        p = int(rng.integers(0, L - ins - 16))
        m1 = mutate_read(genome[p:p + READ_LEN + 6], rng)
        m2 = dna.reverse_complement(mutate_read(
            genome[p + ins - READ_LEN:p + ins + 6], rng))
        pairs.append(((f"p{i:05d}/1", dna.decode(m1), "h" * READ_LEN),
                      (f"p{i:05d}/2", dna.decode(m2), "h" * READ_LEN)))
        truth.append(p)
    return pairs, np.array(truth)
