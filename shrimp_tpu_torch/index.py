"""Spaced-seed genome index — CSR posting lists (L1/L3).

The reference builds, per seed, a table `genomemap[sn][mapidx] -> uint32*`
of growing position lists by sliding a window over the concatenated genome
(`gmapper/genome.c:1141-1166`).  The TPU-native layout is CSR: one
`offsets[4^weight + 1]` array plus one flat `positions[]` array per seed,
built by a vectorized counting sort — gather-friendly, serializable, and
shardable by genome range.

Semantics mirrored:
  * positions are **global** coordinates over concatenated contigs; the value
    stored for a window ending at global i is `i - span + 1` (genome.c:1164).
  * windows containing N/X are skipped (`load` reset, genome.c:1148-1152).
  * mapidx packs the seed's '1' positions, 2 bits per base (`code & 3`;
    IUPAC codes alias onto ACGT — gmapper.h:342-366 and its XXX note), with
    the base under the **last** pattern position most significant.
  * `-H` hash mode maps the masked 4-bit kmer window into 2^24 buckets via
    the reference's chained 32-bit hash (kmer_to_mapidx_hash,
    gmapper.h:308-337) — replicated exactly in `hash_mapidx` so -H runs
    are byte-comparable.
  * list trimming: lists longer than a cutoff are dropped wholesale
    (`trim_genome`, genome.c:1188; query-time skip, mapping.c:901-903).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field

import numpy as np

from shrimp_tpu_torch import dna
from shrimp_tpu_torch.io import fastx
from shrimp_tpu_torch.seeds import SeedSet, make_seed_set

INDEX_FORMAT_VERSION = 1   # analogue of map_version (gmapper-definitions.h:310)

HASH_BITS = 24


def _jenkins32(a: np.ndarray) -> np.ndarray:
    """The reference's 32-bit integer hash (gmapper.h:308-318)."""
    a = np.asarray(a, dtype=np.uint32)
    a = (a + np.uint32(0x7ED55D16)) + (a << np.uint32(12))
    a = (a ^ np.uint32(0xC761C23C)) ^ (a >> np.uint32(19))
    a = (a + np.uint32(0x165667B1)) + (a << np.uint32(5))
    a = (a + np.uint32(0xD3A2646C)) ^ (a << np.uint32(9))
    a = (a + np.uint32(0xFD7046C5)) + (a << np.uint32(3))
    a = (a ^ np.uint32(0xB55A4F09)) ^ (a >> np.uint32(16))
    return a


def hash_mapidx(codes: np.ndarray, starts: np.ndarray, span: int,
                ones_idx: np.ndarray, max_span: int) -> np.ndarray:
    """kmer_to_mapidx_hash (gmapper.h:322-337): the rolling 4-bit kmer
    window (nibble 0 = newest base, bitfield_prepend) is masked by the
    seed's one-positions and its BPTO32BW(max_seed_span) words are chained
    through `hash((word & mask) ^ acc)`; trailing all-zero words still
    advance the chain."""
    starts = np.asarray(starts, dtype=np.int64)
    key = np.zeros(len(starts), np.uint32)
    codes_u = np.asarray(codes)
    W = (max_span + 7) // 8
    for w in range(W):
        v = np.zeros(len(starts), np.uint32)
        for o in ones_idx:
            j = span - 1 - int(o)          # nibble index from the window end
            if j // 8 != w:
                continue
            v |= ((codes_u[starts + int(o)].astype(np.uint32))
                  & np.uint32(0xF)) << np.uint32(4 * (j % 8))
        key = _jenkins32(v ^ key)
    return key & np.uint32((1 << HASH_BITS) - 1)


def compute_mapidx(codes: np.ndarray, starts: np.ndarray, ones_idx: np.ndarray,
                   use_hashing: bool = False) -> np.ndarray:
    """mapidx for windows starting at `starts` of a code array.

    mapidx = sum_k (codes[start + ones_idx[k]] & 3) << 2k, matching
    kmer_to_mapidx_orig's bit order (gmapper.h:348-366).
    """
    w = len(ones_idx)
    acc = np.zeros(len(starts), dtype=np.uint64)
    for k in range(w):
        acc |= ((codes[starts + ones_idx[k]].astype(np.uint64)) & np.uint64(3)) \
            << np.uint64(2 * k)
    if use_hashing:
        raise ValueError("use hash_mapidx for -H seeds")
    return acc.astype(np.uint32)


@dataclass
class GenomeIndex:
    """In-memory (host) genome index; `device()` ships it to TPU HBM."""

    contig_names: list[str]
    contig_offsets: np.ndarray        # int64[C] global start of each contig
    contig_len: np.ndarray            # int64[C]
    genome: np.ndarray                # int8[L] concatenated letter-space codes
    seed_set: SeedSet
    offsets: list[np.ndarray]         # per seed: int64[buckets + 1]
    positions: list[np.ndarray]       # per seed: uint32[total]
    colour_space: bool = False
    genome_cs: np.ndarray | None = None   # colour translation (CS mode)
    list_cutoff: int = 0xFFFFFFFF     # DEF_LIST_CUTOFF
    stats: dict = field(default_factory=dict)

    @property
    def total_len(self) -> int:
        return int(self.genome.shape[0])

    @property
    def num_contigs(self) -> int:
        return len(self.contig_names)

    def contig_of(self, pos: np.ndarray) -> np.ndarray:
        """Global position -> contig number (get_contig_num,
        gmapper.h:374-406)."""
        return np.searchsorted(self.contig_offsets, pos, side="right") - 1

    def list_length_histogram(self, sn: int, bins: int = 32) -> np.ndarray:
        """`-Y` projection-list histogram (genome.c:834)."""
        lens = np.diff(self.offsets[sn])
        lens = lens[lens > 0]
        return np.histogram(lens, bins=bins)[0]

    def trim(self, cutoff: int) -> None:
        """Drop posting lists longer than cutoff (trim_genome,
        genome.c:1188-1207)."""
        from shrimp_tpu_torch import native as native_mod
        nlib = native_mod.load_index()
        use_native = nlib is not None and hasattr(nlib, "index_trim")
        for sn in range(len(self.offsets)):
            lens = np.diff(self.offsets[sn])
            keep = lens <= cutoff
            if use_native:
                import ctypes
                new_total = int(lens[keep].sum())
                off = np.ascontiguousarray(self.offsets[sn],
                                           dtype=np.int64).copy()
                pos = self.positions[sn]
                pos_out = np.empty(new_total, np.uint32)
                w = nlib.index_trim(
                    off.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
                    len(lens),
                    pos.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
                    pos_out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
                    cutoff)
                assert w == new_total
                self.positions[sn] = pos_out
                self.offsets[sn] = off
                continue
            new_lens = np.where(keep, lens, 0)
            new_off = np.zeros_like(self.offsets[sn])
            np.cumsum(new_lens, out=new_off[1:])
            pos = self.positions[sn]
            mask = np.repeat(keep, lens)
            self.positions[sn] = pos[mask]
            self.offsets[sn] = new_off
        self.list_cutoff = cutoff

    # ------------------------------------------------------------------
    # persistence (the .genome/.seed.N save/load, genome.c:15-273,606-833)
    # ------------------------------------------------------------------
    def save(self, prefix: str) -> None:
        meta = {
            "format_version": INDEX_FORMAT_VERSION,
            "contig_names": self.contig_names,
            "colour_space": self.colour_space,
            "list_cutoff": int(self.list_cutoff),
            "seeds": [s.pattern for s in self.seed_set.seeds],
            "use_hashing": self.seed_set.use_hashing,
        }
        with open(prefix + ".meta.json", "w") as fh:
            json.dump(meta, fh)
        arrays = {
            "contig_offsets": self.contig_offsets,
            "contig_len": self.contig_len,
            "genome": self.genome,
        }
        if self.genome_cs is not None:
            arrays["genome_cs"] = self.genome_cs
        for sn in range(len(self.offsets)):
            arrays[f"offsets_{sn}"] = self.offsets[sn]
            arrays[f"positions_{sn}"] = self.positions[sn]
        np.savez_compressed(prefix + ".idx.npz", **arrays)

    # ------------------------------------------------------------------
    # shared-memory residency (the --save-mmap/--load-mmap analogue:
    # genome_load_map_save_mmap / genome_load_mmap, genome.c:291-668).
    # Arrays are written raw and re-opened with np.memmap, so concurrent
    # mappers on one host share a single page-cache copy; placing the
    # prefix under /dev/shm reproduces the reference exactly.
    # ------------------------------------------------------------------
    def save_mmap(self, prefix: str) -> None:
        meta = {
            "format_version": INDEX_FORMAT_VERSION,
            "contig_names": self.contig_names,
            "colour_space": self.colour_space,
            "list_cutoff": int(self.list_cutoff),
            "seeds": [s.pattern for s in self.seed_set.seeds],
            "use_hashing": self.seed_set.use_hashing,
            "arrays": {},
        }

        def dump(name, arr):
            arr = np.ascontiguousarray(arr)
            path = f"{prefix}.{name}.bin"
            arr.tofile(path)
            meta["arrays"][name] = {"dtype": str(arr.dtype),
                                    "shape": list(arr.shape)}

        dump("contig_offsets", self.contig_offsets)
        dump("contig_len", self.contig_len)
        dump("genome", self.genome)
        if self.genome_cs is not None:
            dump("genome_cs", self.genome_cs)
        for sn in range(len(self.offsets)):
            dump(f"offsets_{sn}", self.offsets[sn])
            dump(f"positions_{sn}", self.positions[sn])
        with open(prefix + ".mmap.json", "w") as fh:
            json.dump(meta, fh)

    @classmethod
    def load_mmap(cls, prefix: str) -> "GenomeIndex":
        with open(prefix + ".mmap.json") as fh:
            meta = json.load(fh)
        if meta["format_version"] != INDEX_FORMAT_VERSION:
            raise ValueError("index format mismatch")

        def mm(name):
            info = meta["arrays"][name]
            return np.memmap(f"{prefix}.{name}.bin", dtype=info["dtype"],
                             mode="r", shape=tuple(info["shape"]))

        seed_set = make_seed_set(meta["seeds"],
                                 use_hashing=meta["use_hashing"])
        n = len(meta["seeds"])
        return cls(
            contig_names=meta["contig_names"],
            contig_offsets=np.asarray(mm("contig_offsets")),
            contig_len=np.asarray(mm("contig_len")),
            genome=mm("genome"),
            seed_set=seed_set,
            offsets=[mm(f"offsets_{sn}") for sn in range(n)],
            positions=[mm(f"positions_{sn}") for sn in range(n)],
            colour_space=meta["colour_space"],
            genome_cs=(mm("genome_cs") if "genome_cs" in meta["arrays"]
                       else None),
            list_cutoff=meta["list_cutoff"],
        )

    @classmethod
    def load(cls, prefix: str) -> "GenomeIndex":
        with open(prefix + ".meta.json") as fh:
            meta = json.load(fh)
        if meta["format_version"] != INDEX_FORMAT_VERSION:
            raise ValueError(
                f"index format {meta['format_version']} != "
                f"{INDEX_FORMAT_VERSION}")
        z = np.load(prefix + ".idx.npz")
        seed_set = make_seed_set(meta["seeds"],
                                 use_hashing=meta["use_hashing"])
        n = len(meta["seeds"])
        return cls(
            contig_names=meta["contig_names"],
            contig_offsets=z["contig_offsets"],
            contig_len=z["contig_len"],
            genome=z["genome"],
            seed_set=seed_set,
            offsets=[z[f"offsets_{sn}"] for sn in range(n)],
            positions=[z[f"positions_{sn}"] for sn in range(n)],
            colour_space=meta["colour_space"],
            genome_cs=z["genome_cs"] if "genome_cs" in z else None,
            list_cutoff=meta["list_cutoff"],
        )


def build_index(contigs: list[fastx.Contig], seed_set: SeedSet | None = None,
                colour_space: bool = False,
                postings: bool = True) -> GenomeIndex:
    """Build the CSR index from contigs (load_genome, genome.c:1012-1186).

    postings=False skips the seed scan and returns empty posting lists —
    an emission-only index (contig tables + genome planes) used by the
    distributed genome-axis merge, which renders other shards' hits but
    never maps against them."""
    if seed_set is None:
        seed_set = make_seed_set()

    names = [c.name for c in contigs]
    lens = np.array([len(c.codes) for c in contigs], dtype=np.int64)
    offs = np.zeros(len(contigs), dtype=np.int64)
    np.cumsum(lens[:-1], out=offs[1:])
    genome = np.concatenate([c.codes for c in contigs]).astype(np.int8)
    L = len(genome)

    genome_cs = None
    index_codes = genome
    if colour_space:
        # CS indexes the colour translation of each contig; colour 0 of a
        # contig pairs its first base with virtual T (genome.c:1135,
        # bitfield_to_colourspace)
        parts = []
        for c in contigs:
            parts.append(dna.letters_to_colours(c.codes, dna.BASE_T))
        genome_cs = np.concatenate(parts).astype(np.int8)
        index_codes = genome_cs

    # windows containing N/X are skipped; windows never span contigs.
    # The cumulative-N / contig-of planes back the NumPy fallback path;
    # the native path computes validity in one rolling C pass instead.
    n_csum = None
    contig_of = None

    def _np_valid_planes():
        nonlocal n_csum, contig_of
        if n_csum is None:
            is_n = (index_codes == dna.BASE_N).astype(np.int32)
            n_csum = np.concatenate(
                ([0], np.cumsum(is_n, dtype=np.int64)))
            contig_of = np.repeat(np.arange(len(contigs), dtype=np.int32),
                                  lens)
        return n_csum, contig_of

    contig_ends = np.ascontiguousarray(offs + lens)   # int64 global ends

    offsets_per_seed: list[np.ndarray] = []
    positions_per_seed: list[np.ndarray] = []
    n_buckets_list = seed_set.table_sizes()

    from shrimp_tpu_torch import native as native_mod
    nlib = native_mod.load_index()

    for sn, seed in enumerate(seed_set.seeds):
        span = seed.span
        nb = n_buckets_list[sn]
        if not postings:
            offsets_per_seed.append(np.zeros(nb + 1, np.int64))
            positions_per_seed.append(np.zeros(0, np.uint32))
            continue
        if L < span:
            offsets_per_seed.append(np.zeros(nb + 1, np.int64))
            positions_per_seed.append(np.zeros(0, np.uint32))
            continue
        n_win = L - span + 1

        if nlib is not None and len(seed.ones_idx) <= 16 \
                and not seed_set.use_hashing:
            # native counting-sort build: linear passes replace the stable
            # mergesort (identical output ordering — positions are placed
            # in genome order within each bucket)
            import ctypes
            vmask = np.empty(n_win, np.uint8)
            keys = np.empty(n_win, np.uint32)
            ones = np.ascontiguousarray(seed.ones_idx.astype(np.int32))
            codes_c = np.ascontiguousarray(index_codes)

            def p(a, t):
                return a.ctypes.data_as(ctypes.POINTER(t))
            nlib.index_valid(p(codes_c, ctypes.c_int8), L, span,
                             p(contig_ends, ctypes.c_longlong),
                             len(contigs), p(vmask, ctypes.c_uint8))
            nlib.index_mapidx(p(codes_c, ctypes.c_int8), n_win,
                              p(ones, ctypes.c_int32), len(ones),
                              p(vmask, ctypes.c_uint8),
                              p(keys, ctypes.c_uint32))
            # partitioned counting sort (index_partition_sort): the flat
            # count+place passes do ~2 random DRAM hits per window —
            # minutes at Gbp scale; the partitioned form streams instead
            counts = np.zeros(nb, np.int64)
            n_valid = int(vmask.sum())
            positions = np.empty(n_valid, np.uint32)
            m = -1
            if hasattr(nlib, "index_partition_sort"):
                m = nlib.index_partition_sort(
                    p(keys, ctypes.c_uint32), n_win, nb,
                    p(counts, ctypes.c_longlong),
                    None,       # pair scratch is malloc'd natively
                    p(positions, ctypes.c_uint32))
            if m != n_valid:        # OOM or stale .so: flat fallback
                counts[:] = 0
                nlib.index_count(p(keys, ctypes.c_uint32), n_win,
                                 p(counts, ctypes.c_longlong))
                off = np.zeros(nb + 1, dtype=np.int64)
                np.cumsum(counts, out=off[1:])
                cursor = np.ascontiguousarray(off[:-1].copy())
                positions = np.empty(int(off[-1]), np.uint32)
                nlib.index_place(p(keys, ctypes.c_uint32), n_win,
                                 p(cursor, ctypes.c_longlong),
                                 p(positions, ctypes.c_uint32))
            else:
                off = np.zeros(nb + 1, dtype=np.int64)
                np.cumsum(counts, out=off[1:])
            positions_per_seed.append(positions)
            offsets_per_seed.append(off)
            continue

        ncs, cof = _np_valid_planes()
        valid = ((ncs[span:span + n_win] - ncs[:n_win]) == 0) \
            & (cof[:n_win] == cof[span - 1:span - 1 + n_win])
        starts = np.flatnonzero(valid).astype(np.int64)
        if seed_set.use_hashing:
            mapidx = hash_mapidx(index_codes, starts, span, seed.ones_idx,
                                 max(sd.span for sd in seed_set.seeds))
        else:
            mapidx = compute_mapidx(index_codes, starts, seed.ones_idx)
        counts = np.bincount(mapidx, minlength=nb).astype(np.int64)
        off = np.zeros(nb + 1, dtype=np.int64)
        np.cumsum(counts, out=off[1:])
        order = np.argsort(mapidx, kind="stable")
        positions_per_seed.append(starts[order].astype(np.uint32))
        offsets_per_seed.append(off)

    return GenomeIndex(
        contig_names=names,
        contig_offsets=offs,
        contig_len=lens,
        genome=genome,
        seed_set=seed_set,
        offsets=offsets_per_seed,
        positions=positions_per_seed,
        colour_space=colour_space,
        genome_cs=genome_cs,
    )


def build_index_from_fasta(path: str, seed_set: SeedSet | None = None,
                           colour_space: bool = False) -> GenomeIndex:
    return build_index(list(fastx.iter_contigs(path)), seed_set, colour_space)
