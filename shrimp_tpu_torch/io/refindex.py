"""Reference SHRiMP2 index-file interop (.genome / .seed.N).

Reads and writes the reference's gzip'd binary genome projections so
reference-projected shards (utils/project-db.py -> `gmapper -S`) load
directly into this framework and vice versa.

Formats (byte-for-byte per the reference writers/readers):
  .seed.N  save_genome_map_seed / load_genome_map_seed
           (gmapper/genome.c:15-70,71-178):
      u32 shrimp_mode; u32 Hflag; seed_type seed;
      u32 genomemap_len[capacity]; u32 total; u32 genomemap[total]
      capacity = 4^(HASH_TABLE_POWER=12 if Hflag else seed.weight)
  .genome  save_genome_map / load_genome_map (genome.c:179-273,670-833):
      u32 shrimp_mode; u32 Hflag; u32 num_contigs;
      u32 genome_len[C]; u32 contig_offsets[C];
      per contig: u32 name_len; char name[name_len+1];
      u32 total; per contig u32 packed_fw[BPTO32BW(len)];
      per contig u32 packed_rc[...]; (CS: per contig u32 packed_cs[...])

  seed_type (gmapper-definitions.h:67-75, ENABLE_SEED_POSITIONS build):
      u64 mask[1]  (LSB = rightmost pattern character)
      i32 span; i32 weight; u64 positions[16]  (all-ones = unpositioned)

  Packed bases: 4-bit codes, 8 per u32 little-endian, EXTRACT(word, i) =
  (word[i/8] >> 4*(i%8)) & 0xF (common/util.h:41); base code tables are
  identical to shrimp_tpu_torch.dna.

  Posting-list positions are GLOBAL (contig_offsets included) start
  positions, ascending (genome.c:1141-1166) — the same convention as the
  native CSR builder here, so lists are used verbatim.
"""

from __future__ import annotations

import gzip
import os
import struct

import numpy as np

from shrimp_tpu_torch import dna

MODE_LS = 1           # MODE_LETTER_SPACE (gmapper-definitions.h:31)
MODE_CS = 2           # MODE_COLOUR_SPACE (gmapper-definitions.h:32)
HASH_TABLE_POWER = 12
SEED_STRUCT = struct.Struct("<Qii16Q")     # mask, span, weight, positions[16]


def _mode_values():
    """shrimp_mode enum: MODE_COLOUR_SPACE=0, MODE_LETTER_SPACE=1,
    MODE_HELICOS_SPACE=2 (gmapper-definitions.h)."""
    return {"cs": 2, "ls": 1}


def unpack_bases(words: np.ndarray, n: int) -> np.ndarray:
    """u32 packed 4-bit codes -> int8[n]."""
    w = np.asarray(words, dtype=np.uint32)
    shifts = (4 * np.arange(8, dtype=np.uint32))[None, :]
    nibbles = (w[:, None] >> shifts) & np.uint32(0xF)
    return nibbles.reshape(-1)[:n].astype(np.int8)


def pack_bases(codes: np.ndarray) -> np.ndarray:
    """int8 codes -> u32 packed words (BPTO32BW layout)."""
    n = len(codes)
    pad = (-n) % 8
    c = np.concatenate([np.asarray(codes, np.uint32) & 0xF,
                        np.zeros(pad, np.uint32)])
    c = c.reshape(-1, 8)
    shifts = (4 * np.arange(8, dtype=np.uint32))[None, :]
    return np.bitwise_or.reduce(c << shifts, axis=1).astype(np.uint32)


def _seed_from_struct(raw: bytes):
    mask, span, weight, *positions = SEED_STRUCT.unpack(raw)
    pattern = "".join("1" if (mask >> (span - 1 - i)) & 1 else "0"
                      for i in range(span))
    # positions bitmap: all-ones (within any span) means unpositioned
    pos_list = [p for p in range(1024)
                if (positions[p // 64] >> (p % 64)) & 1]
    unpositioned = len(pos_list) == 1024
    from shrimp_tpu_torch.seeds import parse_seed
    sd = parse_seed(pattern if unpositioned
                    else pattern + ":" + "|".join(map(str, pos_list)))
    return sd


def _seed_to_struct(sd) -> bytes:
    mask = 0
    for i, ch in enumerate(sd.pattern.split(":")[0]):
        mask = (mask << 1) | (1 if ch == "1" else 0)
    positions = [0] * 16
    if sd.positions is None:
        positions = [0xFFFFFFFFFFFFFFFF] * 16
    else:
        for p in sd.positions:
            positions[int(p) // 64] |= 1 << (int(p) % 64)
    return SEED_STRUCT.pack(mask, sd.span, sd.weight, *positions)


def is_reference_index(prefix: str) -> bool:
    return os.path.exists(prefix + ".genome")


def load(prefix: str):
    """Load a reference `.genome` + `.seed.N` projection as a GenomeIndex."""
    from shrimp_tpu_torch.index import GenomeIndex
    from shrimp_tpu_torch.seeds import SeedSet

    with gzip.open(prefix + ".genome", "rb") as fh:
        mode, hflag, num_contigs = struct.unpack("<III", fh.read(12))
        colour_space = (mode == MODE_CS)
        genome_len = np.frombuffer(fh.read(4 * num_contigs), np.uint32)
        contig_offsets = np.frombuffer(fh.read(4 * num_contigs), np.uint32)
        names = []
        for _ in range(num_contigs):
            (nl,) = struct.unpack("<I", fh.read(4))
            names.append(fh.read(nl + 1)[:nl].decode())
        (_total,) = struct.unpack("<I", fh.read(4))
        fw_parts, rc_parts, cs_parts = [], [], []
        for ln in genome_len:
            nw = (int(ln) + 7) // 8
            fw_parts.append(unpack_bases(
                np.frombuffer(fh.read(4 * nw), np.uint32), int(ln)))
        for ln in genome_len:
            nw = (int(ln) + 7) // 8
            rc_parts.append(unpack_bases(
                np.frombuffer(fh.read(4 * nw), np.uint32), int(ln)))
        if colour_space:
            for ln in genome_len:
                nw = (int(ln) + 7) // 8
                cs_parts.append(unpack_bases(
                    np.frombuffer(fh.read(4 * nw), np.uint32), int(ln)))

    seeds = []
    offsets, positions = [], []
    sn = 0
    while os.path.exists(f"{prefix}.seed.{sn}"):
        with gzip.open(f"{prefix}.seed.{sn}", "rb") as fh:
            m2, h2 = struct.unpack("<II", fh.read(8))
            sd = _seed_from_struct(fh.read(SEED_STRUCT.size))
            capacity = 4 ** (HASH_TABLE_POWER if h2 else sd.weight)
            lens = np.frombuffer(fh.read(4 * capacity), np.uint32)
            (total,) = struct.unpack("<I", fh.read(4))
            flat = np.frombuffer(fh.read(4 * total), np.uint32)
        off = np.zeros(capacity + 1, np.int64)
        np.cumsum(lens.astype(np.int64), out=off[1:])
        seeds.append(sd)
        offsets.append(off)
        positions.append(flat.astype(np.uint32))
        sn += 1
    if sn == 0:
        raise FileNotFoundError(f"no {prefix}.seed.0 next to {prefix}.genome")

    genome = (np.concatenate(fw_parts) if fw_parts
              else np.zeros(0, np.int8))
    genome_cs = (np.concatenate(cs_parts) if cs_parts else None)
    return GenomeIndex(
        contig_names=names,
        contig_offsets=contig_offsets.astype(np.int64),
        contig_len=genome_len.astype(np.int64),
        genome=genome,
        seed_set=SeedSet(seeds=tuple(seeds), use_hashing=bool(hflag)),
        offsets=offsets,
        positions=positions,
        colour_space=colour_space,
        genome_cs=genome_cs,
    )


def save(idx, prefix: str) -> None:
    """Write a GenomeIndex in the reference's .genome/.seed.N format."""
    mode = MODE_CS if idx.colour_space else MODE_LS
    hflag = 1 if idx.seed_set.use_hashing else 0

    for sn, sd in enumerate(idx.seed_set.seeds):
        with gzip.open(f"{prefix}.seed.{sn}", "wb") as fh:
            fh.write(struct.pack("<II", mode, hflag))
            fh.write(_seed_to_struct(sd))
            capacity = 4 ** (HASH_TABLE_POWER if hflag else sd.weight)
            lens = np.diff(idx.offsets[sn]).astype(np.uint32)
            assert len(lens) == capacity, (len(lens), capacity)
            fh.write(lens.tobytes())
            fh.write(struct.pack("<I", len(idx.positions[sn])))
            fh.write(idx.positions[sn].astype(np.uint32).tobytes())

    with gzip.open(prefix + ".genome", "wb") as fh:
        C = idx.num_contigs
        fh.write(struct.pack("<III", mode, hflag, C))
        fh.write(idx.contig_len.astype(np.uint32).tobytes())
        fh.write(idx.contig_offsets.astype(np.uint32).tobytes())
        total = 0
        for c in range(C):
            nm = idx.contig_names[c].encode()
            fh.write(struct.pack("<I", len(nm)))
            fh.write(nm + b"\x00")
            total += (int(idx.contig_len[c]) + 7) // 8
        fh.write(struct.pack("<I", total))
        for c in range(C):
            lo = int(idx.contig_offsets[c])
            hi = lo + int(idx.contig_len[c])
            fh.write(pack_bases(idx.genome[lo:hi]).tobytes())
        for c in range(C):
            lo = int(idx.contig_offsets[c])
            hi = lo + int(idx.contig_len[c])
            fh.write(pack_bases(
                dna.reverse_complement(idx.genome[lo:hi])).tobytes())
        if idx.colour_space:
            for c in range(C):
                lo = int(idx.contig_offsets[c])
                hi = lo + int(idx.contig_len[c])
                fh.write(pack_bases(idx.genome_cs[lo:hi]).tobytes())
