"""The cell's inputs: the genome of its configuration, the program's
index of it, and the pool of reads, in an order drawn from the seed.

The genome comes from the configuration's genome seed through the frozen
generator (`gen/synth.py`) and is kept as a raw file of base codes under
`build/portbench/` in the checkout, which the program's index build and
the reference both read.  The program's index (`GenomeIndex.save_mmap`)
is kept beside it, and so is each traffic mix's pool of reads, which
the frozen generators draw from the mix's own `pool_seed`.  Only a
checkout's first run writes them; later runs attach or load them, so a
run's set-up holds none of the harness's own input making.  Each is
written under a fixed temporary name and renamed into place, so a run
that is cut leaves no half-written input behind.
"""

from __future__ import annotations

import json
import os
import pickle
import shutil
from dataclasses import dataclass

import numpy as np

from gen import synth


def cache_dir(root: str) -> str:
    return os.path.join(root, "build", "portbench")


def genome_key(conf: dict) -> str:
    g = conf["genome"]
    return f"{g['generator']}-{g['genome_bp']}-{g['seed']}"


@dataclass
class Genome:
    """Base codes of all contigs end to end, with the contig table."""

    codes: np.ndarray            # int8, a memory map of the raw file
    names: list
    offsets: np.ndarray          # int64 [n]
    lens: np.ndarray             # int64 [n]

    def contig(self, i: int) -> np.ndarray:
        o = int(self.offsets[i])
        return self.codes[o:o + int(self.lens[i])]


def ensure_genome(conf: dict, root: str) -> Genome:
    """The configuration's genome, made and written on a checkout's
    first run."""
    key = genome_key(conf)
    raw = os.path.join(cache_dir(root), "genome", key + ".u8")
    meta_path = raw + ".json"
    if not os.path.exists(meta_path):
        g = conf["genome"]
        if g["generator"] != "make_genome":
            raise ValueError(f"unknown genome generator {g['generator']!r}")
        chroms = synth.make_genome(np.random.default_rng(g["seed"]),
                                   g["genome_bp"])
        os.makedirs(os.path.dirname(raw), exist_ok=True)
        tmp = raw + ".partial"
        with open(tmp, "wb") as fh:
            for c in chroms:
                fh.write(np.ascontiguousarray(c, np.int8).tobytes())
        os.replace(tmp, raw)
        meta = {"names": [f"chr{i + 1}" for i in range(len(chroms))],
                "lens": [int(len(c)) for c in chroms]}
        with open(meta_path + ".partial", "w") as fh:
            json.dump(meta, fh)
        os.replace(meta_path + ".partial", meta_path)
    with open(meta_path) as fh:
        meta = json.load(fh)
    lens = np.array(meta["lens"], np.int64)
    offsets = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    codes = np.memmap(raw, dtype=np.int8, mode="r", shape=(int(lens.sum()),))
    return Genome(codes=codes, names=meta["names"], offsets=offsets,
                  lens=lens)


def index_prefix(conf: dict, root: str) -> str:
    """Where the program's index of this configuration's genome lives."""
    d = os.path.join(cache_dir(root), "index",
                     f"{conf['mode']}-{genome_key(conf)}")
    return os.path.join(d, "index")


@dataclass
class Pool:
    """One traffic mix's items, made from the seed: (name, seq, qual)
    triples, or pairs of them, and each item's true start."""

    kind: str
    items: list
    truth: np.ndarray

    def cycled(self):
        """The pool again and again, each pass with fresh names, so that
        a window may take more items than the pool holds."""
        n = 0
        while True:
            if self.kind == "pairs":
                for (a, b) in self.items:
                    yield ((_renamed(a[0], n), a[1], a[2]),
                           (_renamed(b[0], n), b[1], b[2]))
            else:
                for (name, seq, qual) in self.items:
                    yield (f"{name}_{n}", seq, qual)
            n += 1


def _renamed(name: str, n: int) -> str:
    """p00012/1 -> p00012_3/1: the mate suffix stays last."""
    base, _, mate = name.rpartition("/")
    return f"{base}_{n}/{mate}"


def rng_for(seed: int, stream: int = 0) -> np.random.Generator:
    """A generator for `seed`, any whole number; `stream` separates the
    draws of the inputs from those of the sample that is checked."""
    return np.random.default_rng([int(seed) % (1 << 64), stream])


GENERATORS = {"reads": synth.make_reads, "cs_reads": synth.make_cs_reads,
              "pairs": synth.make_pairs}


def pool_path(conf: dict, traffic: dict, root: str) -> str:
    """Where the pool of a traffic mix on a configuration's genome is
    kept: its name holds everything the pool is drawn from."""
    key = (f"{traffic['generator']}-{traffic['pool_seed']}-"
           f"{traffic['pool_batches']}x{traffic['batch_size']}-"
           f"{genome_key(conf)}")
    return os.path.join(cache_dir(root), "pool", key + ".pickle")


def make_pool(traffic: dict, genome: Genome, seed: int,
              path: str | None = None) -> Pool:
    """The traffic's pool of reads, drawn by the frozen generator from
    the traffic's own `pool_seed` and cut into its batches (kept at
    `path` on a checkout's first run and loaded after), with the batches
    in an order drawn from `seed`.

    Every seed so gets the same batches in another order.  A read's cost
    has a heavy tail (a read from a high-copy repeat sends thousands of
    windows to pass 1) and a batch's cost is not the sum of its reads'
    (its arrays are padded to its longest rows): pools drawn afresh for
    each seed, or the same reads dealt into other batches, differ in work
    by more than runs of one seed do."""
    B = int(traffic["batch_size"])
    items, truth = pool_items(traffic, genome, path)
    order = batch_order(rng_for(seed), int(traffic["pool_batches"]), B)
    return Pool(kind="pairs" if traffic["generator"] == "pairs" else "reads",
                items=[items[i] for i in order], truth=truth[order])


def pool_items(traffic: dict, genome: Genome,
               path: str | None = None) -> tuple[list, np.ndarray]:
    """The traffic's pool in the generator's order, with each item's
    true start: drawn from the traffic's own `pool_seed`, kept at `path`
    on a checkout's first run and loaded after."""
    if path is not None and os.path.exists(path):
        with open(path, "rb") as fh:
            return pickle.load(fh)
    gen = GENERATORS[traffic["generator"]]
    holder = type("GenomeHolder", (), {"genome": genome.codes})()
    items, truth = gen(holder, rng_for(int(traffic["pool_seed"])),
                       int(traffic["pool_batches"])
                       * int(traffic["batch_size"]))
    if path is not None:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path + ".partial", "wb") as fh:
            pickle.dump((items, truth), fh)
        os.replace(path + ".partial", path)
    return items, truth


def batch_order(rng: np.random.Generator, n_batches: int,
                B: int) -> np.ndarray:
    """Item indices of `n_batches` whole batches of `B`, the batches in
    an order drawn from `rng`."""
    return (rng.permutation(n_batches)[:, None] * B
            + np.arange(B)[None, :]).ravel()


def clear_partial(path: str) -> None:
    if os.path.isdir(path):
        shutil.rmtree(path)
