"""split-db / project-db / split-project-db — genome sharding utilities (L7).

Mirrors `utils/split-db.py` + `utils/project-db.py`: bin-packs contigs into
shards whose index fits a memory budget, using the reference RAM model
(`README:135-150`):

    bytes = L*K*4  +  K * 4^min(W,12) * (4 + 8)  +  50MB

where L = shard bp, K = number of seeds, W = seed weight.  On TPU the budget
is the per-chip HBM share instead of node RAM — same formula, same shard
naming scheme (`<prefix>-<N>gb-<W>seeds-<X>of<Y>`), so existing cluster
recipes translate directly.

`--project` additionally builds and saves each shard's index (`gmapper -S`
equivalent, the project-db.py step).

Usage:
    python -m shrimp_tpu_torch.tools.splitdb --ram-size 2 [--prefix db]
           [--dest-dir DIR] [--seed SPEC] [--h-flag] [--project]
           [--colour-space] genome1.fa [genome2.fa ...]
"""

from __future__ import annotations

import getopt
import os
import sys


def index_bytes(total_bp: int, n_seeds: int, max_weight: int,
                hashed: bool) -> int:
    """The reference RAM formula (README:135-150)."""
    w = min(max_weight, 12) if not hashed else 12
    return total_bp * n_seeds * 4 + n_seeds * (4 ** w) * 12 + 50 * (1 << 20)


def pack_contigs(contigs: list[tuple[str, int]], budget_bp: int):
    """First-fit-decreasing bin packing of (name, length) into shards.

    Contigs longer than the budget get their own shard (the reference
    refuses to split individual contigs — README:158-164)."""
    order = sorted(range(len(contigs)), key=lambda i: -contigs[i][1])
    shards: list[list[int]] = []
    loads: list[int] = []
    for i in order:
        L = contigs[i][1]
        placed = False
        for s in range(len(shards)):
            if loads[s] + L <= budget_bp:
                shards[s].append(i)
                loads[s] += L
                placed = True
                break
        if not placed:
            shards.append([i])
            loads.append(L)
    for s in shards:
        s.sort()
    return shards


def main(argv=None) -> int:
    argv = list(sys.argv if argv is None else argv)
    try:
        opts, files = getopt.gnu_getopt(
            argv[1:], "r:d:p:s:h",
            ["ram-size=", "dest-dir=", "prefix=", "seed=", "h-flag",
             "project", "colour-space", "help"])
    except getopt.GetoptError as exc:
        sys.stderr.write(f"error: {exc}\n")
        return 1
    ram_gb = -1.0
    dest = "."
    prefix = "db"
    seed_specs = None
    h_flag = False
    project = False
    colour = False
    for o, a in opts:
        if o in ("-r", "--ram-size"):
            ram_gb = float(a)
        elif o in ("-d", "--dest-dir"):
            dest = a
        elif o in ("-p", "--prefix"):
            prefix = a
        elif o in ("-s", "--seed"):
            seed_specs = a.split(",")
        elif o in ("-h", "--h-flag"):
            h_flag = True
        elif o == "--project":
            project = True
        elif o == "--colour-space":
            colour = True
        elif o == "--help":
            sys.stderr.write(__doc__)
            return 0
    if ram_gb <= 0 or not files:
        sys.stderr.write("usage: splitdb --ram-size GB genome.fa ...\n")
        return 1

    from shrimp_tpu_torch import seeds as seedmod
    from shrimp_tpu_torch.io import fastx

    seed_set = seedmod.make_seed_set(seed_specs, use_hashing=h_flag)
    K = seed_set.n_seeds
    W = max(s.weight for s in seed_set.seeds)
    if not h_flag and W > 14:
        sys.stderr.write("seeds of weight > 14 need --h-flag\n")
        return 1

    budget = int(ram_gb * (1 << 30))
    fixed = index_bytes(0, K, W, h_flag)
    if budget <= fixed:
        sys.stderr.write("budget smaller than fixed index overhead\n")
        return 1
    budget_bp = (budget - fixed) // (K * 4)

    contigs = []
    texts = {}
    for f in files:
        for rec in fastx.iter_reads(f, fastq=False):
            contigs.append((rec.name, len(rec.seq)))
            texts[rec.name] = rec.seq
    shards = pack_contigs(contigs, budget_bp)
    Y = len(shards)
    os.makedirs(dest, exist_ok=True)
    gb_tag = (f"{ram_gb:g}gb")
    seeds_tag = "_".join(str(s.weight) for s in seed_set.seeds) + "seeds"
    for x, shard in enumerate(shards, 1):
        name = f"{prefix}-{gb_tag}-{seeds_tag}-{x}of{Y}"
        fa = os.path.join(dest, name + ".fa")
        with open(fa, "w") as fh:
            for ci in shard:
                nm = contigs[ci][0]
                fh.write(f">{nm}\n")
                t = texts[nm]
                for i in range(0, len(t), 70):
                    fh.write(t[i:i + 70] + "\n")
        sys.stderr.write(f"wrote {fa} ({sum(contigs[c][1] for c in shard)} "
                         f"bp, {len(shard)} contigs)\n")
        if project:
            from shrimp_tpu_torch import index as gindex
            idx = gindex.build_index_from_fasta(fa, seed_set,
                                                colour_space=colour)
            pfx = os.path.join(dest, name)
            idx.save(pfx)
            sys.stderr.write(f"projected {pfx}.idx.npz\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
