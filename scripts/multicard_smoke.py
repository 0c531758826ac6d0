#!/usr/bin/env python3
"""Multi-card smoke run of the port's multi-device forms, on every visible
card of one host (two or more):

    python3 scripts/multicard_smoke.py

  1. mesh   MeshMapper and MeshPairedMapper with 4 genome shards spread
            over the cards (a shard a card on four) against the
            single-device mappers on cuda:0 on a synthetic corpus (8
            contigs of 12 kbp, 240 reads, 120 pairs): SAM byte-equal;
            the sharded steps at the JAX dry run's shapes on a mesh of
            two reads rows over the cards against the CPU plain versions
  2. ranks  parallel/multihost.py with one nccl rank a card: the reads
            dealt to as many ranks as cards (unpaired; --genome-shards 2
            a rank, each rank's mesh starting at its card), and the genome
            axis on two ranks (unpaired, paired), each byte-equal to its
            golden outside the header

chip_smoke.py holds the same forms on one card (phases 16 and 17).  This
script prints the cards, then one JSON line of results; it exits
nonzero on any difference, and with fewer than two cards.
"""

import json
import os
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def mesh_checks(devices: list, reference_device) -> dict:
    """Meshes over `devices` against single-device mappers on
    `reference_device`, and the sharded steps against the CPU."""
    import torch

    from shrimp_tpu_torch import index as gindex
    from shrimp_tpu_torch.io import fastx
    from shrimp_tpu_torch.parallel import mesh, shard
    from shrimp_tpu_torch.pipeline.mapper import Mapper
    from shrimp_tpu_torch.pipeline.options import MapperConfig
    from shrimp_tpu_torch.pipeline.paired import (PAIR_OPP_IN, PairedConfig,
                                                  PairedMapper)
    from shrimp_tpu_torch.utils import synth
    rng = np.random.default_rng(21)
    contigs = [fastx.Contig(name=f"ctg{i:02d}",
                            codes=rng.integers(0, 4, 12_000).astype(np.int8))
               for i in range(8)]
    whole = gindex.build_index(contigs)
    reads, _ = synth.make_reads(whole, rng, 240)
    pairs, _ = synth.make_pairs(whole, rng, 120)
    shards = mesh.split_index_shards(contigs, 4)
    grid = shard.make_mesh(4, 4, devices=devices)
    out = {"shard_devices": [str(d) for d in grid.devices[0]]}

    def cfg():
        return MapperConfig(qual_delta=64, device_candidates=False)

    mm = mesh.MeshMapper(shards, cfg(), mesh=grid)
    single = Mapper(whole, cfg(), device=reference_device)
    got = [r.line() for e, h in mm.map_batch(reads)
           for r in mm.sam_records(e, h)]
    want = [r.line() for e, h in single.map_batch(reads)
            for r in single.sam_records(e, h)]
    if got != want:
        raise AssertionError("mesh: SAM differs from the single device's")
    pcfg = PairedConfig(pair_mode=PAIR_OPP_IN, min_insert_size=50,
                        max_insert_size=600)
    pm = mesh.MeshPairedMapper(shards, cfg(), pcfg, mesh=grid)
    psingle = PairedMapper(whole, cfg(), pcfg, device=reference_device)
    pgot = [r.line() for t in pm.map_pair_batch(pairs)
            for r in pm.sam_records_pair(*t)]
    pwant = [r.line() for pr in psingle.map_pair_batch(pairs)
             for r in psingle.sam_records_pair(pr)]
    if pgot != pwant:
        raise AssertionError("paired mesh: SAM differs from the single "
                             "device's")
    out.update(unpaired_sam_lines=len(got), paired_sam_lines=len(pgot))

    rng = np.random.default_rng(1)
    windows = rng.integers(0, 4, size=(16, 2, 64)).astype(np.int8)
    rd = rng.integers(0, 4, size=(16, 1, 32)).astype(np.int8)
    rows = shard.make_mesh(4, 2, devices=devices)
    cpu = shard.make_mesh(4, 2, devices=["cpu"])
    for name, build, kw in (("sharded_pass1_step", shard.sharded_pass1_step,
                             {"k": 4}),
                            ("sharded_map_step", shard.sharded_map_step, {})):
        a, z1 = build(rows, **kw)(windows, rd)
        b, z1_p = build(cpu, **kw)(windows, rd)
        if not torch.equal(a, b) or not np.allclose(z1.numpy(), z1_p.numpy(),
                                                    rtol=1e-6, atol=0):
            raise AssertionError(f"{name}: differs from the plain versions")
    out["sharded_steps_mesh"] = [[str(d) for d in r] for r in rows.devices]
    return out


def rank_checks(n_ranks: int, backend: str) -> dict:
    """The multi-process runner's forms as `n_ranks` ranks (two on the
    genome axis), each byte-equal to its golden."""
    sys.path.insert(0, REPO)
    import chip_smoke
    dealt = ["--block", "20", "--backend", backend]
    axis = ["--genome-axis", "--backend", backend]
    cases = {
        "reads dealt": (dealt, ["-Q"], "golden_reads.fq",
                        "golden_unpaired.sam", n_ranks),
        "reads dealt, --genome-shards 2": (
            dealt, ["-Q", "--genome-shards", "2"], "golden_reads.fq",
            "golden_unpaired.sam", n_ranks),
        "genome axis": (axis, ["-Q"], "golden_reads.fq",
                        "golden_unpaired.sam", 2),
        "genome axis, paired": (axis, ["-Q", "-p", "opp-in", "-I", "0,500"],
                                "golden_pairs.fq", "golden_paired.sam", 2),
    }
    out = {}
    with tempfile.TemporaryDirectory() as d:
        for name, case in cases.items():
            t0 = time.time()
            run = chip_smoke._start_ranks(d, name, case)
            try:
                chip_smoke._finish_ranks(name, case, run)
            finally:
                for p, err in run[1]:
                    p.kill()
                    p.wait()
                    err.close()
            out[name] = {"ranks": case[4], "secs": round(time.time() - t0, 1)}
    return out


def main() -> int:
    import torch
    n = torch.cuda.device_count()
    if n < 2:
        sys.stderr.write("multicard_smoke: needs two or more CUDA devices\n")
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke
    device = chip_smoke.phase_device()
    cards = [torch.device("cuda", i) for i in range(n)]
    t0 = time.time()
    result = {"cards": n, "mesh": mesh_checks(cards, cards[0])}
    result["ranks"] = rank_checks(n, "nccl")
    result["secs"] = round(time.time() - t0, 1)
    print(json.dumps({"ok": True, "device": device["smi"], **result}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
