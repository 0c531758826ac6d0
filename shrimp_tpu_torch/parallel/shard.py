"""Multi-device sharding, the counterpart of `shrimp_tpu/parallel/shard.py`:
the device replacement for split-db + mergesam.

The reference scales by (a) sharding reads across jobs and (b) sharding the
genome into RAM-sized pieces, then recombining mapping qualities exactly from
Z-field side channels (`SPLITTING_AND_MERGING`, `not_in_dist/MAPPING_QUALITIES`,
`mergesam/sam_reader.c:127-270`).  The merge algebra is associative:

    z1 (posterior sum)  -> a sum over the genome shards, in shard order
    top-k hit selection -> the shards' scores side by side + one top-k

A mesh here is a plain [reads x genome] grid of `torch.device`s: column s
holds genome shard s, row r a share of the reads.  Several cells may name
one device (one card holds every shard), and the CPU stands in for every
cell when the caller asks for it.  The steps below move each shard's
result to its row's first device and reduce there in shard order, so no
sum depends on a collective's order.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from shrimp_tpu_torch.ops.params import ScoreProbs, SWParams

READS_AXIS = "reads"     # data-parallel axis (splitreads.py analogue)
GENOME_AXIS = "genome"   # index-shard axis (split-db.py analogue)


@dataclass(frozen=True)
class Mesh:
    """A [reads x genome] grid of devices: devices[r][s] maps row r's
    reads against genome shard s."""

    devices: tuple
    axis_names: tuple = (READS_AXIS, GENOME_AXIS)

    @property
    def shape(self) -> dict:
        return {READS_AXIS: len(self.devices),
                GENOME_AXIS: len(self.devices[0])}


def visible_cuda_devices(first: int = 0) -> list:
    """Every visible card, starting at `first` and wrapping round."""
    n = torch.cuda.device_count()
    return [torch.device("cuda", (first + i) % n) for i in range(n)]


def make_mesh(n_devices: int | None = None, genome_shards: int = 1,
              devices=None) -> Mesh:
    """Build a (reads x genome) device mesh of n_devices cells.

    genome_shards cells along the index axis; the rest data-parallel.
    `devices` defaults to every visible card; with fewer devices than
    cells they repeat round-robin (four shards on one card)."""
    devs = [torch.device(d) for d in devices] if devices is not None \
        else visible_cuda_devices()
    if not devs:
        raise RuntimeError("no CUDA device; pass devices=['cpu'] to build "
                           "a mesh on the CPU")
    n = n_devices or len(devs)
    if n % genome_shards != 0:
        raise ValueError(f"{n} devices not divisible by {genome_shards}")
    cells = [devs[i % len(devs)] for i in range(n)]
    rows = n // genome_shards
    return Mesh(tuple(tuple(cells[r * genome_shards:(r + 1) * genome_shards])
                      for r in range(rows)))


def merge_scores_across_shards(scores, posteriors, k: int):
    """The mergesam reduce over per-shard tensors.

    Args:
      scores:     per shard, int32 [H] candidate scores.
      posteriors: per shard, float32 [H] candidate posteriors.
      k: top-k to keep globally.

    Returns (top_scores [k], z1 scalar) on shard 0's device: the
    cross-shard top-k candidate scores and the global posterior sum (Z1
    of MAPPING_QUALITIES Part 1c: z1 := sum_j z1_j), the shards' sums
    added in shard order."""
    dev = scores[0].device
    z1 = None
    for p in posteriors:
        zs = p.sum().to(dev)
        z1 = zs if z1 is None else z1 + zs
    top = torch.topk(torch.cat([s.to(dev) for s in scores]), k).values
    return top, z1


def first_argmax(x: torch.Tensor) -> torch.Tensor:
    """Per row of int [b, S], the column of its FIRST maximum (as
    jnp.argmax), resolved explicitly rather than by torch.argmax's tie
    order."""
    cols = torch.arange(x.shape[1], device=x.device).expand_as(x)
    at_max = x == x.max(dim=1, keepdim=True).values
    return torch.where(at_max, cols, x.shape[1]).min(dim=1).values


class ShardedMapper:
    """Maps reads against N genome-index shards and recombines mapping
    qualities exactly: the in-memory (single-host, multi-shard) form of the
    split-db + mergesam workflow, every shard on `device`.

    The merge quantities (z1 sums across shards, bounded top-k by score)
    are the algebra `merge_scores_across_shards` expresses over the
    shards' tensors."""

    def __init__(self, indexes, cfg=None, device="cuda"):
        from shrimp_tpu_torch.pipeline.mapper import Mapper
        from shrimp_tpu_torch.pipeline.options import MapperConfig
        self.cfg = cfg or MapperConfig()
        self.mappers = [Mapper(idx, self.cfg, device=device)
                        for idx in indexes]

    def map_batch(self, reads):
        """Returns (entry, hits) per read with cross-shard MQVs; hit
        contig numbers are remapped to (shard, cn) pairs via `contig_name`."""
        from shrimp_tpu_torch import mapq

        per_shard = [m.map_batch(reads) for m in self.mappers]
        out = []
        for ri in range(len(reads)):
            entry = per_shard[0][ri][0]
            # z1 := sum_j z1_j (MAPPING_QUALITIES Part 1c); each shard's
            # kept-hit posterior sum plays z1_j
            z1 = 0.0
            merged = []
            for sn, shard in enumerate(per_shard):
                hits = shard[ri][1]
                if not hits:
                    continue
                z1 += sum(h.posterior for h in hits)
                for h in hits:
                    merged.append((sn, h))
            # bounded selection by score (the mergesam heap policy)
            merged.sort(key=lambda t: -t[1].score_full)
            merged = merged[:self.cfg.num_outputs]
            for sn, h in merged:
                h.z0 = h.posterior
                h.z1 = z1
                h.mqv = mapq.qv_from_pr_corr(h.posterior / z1) if z1 else 0
                if h.mqv < 4:
                    h.mqv = 0
            out.append((entry, merged))
        return out

    def contig_name(self, sn: int, cn: int) -> str:
        return self.mappers[sn].index.contig_names[cn]


def _ls_posterior_consts(params: SWParams, R: int) -> tuple[float, float]:
    """(R * bta, ln 2 / a) of the LS posterior exp2((score - R*bta) / a),
    in float32 as the JAX step's compiled program has them: XLA folds the
    division and jnp.exp2's factor ln 2 into one multiply,
    exp((score - R*bta) * (ln 2 * (1 / a)))."""
    probs = ScoreProbs.from_scores(params, False)
    a = np.float32(probs.alpha)
    bta = np.float32(2.0 * probs.alpha + probs.beta)
    k = np.float32(np.log(2.0)) * (np.float32(1.0) / a)
    return float(np.float32(R) * bta), float(k)


def _score(windows: torch.Tensor, reads: torch.Tensor,
           params: SWParams) -> torch.Tensor:
    """Pass-1 vector-SW scores int32 [n] of (window, read) rows: K1 on a
    CUDA tensor, its plain version on a CPU one."""
    from shrimp_tpu_torch.ops import sw_vector
    if windows.device.type == "cuda":
        return sw_vector.sw_score_batch_cuda(windows, reads, params)
    return sw_vector.sw_score_batch(windows, reads, params)


def _row_pass1(mesh: Mesh, row: int, windows, reads, params: SWParams):
    """One READS row's pass 1: shard s scores its windows [b, G] against
    the reads [b, R] on devices[row][s].  Returns (scores [b, S] int32,
    z1 [b] float32) on the row's first device, z1 the shards' posteriors
    added in shard order, and each shard's windows on its device."""
    devs = mesh.devices[row]
    R = reads.shape[-1]
    c, k = _ls_posterior_consts(params, R)
    dev0 = devs[0]
    cols, wins, z1 = [], [], None
    for s, dev in enumerate(devs):
        wins.append(windows[:, s].to(dev, torch.int8).contiguous())
        sc = _score(wins[-1], reads.to(dev, torch.int8).contiguous(), params)
        # LS posterior (hit_run_post_sw shortcut, mapping.c:1632-1634)
        post = torch.exp((sc.to(torch.float32) - c) * k).to(dev0)
        z1 = post if z1 is None else z1 + post
        cols.append(sc.to(dev0))
    return torch.stack(cols, dim=1), z1, wins


def _row_slices(mesh: Mesh, B: int) -> list:
    rows = mesh.shape[READS_AXIS]
    if B % rows:
        raise ValueError(f"batch {B} not divisible by {rows} reads rows")
    b = B // rows
    return [slice(r * b, (r + 1) * b) for r in range(rows)]


def _check_shards(mesh: Mesh, windows) -> None:
    if windows.shape[1] != mesh.shape[GENOME_AXIS]:
        raise ValueError(f"windows have {windows.shape[1]} shards, the mesh "
                         f"{mesh.shape[GENOME_AXIS]}")


def sharded_pass1_step(mesh: Mesh, params: SWParams = SWParams(),
                       k: int = 10):
    """Build the multi-device pass-1 step.

    Reads are split over READS_AXIS; each GENOME_AXIS member scores its
    own candidate windows (gathered from its index shard) and the shards
    merge on the row's first device.  Returns a function

        step(windows[B, S, G], reads[B, 1, R]) -> (top[B, min(k, S)], z1[B])

    (CPU tensors) where B is the global read-batch and S the genome-shard
    axis extent."""
    def step(windows, reads):
        windows = torch.as_tensor(windows)
        reads = torch.as_tensor(reads)
        _check_shards(mesh, windows)
        tops, z1s = [], []
        for r, sl in enumerate(_row_slices(mesh, windows.shape[0])):
            scores, z1, _ = _row_pass1(mesh, r, windows[sl], reads[sl, 0],
                                       params)
            k_ = min(k, scores.shape[1])
            tops.append(torch.topk(scores, k_, dim=1).values.cpu())
            z1s.append(z1.cpu())
        return torch.cat(tops), torch.cat(z1s)
    return step


def sharded_map_step(mesh: Mesh, params: SWParams = SWParams()):
    """The FULL sharded mapping step: pass-1 vector filter per genome shard,
    the mergesam algebra (posteriors summed in shard order, the cross-shard
    argmax), then pass-2 full SW + traceback on each read's winning window.

    Returns step(windows[B, S, G], reads[B, 1, R]) ->
        (stats[B, 10], z1[B]) as CPU tensors.

    Pass 2 runs once per READS row: each read's winning window is taken
    from its owning shard, and one K3+K4 launch (its plain version on the
    CPU) aligns the row's reads globally over the full band [0, G - 1],
    where the JAX step runs the unbanded K5 on every shard and keeps the
    owner's row."""
    from shrimp_tpu_torch.ops import sw_full
    from shrimp_tpu_torch.ops.sw_vector import GENOME_PAD

    def step(windows, reads):
        windows = torch.as_tensor(windows)
        reads = torch.as_tensor(reads)
        _check_shards(mesh, windows)
        B, S, G = windows.shape
        R = reads.shape[2]
        Gp = -(-G // 128) * 128          # the launchers' window unit
        W = -(-G // 32) * 32
        stats_rows, z1s = [], []
        for r, sl in enumerate(_row_slices(mesh, B)):
            dev0 = mesh.devices[r][0]
            scores, z1, wins = _row_pass1(mesh, r, windows[sl],
                                          reads[sl, 0], params)
            best = first_argmax(scores)
            b = best.shape[0]
            # each read's winning window, from its owning shard
            win = torch.full((b, Gp), GENOME_PAD, dtype=torch.int8,
                             device=dev0)
            for s, own in enumerate(wins):
                win[:, :G] = torch.where((best == s)[:, None], own.to(dev0),
                                         win[:, :G])
            rd = reads[sl, 0].to(dev0, torch.int8).contiguous()
            bxmin = torch.zeros((b, R), dtype=torch.int32, device=dev0)
            bxmax = torch.full((b, R), G - 1, dtype=torch.int32, device=dev0)
            rev = torch.zeros(b, dtype=torch.bool, device=dev0)
            stats, _ops = sw_full.sw_full_and_traceback_packed(
                win, rd, rev, bxmin, bxmax, params, local_alignment=False,
                W=W)
            stats_rows.append(stats.cpu())
            z1s.append(z1.cpu())
        return torch.cat(stats_rows), torch.cat(z1s)
    return step
