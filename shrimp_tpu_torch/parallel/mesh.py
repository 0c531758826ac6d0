"""Production multi-device mapping, the genome-shard x read-shard mesh; the
counterpart of `shrimp_tpu/parallel/mesh.py`.

This is the device form of the reference's cluster workflow
(`SPLITTING_AND_MERGING:57-148`): the genome index is sharded across the
mesh's GENOME axis (split-db), and the per-read mapping-quality statistics
are recombined exactly in process instead of through the reference's SAM
side channel (`mergesam/sam_reader.c:127-270`; z1 := sum_j z1_j).

Each shard runs the REAL production funnel: the same `Mapper` stages as a
single-device run (candidates, pass-1 vector / gapless filter with overlap
suppression and top-k, pass-2 full SW with traceback, posterior / dedup /
strata / max-alignments), each shard's mapper on its column's device (on
one card every shard lives on it; on a mesh of the CPU, made with
`make_mesh(devices=["cpu"])`, all run their plain versions).  Output
equals the single-device mapping byte for byte, the reference's
shard-invariance guarantee.

Every MQV comes from the float64 z sums added in shard order on the host.
`build_z1_psum` adds the same [S, B] rows on the device, in the same order,
as the collective self-check the JAX package runs.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from shrimp_tpu_torch import mapq
from shrimp_tpu_torch.parallel.shard import GENOME_AXIS, Mesh, make_mesh
from shrimp_tpu_torch.pipeline.mapper import Mapper
from shrimp_tpu_torch.pipeline.options import MapperConfig


def build_z1_psum(mesh: Mesh):
    """The z-recombination step: per-shard per-read sums [S, B] float64 in,
    the global z1 [B] out (MAPPING_QUALITIES Part 1c: z1 := sum_j z1_j).
    Row s goes to shard s's device (the first row of the mesh) and the
    rows are added on shard 0's device in shard order, so the result is
    the host's serial sum, bit for bit."""
    devs = mesh.devices[0]

    def psum(z_local: np.ndarray) -> np.ndarray:
        acc = None
        for s, dev in enumerate(devs):
            row = torch.from_numpy(np.ascontiguousarray(z_local[s])).to(dev)
            row = row.to(devs[0])
            acc = row if acc is None else acc + row
        return acc.cpu().numpy()
    return psum


class _ShardAggregates:
    """Shared stats/telemetry aggregation over per-shard mappers."""

    @property
    def stats(self):
        """Aggregated per-shard funnel counters."""
        agg: dict = {}
        for m in self.mappers:
            for k, v in m.stats.items():
                agg[k] = agg.get(k, 0) + v
        return agg

    @property
    def tel(self):
        """Aggregated kernel/stage telemetry across shards."""
        from shrimp_tpu_torch.utils import telemetry
        t = telemetry.Telemetry()
        for m in self.mappers:
            for name in ("f1", "f2", "fwbw"):
                ks = getattr(m.tel, name)
                getattr(t, name).add(ks.invocs, ks.cells, ks.secs)
            t.f1_calls_bypassed += m.tel.f1_calls_bypassed
            for sname, st in m.tel.stages.items():
                # stage() makes names beyond the base STAGES tuple (the
                # paired pipeline's pair_up/hp_* stages)
                t.stage(sname).secs += st.secs
        return t


def _default_mesh(S: int) -> Mesh:
    """An R x S mesh over every visible card, shards sharing cards
    round-robin where there are fewer cards than shards."""
    n = max(torch.cuda.device_count() // S, 1) * S
    return make_mesh(n, genome_shards=S)


class MeshMapper(_ShardAggregates):
    """Maps reads against S genome-index shards on a device mesh.

    The three stages of `map_batch` run shard after shard, so one shard's
    host work may overlap another's kernels.  Where a stage copies host
    arrays to a card (`Mapper._to_device`, a pageable `.to(device)`), the
    copy waits for the work queued on that card's stream: on one card,
    shard s+1's pass-1 dispatch waits for shard s's pass 1 at its first
    copy, after shard s+1's candidates have run on the host beside it."""

    def __init__(self, indexes, cfg: MapperConfig | None = None,
                 mesh: Mesh | None = None):
        self.cfg = cfg or MapperConfig()
        if self.cfg.device_candidates == "auto":
            # the JAX package's choice (an XLA compile per shard there);
            # the meshes feed every shard from the native host L3
            self.cfg.device_candidates = False
        self.S = len(indexes)
        if mesh is None:
            mesh = _default_mesh(self.S)
        assert mesh.shape[GENOME_AXIS] == self.S, (mesh.shape, self.S)
        self.mesh = mesh
        # each genome shard's kernels run on its own column's device
        self._shard_devices = list(mesh.devices[0])
        self.mappers = [Mapper(idx, self.cfg, device=dev)
                        for idx, dev in zip(indexes, self._shard_devices)]
        self._z1_psum = build_z1_psum(mesh)

    # ------------------------------------------------------------------
    def map_batch(self, reads, options=None):
        """Map one read batch against every shard and merge exactly.

        Returns [(entry, [(shard, FinalHit), ...])] in read order; hit
        lists carry cross-shard-exact MQVs and z fields."""
        cfg = self.cfg
        opts = (options or cfg.unpaired_options())[0]
        from shrimp_tpu_torch.pipeline import candidates as cand

        m0 = self.mappers[0]
        with m0.tel.stage("readparse"):
            entries = cand.prepare_reads(reads, cfg, m0.min_seed_span)
            if cfg.seed_qual_filter:
                cand.apply_seed_qual_filter(entries, m0.index.seed_set,
                                            cfg.qual_delta)
        ok = np.array([e.read_len <= cfg.longest_read_len
                       and e.max_n_kmers > 0 for e in entries])
        live = [e for e, o in zip(entries, ok) if o]
        live_map = np.flatnonzero(ok)

        # --- staged per-shard funnels: shard s+1's host work overlaps
        # shard s's in-flight device work (each stage timed on its
        # shard's mapper) ---
        ctxs = [None] * self.S
        for s, m in enumerate(self.mappers):
            hb = m._candidates(live, opts) if live else None
            with m.tel.stage("pass1"):
                p1 = (m._pass1_dispatch(live, hb, opts)
                      if hb is not None and hb.n else None)
            ctxs[s] = {"hb": hb, "p1": p1}
        for s, m in enumerate(self.mappers):
            c = ctxs[s]
            with m.tel.stage("pass1"):
                sel = (m._pass1_finish(live, c["hb"], opts, c["p1"])
                       if c["p1"] is not None else None)
            c["sel"] = sel
            with m.tel.stage("pass2"):
                c["p2"] = (m._pass2_dispatch(live, sel)
                           if sel is not None else None)
        per_shard: list[dict] = []
        for s, m in enumerate(self.mappers):
            c = ctxs[s]
            with m.tel.stage("pass2"):
                per_shard.append(
                    m._pass2_finish(live, c["sel"], opts, c["p2"])
                    if c["p2"] is not None else {})

        # --- exact z recombination: the serial sum in shard order; the
        # device sum of the same rows checked against it ---
        B = len(live)
        z1_local = np.zeros((self.S, B), np.float64)
        for s in range(self.S):
            for li, hits in per_shard[s].items():
                z1_local[s, li] = sum(h.posterior for h in hits)
        z1 = z1_local.sum(axis=0)          # row after row, shard order
        if B and self.S > 1:
            if not np.array_equal(self._z1_psum(z1_local), z1):
                raise AssertionError(
                    "device z recombination diverged from the serial sum")

        # --- bounded global selection (the mergesam heap policy) ---
        out = []
        for ri in range(len(entries)):
            out.append((entries[ri], []))
        for li in range(B):
            merged = []
            for s in range(self.S):
                for h in per_shard[s].get(li, []):
                    merged.append((s, h))
            if not merged:
                continue
            merged.sort(key=lambda t: -t[1].pass2_key)
            merged = merged[:self.cfg.num_outputs]
            zz = float(z1[li])
            for s, h in merged:
                h.z0 = h.posterior
                h.z1 = zz
                if self.cfg.compute_mapping_qualities:
                    h.mqv = (mapq.qv_from_pr_corr(h.posterior / zz)
                             if zz else 0)
                    if h.mqv < 4:
                        h.mqv = 0
            out[int(live_map[li])] = (entries[live_map[li]], merged)
        return out

    def contig_name(self, sn: int, cn: int) -> str:
        return self.mappers[sn].index.contig_names[cn]

    def sam_records(self, entry, shard_hits):
        """SAM lines for one read's merged (shard, hit) list; each hit is
        rendered through its shard's mapper (contig names/lengths are
        shard-local), fields are per-hit so lines match the single-device
        emission byte-for-byte."""
        if not shard_hits:
            return self.mappers[0].sam_records(entry, [])
        sel = shard_hits
        if self.cfg.single_best_mapping and \
                self.cfg.compute_mapping_qualities:
            best = max(range(len(shard_hits)),
                       key=lambda i: shard_hits[i][1].mqv)
            sel = [shard_hits[best]]
        recs = []
        for s, fh in sel:
            recs.extend(self.mappers[s].sam_records(entry, [fh]))
        return recs

    def sam_header_lines(self, version: str, cmdline: str):
        lines = ["@HD\tVN:1.0\tSO:unsorted"]
        for m in self.mappers:
            for nm, ln in zip(m.index.contig_names, m.index.contig_len):
                lines.append(f"@SQ\tSN:{nm}\tLN:{int(ln)}")
        lines.append(f"@PG\tID:gmapper\tVN:{version}\tCL:{cmdline}")
        return lines


def split_contig_bins(contigs, n_shards: int) -> list[list]:
    """split-db style contig binning: group whole contigs into n_shards
    contiguous, size-balanced groups (contigs are never split,
    README:158-164; original order preserved so score-tie ordering in the
    merge matches the single-index run)."""
    contigs = list(contigs)
    total = sum(len(c.codes) for c in contigs)
    target = total / max(n_shards, 1)
    bins: list[list] = [[]]
    acc = 0
    for c in contigs:
        if acc >= target and len(bins) < n_shards:
            bins.append([])
            acc = 0
        bins[-1].append(c)
        acc += len(c.codes)
    return [b for b in bins if b]


def split_index_shards(contigs, n_shards: int, seed_set=None,
                       colour_space: bool = False):
    """Binning + one index build per shard (the in-process mesh path; the
    genome-axis runner builds only its own rank's bin).  The builds run
    on threads: most of each is native code and NumPy that release the
    GIL."""
    from concurrent.futures import ThreadPoolExecutor

    from shrimp_tpu_torch import index as gindex
    bins = split_contig_bins(contigs, n_shards)
    with ThreadPoolExecutor(max_workers=len(bins)) as ex:
        return list(ex.map(lambda b: gindex.build_index(
            b, seed_set, colour_space=colour_space), bins))


def merge_paired_shard_results(per_shard, nP: int, cfg, pcfg, merge_mapper,
                               thr, K, merge_strata: bool,
                               collect_z: bool = False):
    """Cross-shard paired merge, the MAPPING_QUALITIES Part-2c reduce.

    per_shard: per shard, the list of PairResult from the shard funnel
    run with compute_mqv=False (shard order == contig order, so a stable
    sort by the pair key reproduces the single-index candidate ordering,
    readpair_pass2's sort).  merge_mapper must carry mqv_total_len = the
    WHOLE genome length.  Shared by MeshPairedMapper (in-process mesh)
    and the torch.distributed genome-axis runner (per_shard rebuilt from
    rank sidecars on rank 0) so both merge byte-identically.

    Returns (out, z3_local, z6_local): out = [(PairResult, tagged_pairs,
    tagged_unpaired)] and, when collect_z, the per-(shard, pair) z sums
    for the device self-check (z3_s over UNIQUE foot-0 groups: z2 is
    per-foot, a foot paired with several mates appears once; z6_s over
    pairs, the insert-prior denominator)."""
    from shrimp_tpu_torch.pipeline.options import is_absolute
    from shrimp_tpu_torch.pipeline.paired import PairResult

    S = len(per_shard)
    out = []
    z3_local = np.zeros((S, nP), np.float64)
    z6_local = np.zeros((S, nP), np.float64)
    for pi in range(nP):
        tagged_pairs = []
        for s in range(S):
            for fh0, fh1, isz in per_shard[s][pi].paired_hits:
                tagged_pairs.append((s, fh0, fh1, isz))

        def pkey(t):
            total = t[1].score_full + t[2].score_full
            if is_absolute(thr):
                return total
            smax = t[1].score_max + t[2].score_max
            return (100000 * total) // smax

        tagged_pairs.sort(key=lambda t: -pkey(t))
        tagged_pairs = tagged_pairs[:K]
        if merge_strata and tagged_pairs:
            top = (tagged_pairs[0][1].score_full
                   + tagged_pairs[0][2].score_full)
            tagged_pairs = [t for t in tagged_pairs
                            if t[1].score_full + t[2].score_full == top]
        if tagged_pairs and cfg.max_alignments \
           and len(tagged_pairs) > cfg.max_alignments:
            tagged_pairs = []

        # ---- merge half-paired fallback hits per side ----
        tagged_unp = []
        for nip in (0, 1):
            side = []
            for s in range(S):
                for n, fh in per_shard[s][pi].unpaired_hits:
                    if n == nip:
                        side.append((s, nip, fh))
            side.sort(key=lambda t: -t[2].pass2_key)
            side = side[:cfg.num_outputs]
            if cfg.strata and side:
                top = side[0][2].score_full
                side = [t for t in side if t[2].score_full == top]
            if side and cfg.max_alignments \
               and len(side) > cfg.max_alignments:
                side = []
            tagged_unp.extend(side)

        pr = PairResult(re=per_shard[0][pi].re)
        pr.paired_hits = [(fh0, fh1, isz)
                          for _, fh0, fh1, isz in tagged_pairs]
        pr.unpaired_hits = [(nip, fh) for _, nip, fh in tagged_unp]
        if cfg.compute_mapping_qualities:
            merge_mapper._paired_mqv(pr)
        if collect_z:
            seen0 = set()
            for s, fh0, fh1, isz in tagged_pairs:
                if id(fh0) not in seen0:
                    seen0.add(id(fh0))
                    z3_local[s, pi] += fh0.z2
                z6_local[s, pi] += mapq.get_pr_insert_size(
                    isz, pcfg.insert_size_mean, pcfg.insert_size_stddev)
        out.append((pr, tagged_pairs, tagged_unp))
    return out, z3_local, z6_local


def sam_records_pair_tagged(mappers, cfg, pr, tagged_pairs, tagged_unp):
    """readpair_output emission (output.c:1237-1282), each hit rendered
    through its owning shard's contig table (mappers[s]); shared by
    MeshPairedMapper and the genome-axis rank-0 assembly."""
    recs = []
    re = pr.re
    for s, fh0, fh1, isz in tagged_pairs:
        m = mappers[s]
        recs.append(m._paired_record(re[0], fh0, re[1], fh1, isz, True))
        m._append_tail_tags(recs[-1], re[0], fh0, mate_re=re[1])
        recs.append(m._paired_record(re[1], fh1, re[0], fh0, -isz, False))
        m._append_tail_tags(recs[-1], re[1], fh1, mate_re=re[0])
    for s, nip, fh in tagged_unp:
        m = mappers[s]
        mate_nip = 1 - nip
        mapped = m._halfpair_record(re[nip], fh, re[mate_nip], nip == 0)
        m._append_tail_tags(mapped, re[nip], fh, mate_re=re[mate_nip])
        unmapped = m._mate_unmapped_record(re[mate_nip], re[nip], fh,
                                           mate_nip == 0)
        m._append_tail_tags(unmapped, re[mate_nip], None, mate_re=re[nip])
        recs.extend([mapped, unmapped] if nip == 0 else [unmapped, mapped])
    if not tagged_pairs and not tagged_unp and cfg.sam_unaligned:
        return mappers[0].sam_records_pair(pr)
    return recs


class MeshPairedMapper(_ShardAggregates):
    """Paired-end mapping against S genome-index shards on a device mesh.

    The mesh form of the reference's paired cluster workflow: every shard
    runs the full paired funnel independently (per-shard fall-through,
    exactly like independent `gmapper -p` jobs, SPLITTING_AND_MERGING:68-97),
    and the shard results are recombined with the paired MAPPING_QUALITIES
    Part 2c algebra: z3 := sum_s z3_s and the insert-size denominator
    z6 := sum_s z6_s (the associative sums `mergesam/sam_reader.c:117-296`
    computes from SAM side-channel fields), class priors use the WHOLE
    genome length, and the global bounded selection mirrors
    `readpair_pass2` (sort by the normalized pair key, truncate to
    num_outputs, strata).  Pairs never straddle shards (contigs are not
    split, README:158-164), so pair construction and dedup stay
    shard-local.  With the default option set the emitted SAM is
    byte-identical to a single-device `PairedMapper` run."""

    def __init__(self, indexes, cfg: MapperConfig | None = None,
                 pcfg=None, mesh: Mesh | None = None):
        from shrimp_tpu_torch.pipeline.paired import (PairedConfig,
                                                      PairedMapper)
        self.cfg = cfg or MapperConfig()
        if self.cfg.device_candidates == "auto":
            self.cfg.device_candidates = False
        self.pcfg = pcfg or PairedConfig()
        # shard funnels must NOT apply the global selection policies
        # (--strata / --max-alignments act on the CROSS-shard candidate
        # set, like mergesam's policies): a shard-local drop would differ
        # from the single-index run.  The merge below applies them from
        # the original cfg.
        self._shard_cfg = dataclasses.replace(
            self.cfg, strata=False, max_alignments=0)
        self.S = len(indexes)
        if mesh is None:
            mesh = _default_mesh(self.S)
        assert mesh.shape[GENOME_AXIS] == self.S, (mesh.shape, self.S)
        self.mesh = mesh
        self._shard_devices = list(mesh.devices[0])
        self.mappers = [PairedMapper(idx, self._shard_cfg, self.pcfg,
                                     device=dev)
                        for idx, dev in zip(indexes, self._shard_devices)]
        self._z_psum = build_z1_psum(mesh)
        # the merge-side MQV pass scales class priors by the WHOLE genome
        total_len = sum(int(m.index.total_len) for m in self.mappers)
        self._merge_mapper = self.mappers[0]
        self._merge_mapper.mqv_total_len = total_len
        self._z_collective_checked = False

    # ------------------------------------------------------------------
    def map_pair_batch(self, pairs, option_sets=None):
        """Map read pairs against every shard and merge exactly.

        Returns [(PairResult, tagged_pairs, tagged_unpaired)] per pair:
        the PairResult carries merged hits with cross-shard-exact MQVs;
        the tag lists carry (shard, ...) so SAM emission can resolve each
        hit's shard-local contig table."""
        cfg = self.cfg
        per_shard = [m.map_pair_batch(pairs, option_sets, compute_mqv=False)
                     for m in self.mappers]
        pairing = (option_sets[0]["pairing"] if option_sets
                   else self.mappers[0].default_paired_sets()[0]["pairing"])
        thr = pairing["pass2_threshold"]
        K = pairing["pass2_num_outputs"]
        # shard funnels ran with strata/max-alignments neutralized (see
        # __init__); the defaults-path merge applies the user's values
        merge_strata = (pairing["strata"] if option_sets
                        else self.cfg.strata)

        nP = len(pairs)
        check = (self.S > 1 and cfg.compute_mapping_qualities
                 and not self._z_collective_checked)
        out, z3_local, z6_local = merge_paired_shard_results(
            per_shard, nP, cfg, self.pcfg, self._merge_mapper,
            thr, K, merge_strata, collect_z=check)

        # ---- the device form of the Part-2c sums, z3 := sum_s z3_s and
        # z6 := sum_s z6_s, once per mapper as a self-check: the serial
        # sums inside _paired_mqv give every MQV ----
        if check and nP:
            self._z_collective_checked = True
            for arr in (z3_local, z6_local):
                if not np.array_equal(self._z_psum(arr), arr.sum(axis=0)):
                    raise AssertionError("device z recombination diverged "
                                         "from the serial sum")
        return out

    # ------------------------------------------------------------------
    def sam_records_pair(self, pr, tagged_pairs, tagged_unp):
        """readpair_output emission (output.c:1237-1282), each hit
        rendered through its owning shard's contig table."""
        return sam_records_pair_tagged(self.mappers, self.cfg, pr,
                                       tagged_pairs, tagged_unp)
