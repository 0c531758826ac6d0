"""Genome-axis distributed mapping, the index sharded ACROSS processes; the
counterpart of `shrimp_tpu/parallel/genome_axis.py`.

The last piece of the reference's scaling matrix (SPLITTING_AND_MERGING:
57-97): a genome too big for one host's memory is split into per-host
shards, every host maps the FULL read stream against its shard, and the
mapping-quality statistics are recombined exactly.  Here the shards are
the ranks of a `torch.distributed` group, so the z statistics cross the
process group instead of the reference's SAM-file side channel:

  * z1 (unpaired, MAPPING_QUALITIES Part 1c: z1 := sum_s z1_s) crosses
    the process boundary as a float64 all-gather (each rank's per-read
    posterior sums, exact), then the in-order sum: every rank computes
    final MQVs locally from the global z1, so rank SAM lines are final
    bytes.
  * an all-reduce (SUM) of the same float64 rows runs as a self-check
    against the exact sum; no MQV is computed from it, since its order
    of addition is the backend's.
  * paired z3/z6 (Part 2c) are recombined at rank 0 from pickled shard
    results through the SAME merge code as the in-process mesh
    (`mesh.merge_paired_shard_results`); the raw per-shard insert-prior
    sums (z6_s, the quantity mergesam recombines by summation,
    sam_reader.c:127-270) ride the cross-process self-check.

With nccl the payloads live on the rank's card; with gloo on the CPU.
Rank 0 assembles the final SAM (the mergesam role): per read, the shard
hit lists merge in shard order (== contig order), stable-sorted by the
pass-2 key, truncated to num_outputs, byte-identical to a single-process
run over the whole genome.

Usage (one command per process; shard s of S == process s of S):
    python -m shrimp_tpu_torch.parallel.multihost --genome-axis \\
        --coordinator host0:9999 --num-processes S --process-id $RANK \\
        --out out.sam -- -Q [gmapper flags] reads.fq genome.fa

The `--` tail takes the real gmapper surface: tokenized with gmapper's own
getopt tables, it supports `--mode cs`, seeds (-s/-H), score/threshold
flags, window/match-mode/output knobs, -U, the pair flags, and
--unpaired-options / --paired-options strings (single-round sets merge
byte-exactly; multi-round stop conditions evaluate per shard, like the
reference's file-split workflow).  Flags without distributed meaning
(-S/-L/mmap persistence, histograms, legacy output) are refused with an
explicit message.
"""

from __future__ import annotations

import os
import pickle
import time

import numpy as np

BATCH = 1024


def _payload_device(device):
    """Where a collective's tensors live: the rank's card under nccl, the
    CPU under gloo."""
    import torch
    import torch.distributed as dist
    return device if dist.get_backend() == "nccl" else torch.device("cpu")


def _allgather_f64_exact(arr: np.ndarray, device) -> np.ndarray:
    """All-gather a per-process float64 [B] array into [S, B] with no
    rounding: torch carries float64 as it is."""
    import torch
    import torch.distributed as dist
    dev = _payload_device(device)
    t = torch.from_numpy(np.ascontiguousarray(arr, np.float64)).to(dev)
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, t)
    return torch.stack(parts).cpu().numpy()


def _psum_check(z_local: np.ndarray, z_expected: np.ndarray,
                device) -> None:
    """All-reduce (SUM) of the float64 row over the process group against
    the exact in-order sum: the collective's proof obligation."""
    import torch
    import torch.distributed as dist
    dev = _payload_device(device)
    t = torch.from_numpy(np.ascontiguousarray(z_local, np.float64)).to(dev)
    dist.all_reduce(t, op=dist.ReduceOp.SUM)
    tot = t.cpu().numpy()
    assert np.allclose(tot, z_expected, rtol=1e-6, atol=1e-12), \
        "genome-axis all-reduce diverged from the serial z sum"


def _parse_gmapper_args(rest: list[str]):
    """The distributed runner's gmapper argument surface.

    Tokenizes with gmapper's own getopt tables so every real gmapper
    flag parses identically, applies the per-shard-meaningful subset
    (mode, seeds, scores, thresholds, window/match-mode, outputs,
    ungapped, pair flags, --unpaired-options / --paired-options
    strings), accepts-and-ignores per-process knobs (-N/-K/-E), and
    refuses flags with no distributed meaning (-S/-L/mmap persistence,
    histograms, legacy output) with an explicit message.

    Returns a dict: cfg (MapperConfig), seed args, fastq, pair_mode,
    isize, insert_dist, unpaired_sets, paired_sets, reads, genome.
    """
    import getopt as _getopt

    from shrimp_tpu_torch import gmapper as gm
    from shrimp_tpu_torch.ops.params import SWParams
    from shrimp_tpu_torch.pipeline.options import (
        MapperConfig, parse_read_mapping_options,
        parse_readpair_mapping_options)
    from shrimp_tpu_torch.pipeline.paired import PAIR_MODE_NAMES

    try:
        opts, files = _getopt.gnu_getopt(rest, gm._SHORT, gm._LONG)
    except _getopt.GetoptError as exc:
        raise SystemExit(f"genome-axis runner: {exc}")
    if len(files) != 2:
        raise SystemExit("genome-axis runner needs READS GENOME")

    mode = "ls"
    for o, a in opts:
        if o == "--mode" and a in ("ls", "cs"):
            mode = a
    colour = mode == "cs"
    cfg = MapperConfig(
        colour_space=colour,
        params=(SWParams.colour_space() if colour
                else SWParams.letter_space()),
        qual_delta=(33 if colour else 64),
        device_candidates=False)
    cfg.sam_unaligned = False

    seed_specs = None
    seed_weight = 0
    use_hashing = False
    fastq = False
    pair_mode = 0
    isize = (0, 1000)
    insert_dist = (200.0, 100.0)
    thresholds = {"r": 55.0, "v": 47.0 if colour else 50.0, "h": 50.0}
    vec_threshold_set = False
    score_assignments = []
    user_score_flags = set()
    unpaired_sets = []
    paired_sets = []
    match_mode_set = False

    REJECT = ("-S", "--save", "-L", "--load", "--save-mmap",
              "--load-mmap", "-X", "--isize-histogram", "-Y",
              "--proj-histogram", "-D", "--thread-stats", "-P",
              "--pretty", "-R", "--print-reads", "--shrimp-format",
              "-M", "--un", "--al", "-1", "--upstream", "-2",
              "--downstream")
    INERT = ("-N", "--threads", "-K", "--thread-chunk", "-E", "--sam",
             "--progress", "--mode", "-Z", "--cachebypass-off")

    def _thr(a):
        return float(a[:-1]) if a.endswith("%") else -float(a)

    for o, a in opts:
        if o in REJECT:
            raise SystemExit(
                f"genome-axis runner: flag {o} has no distributed "
                "meaning (persistence/diagnostics run per shard; legacy "
                "output is served by the file workflow)")
        elif o in INERT:
            continue
        elif o in ("-s", "--seeds"):
            if a.startswith("w"):
                seed_weight = int(a[1:])
            else:
                seed_specs = (seed_specs or []) + a.split(",")
        elif o in ("-H", "--hash-spaced-kmers"):
            use_hashing = True
        elif o in ("-o", "--report"):
            cfg.num_outputs = int(a)
        elif o == "--max-alignments":
            cfg.max_alignments = int(a)
        elif o in ("-w", "--match-window"):
            cfg.window_len = (float(a[:-1]) if a.endswith("%")
                              else -float(a))
        elif o in ("-n", "--cmw-mode"):
            cfg.match_mode_unpaired = int(a)
            match_mode_set = True
        elif o in ("-l", "--cmw-overlap"):
            cfg.window_overlap = (float(a[:-1]) if a.endswith("%")
                                  else -float(a))
        elif o in ("-a", "--anchor-width"):
            cfg.anchor_width = int(a)
        elif o in ("-z", "--cutoff"):
            cfg.list_cutoff = int(a)
        elif o in ("-V", "--trim-off"):
            cfg.list_cutoff = 0xFFFFFFFF
        elif o in ("-m", "--match"):
            score_assignments.append(("match", int(a)))
        elif o in ("-i", "--mismatch"):
            score_assignments.append(("mismatch", int(a)))
        elif o in ("-g", "--open-r"):
            score_assignments.append(("a_gap_open", int(a)))
            user_score_flags.add("a_gap_open")
        elif o in ("-q", "--open-q"):
            score_assignments.append(("b_gap_open", int(a)))
            user_score_flags.add("b_gap_open")
        elif o in ("-e", "--ext-r"):
            score_assignments.append(("a_gap_extend", int(a)))
            user_score_flags.add("a_gap_extend")
        elif o in ("-f", "--ext-q"):
            score_assignments.append(("b_gap_extend", int(a)))
            user_score_flags.add("b_gap_extend")
        elif o in ("-x", "--crossover"):
            if not colour:
                raise SystemExit(
                    "genome-axis runner: -x is a colour-space option")
            score_assignments.append(("crossover", int(a)))
        elif o in ("-r", "--cmv-threshold"):
            thresholds["r"] = _thr(a)
        elif o in ("-v", "--vec-threshold"):
            if not colour:
                raise SystemExit(
                    "genome-axis runner: -v is a colour-space option")
            thresholds["v"] = _thr(a)
            vec_threshold_set = True
        elif o in ("-h", "--full-threshold"):
            thresholds["h"] = _thr(a)
        elif o in ("-U", "--ungapped"):
            cfg.gapless = True
            cfg.anchor_width = 0
            score_assignments.append(("a_gap_open", -255))
            score_assignments.append(("b_gap_open", -255))
        elif o in ("-C", "--negative"):
            cfg.strand_mask = 2
        elif o in ("-F", "--positive"):
            cfg.strand_mask = 1
        elif o in ("-Q", "--fastq"):
            fastq = True
        elif o in ("-T", "--rev-tiebreak"):
            cfg.rev_tiebreak = True
        elif o in ("-t", "--tiebreak-off"):
            cfg.rev_tiebreak = False
        elif o == "--strata":
            cfg.strata = True
        elif o == "--half-paired":
            cfg.half_paired = True
        elif o == "--no-half-paired":
            cfg.half_paired = False
        elif o == "--no-mapping-qualities":
            cfg.compute_mapping_qualities = False
        elif o in ("-p", "--pair-mode"):
            if a not in PAIR_MODE_NAMES:
                raise SystemExit(f"genome-axis runner: unknown pair "
                                 f"mode {a!r}")
            pair_mode = PAIR_MODE_NAMES.index(a)
        elif o in ("-I", "--isize"):
            lo, hi = a.split(",")
            isize = (int(lo), int(hi))
        elif o == "--insert-size-dist":
            mu, sd = a.split(",")
            insert_dist = (float(mu), float(sd))
        elif o == "--unpaired-options":
            nip, _, body = a.partition(";")
            if nip not in ("0", "1"):
                raise SystemExit(
                    f"genome-axis runner: invalid unpaired mapping "
                    f"options: [{a}]")
            unpaired_sets.append(
                parse_read_mapping_options(body, is_paired=False))
        elif o == "--paired-options":
            paired_sets.append(parse_readpair_mapping_options(a))
            pair_mode = paired_sets[0].pairing.pair_mode
        else:
            raise SystemExit(
                f"genome-axis runner: unsupported flag {o}")

    # post-parse application, mirroring gmapper.main
    updates = {}
    for key, val in score_assignments:
        updates[key] = val
    if "a_gap_open" in user_score_flags and \
            "b_gap_open" not in user_score_flags:
        updates["b_gap_open"] = updates["a_gap_open"]
    if "a_gap_extend" in user_score_flags and \
            "b_gap_extend" not in user_score_flags:
        updates["b_gap_extend"] = updates["a_gap_extend"]
    if updates:
        cfg.params = cfg.params.with_(**updates)
    cfg.window_gen_threshold = thresholds["r"]
    if vec_threshold_set:
        cfg.sw_vect_threshold = thresholds["v"]
    cfg.sw_full_threshold = thresholds["h"]
    if not match_mode_set:
        cfg.match_mode_unpaired = 2 if pair_mode == 0 else 4
    if pair_mode != 0:
        cfg.strand_mask = 3

    return {
        "cfg": cfg, "seed_specs": seed_specs, "seed_weight": seed_weight,
        "use_hashing": use_hashing, "fastq": fastq,
        "pair_mode": pair_mode, "isize": isize,
        "insert_dist": insert_dist, "unpaired_sets": unpaired_sets,
        "paired_sets": paired_sets, "reads": files[0], "genome": files[1],
    }


def _batches(seq, n):
    buf = []
    for x in seq:
        buf.append(x)
        if len(buf) == n:
            yield buf
            buf = []
    if buf:
        yield buf


def _wait_for(paths: list[str], timeout: float = 3600.0) -> None:
    deadline = time.time() + timeout
    while time.time() < deadline:
        if all(os.path.exists(p) for p in paths):
            return
        time.sleep(0.2)
    raise TimeoutError(f"missing rank files: {paths}")


def _write_header(fh, contigs) -> None:
    fh.write("@HD\tVN:1.0\tSO:unsorted\n")
    for c in contigs:
        fh.write(f"@SQ\tSN:{c.name}\tLN:{len(c.codes)}\n")
    fh.write("@PG\tID:gmapper\tVN:genome-axis\n")


def run(rest: list[str], out: str, num_processes: int, process_id: int,
        device) -> int:
    """Map as rank `process_id` of the genome axis, on `device` (the
    process group is up)."""
    from shrimp_tpu_torch import index as gindex
    from shrimp_tpu_torch import seeds as seedmod
    from shrimp_tpu_torch.io import fastx
    from shrimp_tpu_torch.parallel import mesh as meshmod

    pa = _parse_gmapper_args(rest)
    cfg = pa["cfg"]
    S = num_processes

    contigs = list(fastx.iter_contigs(pa["genome"]))
    bins = meshmod.split_contig_bins(contigs, S)
    if len(bins) != S:
        raise SystemExit(
            f"genome has only {len(bins)} shardable bins for {S} processes")
    seed_set = seedmod.make_seed_set(pa["seed_specs"], pa["seed_weight"],
                                     use_hashing=pa["use_hashing"])
    my_index = gindex.build_index(bins[process_id], seed_set,
                                  colour_space=cfg.colour_space)
    total_len = sum(len(c.codes) for c in contigs)

    rank_pkl = f"{out}.rank{process_id:05d}.pkl"
    done_paths = [f"{out}.rank{p:05d}.pkl.done" for p in range(S)]

    def reads():
        return ((r.name, r.seq, r.qual)
                for r in fastx.iter_reads(pa["reads"], fastq=pa["fastq"]))

    if pa["pair_mode"] == 0:
        return _run_unpaired(cfg, my_index, contigs, reads, device, S,
                             process_id, out, rank_pkl, done_paths,
                             option_sets=pa["unpaired_sets"] or None)
    return _run_paired(cfg, my_index, bins, contigs, seed_set, total_len,
                       pa, reads, device, S, process_id, out, rank_pkl,
                       done_paths)


def _run_unpaired(cfg, my_index, contigs, reads, device, S, process_id,
                  out, rank_pkl, done_paths, option_sets=None) -> int:
    from shrimp_tpu_torch import mapq
    from shrimp_tpu_torch.pipeline import candidates as cand
    from shrimp_tpu_torch.pipeline.mapper import Mapper
    from shrimp_tpu_torch.pipeline.options import abs_or_pct

    mapper = Mapper(my_index, cfg, device=device)
    sets = option_sets or cfg.unpaired_options()
    nR = len(sets)
    sidecar = []   # per read (stream order): [round][(key, mqv, lines)]
    checked = False
    for batch in _batches(reads(), BATCH):
        entries = cand.prepare_reads(batch, cfg, mapper.min_seed_span)
        ok = np.array([e.read_len <= cfg.longest_read_len
                       and e.max_n_kmers > 0 for e in entries])
        live = [e for e, o in zip(entries, ok) if o]
        live_map = np.flatnonzero(ok)
        B = len(entries)
        acc = [[[] for _ in range(nR)] for _ in range(B)]
        if live:
            # option-set rounds with per-shard stop conditions (the
            # reference's file-split workflow also evaluates stops per
            # shard, SPLITTING_AND_MERGING:57-97)
            pending = list(range(len(live)))
            for si, opts in enumerate(sets):
                if not pending:
                    break
                sub = [live[i] for i in pending]
                per_read = {}
                hb = mapper._candidates(sub, opts)
                if hb.n:
                    p1 = mapper._pass1(sub, hb, opts)
                    if p1 is not None:
                        per_read = mapper._pass2(sub, p1, opts)
                nxt = []
                for k, li in enumerate(pending):
                    hits = per_read.get(k, [])
                    if hits:
                        acc[int(live_map[li])][si] = hits
                    if opts.pass2.stop_count > 0:
                        cnt = sum(
                            1 for h in hits
                            if h.score_full >= int(abs_or_pct(
                                opts.pass2.stop_threshold, h.score_max)))
                        if cnt < opts.pass2.stop_count:
                            nxt.append(li)
                pending = nxt
        z1_local = np.zeros(B, np.float64)
        for ri in range(B):
            z1_local[ri] = sum(h.posterior for rnd in acc[ri] for h in rnd)
        # ---- THE genome-axis collective: exact float64 all-gather over
        # the process group, summed in shard order ----
        z1 = (_allgather_f64_exact(z1_local, device).sum(axis=0)
              if B else np.zeros(0))
        if not checked and B:
            _psum_check(z1_local, z1, device)
            checked = True
        batch_rows = []
        for ri in range(B):
            zz = float(z1[ri])
            rounds = []
            for rnd in acc[ri]:
                rows = []
                for h in rnd:
                    h.z0 = h.posterior
                    h.z1 = zz
                    if cfg.compute_mapping_qualities:
                        h.mqv = (mapq.qv_from_pr_corr(h.posterior / zz)
                                 if zz else 0)
                        if h.mqv < 4:
                            h.mqv = 0
                    lines = [r.line() for r in
                             mapper.sam_records(entries[ri], [h])]
                    rows.append((h.pass2_key, h.mqv, lines))
                rounds.append(rows)
            batch_rows.append(rounds)
        sidecar.extend(batch_rows)

    with open(rank_pkl, "wb") as fh:
        pickle.dump(sidecar, fh)
    with open(rank_pkl + ".done", "w") as fh:
        fh.write("ok\n")
    _wait_for(done_paths)
    if process_id == 0:
        shards = []
        for p in range(S):
            with open(f"{out}.rank{p:05d}.pkl", "rb") as fh:
                shards.append(pickle.load(fh))
        with open(out, "w") as fh:
            _write_header(fh, contigs)
            for ri in range(len(shards[0])):
                final = []
                for si in range(nR):
                    merged = []
                    for p in range(S):
                        merged.extend(shards[p][ri][si])
                    merged.sort(key=lambda t: -t[0])
                    merged = merged[:sets[si].pass2.num_outputs]
                    final.extend(merged)
                if final and cfg.single_best_mapping \
                        and cfg.compute_mapping_qualities:
                    best = max(range(len(final)),
                               key=lambda i: final[i][1])
                    final = [final[best]]
                for _, _, lines in final:
                    for ln in lines:
                        fh.write(ln + "\n")
    return 0


def _run_paired(cfg, my_index, bins, contigs, seed_set, total_len,
                pa, reads, device, S, process_id, out, rank_pkl,
                done_paths) -> int:
    import dataclasses

    from shrimp_tpu_torch import index as gindex
    from shrimp_tpu_torch import mapq
    from shrimp_tpu_torch.parallel import mesh as meshmod
    from shrimp_tpu_torch.pipeline.paired import PairedConfig, PairedMapper

    pcfg = PairedConfig(pair_mode=pa["pair_mode"],
                        min_insert_size=pa["isize"][0],
                        max_insert_size=pa["isize"][1],
                        insert_size_mean=pa["insert_dist"][0],
                        insert_size_stddev=pa["insert_dist"][1],
                        match_mode=cfg.match_mode_unpaired)
    shard_cfg = dataclasses.replace(cfg, strata=False, max_alignments=0)
    pm = PairedMapper(my_index, shard_cfg, pcfg, device=device)
    popts = ([pm._popts_from(r) for r in pa["paired_sets"]]
             if pa["paired_sets"] else None)
    results = []
    for batch in _batches(reads(), BATCH):
        pairs = [(batch[i], batch[i + 1])
                 for i in range(0, len(batch) - 1, 2)]
        results.extend(pm.map_pair_batch(pairs, option_sets=popts,
                                         compute_mqv=False))

    # ---- cross-process self-check on the raw Part-2c insert-prior sums:
    # z6_s = sum of pr_insert_size over THIS shard's candidate pairs, the
    # per-shard quantity mergesam recombines by summation ----
    nP = len(results)
    z6_raw = np.zeros(nP, np.float64)
    for pi, pr in enumerate(results):
        z6_raw[pi] = sum(
            mapq.get_pr_insert_size(isz, pcfg.insert_size_mean,
                                    pcfg.insert_size_stddev)
            for _, _, isz in pr.paired_hits)
    if nP:
        _psum_check(z6_raw, _allgather_f64_exact(z6_raw, device).sum(axis=0),
                    device)

    with open(rank_pkl, "wb") as fh:
        pickle.dump(results, fh)
    with open(rank_pkl + ".done", "w") as fh:
        fh.write("ok\n")
    _wait_for(done_paths)
    if process_id == 0:
        per_shard = []
        for p in range(S):
            with open(f"{out}.rank{p:05d}.pkl", "rb") as fh:
                per_shard.append(pickle.load(fh))
        # emission-only shard mappers: contig tables + genome planes, no
        # posting lists (index.build_index(postings=False))
        emitters = [
            PairedMapper(gindex.build_index(b, seed_set, postings=False),
                         shard_cfg, pcfg, device=device) for b in bins]
        emitters[0].mqv_total_len = total_len
        # custom --paired-options: the merge selects with the LAST
        # round's pairing thresholds (final-round selection semantics)
        pairing = (popts[-1]["pairing"] if popts else
                   emitters[0].default_paired_sets()[0]["pairing"])
        out_rows, _, _ = meshmod.merge_paired_shard_results(
            per_shard, nP, cfg, pcfg, emitters[0],
            pairing["pass2_threshold"], pairing["pass2_num_outputs"],
            cfg.strata)
        with open(out, "w") as fh:
            _write_header(fh, contigs)
            for (pr, tp, tu) in out_rows:
                for rec in meshmod.sam_records_pair_tagged(
                        emitters, cfg, pr, tp, tu):
                    fh.write(rec.line() + "\n")
    return 0
