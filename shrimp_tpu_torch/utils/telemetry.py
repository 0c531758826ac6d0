"""Run telemetry: per-kernel invocations/cells/seconds, per-stage timers,
and the reference's exact diagnostic output formats.

Replicates, format-for-format:
  * print_settings            (gmapper/gmapper.c:1348-1496) incl.
    print_pairing_options (:1250) / print_read_mapping_options (:1271)
  * print_statistics          (gmapper.c:695-1009) with the -D per-thread
    stage table (:838-863)
  * print_insert_histogram    (gmapper.c:670-679), 100 buckets of
    ceil_div(max-min+1, 100)  (:2363)
  * comma_integer             (common/util.c:1145)

Cell accounting matches the reference kernels:
  vector SW   glen * rlen per invocation     (sw-vector.c:509)
  gapless     rlen per invocation            (sw-gapless.c:105)
  full SW     sum of band widths per row     (sw-full-ls.c:237, -cs.c:327)
  post SW     16 * len per invocation        (sw-post.c:716)

Timers are host wall-clock seconds per pipeline stage, on a monotonic
clock (`time.perf_counter`).  On the card the kernel "seconds" are the
host's blocking read of the batched call's result, which includes the wait
for its kernels (device work for many reference invocations at once), so
cells/sec is the throughput of the batched kernel as the host sees it.

While a torch profiler records, each stage entered a few times a batch is
also a profiler range `stage.<name>` carrying the batch's id (`batch=<k>`),
on the profiler's clock, the clock of the kernels' events; with the
profiler off a stage costs one flag read more.
"""

from __future__ import annotations

import itertools
import math
import threading
import time
from dataclasses import dataclass, field

import torch

# whether a torch profiler records: one flag read (0.1 us on a host core,
# where a record_function costs 8-9 us even with no profiler on)
_profiling = torch._C._autograd._profiler_enabled


def comma_integer(val: int) -> str:
    """comma_integer (common/util.c:1145-1167)."""
    s = str(int(val))
    skip = 3 - (len(s) % 3)
    out = []
    for i, c in enumerate(s):
        if (i + skip) % 3 == 0 and i != 0:
            out.append(",")
        out.append(c)
    return "".join(out)


def thres_to_buff(thres: float) -> str:
    """thres_to_buff (gmapper.c:651-659): negative = absolute."""
    if thres < 0:
        return str(int(-thres) & 0xFFFFFFFF)
    return f"{thres:.2f}%"


def bool_buff(v) -> str:
    return "true" if v else "false"


@dataclass
class KernelStats:
    invocs: int = 0
    cells: int = 0
    secs: float = 0.0
    # shared with the owning Telemetry (and its Mapper's _stats_lock): the
    # pipelined streams add from two worker threads at once
    lock: threading.Lock = field(default_factory=threading.Lock,
                                 repr=False, compare=False)

    def add(self, invocs: int, cells: int, secs: float = 0.0) -> None:
        with self.lock:
            self.invocs += int(invocs)
            self.cells += int(cells)
            self.secs += secs

    @property
    def cells_per_sec(self) -> float:
        return 0.0 if self.secs == 0 else self.cells / self.secs


class StageTimer:
    """Accumulating wall-clock stage timer (time_counter.h:8-60).

    Start times are thread-local: the pipelined paired stream runs two
    batches on worker threads, so the same named stage can be entered
    concurrently; each thread accumulates its own interval (cumulative
    stage seconds may exceed wall time, like summed per-thread tpg).

    With a `label`, the timed interval sits inside a profiler range of
    that name while a torch profiler records: opened before the start is
    read and closed after the end is, so the seconds never include the
    range's own cost.  Its argument is this thread's current batch id in
    `batch` (`Telemetry.begin_batch`), where one is set."""

    def __init__(self, lock=None):
        self.secs = 0.0
        self._local = threading.local()
        self.lock = lock or threading.Lock()
        self.label = None
        self.batch = None

    def __enter__(self):
        local = self._local
        local.rf = None
        if self.label is not None and _profiling():
            k = getattr(self.batch, "k", None)
            local.rf = torch.profiler.record_function(
                self.label, None if k is None else f"batch={k}")
            local.rf.__enter__()
        local.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        local = self._local
        local.last = time.perf_counter() - local.t0
        with self.lock:
            self.secs += local.last
        if local.rf is not None:
            local.rf.__exit__(*exc)
        return False

    @property
    def last(self) -> float:
        """Seconds of this thread's last interval: what a kernel's
        counter adds for the same wait, so the two never disagree."""
        return self._local.last


STAGES = ("readparse", "region_counts", "mp_region_counts", "anchor_list",
          "hit_list", "pass1", "get_vector_hits", "pass2",
          "duplicate_removal", "wait")
# entered once a read: no profiler range of their own (their time shows
# under the enclosing stage's range)
PER_READ = ("duplicate_removal",)


@dataclass
class Telemetry:
    """One mapping run's counters (the tpg_t + kernel stats aggregate)."""

    f1: KernelStats = field(default_factory=KernelStats)      # vector/gapless
    f2: KernelStats = field(default_factory=KernelStats)      # full SW
    fwbw: KernelStats = field(default_factory=KernelStats)    # posterior
    f1_calls_bypassed: int = 0
    stages: dict = field(default_factory=lambda: {
        s: StageTimer() for s in STAGES})
    fasta_load_secs: float = 0.0
    # guards every counter and timer above (Mapper passes its _stats_lock)
    lock: threading.Lock = field(default_factory=threading.Lock,
                                 repr=False, compare=False)
    # this thread's current batch id (`k`), read by the stages' ranges:
    # the pipelined streams have several batches in flight
    batch: threading.local = field(default_factory=threading.local,
                                   repr=False, compare=False)
    _batch_ids: itertools.count = field(default_factory=itertools.count,
                                        repr=False, compare=False)

    def __post_init__(self):
        for ks in (self.f1, self.f2, self.fwbw):
            ks.lock = self.lock
        for name, timer in self.stages.items():
            self._adopt(name, timer)

    def _adopt(self, name: str, timer: StageTimer) -> None:
        timer.lock = self.lock
        timer.batch = self.batch
        timer.label = None if name in PER_READ else "stage." + name

    def stage(self, name: str) -> StageTimer:
        # auto-create: the paired pipeline and the pass-2 split add stages
        # beyond the base STAGES tuple (pair_up, hp_pass1, hp_pass2,
        # paired_mqv; pass2_dispatch, pass2_finish, pass2_select, post_sw,
        # device_fetch)
        with self.lock:
            timer = self.stages.get(name)
            if timer is None:
                timer = self.stages[name] = StageTimer()
                self._adopt(name, timer)
        return timer

    def begin_batch(self) -> int:
        """A new batch id, made this thread's current one."""
        k = next(self._batch_ids)
        self.batch.k = k
        return k

    def set_batch(self, k: int) -> None:
        """Make batch `k` this thread's current one again."""
        self.batch.k = k


_TAB = "    "


def _line24(out, label: str, value: str) -> None:
    out(f"{_TAB}{_TAB}{label:<24}{value}")


def _line40(out, label: str, value: str) -> None:
    out(f"{_TAB}{_TAB}{label:<40}{value}")


def print_statistics(out, tel: Telemetry, *,
                     colour_space: bool,
                     load_genome_secs: float,
                     mapping_secs: float,
                     nreads: int,
                     num_threads: int = 1,
                     dflag: bool = False,
                     engine_info: dict | None = None,
                     pair_mode_none: bool = True,
                     half_paired: bool = True,
                     # unpaired counters
                     total_reads_matched: int = 0,
                     total_reads_matched_conf: int = 0,
                     total_reads_dropped: int = 0,
                     total_single_matches: int = 0,
                     total_dup_single_matches: int = 0,
                     # paired counters
                     total_pairs_matched: int = 0,
                     total_pairs_matched_conf: int = 0,
                     total_pairs_dropped: int = 0,
                     total_paired_matches: int = 0,
                     total_dup_paired_matches: int = 0,
                     genomemap_bytes: int = 0,
                     xflag: bool = False,
                     insert_histogram=None,
                     min_insert_size: int = 0,
                     insert_histogram_bucket_size: int = 1) -> None:
    """print_statistics (gmapper.c:695-1009), exact format."""
    t = _TAB
    f1, f2, fwbw = tel.f1, tel.f2, tel.fwbw
    st = {k: v.secs for k, v in tel.stages.items()}
    scan_secs = max(
        0.0, mapping_secs - f1.secs - f2.secs - fwbw.secs - st["wait"])
    readparse_secs = st["readparse"]

    out("\nStatistics:")
    out(f"{t}Overall:")
    _line24(out, "Load Genome Time:", f"{load_genome_secs:.2f} seconds")
    _line24(out, "Read Mapping Time:", f"{mapping_secs:.2f} seconds")
    rph = 0 if mapping_secs == 0 else nreads / mapping_secs * 3600.0
    _line24(out, "Reads per hour:", comma_integer(int(rph)))
    _line24(out, "Reads per core-hour:",
            comma_integer(int(rph / num_threads)))
    out("")

    if dflag:
        out(f"{t}Per-Thread Stats:")
        hdr1 = (f"{t}{t}" + f"{'':>11} {'ReadParse':>9} {'Scan':>9} "
                f"{'Reg Cnts':>9} {'MPRegCnt':>9} {'Anch List':>9} "
                f"{'Hit List':>9} {'Pass1':>9} {'Vect Hits':>9} "
                f"{'Pass2':>9} {'Dup Remv':>9} {'Vector SW':>25} "
                f"{'Scalar SW':>25} {'Post SW':>25} {'Wait':>9}")
        hdr2 = (f"{t}{t}" + f"{'':>11} {'Time':>9} {'Time':>9} {'Time':>9} "
                f"{'Time':>9} {'Time':>9} {'Time':>9} {'Time':>9} "
                f"{'Time':>9} {'Time':>9} {'Time':>9} "
                f"{'Invocs':>15} {'Time':>9} {'Invocs':>15} {'Time':>9} "
                f"{'Invocs':>15} {'Time':>9} {'Time':>9}")
        out(hdr1)
        out(hdr2)
        out("")
        out(f"{t}{t}" + f"Thread {0:<4d} "
            f"{readparse_secs:9.2f} {scan_secs:9.2f} "
            f"{st['region_counts']:9.2f} {st['mp_region_counts']:9.2f} "
            f"{st['anchor_list']:9.2f} {st['hit_list']:9.2f} "
            f"{st['pass1']:9.2f} {st['get_vector_hits']:9.2f} "
            f"{st['pass2']:9.2f} {st['duplicate_removal']:9.2f} "
            f"{comma_integer(f1.invocs):>15} {f1.secs:9.2f} "
            f"{comma_integer(f2.invocs):>15} {f2.secs:9.2f} "
            f"{comma_integer(fwbw.invocs):>15} {fwbw.secs:9.2f} "
            f"{st['wait']:9.2f}")
        out("")
        if engine_info:
            # TPU-specific diagnostics: the per-run auto-tune verdicts and
            # fallback counters, so perf regressions are visible from -D
            out(f"{t}TPU Engine Choices:")
            _line24(out, "Pass1 engine:",
                    str(engine_info.get("pass1_engine") or "untuned"))
            _line24(out, "Pass1 gather path:",
                    str(engine_info.get("pass1_path") or "untuned"))
            l3 = str(engine_info.get("l3_choice") or
                     ("device" if engine_info.get("device_candidates")
                      is True else "host"))
            if engine_info.get("l3_reason"):
                l3 += f" ({engine_info['l3_reason']})"
            _line24(out, "L3 path:", l3)
            _line24(out, "Device-L3 fallbacks:",
                    str(engine_info.get("device_l3_fallbacks", 0)))
            out("")

    out(f"{t}Spaced Seed Scan:")
    _line24(out, "Run-time:", f"{scan_secs:.2f} seconds")
    out("")

    out(f"{t}Vector Smith-Waterman:")
    _line24(out, "Run-time:", f"{f1.secs:.2f} seconds")
    _line24(out, "Invocations:", comma_integer(f1.invocs))
    _line24(out, "Bypassed Calls:", comma_integer(tel.f1_calls_bypassed))
    _line24(out, "Cells Computed:", f"{f1.cells / 1e6:.2f} million")
    _line24(out, "Cells per Second:", f"{f1.cells_per_sec / 1e6:.2f} million")
    out("")

    out(f"{t}Scalar Smith-Waterman:")
    _line24(out, "Run-time:", f"{f2.secs:.2f} seconds")
    _line24(out, "Invocations:", comma_integer(f2.invocs))
    _line24(out, "Cells Computed:", f"{f2.cells / 1e6:.2f} million")
    _line24(out, "Cells per Second:", f"{f2.cells_per_sec / 1e6:.2f} million")
    out("")

    if colour_space:
        out(f"{t}Forward-Backward:")
        _line24(out, "Run-time:", f"{fwbw.secs:.2f} seconds")
        _line24(out, "Invocations:", comma_integer(fwbw.invocs))
        _line24(out, "Cells Computed:", f"{fwbw.cells / 1e6:.2f} million")
        _line24(out, "Cells per Second:",
                f"{fwbw.cells_per_sec / 1e6:.2f} million")
        out("")

    out(f"{t}Miscellaneous Totals:")
    _line24(out, "Fasta Lib Time:", f"{tel.fasta_load_secs:.2f} seconds")
    _line24(out, "Read Load Time:", f"{readparse_secs:.2f} seconds")
    _line24(out, "Wait Time:", f"{st['wait']:.2f} seconds")
    out("")

    out(f"{t}General:")
    if pair_mode_none:
        pct = (lambda n: 0.0 if nreads == 0 else n / nreads * 100)
        _line24(out, "Reads Matched:",
                f"{comma_integer(total_reads_matched)}    "
                f"({pct(total_reads_matched):.4f}%)")
        _line24(out, "... with QV >= 10:",
                f"{comma_integer(total_reads_matched_conf)}    "
                f"({pct(total_reads_matched_conf):.4f}%)")
        _line24(out, "Reads Dropped:",
                f"{comma_integer(total_reads_dropped)}    "
                f"({pct(total_reads_dropped):.4f}%)")
        _line24(out, "Total Matches:", comma_integer(total_single_matches))
        _line24(out, "Avg Hits/Matched Read:",
                "0.00" if total_reads_matched == 0 else
                f"{total_single_matches / total_reads_matched:.2f}")
        _line24(out, "Duplicate Hits Pruned:",
                comma_integer(total_dup_single_matches))
    else:
        npairs = nreads // 2
        ppct = (lambda n: 0.0 if nreads == 0 else n / npairs * 100)
        _line40(out, "Pairs Matched:",
                f"{comma_integer(total_pairs_matched)}    "
                f"({ppct(total_pairs_matched):.4f}%)")
        _line40(out, "... with QV >= 10:",
                f"{comma_integer(total_pairs_matched_conf)}    "
                f"({ppct(total_pairs_matched_conf):.4f}%)")
        _line40(out, "Pairs Dropped:",
                f"{comma_integer(total_pairs_dropped)}    "
                f"({ppct(total_pairs_dropped):.4f}%)")
        _line40(out, "Total Paired Matches:",
                comma_integer(total_paired_matches))
        _line40(out, "Avg Matches/Pair Matched:",
                "0.00" if total_pairs_matched == 0 else
                f"{total_paired_matches / total_pairs_matched:.2f}")
        _line40(out, "Duplicate Paired Matches Pruned:",
                comma_integer(total_dup_paired_matches))
        if half_paired:
            out("")
            pct = (lambda n: 0.0 if nreads == 0 else n / nreads * 100)
            _line40(out, "Additional Reads Matched Unpaired:",
                    f"{comma_integer(total_reads_matched)}    "
                    f"({pct(total_reads_matched):.4f}%)")
            _line40(out, "... with QV >= 10:",
                    f"{comma_integer(total_reads_matched_conf)}    "
                    f"({pct(total_reads_matched_conf):.4f}%)")
            _line40(out, "Total Unpaired Matches:",
                    comma_integer(total_single_matches))
            _line40(out, "Avg Matches/Unpaired Matched Read:",
                    "0.00" if total_reads_matched == 0 else
                    f"{total_single_matches / total_reads_matched:.2f}")
            _line40(out, "Duplicate Unpaired Matches Pruned:",
                    comma_integer(total_dup_single_matches))
    out("")

    out(f"{t}Memory usage:")
    _line24(out, "Genomemap:", comma_integer(genomemap_bytes))

    if xflag and insert_histogram is not None:
        print_insert_histogram(out, insert_histogram, min_insert_size,
                               insert_histogram_bucket_size,
                               total_paired_matches)


def print_insert_histogram(out, histogram, min_insert_size: int,
                           bucket_size: int, total_paired_matches: int
                           ) -> None:
    """print_insert_histogram (gmapper.c:670-679), exact format."""
    for i in range(100):
        frac = (0.0 if total_paired_matches == 0
                else histogram[i] / total_paired_matches * 100)
        out(f"[{min_insert_size + i * bucket_size}-"
            f"{min_insert_size + (i + 1) * bucket_size - 1}]: {frac:.2f}%")


def insert_histogram_bucket(isize: int, min_insert_size: int,
                            bucket_size: int) -> int:
    """Bucket index, clamped to [0, 99] (output.c:1036-1042)."""
    b = (isize - min_insert_size) // bucket_size
    return min(max(b, 0), 99)


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _sample_stddev(sum_sq: float, total: float, n: int) -> float:
    """stat_get_sample_stddev (common/stats.h:78-85), same formula order
    so the printed %.2f matches the reference bit-for-bit (nan included)."""
    import numpy as np
    return float(np.sqrt(sum_sq / (n - 1.0) - total * total / (n * (n - 1.0))))


def print_genomemap_stats(out, idx) -> None:
    """-Y genome map stats (print_genomemap_stats, genome.c:834-903).

    Over-cutoff posting lists were already dropped by ``GenomeIndex.trim``
    before this runs, so a zero-length list here reproduces the reference's
    ``> list_cutoff`` exclusion (genome.c:856-866): it contributes 0 to the
    all-lists stat, is absent from the non-zero stat and max, and lands in
    histogram bucket 0.
    """
    import numpy as np
    out("Genome Map stats:")
    for sn in range(len(idx.offsets)):
        capacity = len(idx.offsets[sn]) - 1
        lens = np.diff(idx.offsets[sn]).astype(np.int64)
        total = int(lens.sum())
        sum_sq = float((lens.astype(np.float64) ** 2).sum())
        non0 = int((lens > 0).sum())
        mx = int(lens.max()) if capacity else 0
        mean = total / capacity
        mean_n0 = total / non0 if non0 else float("nan")
        weight = idx.seed_set.seeds[sn].weight
        out(f"sn:{sn} weight:{weight} total_kmers:{total} lists:{capacity} "
            f"(non-zero:{non0}) "
            f"list_sz_avg:{mean:.2f} ({mean_n0:.2f}) "
            f"list_sz_stddev:{_sample_stddev(sum_sq, total, capacity):.2f} "
            f"({_sample_stddev(sum_sq, total, non0):.2f}) max:{mx}")
        bucket_size = ceil_div(mx + 1, 100)
        hist = np.bincount(np.minimum(lens // bucket_size, 99),
                           minlength=100)
        cum = np.cumsum(hist)
        for i in range(100):
            out(f"[{i * bucket_size}-{(i + 1) * bucket_size}]: "
                f"{int(hist[i])} "
                f"(cummulative: {cum[i] / capacity * 100.0:.4f}%)")


# ---------------------------------------------------------------------------
# print_settings (gmapper.c:1348-1443; the tail after the early return is
# dead code in the reference and not reproduced)
# ---------------------------------------------------------------------------

def print_settings(out, *, seed_set, num_threads: int, chunk_size: int,
                   window_len: float, hash_filter_calls: bool,
                   anchor_width: int, indel_taboo_len: int,
                   list_cutoff: int, def_list_cutoff: int,
                   gapless: bool, global_alignment: bool,
                   use_regions: bool, region_bits: int, region_overlap: int,
                   qflag: bool, ignore_qvs: bool, min_avg_qv: int,
                   compute_mapping_qualities: bool, all_contigs: bool,
                   single_best_mapping: bool,
                   colour_space: bool, params, probs,
                   option_set_printers=()) -> None:
    t = _TAB
    out("Settings:")
    seeds = seed_set.seeds
    label = ("Spaced Seed (weight/span)" if len(seeds) == 1
             else "Spaced Seeds (weight/span)")
    for sn, sd in enumerate(seeds):
        lbl = label if sn == 0 else ""
        out(f"{t}{lbl:<40}{seed_str(sd)} ({sd.weight}/{sd.span})")
    out("")
    out(f"{t}{'Number of threads:':<40}{num_threads}")
    out(f"{t}{'Thread chunk size:':<40}{chunk_size}")
    out(f"{t}{'Window length:':<40}{thres_to_buff(window_len)}")
    out(f"{t}{'Hash filter calls:':<40}{'yes' if hash_filter_calls else 'no'}")
    out(f"{t}{'Anchor width:':<40}{anchor_width}"
        f"{' (disabled)' if anchor_width == -1 else ''}")
    out(f"{t}{'Indel taboo Len:':<40}{indel_taboo_len}"
        f"{' (disabled)' if indel_taboo_len == 0 else ''}")
    if list_cutoff < def_list_cutoff:
        out(f"{t}{'Index list cutoff length:':<40}{list_cutoff}")
    out(f"{t}{'Gapless mode:':<40}{'yes' if gapless else 'no'}")
    out(f"{t}{'Global alignment:':<40}{'yes' if global_alignment else 'no'}")
    out(f"{t}{'Region filter:':<40}{'yes' if use_regions else 'no'}")
    if use_regions:
        out(f"{t}{'Region size:':<40}{1 << region_bits}")
        out(f"{t}{'Region overlap:':<40}{region_overlap}")
    if qflag:
        out(f"{t}{'Ignore QVs:':<40}{'yes' if ignore_qvs else 'no'}")
    if qflag and not ignore_qvs:
        out(f"{t}{'Minimum average qv:':<40}{min_avg_qv}"
            f"{' (none)' if min_avg_qv < 0 else ''}")
    out(f"{t}{'Compute mapping qualities:':<40}"
        f"{'yes' if compute_mapping_qualities else 'no'}")
    if compute_mapping_qualities:
        out(f"{t}{'All contigs:':<40}{'yes' if all_contigs else 'no'}")
        out(f"{t}{'Single best mapping:':<40}"
            f"{'yes' if single_best_mapping else 'no'}")
    out("")
    out(f"{t}{'SW Match Score:':<40}{params.match:<10}")
    out(f"{t}{'SW Mismatch Score [Prob]:':<40}{params.mismatch:<10}"
        f"\t[{probs.pr_mismatch:.1e}]")
    out(f"{t}{'SW Del Open Score [Prob]:':<40}{params.a_gap_open:<10}"
        f"\t[{probs.pr_del_open:.1e}]")
    out(f"{t}{'SW Ins Open Score [Prob]:':<40}{params.b_gap_open:<10}"
        f"\t[{probs.pr_ins_open:.1e}]")
    out(f"{t}{'SW Del Extend Score [Prob]:':<40}{params.a_gap_extend:<10}"
        f"\t[{probs.pr_del_extend:.1e}]")
    out(f"{t}{'SW Ins Extend Score [Prob]:':<40}{params.b_gap_extend:<10}"
        f"\t[{probs.pr_ins_extend:.1e}]")
    if colour_space:
        out(f"{t}{'SW Crossover Score [Prob]:':<40}{params.crossover:<10}"
            f"\t[{probs.pr_xover:.1e}]")
    out("")
    for printer in option_set_printers:
        printer(out)
    out("")


def seed_str(sd) -> str:
    """seed_to_string (gmapper/seeds.c:139-158)."""
    mask = ["0"] * sd.span
    for o in sd.ones_idx:
        mask[o] = "1"
    s = "".join(mask)
    if sd.positions is not None:
        s += ":" + "|".join(str(int(p)) for p in sd.positions)
    return s


def print_read_mapping_options(out, opts, is_paired: bool) -> None:
    """print_read_mapping_options (gmapper.c:1271-1345)."""
    out("[")
    out("  regions:")
    out(f"    recompute:{bool_buff(opts.regions.recompute)}")
    out("  anchor_list:")
    out(f"    recompute:{bool_buff(opts.anchor_list.recompute)}")
    if opts.anchor_list.recompute:
        out(f"    collapse:{bool_buff(opts.anchor_list.collapse)}")
        out(f"    use_region_counts:"
            f"{bool_buff(opts.anchor_list.use_region_counts)}")
        out(f"    use_mp_region_counts:"
            f"{opts.anchor_list.use_mp_region_counts}")
    out("  hit_list:")
    out(f"    recompute:{bool_buff(opts.hit_list.recompute)}")
    if opts.hit_list.recompute:
        out(f"    gapless:{bool_buff(opts.hit_list.gapless)}")
        out(f"    match_mode:{opts.hit_list.match_mode}")
        out(f"    threshold:{thres_to_buff(opts.hit_list.threshold)}")
    out("  pass1:")
    out(f"    recompute:{bool_buff(opts.pass1.recompute)}")
    if opts.pass1.recompute:
        out(f"    threshold:{thres_to_buff(opts.pass1.threshold)}")
        out(f"    window_overlap:{thres_to_buff(opts.pass1.window_overlap)}")
        out(f"    min_matches:{opts.pass1.min_matches}")
        out(f"    gapless:{bool_buff(opts.pass1.gapless)}")
        if is_paired:
            out(f"    only_paired:{bool_buff(opts.pass1.only_paired)}")
        else:
            out(f"    num_outputs:{opts.pass1.num_outputs}")
    out("  pass2:")
    out(f"    threshold:{thres_to_buff(opts.pass2.threshold)}")
    if not is_paired:
        out(f"    strata:{bool_buff(opts.pass2.strata)}")
        out(f"    save_outputs:{bool_buff(opts.pass2.save_outputs)}")
        out(f"    num_outputs:{opts.pass2.num_outputs}")
        out("  stop:")
        out(f"    stop_count:{opts.pass2.stop_count}")
        if opts.pass2.stop_count > 0:
            out(f"    stop_threshold:{thres_to_buff(opts.pass2.stop_threshold)}")
    out("]")


def print_pairing_options(out, pairing) -> None:
    """print_pairing_options (gmapper.c:1250-1268)."""
    out("[")
    out(f"  pairing:{pairing.pair_mode_name}")
    out(f"  min_insert:{pairing.min_insert_size}")
    out(f"  max_insert:{pairing.max_insert_size}")
    out(f"  pass1_num_outputs:{pairing.pass1_num_outputs}")
    out(f"  pass1_threshold:{thres_to_buff(pairing.pass1_threshold)}")
    out(f"  pass2_num_outputs:{pairing.pass2_num_outputs}")
    out(f"  pass2_threshold:{thres_to_buff(pairing.pass2_threshold)}")
    out(f"  strata:{bool_buff(pairing.strata)}")
    out(f"  save_outputs:{bool_buff(pairing.save_outputs)}")
    out(f"  stop_count:{pairing.stop_count}")
    out(f"  stop_threshold:{thres_to_buff(pairing.stop_threshold)}")
    out("]")
