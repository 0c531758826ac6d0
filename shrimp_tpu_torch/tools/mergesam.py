"""mergesam — the distributed-merge reducer (L6/L7 tool).

Merges per-shard SAM outputs for the same read set against different genome
shards (or concatenated different read sets), recombining mapping qualities
exactly per the `not_in_dist/MAPPING_QUALITIES` spec Parts 1c/2c:

  * unpaired / half-paired:  z1 := sum_j z1_j;   z4 := z4 of the max-z0 hit
    (`consolidate_single`, mergesam/sam_reader.c:299-385)
  * paired:  z3 := sum_j z3_j (one per file);  z4 := min over hits;
    z6 (insert-size denominator) := sum_j z6_j
    (`consolidate_paired`, sam_reader.c:117-296)
  * class priors from z4*genome_length (capped at 1) and z5
    (`pp_ll_combine_and_check`, sam_reader.c:455-520)

Selection uses the reference's bounded min-heap whose ARRAY order is the
output order (mergesam_heap.c), with --strata / --max-alignments /
--single-best / --half-paired policies, and records are re-rendered with the
reference's field order (render.c:227-295): fixed fields, AS, Z*, verbatim
aux remainder.

The merge algebra is associative/commutative (sums and mins), which is what
makes the in-memory equivalent a pair of sum/min collectives over index
shards (the JAX package's shrimp_tpu/parallel/shard.py).
"""

from __future__ import annotations

import math
import sys

# class indices (mergesam/mergesam.h:14-20)
PAIRED, UNPAIRED, FIRST_LEG, SECOND_LEG, UNMAPPED = 0, 2, 3, 4, 5

VERSION = "0.1.0"


def tnlog(x: float) -> int:
    return int(1000.0 * -math.log(x))


def inv_tnlog(y: int) -> float:
    return math.exp(-y / 1000.0)


def qv_from_pr_corr(pr_corr: float) -> int:
    pr_err = 1 - pr_corr
    if pr_err > 0.99999999:
        return 0
    if pr_err < 1e-25:
        return 250
    return int(-10.0 * math.log(pr_err) / math.log(10.0))


class Pretty:
    """One parsed SAM record (sam2pretty_lib.c pretty_from_string_inplace)."""

    __slots__ = ("qname", "flags", "rname", "pos", "mapq", "cigar", "rnext",
                 "pnext", "isize", "seq", "qual", "has_score", "score",
                 "has_zs", "z", "aux", "fileno", "mate", "paired_sequencing",
                 "proper_pair", "mapped", "mp_mapped", "reverse",
                 "mp_reverse", "first_in_pair", "second_in_pair",
                 "primary_alignment", "platform_quality_fail",
                 "pcr_duplicate")

    def __init__(self, line: str, fileno: int):
        f = line.split("\t")
        self.qname = f[0]
        self.flags = int(f[1])
        self.rname = f[2]
        self.pos = int(f[3])
        self.mapq = int(f[4])
        self.cigar = f[5]
        self.rnext = f[6]
        self.pnext = int(f[7])
        self.isize = int(f[8])
        self.seq = f[9]
        self.qual = f[10]
        self.has_score = False
        self.score = 0
        self.has_zs = 0
        self.z = [0.0] * 7
        self.aux = None
        rest = f[11:]
        i = 0
        if rest and rest[0].startswith("AS"):
            self.has_score = True
            self.score = int(rest[0][5:])
            i = 1
            # Z fields must directly follow AS (sam2pretty_lib.c:1437-1466)
            while i < len(rest) and rest[i][0] == "Z" and rest[i][1].isdigit():
                zi = int(rest[i][1])
                self.has_zs |= 1 << zi
                self.z[zi] = inv_tnlog(int(rest[i][5:]))
                i += 1
        if i < len(rest):
            self.aux = "\t".join(rest[i:])
        self.fileno = fileno
        self.mate = None
        fl = self.flags
        self.paired_sequencing = bool(fl & 0x1)
        self.proper_pair = bool(fl & 0x2)
        self.mapped = not fl & 0x4
        self.mp_mapped = not fl & 0x8
        self.reverse = bool(fl & 0x10)
        self.mp_reverse = bool(fl & 0x20)
        self.first_in_pair = bool(fl & 0x40)
        self.second_in_pair = bool(fl & 0x80)
        self.primary_alignment = bool(fl & 0x100)
        self.platform_quality_fail = bool(fl & 0x200)
        self.pcr_duplicate = bool(fl & 0x400)

    def get_flag(self) -> int:
        return ((0x1 if self.paired_sequencing else 0)
                | (0x2 if self.proper_pair else 0)
                | (0 if self.mapped else 0x4)
                | (0 if self.mp_mapped else 0x8)
                | (0x10 if self.reverse else 0)
                | (0x20 if self.mp_reverse else 0)
                | (0x40 if self.first_in_pair else 0)
                | (0x80 if self.second_in_pair else 0)
                | (0x100 if self.primary_alignment else 0)
                | (0x200 if self.platform_quality_fail else 0)
                | (0x400 if self.pcr_duplicate else 0))

    def render_unaligned(self) -> str:
        """render_sam_unaligned_string (render.c:27-57); raw flags |4|8."""
        parts = [self.qname, str(self.flags | 0x4 | 0x8), "*", "0", "0", "*",
                 "*", "0", "0", self.seq, self.qual]
        out = "\t".join(parts)
        if self.aux is not None:
            out += "\t" + self.aux
        return out

    def render(self) -> str:
        """render_sam_string (render.c:227-295)."""
        if not self.mapped:
            return self.render_unaligned()
        self.flags = self.get_flag()
        parts = [self.qname, str(self.flags), self.rname, str(self.pos),
                 str(self.mapq if self.mapq >= 4 else 0), self.cigar,
                 "=" if self.rname == self.rnext else self.rnext,
                 str(self.pnext), str(self.isize), self.seq, self.qual]
        out = "\t".join(parts)
        if self.has_score:
            out += f"\tAS:i:{self.score}"
        for i in range(7):
            if self.has_zs & (1 << i):
                out += f"\tZ{i}:i:{tnlog(self.z[i])}"
        if self.aux is not None:
            out += "\t" + self.aux
        return out


class BoundedHeap:
    """The reference min-heap (mergesam_heap.c); output order is the raw
    ARRAY order, so percolation details are replicated exactly."""

    def __init__(self, capacity: int):
        self.a: list = [None] * capacity
        self.capacity = capacity
        self.load = 0

    @staticmethod
    def _less(x, y) -> bool:
        return x[0] < y[0]

    def _up(self, node):
        a = self.a
        parent = node // 2
        while node > 1 and self._less(a[node - 1], a[parent - 1]):
            a[parent - 1], a[node - 1] = a[node - 1], a[parent - 1]
            node = parent
            parent = node // 2

    def _down(self, node):
        a = self.a
        while True:
            left = node * 2
            right = left + 1
            m = node
            if left <= self.load and self._less(a[left - 1], a[m - 1]):
                m = left
            if right <= self.load and self._less(a[right - 1], a[m - 1]):
                m = right
            if m == node:
                break
            a[m - 1], a[node - 1] = a[node - 1], a[m - 1]
            node = m

    def insert(self, e):
        self.a[self.load] = e
        self.load += 1
        self._up(self.load)

    def insert_bounded(self, e):
        if self.load < self.capacity:
            if self.load == 0:
                self.a[0] = e
                self.load = 1
            else:
                self.insert(e)
        elif self._less(self.a[0], e):
            self.a[0] = e
            self._down(1)

    def insert_bounded_strata(self, e):
        if self.load == 0:
            self.a[0] = e
            self.load = 1
        elif self._less(e, self.a[0]):
            return
        elif self._less(self.a[0], e):
            self.load = 1
            self.a[0] = e
        elif self.load < self.capacity:
            self.a[self.load] = e
            self.load += 1

    def items(self):
        return [self.a[i] for i in range(self.load)]


class Options:
    def __init__(self):
        self.max_outputs = 10
        self.max_alignments = 0
        self.strata = False
        self.half_paired = True
        self.single_best = False
        self.sam_unaligned = False
        self.no_mapping_qualities = False
        self.leave_mapq = False
        self.all_contigs = False
        self.no_improper_mappings = False
        self.min_mapq = 0
        self.insert_size_mean = 200
        self.insert_size_stddev = 100
        self.paired = False
        self.unpaired = False
        self.number_of_sam_files = 0
        self.fastq = None
        self.un = None
        self.al = None
        self.sam_format = False
        self.sam_header = None


def consolidate_single(opts: Options, lists, map_class, heap, genome_length):
    """consolidate_single (sam_reader.c:299-385): one non-paired class."""
    heap.load = 0
    z1_summed = [False] * opts.number_of_sam_files
    z1_sum = 0.0
    max_pa = None
    for i in range(opts.number_of_sam_files):
        for pa in lists[i][map_class]:
            if not opts.no_mapping_qualities:
                if not z1_summed[pa.fileno]:
                    z1_sum += pa.z[1]
                    z1_summed[pa.fileno] = True
                if max_pa is None or max_pa.z[0] < pa.z[0]:
                    max_pa = pa
            if not opts.single_best:
                e = (pa.score, 0, pa)
                if opts.strata:
                    heap.insert_bounded_strata(e)
                else:
                    heap.insert_bounded(e)
    if not opts.no_mapping_qualities:
        if max_pa is None:
            return []
        if opts.single_best:
            heap.load = 1
            heap.a[0] = (0, 0, max_pa)
        for _, _, pa in heap.items():
            pa.z[1] = z1_sum
            if map_class != UNPAIRED:
                pa.z[4] = max_pa.z[4]
    load = heap.load
    if load > 0 and (opts.max_alignments == 0 or load <= opts.max_alignments):
        start = 1 if load > opts.max_outputs else 0
        return [heap.a[i][2] for i in range(start, load)]
    return []


def consolidate_paired(opts: Options, lists, heap):
    """consolidate_paired (sam_reader.c:117-296)."""
    heap.load = 0
    best_pair_for_file = [None] * opts.number_of_sam_files
    summed = [False] * opts.number_of_sam_files
    z3_sum = 0.0
    global_ins_denom = 0.0
    z4_min = 1.0
    for i in range(opts.number_of_sam_files):
        for pa in lists[i][PAIRED]:
            if not opts.no_mapping_qualities:
                mapq_score = pa.mapq + pa.mate.mapq
                fn = pa.fileno
                bp = best_pair_for_file[fn]
                if bp is None or bp.mapq + bp.mate.mapq < mapq_score:
                    if pa.mapq > pa.mate.mapq or \
                       (pa.mapq == pa.mate.mapq and pa.score > pa.mate.score):
                        best_pair_for_file[fn] = pa
                    else:
                        best_pair_for_file[fn] = pa.mate
            if not opts.single_best:
                e = (pa.mapq + pa.mate.mapq, pa.score + pa.mate.score, pa)
                if opts.strata:
                    heap.insert_bounded_strata(e)
                else:
                    heap.insert_bounded(e)
            if (pa.has_zs ^ 0b1011100) == 0:   # HAS_ZPAIRED = Z2,Z3,Z4,Z6
                if not summed[pa.fileno]:
                    z3_sum += pa.z[3]
                    summed[pa.fileno] = True
                    global_ins_denom += pa.z[6]
                z4_min = min(z4_min, pa.z[4])
    if opts.single_best:
        for pa in best_pair_for_file:
            if pa is not None:
                pa.z[3] = pa.mate.z[3] = z3_sum
                pa.z[4] = pa.mate.z[4] = z4_min
        best_index = -1
        best_z2 = 0.0
        for i, pa in enumerate(best_pair_for_file):
            if pa is not None:
                new_z2 = max(pa.z[2], pa.mate.z[2])
                if best_index == -1 or best_z2 < new_z2:
                    best_z2 = new_z2
                    best_index = i
        if best_index != -1:
            pa = best_pair_for_file[best_index]
            pa.z[6] = global_ins_denom
            pa.mate.z[6] = global_ins_denom
            heap.load = 0
            heap.insert_bounded((0, 0, pa))
    else:
        for _, _, pa in heap.items():
            if (pa.has_zs ^ 0b1011100) == 0:
                pa.z[3] = pa.mate.z[3] = z3_sum
                pa.z[4] = pa.mate.z[4] = z4_min
                pa.z[6] = pa.mate.z[6] = global_ins_denom
    load = heap.load
    if load > 0 and (opts.max_alignments == 0 or load <= opts.max_alignments):
        start = 1 if load > opts.max_outputs else 0
        return [heap.a[i][2] for i in range(start, load)]
    return []


def combine_and_check(opts: Options, lists, heap, genome_length,
                      out_lines: list):
    """pp_ll_combine_and_check (sam_reader.c:413-745)."""
    paired_list = first_leg = second_leg = unpaired_list = None
    unaligned_pa = None

    def track_unaligned(res):
        nonlocal unaligned_pa
        if (opts.sam_unaligned or opts.un) and res and unaligned_pa is None:
            unaligned_pa = res[0]

    if opts.paired:
        paired_list = consolidate_paired(opts, lists, heap)
        track_unaligned(paired_list)
        if opts.half_paired:
            first_leg = consolidate_single(opts, lists, FIRST_LEG, heap,
                                           genome_length)
            track_unaligned(first_leg)
            second_leg = consolidate_single(opts, lists, SECOND_LEG, heap,
                                            genome_length)
            track_unaligned(second_leg)
    elif opts.unpaired:
        unpaired_list = consolidate_single(opts, lists, UNPAIRED, heap,
                                           genome_length)
        track_unaligned(unpaired_list)

    first_empty = not first_leg
    second_empty = not second_leg
    paired_empty = not paired_list
    best_alignment = None

    if not opts.no_mapping_qualities:
        paired_scale = \
            (min(first_leg[0].z[4] * genome_length, 1.0)
             if not first_empty else 1.0) * \
            (min(second_leg[0].z[4] * genome_length, 1.0)
             if not second_empty else 1.0)
        first_scale = 0.0
        if not first_empty:
            first_scale = \
                (min(paired_list[0].z[4] * genome_length, 1.0)
                 if paired_list else 1.0) * \
                (min(second_leg[0].z[4] * genome_length, 1.0)
                 if not second_empty else 1.0) * first_leg[0].z[5]
        second_scale = 0.0
        if not second_empty:
            second_scale = \
                (min(paired_list[0].z[4] * genome_length, 1.0)
                 if paired_list else 1.0) * \
                (min(first_leg[0].z[4] * genome_length, 1.0)
                 if not first_empty else 1.0) * second_leg[0].z[5]
        class_denom = (paired_scale if not paired_empty else 0.0) + \
            (first_scale if not first_empty else 0.0) + \
            (second_scale if not second_empty else 0.0)
        if opts.unpaired or class_denom > 0:
            if not paired_empty:
                for pa in paired_list:
                    pa.mapq = qv_from_pr_corr(
                        (pa.z[2] * paired_scale) / (pa.z[3] * class_denom))
                    pa.mate.mapq = qv_from_pr_corr(
                        (pa.mate.z[2] * paired_scale)
                        / (pa.mate.z[3] * class_denom))
                    max_pa = pa if pa.mapq > pa.mate.mapq else pa.mate
                    if best_alignment is None or \
                       max_pa.mapq > best_alignment.mapq:
                        best_alignment = max_pa
            if not first_empty:
                for pa in first_leg:
                    pa.mapq = qv_from_pr_corr(
                        (pa.z[0] * first_scale) / (pa.z[1] * class_denom))
                    if best_alignment is None or \
                       pa.mapq > best_alignment.mapq:
                        best_alignment = pa
            if not second_empty:
                for pa in second_leg:
                    pa.mapq = qv_from_pr_corr(
                        (pa.z[0] * second_scale) / (pa.z[1] * class_denom))
                    if best_alignment is None or \
                       pa.mapq > best_alignment.mapq:
                        best_alignment = pa
            if unpaired_list:
                for pa in unpaired_list:
                    pa.mapq = qv_from_pr_corr(pa.z[0] / pa.z[1])
                    if best_alignment is None or \
                       pa.mapq > best_alignment.mapq:
                        best_alignment = pa

    m_ll: list = []
    if opts.all_contigs and opts.single_best and not opts.no_improper_mappings:
        if best_alignment is not None:
            ba = best_alignment
            if ba.paired_sequencing and not ba.mp_mapped and ba.mapq >= 10:
                check = second_leg if ba.first_in_pair else first_leg
                bp = None
                for pa in (check or []):
                    if bp is None or pa.mapq > bp.mapq:
                        bp = pa
                if bp is not None:
                    mapq = qv_from_pr_corr(bp.z[0] / bp.z[1])
                    if mapq >= 10:
                        ba.mate = bp
                        ba.mp_mapped = True
                        ba.mp_reverse = bp.reverse
                        ba.rnext = bp.rname
                        ba.pnext = bp.pos
                        bp.mate = ba
                        bp.mp_mapped = True
                        bp.mp_reverse = ba.reverse
                        bp.rnext = ba.rname
                        bp.pnext = ba.pos
                        _recompute_isize(ba, bp)
            m_ll.append(best_alignment)
    else:
        for lst in (paired_list, first_leg, second_leg, unpaired_list):
            if lst:
                m_ll.extend(lst)

    if m_ll and opts.all_contigs and opts.min_mapq > 0:
        kept = []
        for pa in m_ll:
            mapq = max(pa.mapq, pa.mate.mapq if pa.paired_sequencing else 0)
            if mapq >= opts.min_mapq:
                if pa.paired_sequencing:
                    if pa.mapq < opts.min_mapq:
                        pa.mapped = False
                    elif pa.mate.mapq < opts.min_mapq:
                        pa.mate.mapped = False
                kept.append(pa)
        m_ll = kept

    if opts.all_contigs:
        for pa in m_ll:
            pa.has_zs = 0
            if pa.mate is not None:
                pa.mate.has_zs = 0
    if opts.no_mapping_qualities and not opts.leave_mapq:
        for pa in m_ll:
            pa.mapq = 255
            if pa.mate is not None:
                pa.mate.mapq = 255

    if not m_ll and (opts.sam_unaligned or opts.un):
        if unaligned_pa is None:
            if not opts.half_paired:
                r = consolidate_single(opts, lists, FIRST_LEG, heap,
                                       genome_length)
                if r:
                    unaligned_pa = r[0]
                if unaligned_pa is None:
                    r = consolidate_single(opts, lists, SECOND_LEG, heap,
                                           genome_length)
                    if r:
                        unaligned_pa = r[0]
            if unaligned_pa is None:
                for i in range(opts.number_of_sam_files):
                    if lists[i][UNMAPPED]:
                        unaligned_pa = lists[i][UNMAPPED][0]
                        break
        if unaligned_pa is not None:
            ua = unaligned_pa
            if ua.paired_sequencing and ua.mate is not None:
                if ua.first_in_pair:
                    out_lines.append(ua.render_unaligned())
                    out_lines.append(ua.mate.render_unaligned())
                else:
                    out_lines.append(ua.mate.render_unaligned())
                    out_lines.append(ua.render_unaligned())
            else:
                out_lines.append(ua.render_unaligned())
        return

    # first-in-pair prints first (mergesam.c:758-776)
    for pa in m_ll:
        if pa.paired_sequencing and pa.mate is not None:
            if pa.first_in_pair:
                out_lines.append(pa.render())
                out_lines.append(pa.mate.render())
            else:
                out_lines.append(pa.mate.render())
                out_lines.append(pa.render())
        else:
            out_lines.append(pa.render())


def _recompute_isize(pa, mate):
    """calculate_insert_size for the improper-pairing path."""
    def span(p):
        # genome end from cigar (M/D/N consume reference)
        n = 0
        num = 0
        for c in p.cigar:
            if c.isdigit():
                num = num * 10 + int(c)
            else:
                if c in "MDN=X":
                    n += num
                num = 0
        return n

    if pa.rname != mate.rname:
        pa.isize = 0
        mate.isize = 0
        return
    end_a = pa.pos + span(pa) - 1
    end_b = mate.pos + span(mate) - 1
    fivep_a = end_a if pa.reverse else pa.pos - 1
    fivep_b = end_b if mate.reverse else mate.pos - 1
    pa.isize = fivep_b - fivep_a
    mate.isize = -pa.isize if pa.isize != 0 else 0


def _header_sort_key_pairwise(lines):
    """qsort with sam_header_sort (sam_reader.c:827-861): rank by record
    type; strcmp within a type; stable for unknown types."""
    def rank(s):
        for i, t in enumerate(("@HD", "@SQ", "@RG", "@PG", "@CO")):
            if s.startswith(t):
                return i
        return 5

    return sorted(lines, key=lambda s: (rank(s), s if rank(s) < 5 else ""))


def read_names(path):
    """Stream read names from FASTA/FASTQ (fastx_readnames.c)."""
    from shrimp_tpu_torch.io import fastx
    for rec in fastx.iter_reads(path):
        yield rec.name


def merge(reads_file: str, sam_files: list[str], opts: Options,
          out=None, command_line: str = "") -> None:
    if out is None:
        out = sys.stdout          # resolved at call time, not import time
    names = list(read_names(reads_file))

    # parse all files: headers + records bound to read slots
    all_headers: list[str] = []
    genome_length = 0
    per_file_slots: list[dict[int, list[Pretty]]] = []
    pg_id = 0
    for fileno, sf in enumerate(sam_files):
        slots: dict[int, list[Pretty]] = {}
        ptr = 0
        prev: Pretty | None = None
        with open(sf) as fh:
            for line in fh:
                line = line.rstrip("\n")
                if not line:
                    continue
                if line.startswith("@"):
                    if line.startswith("@PG\tID:"):
                        line = f"@PG\tID:{pg_id}-" + line[len("@PG\tID:"):]
                        pg_id += 1
                    all_headers.append(line)
                    continue
                pa = Pretty(line, fileno)
                qn = pa.qname
                while ptr < len(names) and not names[ptr].startswith(qn):
                    ptr += 1
                    prev = None
                if ptr >= len(names):
                    break
                if pa.paired_sequencing:
                    opts.paired = True
                    if prev is not None and prev.mate is None:
                        prev.mate = pa
                        pa.mate = prev
                        _bind(slots, ptr, pa, opts)
                        prev = pa
                    else:
                        prev = pa
                else:
                    opts.unpaired = True
                    _bind(slots, ptr, pa, opts)
                    prev = pa
        per_file_slots.append(slots)

    opts.number_of_sam_files = len(sam_files)

    # header emission (process_sam_headers, mergesam.c:84-146)
    for line in all_headers:
        if line.startswith("@SQ"):
            for fld in line.split("\t"):
                if fld.startswith("LN:"):
                    genome_length += int(fld[3:])
    if all_headers:
        if opts.sam_header is not None:
            with open(opts.sam_header) as fh:
                out.write(fh.read())
        else:
            slines = _header_sort_key_pairwise(all_headers)
            own_pg = (f"@PG\tID:mergesam\tVN:{VERSION}\tCL:{command_line} ")
            out.write(slines[0] + "\n")
            printed_self = False
            for i in range(1, len(slines)):
                if not printed_self and slines[i].startswith("@PG"):
                    out.write(own_pg + "\n")
                    printed_self = True
                if slines[i] != slines[i - 1]:
                    out.write(slines[i] + "\n")
            if not printed_self:
                out.write(own_pg + "\n")

    cutoff = opts.max_outputs if opts.max_alignments == 0 else \
        min(opts.max_alignments, opts.max_outputs)
    heap = BoundedHeap(cutoff + (0 if opts.single_best else 1))

    out_lines: list[str] = []
    empty = {c: [] for c in (PAIRED, UNPAIRED, FIRST_LEG, SECOND_LEG,
                             UNMAPPED)}
    for slot in range(len(names)):
        lists = []
        any_rec = False
        for slots in per_file_slots:
            by_class = slots.get(slot)
            if by_class is None:
                lists.append(empty)
            else:
                any_rec = True
                lists.append(by_class)
        if not any_rec:
            continue
        combine_and_check(opts, lists, heap, genome_length, out_lines)
    for line in out_lines:
        out.write(line + "\n")


def _bind(slots, ptr, pa: Pretty, opts: Options) -> None:
    """pp_ll_append_and_check (sam_reader.c:720-758)."""
    by_class = slots.setdefault(ptr, {c: [] for c in
                                      (PAIRED, UNPAIRED, FIRST_LEG,
                                       SECOND_LEG, UNMAPPED)})
    if pa.paired_sequencing:
        if pa.proper_pair:
            by_class[PAIRED].append(pa if pa.first_in_pair else pa.mate)
        elif (opts.half_paired or opts.sam_unaligned or opts.un) and \
                (pa.mapped or pa.mp_mapped):
            if pa.mapped:
                by_class[FIRST_LEG if pa.first_in_pair
                         else SECOND_LEG].append(pa)
            else:
                by_class[SECOND_LEG if pa.first_in_pair
                         else FIRST_LEG].append(pa.mate)
        elif (opts.sam_unaligned or opts.un) and not pa.mapped and \
                not pa.mp_mapped:
            by_class[UNMAPPED].append(pa)
    else:
        if pa.mapped:
            by_class[UNPAIRED].append(pa)
        elif opts.sam_unaligned or opts.un:
            by_class[UNMAPPED].append(pa)


def main(argv=None) -> int:
    import getopt
    argv = list(sys.argv if argv is None else argv)
    opts = Options()
    long_opts = ["buffer-size=", "read-size=", "stack-size=", "read-rate=",
                 "un=", "al=", "sam-unaligned", "report=", "threads=", "sam",
                 "fastq", "strata", "max-alignments=", "no-half-paired",
                 "insert-size-dist=", "single-best-mapping", "min-mapq=",
                 "all-contigs", "half-paired", "no-mapping-qualities",
                 "leave-mapq", "sam-header=", "no-improper-mappings",
                 "no-autodetect-input", "help",
                 "alignments-stack-size="]
    try:
        parsed, positional = getopt.gnu_getopt(argv[1:], "s:o:N:EQ?",
                                               long_opts)
    except getopt.GetoptError as exc:
        sys.stderr.write(f"error: {exc}\n")
        return 1
    for o, a in parsed:
        if o in ("-o", "--report"):
            opts.max_outputs = int(a)
        elif o in ("-E", "--sam"):
            opts.sam_format = True
        elif o in ("-Q", "--fastq"):
            opts.fastq = True
        elif o == "--strata":
            opts.strata = True
        elif o == "--max-alignments":
            opts.max_alignments = int(a)
        elif o == "--no-half-paired":
            opts.half_paired = False
        elif o == "--half-paired":
            opts.half_paired = True
        elif o == "--sam-unaligned":
            opts.sam_unaligned = True
        elif o == "--single-best-mapping":
            opts.single_best = True
        elif o == "--min-mapq":
            opts.min_mapq = int(a)
        elif o == "--all-contigs":
            opts.all_contigs = True
        elif o == "--no-mapping-qualities":
            opts.no_mapping_qualities = True
        elif o == "--leave-mapq":
            opts.leave_mapq = True
        elif o == "--sam-header":
            opts.sam_header = a
        elif o == "--no-improper-mappings":
            opts.no_improper_mappings = True
        elif o == "--un":
            opts.un = a
        elif o == "--al":
            opts.al = a
        elif o in ("-?", "--help"):
            sys.stderr.write("usage: mergesam [options] <reads> <s1> ...\n")
            return 0
    if len(positional) < 2:
        sys.stderr.write("usage: mergesam [options] <reads> <s1> <s2> ...\n")
        return 1
    if not opts.sam_format and not (opts.un or opts.al):
        sys.stderr.write("mergesam currently only outputs SAM (-E) or "
                         "FAST(A/Q) (--un/--al)\n")
        return 1
    if opts.single_best:
        opts.max_outputs = 1
    merge(positional[0], positional[1:], opts,
          command_line=" ".join(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
