"""gmapper-compatible command line for the PyTorch / CUDA port.

The counterpart of `shrimp_tpu.gmapper.main` (`gmapper/gmapper.c:main`),
letter space and colour space (`--mode cs`, or the program name
`gmapper-cs`), gapped or gapless (`-U`, `-M mirna`), unpaired or paired
(`-p`, `-1`/`-2`, `--paired-options`, the half-paired fallback):
option parsing for the scoring, crossover, threshold, seed, window,
strand, pairing, output and read-intake flags, the `--unpaired-options`
rounds, index save and load (`-S`/`-L` in this package's npz format or
the reference's `.genome`/`.seed.N` projection, `--index-format`;
`--save-mmap`/`--load-mmap` for raw arrays that mappers share through
the page cache), the settings banner, the SAM header or the legacy SHRiMP
format (`--shrimp-format`, `-R`, `-P` with its pretty blocks), read
intake with trimming and filtering, the pipelined `Mapper.map_stream` /
`PairedMapper.map_pair_stream` loops, and the closing statistics block
with the insert-size histogram (`-X`).  The option tables, usage text and
logging are the JAX package's own.

Mapping runs on the first CUDA device (the kernels).  It runs on the CPU
(their plain PyTorch versions) only when the caller passes `device="cpu"`
or the environment sets `SHRIMP_TPU_TORCH_DEVICE=cpu`; without a CUDA
device and without such a request it exits with rc 1.  With
`--genome-shards N` the genome is split into N contig groups, each mapped
by its own mapper on the devices `--devices` names (the first N cards,
all by default; shards share cards round-robin, and on the CPU all of
them run there) and merged exactly (`parallel/mesh.py`).

Usage:
    python -m shrimp_tpu_torch.gmapper [options] reads.fq genome.fa
    python -m shrimp_tpu_torch.gmapper --mode cs [options] reads.csfq genome.fa
    python -m shrimp_tpu_torch.gmapper -p opp-in -I 0,500 pairs.fq genome.fa
    python -m shrimp_tpu_torch.gmapper -S prefix genome.fa    (save an index)
    python -m shrimp_tpu_torch.gmapper -L prefix reads.fq     (map on it)
    python -m shrimp_tpu_torch.gmapper --genome-shards 4 reads.fq genome.fa
"""

from __future__ import annotations

import getopt
import os
import sys
import time

VERSION = "0.1.0"

_SHORT = "s:o:w:n:l:a:S:L:z:m:i:g:q:e:f:r:h:N:K:p:I:M:1:2:x:v:UCFPEQRTtXYZ?HDVB"

_LONG = [
    "un=", "al=", "upstream=", "downstream=", "sam-unaligned",
    "longest-read=", "seeds=", "report=", "match-window=", "cmw-mode=",
    "cmw-overlap=", "anchor-width=", "save=", "load=", "cutoff=", "match=",
    "mismatch=", "open-r=", "open-q=", "ext-r=", "ext-q=", "cmv-threshold=",
    "full-threshold=", "threads=", "thread-chunk=", "pair-mode=", "isize=",
    "ungapped", "negative", "positive", "pretty", "sam", "fastq",
    "print-reads", "rev-tiebreak", "tiebreak-off", "isize-histogram",
    "proj-histogram", "cachebypass-off", "help", "hash-spaced-kmers",
    "thread-stats", "trim-off", "strata", "max-alignments=", "global",
    "read-group=", "sam-header=", "no-half-paired", "sam-r2", "mode=",
    "trim-front=", "trim-end=", "trim-first", "trim-second",
    "insert-size-dist=", "use-regions", "region-overlap=",
    "paired-options=", "unpaired-options=", "min-avg-qv=",
    "extra-sam-fields", "region-bits=", "progress=", "save-mmap=",
    "load-mmap=", "indel-taboo-len=", "single-best-mapping", "all-contigs",
    "no-mapping-qualities", "shrimp-format", "half-paired",
    "no-improper-mappings", "qv-offset=", "sam-header-hd=", "sam-header-sq=",
    "sam-header-rg=", "sam-header-pg=", "no-autodetect-input", "local",
    "no-qv-check", "ignore-qvs", "enable-seed-qual-filter",
    "index-format=", "genome-shards=", "devices=",
    # colour-space extras
    "crossover=", "vec-threshold=", "bfast",
    # letter-space extras
    "trim-illumina",
]


def usage(prog: str, mode: str, full: bool = False,
          seed_strings: list[str] | None = None,
          state: dict | None = None) -> None:
    """Exact usage text (usage, gmapper.c:1009-1246).

    Like the reference, option defaults reflect the *current* parsed
    state where the reference prints live globals (strand flags, output
    format toggles), and compile-time DEF_* constants elsewhere.
    """
    st = {
        "pair_mode": 0, "gapless": False, "global": True,
        "trim_illumina": False, "bfast": False, "Cflag": False,
        "Fflag": False, "Pflag": False, "Eflag": True, "Qflag": True,
        "Rflag": False, "Tflag": True, "Xflag": False, "Yflag": False,
        "hash_filter_calls": True, "Hflag": False, "Dflag": False,
        "Vflag": True, "sam_unaligned": False, "half_paired": True,
        "progress": 100000,
    }
    if state:
        st.update(state)
    cs = mode == "cs"
    if seed_strings is None:
        seed_strings = ["11110111101111", "1111011100100001111",
                        "1111000011001101111"]
    e = sys.stderr.write
    onoff = lambda v: "enabled" if v else "disabled"
    name = f"gmapper-{mode}"
    e(f"usage: {name} [options/parameters] "
      "{ <r> | -1 <r1> -2 <r2> } <g1> <g2>...\n")
    e("   <r>                  Reads filename, paired or unpaired\n")
    e("   <r1>                 Upstream reads filename\n")
    e("   <r2>                 Downstream reads filename\n")
    e("   <g1> <g2>...         Space seperated list of genome filenames\n")
    e("Parameters:\n")
    e("   -s/--seeds           Spaced Seed(s)                (default: ")
    for sn, s in enumerate(seed_strings):
        if sn > 0:
            e(" " * 55)
        e(f"{s}{')' if sn == len(seed_strings) - 1 else ','}\n")
    e("   -o/--report          Maximum Hits per Read         "
      "(default: 10)\n")
    e("      --max-alignments  Max. align. per read  (0=all) "
      "(default: 0)\n")
    e("   -w/--match-window    Match Window Length           "
      "(default: 140.00%)\n")
    e("   -n/--cmw-mode        Match Mode                    "
      "(default: unpaired:2 paired:4)\n")
    if full:
        e("   -l/--cmw-overlap     Match Window Overlap Length   "
          "(default: 90.00%)\n")
        e("   -a/--anchor-width    Anchor Width Limiting Full SW "
          "(default: 8; disable: -1)\n")
        e("\n")
        e("   -S/--save            Save Genome Proj. in File     "
          "(default: no)\n")
        e("   -L/--load            Load Genome Proj. from File   "
          "(default: no)\n")
        e("   -z/--cutoff          Projection List Cut-off Len.  "
          "(default: 4294967295)\n")
    e("\n")
    e(f"   -m/--match           SW Match Score                "
      f"(default: 10)\n")
    e(f"   -i/--mismatch        SW Mismatch Score             "
      f"(default: {-24 if cs else -15})\n")
    e("   -g/--open-r          SW Gap Open Score (Reference) "
      "(default: -33)\n")
    e("   -q/--open-q          SW Gap Open Score (Query)     "
      "(default: -33)\n")
    e("   -e/--ext-r           SW Gap Extend Score(Reference)"
      "(default: -7)\n")
    e("   -f/--ext-q           SW Gap Extend Score (Query)   "
      "(default: -3)\n")
    if cs:
        e("   -x/--crossover       SW Crossover Score            "
          "(default: -20)\n")
    e("   -r/--cmw-threshold   Window Generation Threshold   "
      "(default: 55.00%)\n")
    if cs:
        e("   -v/--vec-threshold   SW Vector Hit Threshold       "
          "(default: 47.00%)\n")
    e("   -h/--full-threshold  SW Full Hit Threshold         "
      "(default: 50.00%)\n")
    e("\n")
    e("   -N/--threads         Number of Threads             "
      "(default: 1)\n")
    if full:
        e("   -K/--thread-chunk    Thread Chunk Size             "
          "(default: 1000)\n")
    e("\n")
    pair_names = ["none", "opposing strands; inwards",
                  "opposing strands; outwards",
                  "same strand; second is forward",
                  "same strand; second is backward"]
    e(f"   -p/--pair-mode       Paired Mode                   "
      f"(default: {pair_names[st['pair_mode']]})\n")
    e("   -I/--isize           Min and Max Insert Size       "
      "(default: 0,1000)\n")
    e("      --longest-read    Maximum read length           "
      "(default: 1000)\n")
    e("   -1/--upstream        Upstream read pair file\n")
    e("   -2/--downstream      Downstream read pair file\n")
    e("      --un              Dump unaligned reads to file\n")
    e("      --al              Dump aligned reads to file\n")
    e("      --read-group      Attach SAM Read Group name\n")
    e("      --sam-header      Use file as SAM header\n")
    e("      --single-best-mapping Report only the best mapping(s), "
      "this is not strata (see README)\n")
    e("      --all-contigs     Report a maximum of 1 mapping for "
      "each read.\n")
    e("      --no-mapping-qualities Do not compute mapping qualities\n")
    e("      --insert-size-dist Specifies the mean and stddev of the "
      "insert sizes\n")
    e("      --no-improper-mappings (see README)\n")
    if full:
        e("      --trim-front      Trim front of reads by this amount\n")
        e("      --trim-end        Trim end of reads by this amount\n")
        e("      --trim-first      Trim only first read in pair\n")
        e("      --trim-second     Trim only second read in pair\n")
        e("      --min-avg-qv      The minimum average quality value "
          "of a read\n")
        e(f"      --progress        Display a progress line each "
          f"<value> reads. (default {st['progress']})\n")
        e("      --save-mmap       Save genome projection to shared "
          "memory\n")
        e("      --load-mmap       Load genome projection from shared "
          "memory\n")
        e("      --indel-taboo-len Prevent indels from starting or "
          "ending in the tail\n")
        e(f"      --shrimp-format   Output mappings in SHRiMP format "
          f"(default: {'disabled' if st['Eflag'] else 'enabled'})\n")
        e("      --qv-offset       (see README)\n")
        e("      --sam-header-hd   (see README)\n")
        e("      --sam-header-sq   (see README)\n")
        e("      --sam-header-rg   (see README)\n")
        e("      --sam-header-pg   (see README)\n")
        e("      --no-autodetect-input (see README)\n")
    e("\n")
    e("Options:\n")
    e(f"   -U/--ungapped        Perform Ungapped Alignment    "
      f"(default: {onoff(st['gapless'])})\n")
    e(f"      --global          Perform full global alignment "
      f"(default: {onoff(st['global'])})\n")
    e(f"      --local           Perform local alignment       "
      f"(default: {onoff(not st['global'])})\n")
    if cs:
        e(f"      --bfast           Try to align like bfast       "
          f"(default: {onoff(st['bfast'])})\n")
    else:
        e(f"      --trim-illumina   Trim trailing B qual values   "
          f"(default: {onoff(st['trim_illumina'])})\n")
    e(f"   -C/--negative        Negative Strand Aln. Only     "
      f"(default: {onoff(st['Cflag'])})\n")
    e(f"   -F/--positive        Positive Strand Aln. Only     "
      f"(default: {onoff(st['Fflag'])})\n")
    e(f"   -P/--pretty          Pretty Print Alignments       "
      f"(default: {onoff(st['Pflag'])})\n")
    e(f"   -E/--sam             Output SAM Format             "
      f"(default: {onoff(st['Eflag'])})\n")
    e(f"   -Q/--fastq           Reads are in fastq format     "
      f"(default: {onoff(st['Qflag'])})\n")
    if full:
        e(f"   -R/--print-reads     Print Reads in Output         "
          f"(default: {onoff(st['Rflag'])})\n")
        e("   -t/--tiebreak-off    Disable Reverse Tie-break\n")
        e(f"                                  on Negative Strand  "
          f"(default: {onoff(st['Tflag'])})\n")
        e(f"   -X/--isize-hist      Print Insert Size Histogram   "
          f"(default: {onoff(st['Xflag'])})\n")
        e(f"   -Y/--proj-hist       Print Genome Proj. Histogram  "
          f"(default: {onoff(st['Yflag'])})\n")
        e("   -Z/--bypass-off      Disable Cache Bypass for SW\n")
        e(f"                                    Vector Calls      "
          f"(default: {onoff(st['hash_filter_calls'])})\n")
        e("   -H/--spaced-kmers    Hash Spaced Kmers in Genome\n")
        e(f"                                    Projection        "
          f"(default: {onoff(st['Hflag'])})\n")
        e(f"   -D/--thread-stats    Individual Thread Statistics  "
          f"(default: {onoff(st['Dflag'])})\n")
        e("   -V/--trim-off        Disable Automatic Genome\n")
        e(f"                                 Index Trimming       "
          f"(default: {onoff(st['Vflag'])})\n")
    e(f"      --sam-unaligned   Unaligned reads in SAM output "
      f"(default: {onoff(st['sam_unaligned'])})\n")
    e(f"      --half-paired     Output half mapped read pairs "
      f"(default: {onoff(st['half_paired'])})\n")
    e("      --strata          Print only the best scoring hits\n")
    e("   -?/--help            Full List of Parameters and Options\n")


def log(msg: str) -> None:
    sys.stderr.write(msg + "\n")


def main(argv: list[str] | None = None,
         device: str | None = None) -> int:
    """Run the CLI on `argv` (program name first); map on `device`, by
    default $SHRIMP_TPU_TORCH_DEVICE or else "cuda"."""
    argv = list(sys.argv if argv is None else argv)
    prog = os.path.basename(argv[0]) if argv else "gmapper"
    args = argv[1:]
    try:
        opts, positional = getopt.gnu_getopt(args, _SHORT, _LONG)
    except getopt.GetoptError as exc:
        log(f"error: {exc}")
        return 1

    mode = "cs" if prog.endswith("-cs") else "ls"
    for o, a in opts:
        if o == "--mode" and a in ("ls", "cs"):
            mode = a
    import torch

    from shrimp_tpu_torch import index as gindex
    from shrimp_tpu_torch import seeds as seedmod
    from shrimp_tpu_torch.io import fastx
    from shrimp_tpu_torch.io import legacy as legacy_mod
    from shrimp_tpu_torch.io import refindex
    from shrimp_tpu_torch.ops.params import ScoreProbs, SWParams
    from shrimp_tpu_torch.pipeline import candidates_batch as cb
    from shrimp_tpu_torch.pipeline.options import (
        MapperConfig, ReadMappingOptions, parse_read_mapping_options,
        parse_readpair_mapping_options)
    from shrimp_tpu_torch.utils import telemetry
    from shrimp_tpu_torch.pipeline.mapper import Mapper
    from shrimp_tpu_torch.pipeline.paired import (PAIR_MODE_NAMES,
                                                  PairedConfig, PairedMapper)

    colour = mode == "cs"
    cfg = MapperConfig(colour_space=colour,
                       params=(SWParams.colour_space() if colour
                               else SWParams.letter_space()),
                       qual_delta=(33 if colour else 64))
    cfg.sam_unaligned = False

    seed_specs: list[str] | None = None
    seed_weight = 0
    use_hashing = False
    pair_mode = 0
    isize_min, isize_max = 0, 1000
    insert_size_mean, insert_size_stddev = 200.0, 100.0
    fastq = None
    threads = 1
    chunk = 1000
    batch_size = 2048
    up_file = down_file = None
    un_file = al_file = None
    progress = 100000
    thresholds = {"r": 55.0, "v": 47.0 if colour else 50.0, "h": 50.0}
    vec_threshold_set = False
    mirna = False
    x_isize_hist = False
    y_proj_hist = False
    d_stats = False
    trim_front = trim_end = 0
    trim_first = trim_second = True
    min_avg_qv = 10              # DEF min_avg_qv (gmapper.h:81)
    no_qv_check = False
    no_autodetect = False
    qv_offset_set = False
    read_group = None
    sam_header_file = None
    sam_header_sections = {}
    unpaired_option_sets = []
    paired_option_sets = []
    match_mode_set = False
    shrimp_format = False
    sam_r2 = False
    rflag = False
    pflag = False
    save_prefix = load_prefix = None
    save_mmap_prefix = load_mmap_prefix = None
    index_format = "npz"
    genome_shards = 1
    n_devices = 0
    trim_illumina = False
    no_hash_filter_calls = False
    auto_trim_off = False
    score_assignments: list[tuple[str, int]] = []
    user_score_flags: set[str] = set()

    def _usage_seeds():
        if seed_specs:
            return list(seed_specs)
        if seed_weight:
            return [s.pattern for s in seedmod.default_seeds(seed_weight)]
        return None

    def _usage_state():
        return {
            "pair_mode": pair_mode, "gapless": cfg.gapless,
            "global": cfg.global_alignment,
            "trim_illumina": trim_illumina, "bfast": cfg.bfast,
            "Cflag": cfg.strand_mask == 2, "Fflag": cfg.strand_mask == 1,
            "Pflag": pflag, "Eflag": not shrimp_format, "Qflag": True,
            "Rflag": rflag,
            "Tflag": cfg.rev_tiebreak, "Xflag": x_isize_hist,
            "Yflag": y_proj_hist,
            "hash_filter_calls": not no_hash_filter_calls,
            "Hflag": use_hashing, "Dflag": d_stats,
            "Vflag": not auto_trim_off, "sam_unaligned": cfg.sam_unaligned,
            "half_paired": cfg.half_paired, "progress": progress,
        }

    for o, a in opts:
        if o in ("-s", "--seeds"):
            if a.startswith("w"):
                seed_weight = int(a[1:])
            else:
                seed_specs = (seed_specs or []) + a.split(",")
        elif o in ("-o", "--report"):
            cfg.num_outputs = int(a)
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
        elif o in ("-S", "--save"):
            save_prefix = a
        elif o in ("-L", "--load"):
            load_prefix = a
        elif o == "--save-mmap":
            save_mmap_prefix = a
        elif o == "--load-mmap":
            load_mmap_prefix = a
        elif o in ("-z", "--cutoff"):
            cfg.list_cutoff = int(a)
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
                # CS-only option table (DEF_COLOUR_SPACE_OPTIONS,
                # gmapper-defaults.h:161-167): gmapper-ls rejects it
                log("error: -x/--crossover is a colour-space option")
                return 1
            score_assignments.append(("crossover", int(a)))
        elif o in ("-r", "--cmv-threshold", "-v", "--vec-threshold",
                   "-h", "--full-threshold"):
            try:
                val = (float(a[:-1]) if a.endswith("%") else -float(a))
            except ValueError:
                log(f"error: invalid threshold [{a}]")
                return 1
            key = ("r" if o in ("-r", "--cmv-threshold")
                   else "v" if o in ("-v", "--vec-threshold") else "h")
            if key == "v" and not colour:
                # CS-only option table (DEF_COLOUR_SPACE_OPTIONS)
                log("error: -v/--vec-threshold is a colour-space option")
                return 1
            thresholds[key] = val
            if key == "v":
                vec_threshold_set = True
        elif o in ("-N", "--threads"):
            threads = int(a)
        elif o in ("-K", "--thread-chunk"):
            chunk = int(a)
            batch_size = max(batch_size, chunk)
        elif o in ("-p", "--pair-mode"):
            if a not in PAIR_MODE_NAMES:
                log(f"error: unknown pair mode {a!r}")
                return 1
            pair_mode = PAIR_MODE_NAMES.index(a)
        elif o in ("-I", "--isize"):
            lo, hi = a.split(",")
            isize_min, isize_max = int(lo), int(hi)
        elif o == "--insert-size-dist":
            mu, sd = a.split(",")
            insert_size_mean, insert_size_stddev = float(mu), float(sd)
        elif o in ("-C", "--negative"):
            if cfg.strand_mask == 1:   # -F already given (gmapper.c:1977)
                log("error: -C and -F are mutually exclusive")
                return 1
            cfg.strand_mask = 2
        elif o in ("-F", "--positive"):
            if cfg.strand_mask == 2:   # -C already given (gmapper.c:1985)
                log("error: -C and -F are mutually exclusive")
                return 1
            cfg.strand_mask = 1
        elif o in ("-U", "--ungapped"):
            # -U also kills gap opens, anchors, and the SW cache display
            # flag (gmapper.c:2055-2060)
            cfg.gapless = True
            cfg.anchor_width = 0
            score_assignments.append(("a_gap_open", -255))
            score_assignments.append(("b_gap_open", -255))
            no_hash_filter_calls = True
        elif o in ("-E", "--sam"):
            shrimp_format = False
        elif o == "--shrimp-format":
            shrimp_format = True
        elif o in ("-R", "--print-reads"):
            rflag = True
        elif o in ("-P", "--pretty"):
            pflag = True
            shrimp_format = True   # -P implies legacy output (Eflag=false,
            #                        gmapper.c:1995-1997)
        elif o in ("-B", "--bfast"):
            if not colour:
                log("error: --bfast is a colour-space option")
                return 1
            cfg.bfast = True
        elif o == "--trim-illumina":
            if colour:
                # LS-only option table (DEF_LETTER_SPACE_OPTIONS)
                log("error: --trim-illumina is a letter-space option")
                return 1
            trim_illumina = True
        elif o == "--unpaired-options":
            nip, _, rest = a.partition(";")
            if nip not in ("0", "1"):
                log(f"error: invalid unpaired mapping options: [{a}]")
                return 1
            if paired_option_sets:
                cfg.half_paired = True    # gmapper.c:2207
            unpaired_option_sets.append(
                parse_read_mapping_options(rest, is_paired=False))
        elif o == "--paired-options":
            # gmapper.c:2181-2199 (case 28); pair_mode comes from set 0
            if unpaired_option_sets:
                log("warning: unpaired mapping options set before paired "
                    "mapping options! the latter take precedence.")
                cfg.half_paired = True
            try:
                paired_option_sets.append(parse_readpair_mapping_options(a))
            except (ValueError, IndexError):
                log(f"error: invalid paired mapping options:[{a}]")
                return 1
            pair_mode = paired_option_sets[0].pairing.pair_mode
        elif o == "-M":
            # set_mode_from_string accepts only "mirna"; anything else —
            # including ls/cs — is rejected (gmapper.c:1495-1516,2119-2129)
            for tok in a.split(","):
                if tok != "mirna":
                    log(f"error: unrecognized mode ({tok})")
                    return 1
                mirna = True
                # full set_mode_from_string flag bundle (gmapper.c:1497-1511)
                use_hashing = True
                cfg.gapless = True
                cfg.anchor_width = 0
                score_assignments.append(("a_gap_open", -255))
                score_assignments.append(("b_gap_open", -255))
                cfg.match_mode_unpaired = 1
                match_mode_set = True
                cfg.window_len = 100.0
                cfg.global_alignment = False
                cfg.compute_mapping_qualities = False
                no_hash_filter_calls = True
        elif o == "--indel-taboo-len":
            cfg.indel_taboo_len = int(a)
        elif o in ("-Q", "--fastq"):
            fastq = True
        elif o in ("-T", "--rev-tiebreak"):
            cfg.rev_tiebreak = True
        elif o in ("-t", "--tiebreak-off"):
            cfg.rev_tiebreak = False
        elif o in ("-X", "--isize-histogram"):
            x_isize_hist = True
        elif o in ("-Y", "--proj-histogram"):
            y_proj_hist = True
        elif o in ("-Z", "--cachebypass-off"):
            no_hash_filter_calls = True   # display-parity; no SW cache here
        elif o in ("-H", "--hash-spaced-kmers"):
            use_hashing = True
        elif o in ("-D", "--thread-stats"):
            d_stats = True
        elif o in ("-V", "--trim-off"):
            cfg.list_cutoff = 0xFFFFFFFF
            auto_trim_off = True
        elif o in ("-1", "--upstream"):
            up_file = a
        elif o in ("-2", "--downstream"):
            down_file = a
        elif o == "--un":
            un_file = a
        elif o == "--al":
            al_file = a
        elif o == "--sam-unaligned":
            cfg.sam_unaligned = True
        elif o == "--longest-read":
            cfg.longest_read_len = int(a)
        elif o == "--strata":
            cfg.strata = True
        elif o == "--max-alignments":
            cfg.max_alignments = int(a)
        elif o == "--global":
            cfg.global_alignment = True
        elif o == "--local":
            cfg.global_alignment = False
        elif o == "--half-paired":
            cfg.half_paired = True
        elif o == "--no-half-paired":
            cfg.half_paired = False
        elif o == "--no-improper-mappings":
            pass      # accepted and without effect, as in the JAX package
        elif o == "--no-mapping-qualities":
            cfg.compute_mapping_qualities = False
        elif o == "--single-best-mapping":
            cfg.single_best_mapping = True
        elif o == "--all-contigs":
            cfg.all_contigs = True
        elif o == "--extra-sam-fields":
            cfg.extra_sam_fields = True
        elif o == "--qv-offset":
            cfg.qual_delta = int(a)
            qv_offset_set = True
        elif o == "--ignore-qvs":
            cfg.ignore_qvs = True
        elif o == "--enable-seed-qual-filter":
            cfg.seed_qual_filter = True
        elif o == "--no-qv-check":
            no_qv_check = True
        elif o == "--min-avg-qv":
            min_avg_qv = int(a)
            if min_avg_qv < -2 or min_avg_qv > 40:
                # reference prints the error but keeps going (gmapper.c:2219)
                log(f"error: invalid minimum average quality value ({a})")
        elif o == "--trim-front":
            trim_front = int(a)
            if colour:
                log("--trim-front cannot be used in colour space mode!")
                return 1
            if trim_front < 0:
                log("--trim-front value must be positive")
                return 1
        elif o == "--trim-end":
            trim_end = int(a)
            if trim_end < 0:
                log("--trim-end value must be positive")
                return 1
        elif o == "--trim-first":
            trim_first, trim_second = True, False
        elif o == "--trim-second":
            trim_second, trim_first = True, False
        elif o == "--use-regions":
            cfg.use_regions = True
        elif o == "--region-overlap":
            cb.REGION_OVERLAP = int(a)
        elif o == "--region-bits":
            cb.REGION_BITS = int(a)
        elif o == "--progress":
            progress = int(a)
        elif o == "--read-group":
            read_group = a.split(",")
        elif o == "--sam-header":
            sam_header_file = a
        elif o in ("--sam-header-hd", "--sam-header-sq",
                   "--sam-header-rg", "--sam-header-pg"):
            if not os.path.exists(a):
                log(f"error: could not open sam header file [{a}]")
                return 1
            sam_header_sections[o.rsplit("-", 1)[1]] = a
        elif o == "--sam-r2":
            sam_r2 = True
        elif o == "--genome-shards":
            genome_shards = int(a)
            if genome_shards < 1:
                log("error: --genome-shards must be >= 1")
                return 1
        elif o == "--devices":
            n_devices = int(a)
        elif o == "--index-format":
            if a not in ("npz", "ref", "both"):
                log(f"error: invalid index format {a!r} (npz|ref|both)")
                return 1
            index_format = a
        elif o == "--no-autodetect-input":
            no_autodetect = True
        elif o in ("-?", "--help"):
            # full usage, exit 1 like the reference (gmapper.c:2050,1246)
            usage(prog, mode, full=True, seed_strings=_usage_seeds(),
                  state=_usage_state())
            return 1

    if read_group:
        cfg.sam_read_group_name = read_group[0]
    cfg.sam_r2 = sam_r2

    # SAM vs legacy output flag conflicts (gmapper.c:2466-2474); like the
    # reference this is order-dependent: -P implies legacy, a later -E
    # re-enables SAM and collides
    if not shrimp_format and pflag:
        log("-E and -P are incompatable")
        return 1
    if not shrimp_format and rflag:
        log("-E and -R are incompatable")
        return 1
    if pair_mode != 0 and cfg.strand_mask != 3:
        log("warning: in paired mode, both strands must be inspected; "
            "ignoring -C and -F")          # gmapper.c:2446-2449
        cfg.strand_mask = 3

    score_updates: dict[str, int] = dict(score_assignments)
    # -g/-e set without -q/-f imply symmetric query-gap penalties
    # (gmapper.c:1730-1744,2538-2552)
    if "a_gap_open" in user_score_flags and \
            "b_gap_open" not in user_score_flags:
        log("Notice: Gap open penalty set for reference but not query; "
            "assuming symmetry.")
        score_updates["b_gap_open"] = score_updates["a_gap_open"]
    if "a_gap_extend" in user_score_flags and \
            "b_gap_extend" not in user_score_flags:
        log("Notice: Gap extend penalty set for reference but not query; "
            "assuming symmetry.")
        score_updates["b_gap_extend"] = score_updates["a_gap_extend"]
    if score_updates:
        cfg.params = cfg.params.with_(**score_updates)
    cfg.window_gen_threshold = thresholds["r"]
    if vec_threshold_set:
        cfg.sw_vect_threshold = thresholds["v"]
    cfg.sw_full_threshold = thresholds["h"]

    # cross-option validation (gmapper.c:2322-2500)
    if not cfg.global_alignment and cfg.compute_mapping_qualities:
        log("note: mapping qualities are not available in local alignment "
            "mode; disabling them")
        cfg.compute_mapping_qualities = False
    if cfg.global_alignment and cfg.gapless:
        log("error: cannot use global (or bfast) and ungapped mode at the "
            "same time!")
        return 1
    if cfg.sam_unaligned and shrimp_format:
        log("error: when using flag --sam-unaligned must also use -E/--sam")
        return 1
    if cfg.window_len >= 0 and cfg.window_len < 100.0:
        log("error: window length < 100% of read length")
        return 1
    if cfg.window_overlap >= 0 and cfg.window_overlap > 100.0:
        log("warning: window overlap length > 100% of window_length; "
            "resetting to 100%")
        cfg.window_overlap = 100.0
    if not match_mode_set:
        # DEF_MATCH_MODE_{UNPAIRED,PAIRED} (gmapper.c:2349-2351)
        cfg.match_mode_unpaired = 2 if pair_mode == 0 else 4
    mm = cfg.match_mode_unpaired
    if (pair_mode == 0 and not 1 <= mm <= 2) or \
            (pair_mode != 0 and not 2 <= mm <= 4):
        log(f"error: invalid match mode [pair_mode={pair_mode};"
            f"match_mode={mm}]")
        return 1
    if mirna and seed_specs is None and not seed_weight \
            and load_prefix is None and load_mmap_prefix is None:
        # default mirna seed set only when none given and no index is
        # loaded (gmapper.c:2375-2379)
        seed_specs = seedmod.MIRNA_SEEDS

    device = torch.device(device or os.environ.get("SHRIMP_TPU_TORCH_DEVICE")
                          or "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        log("error: no CUDA device; map on the CPU with "
            "SHRIMP_TPU_TORCH_DEVICE=cpu")
        return 1
    log("--------------------------------------------------"
        "------------------------------")
    log(f"shrimp-tpu: [{'COLOUR' if colour else 'LETTER'} SPACE] gmapper "
        f"v{VERSION} (SHRiMP2-compatible), PyTorch port on {device.type}")
    log("--------------------------------------------------"
        "------------------------------")

    # ----- insert-size histogram setup (gmapper.c:2357-2368) -----
    insert_histogram = None
    insert_bucket_size = 1
    if x_isize_hist and pair_mode == 0:
        log("warning: insert histogram not available in unpaired mode; "
            "ignoring")
        x_isize_hist = False
    if pair_mode != 0:
        insert_bucket_size = telemetry.ceil_div(
            isize_max - isize_min + 1, 100)
        insert_histogram = [1] * 100          # +1 prior per bucket

    def _print_paired_set_default(out):
        # default paired construction (gmapper.c:2634-2716)
        class _P:
            pair_mode_name = PAIR_MODE_NAMES[pair_mode]
            min_insert_size = isize_min
            max_insert_size = isize_max
            pass1_num_outputs = 3 * cfg.num_outputs
            pass2_num_outputs = cfg.num_outputs
            pass1_threshold = cfg.vect_threshold()
            pass2_threshold = cfg.sw_full_threshold
            strata = cfg.strata
            save_outputs = cfg.compute_mapping_qualities
            stop_count = 1 if cfg.half_paired else 0
            stop_threshold = 101.0 if cfg.half_paired else 50.0
        telemetry.print_pairing_options(out, _P)
        mm2 = cfg.match_mode_unpaired
        ro = ReadMappingOptions()
        ro.regions.recompute = cfg.use_regions and mm2 != 2
        ro.anchor_list.use_region_counts = cfg.use_regions and mm2 != 2
        if cfg.use_regions:
            ro.anchor_list.use_mp_region_counts = (
                1 if mm2 == 4 and not cfg.half_paired
                else 2 if mm2 == 3 and cfg.half_paired
                else 3 if mm2 == 3 and not cfg.half_paired else 0)
        ro.hit_list.gapless = cfg.gapless
        ro.hit_list.match_mode = (2 if mm2 == 4 else 3 if mm2 == 3 else 1)
        ro.hit_list.threshold = cfg.window_gen_threshold
        ro.pass1.only_paired = True
        ro.pass1.gapless = cfg.gapless
        ro.pass1.min_matches = 2 if mm2 == 4 else 1
        ro.pass1.threshold = cfg.vect_threshold()
        ro.pass1.window_overlap = cfg.window_overlap
        ro.pass2.strata = cfg.strata
        ro.pass2.threshold = cfg.sw_full_threshold * 0.5
        telemetry.print_read_mapping_options(log, ro, True)
        telemetry.print_read_mapping_options(log, ro, True)

    def _option_printers():
        if pair_mode != 0:
            def p_paired(out):
                out("Paired mapping options, set [0]")
                _print_paired_set_default(out)
            return [p_paired]
        printers = []
        for i, os_ in enumerate(unpaired_option_sets
                                or cfg.unpaired_options()):
            def p_unp(out, i=i, os_=os_):
                out(f"Unpaired mapping options, set [{i}]")
                telemetry.print_read_mapping_options(out, os_, False)
            printers.append(p_unp)
        return printers

    # ----- index: loaded (-L, --load-mmap) or built from the genome -----
    t0 = time.time()
    if load_mmap_prefix is not None or load_prefix is not None:
        if load_mmap_prefix is not None:
            idx = gindex.GenomeIndex.load_mmap(load_mmap_prefix)
        elif os.path.exists(load_prefix + ".idx.npz"):
            idx = gindex.GenomeIndex.load(load_prefix)
        elif refindex.is_reference_index(load_prefix):
            # reference-format projection (.genome/.seed.N from the
            # reference's gmapper -S / project-db.py)
            idx = refindex.load(load_prefix)
        else:
            log(f"error: no index found under prefix [{load_prefix}]")
            return 1
        if idx.colour_space != colour:
            log("error: index space does not match mapper mode")
            return 1
        if load_mmap_prefix is not None:
            log(f"Attached shared index [{load_mmap_prefix}] "
                f"({time.time() - t0:.1f}s)")
        seed_set = idx.seed_set
        reads_files = positional
    else:
        if save_prefix is not None or save_mmap_prefix is not None:
            # saving only: every positional is a genome file, no reads
            genome_files = positional
            reads_files = []
        else:
            if len(positional) < (1 if (up_file or down_file) else 2):
                # exact error + short usage (gmapper.c:2423-2436)
                if up_file or down_file:
                    log("error: genome_file(s) not specified")
                else:
                    log(f"error: {'reads_file, ' if not positional else ''}"
                        "genome_file(s) not specified")
                usage(prog, mode, seed_strings=_usage_seeds(),
                      state=_usage_state())
                return 1
            if up_file or down_file:
                genome_files = positional
                reads_files = []
            else:
                reads_files = positional[:1]
                genome_files = positional[1:]
        seed_set = seedmod.make_seed_set(seed_specs, weight=seed_weight,
                                         use_hashing=use_hashing)

        # settings echo (print_settings, gmapper.c:1348-1443; printed only
        # when not loading a projection, :2719-2721)
        telemetry.print_settings(
            log, seed_set=seed_set, num_threads=threads, chunk_size=chunk,
            window_len=cfg.window_len,
            hash_filter_calls=not no_hash_filter_calls,
            anchor_width=cfg.anchor_width,
            indel_taboo_len=cfg.indel_taboo_len,
            list_cutoff=cfg.list_cutoff, def_list_cutoff=0xFFFFFFFF,
            gapless=cfg.gapless, global_alignment=cfg.global_alignment,
            use_regions=cfg.use_regions,
            region_bits=cb.REGION_BITS, region_overlap=cb.REGION_OVERLAP,
            qflag=bool(fastq), ignore_qvs=cfg.ignore_qvs,
            min_avg_qv=min_avg_qv,
            compute_mapping_qualities=cfg.compute_mapping_qualities,
            all_contigs=cfg.all_contigs,
            single_best_mapping=cfg.single_best_mapping,
            colour_space=colour, params=cfg.params,
            probs=ScoreProbs.from_scores(cfg.params, colour),
            option_set_printers=_option_printers())
        contigs = []
        for gf in genome_files:
            log(f"- Processing genome file [{gf}]")
            for c in fastx.iter_contigs(gf):
                log(f"- Processing contig {c.name}")
                contigs.append(c)
        # automatic list trimming for mapping jobs
        # (cutoff := max(1000, 100*L/4^max_weight), gmapper.c:2809-2835)
        # (none when saving: the projection keeps every list)
        if not auto_trim_off and save_prefix is None and \
                save_mmap_prefix is None and cfg.list_cutoff == 0xFFFFFFFF:
            total_len = sum(len(c.codes) for c in contigs)
            max_w = (12 if use_hashing
                     else max(s.weight for s in seed_set.seeds))
            cfg.list_cutoff = max(1000, (100 * total_len) // (4 ** max_w))
        if genome_shards > 1:
            from shrimp_tpu_torch.parallel.mesh import split_index_shards
            shard_indexes = split_index_shards(
                contigs, genome_shards, seed_set, colour_space=colour)
            if len(shard_indexes) < genome_shards:
                log(f"note: only {len(shard_indexes)} contig groups; "
                    f"using {len(shard_indexes)} genome shards")
                genome_shards = len(shard_indexes)
            # each shard trimmed at the WHOLE genome's cutoff
            if cfg.list_cutoff != 0xFFFFFFFF:
                for si in shard_indexes:
                    si.trim(cfg.list_cutoff)
            idx = shard_indexes[0]      # header/QC fallback handle
        else:
            idx = gindex.build_index(contigs, seed_set, colour_space=colour)
            if cfg.list_cutoff != 0xFFFFFFFF:
                idx.trim(cfg.list_cutoff)
        log("Loaded Genome")     # exact text (genome.c:1180)
    load_genome_secs = time.time() - t0
    if genome_shards > 1:
        if load_prefix is not None or load_mmap_prefix is not None or \
                save_prefix is not None or save_mmap_prefix is not None:
            log("error: --genome-shards maps directly from genome FASTA")
            return 1
        if shrimp_format:
            log("error: --genome-shards emits SAM (the cluster workflow's "
                "merge format); legacy output is single-index only")
            return 1

    if y_proj_hist:
        # exact print_genomemap_stats format (genome.c:834-903); with
        # --genome-shards each shard prints its own table
        for si in (shard_indexes if genome_shards > 1 else [idx]):
            telemetry.print_genomemap_stats(log, si)

    if save_mmap_prefix is not None:
        idx.save_mmap(save_mmap_prefix)
        log(f"Saved shared-memory index under [{save_mmap_prefix}] "
            f"(use --load-mmap; put the prefix in /dev/shm for "
            f"cross-process residency)")
        return 0
    if save_prefix is not None:
        if index_format in ("npz", "both"):
            idx.save(save_prefix)
        if index_format in ("ref", "both"):
            # reference .genome/.seed.N projection files, loadable by the
            # reference binary (genome.c:179-273) and by -L here
            refindex.save(idx, save_prefix)
        log(f"Saved genome projection under [{save_prefix}]")
        return 0

    # ----- read input -----
    if up_file or down_file:
        if not (up_file and down_file):
            log("error: need both -1 and -2 for split pair files")
            return 1
    elif not reads_files:
        log("error: read_file not specified")
        usage(prog, mode, seed_strings=_usage_seeds(), state=_usage_state())
        return 1
    # reads-file open notes, in the reference's order (fasta.c:113-121,
    # gmapper.c:2871-2902); only the single/-1 file is opened with
    # autodetect (gmapper.c:2867-2878)
    det_fastq = fastq
    if not no_autodetect:
        rf_ = up_file if up_file else reads_files[0]
        det_fastq = fastx.detect_fastq(rf_)
        log(f"note: detected {'fastq' if det_fastq else 'fasta'} "
            f"format in input file [{rf_}]")
    if up_file:
        log(f"- Processing read files [{up_file} , {down_file}]")
    else:
        log(f"- Processing read file [{reads_files[0]}]")
    if det_fastq or fastq:
        log("note: quality value format "
            + (f"set to PHRED+{cfg.qual_delta}" if qv_offset_set
               else f"not set explicitly; using PHRED+{cfg.qual_delta}"))

    # ----- SAM header, or the legacy format line -----
    out = sys.stdout
    if shrimp_format:
        out.write(legacy_mod.format_line(rflag) + "\n")
    elif sam_header_file:
        with open(sam_header_file) as fh:
            out.write(fh.read())
    else:
        # per-section override files (--sam-header-{hd,sq,rg,pg},
        # gmapper.c:2977-3006)
        def section(name, default_lines):
            path = sam_header_sections.get(name)
            if path:
                with open(path) as fh:
                    out.write(fh.read())
            else:
                for ln_ in default_lines:
                    out.write(ln_ + "\n")
        section("hd", ["@HD\tVN:1.0\tSO:unsorted"])
        section("sq", [f"@SQ\tSN:{nm}\tLN:{int(ln)}"
                       for si in (shard_indexes if genome_shards > 1
                                  else [idx])
                       for nm, ln in zip(si.contig_names, si.contig_len)])
        section("rg", ([f"@RG\tID:{read_group[0]}\tSM:{read_group[-1]}"]
                       if read_group else []))
        section("pg", [f"@PG\tID:gmapper\tVN:{VERSION}\tCL:{' '.join(argv)}"])

    # --trim-first/--trim-second are paired-mode-only mate selectors
    # (gmapper.c:425-441,2352-2355)
    if pair_mode == 0 and (not trim_first or not trim_second):
        log("error: cannot use --trim-first or --trim-second in "
            "unpaired mode")
        return 1

    def build_cli_mesh():
        # the mapping device's cards ONLY, starting at it: under
        # parallel/multihost.py each rank maps its share of the reads
        # against its own genome-shard mesh
        from shrimp_tpu_torch.parallel.shard import (make_mesh,
                                                     visible_cuda_devices)
        devs = ([device] if device.type == "cpu"
                else visible_cuda_devices(device.index or 0))
        nd = min(n_devices or len(devs), len(devs))
        if nd >= genome_shards:
            nd = max(nd - nd % genome_shards, genome_shards)
            return make_mesh(nd, genome_shards, devices=devs[:nd])
        # fewer devices than shards: they repeat round-robin
        return make_mesh(genome_shards, genome_shards, devices=devs[:nd])

    if pair_mode != 0:
        pcfg = PairedConfig(pair_mode=pair_mode,
                            min_insert_size=isize_min,
                            max_insert_size=isize_max,
                            insert_size_mean=insert_size_mean,
                            insert_size_stddev=insert_size_stddev,
                            match_mode=cfg.match_mode_unpaired)
        if genome_shards > 1:
            from shrimp_tpu_torch.parallel.mesh import MeshPairedMapper
            mapper = MeshPairedMapper(shard_indexes, cfg, pcfg,
                                      mesh=build_cli_mesh())
            paired_popts = [mapper.mappers[0]._popts_from(rpo)
                            for rpo in paired_option_sets]
        else:
            mapper = PairedMapper(idx, cfg, pcfg, device=device)
            paired_popts = [mapper._popts_from(rpo)
                            for rpo in paired_option_sets]
    elif genome_shards > 1:
        from shrimp_tpu_torch.parallel.mesh import MeshMapper
        mapper = MeshMapper(shard_indexes, cfg, mesh=build_cli_mesh())
    else:
        mapper = Mapper(idx, cfg, device=device)

    def trim_rec(rec, mate=None):
        do_trim = (mate is None
                   or (mate == 0 and trim_first)
                   or (mate == 1 and trim_second))
        if do_trim and (trim_front or trim_end):
            keep = len(rec.seq) - trim_front - trim_end
            rec.seq = rec.seq[trim_front:trim_front + keep]
            if rec.qual:
                # the reference trims qual with the SEQ-length loop bound
                # (trim_read, gmapper.c:265-285)
                rec.qual = rec.qual[trim_front:trim_front + keep]
        if trim_illumina and not colour and rec.qual:
            # trim trailing Illumina 'B' qualities (gmapper.c:442-455)
            n = len(rec.qual)
            while n > 0 and rec.qual[n - 1] == "B":
                n -= 1
            if n < len(rec.qual):
                rec.seq = rec.seq[:n]
                rec.qual = rec.qual[:n]
        return rec

    n_dropped_intake = 0   # intake drops: over-length + low avg qv
    #                        (gmapper.c:495-531; counts READS, also in
    #                        paired mode where the stats call them pairs)

    def rec_ok(rec):
        nonlocal n_dropped_intake
        if rec.qual and not cfg.ignore_qvs and not no_qv_check:
            for c in rec.qual:
                qv = ord(c) - cfg.qual_delta
                if qv < -10 or qv > 50:
                    log(f"The qv-offset might be set incorrectly! qv {qv} "
                        f"observed under PHRED+{cfg.qual_delta}.")
                    sys.exit(1)
        low_qv = False
        if rec.qual and not cfg.ignore_qvs and min_avg_qv >= 0:
            # integer sum / integer read_len (= strlen(seq): one longer
            # than qual for CS primer-base reads) — gmapper.c:458-500
            total = sum(ord(c) - cfg.qual_delta for c in rec.qual)
            rl = max(len(rec.seq), 1)
            avg = total // rl if total >= 0 else -((-total) // rl)
            low_qv = avg < min_avg_qv
        rlen = len(rec.seq) - (1 if colour else 0)
        if rlen > cfg.longest_read_len or low_qv:
            # exact intake-drop warnings (gmapper.c:499-511): the
            # smaller-than-seed branch wins when both apply; the low-qv
            # drop is silent
            if rlen - seed_set.min_span + 1 <= 0:
                log(f"warning: skipping read [{rec.name}]; "
                    f"smaller then any seed!")
            elif rlen > cfg.longest_read_len:
                log(f"warning: skipping read [{rec.name}]; it has length "
                    f"{rlen}, maximum allowed is {cfg.longest_read_len}. "
                    f"Use --longest-read ?")
            n_dropped_intake += 1
            return False
        return True

    n_reads = 0
    n_intake_reads_skipped = 0   # paired mode: reads of pairs dropped at
    #                              intake (still counted in nreads)
    n_matched = 0
    n_matched_conf = 0           # reads with an emitted hit MQV >= 10
    n_pairs_matched = 0
    n_pairs_matched_conf = 0
    n_paired_matches = 0
    n_unp_reads_matched = 0      # paired mode: half-paired fallback reads
    n_unp_matches = 0
    un_recs: list = []
    al_recs: list = []
    t_map0 = time.time()
    # progress header + line format (gmapper.c:320-397)
    if progress > 0:
        log("done r/hr r/core-hr")
    _prog_last = [0, t_map0]

    def progress_print():
        now = time.time()
        dn = n_reads - _prog_last[0]
        dt_ = max(now - _prog_last[1], 1e-9)
        rph = int(dn / dt_ * 3600.0)
        sys.stderr.write(f"{n_reads} {rph} {int(rph / max(threads, 1))}.\r")
        _prog_last[0] = n_reads
        _prog_last[1] = now

    def reads_stream():
        if up_file:
            it1 = fastx.iter_reads(up_file, fastq=fastq)
            it2 = fastx.iter_reads(down_file, fastq=fastq)
            for r1 in it1:
                r2 = next(it2, None)
                if r2 is None:
                    break
                yield r1
                yield r2
        else:
            for rf in reads_files:
                yield from fastx.iter_reads(rf, fastq=fastq)

    stream = reads_stream()
    if pair_mode != 0:
        def pairs_gen():
            nonlocal n_intake_reads_skipped
            buf = None
            for rec in stream:
                if buf is None:
                    buf = trim_rec(rec, mate=0)
                    continue
                r1, r2 = buf, trim_rec(rec, mate=1)
                buf = None
                ok1 = rec_ok(r1)
                ok2 = rec_ok(r2)   # no short-circuit: both reads get the
                #                    intake check + warning (gmapper.c:495)
                if ok1 and ok2:
                    yield ((r1.name, r1.seq, r1.qual),
                           (r2.name, r2.seq, r2.qual))
                else:
                    n_intake_reads_skipped += 2
            if buf is not None:
                log("warning: odd number of reads in paired mode; "
                    "dropping the last one")

        if genome_shards > 1:
            # mesh mode: per-shard paired funnels + Part-2c recombination
            def pair_results():
                import itertools
                it = pairs_gen()
                while True:
                    chunk = list(itertools.islice(
                        it, max(batch_size // 2, 1)))
                    if not chunk:
                        break
                    for pr_, tp_, tu_ in mapper.map_pair_batch(
                            chunk, option_sets=paired_popts or None):
                        yield pr_, (lambda p, a=tp_, b=tu_:
                                    mapper.sam_records_pair(p, a, b))
        else:
            # the pipelined stream: two batches on worker threads, one's
            # host work overlapping the other's kernels
            def pair_results():
                for pr_ in mapper.map_pair_stream(
                        pairs_gen(), batch_size=max(batch_size // 2, 1),
                        option_sets=paired_popts or None):
                    yield pr_, mapper.sam_records_pair

        for pr, emit_pair in pair_results():
            n_reads += 2
            got = bool(pr.paired_hits or pr.unpaired_hits)
            n_matched += 2 if got else 0
            if got and al_file:
                al_recs.extend(pr.re)
            elif not got and un_file:
                un_recs.extend(pr.re)
            if pr.paired_hits:
                n_pairs_matched += 1
                n_paired_matches += len(pr.paired_hits)
                if any(fh1.mqv >= 10 or fh2.mqv >= 10
                       for fh1, fh2, _ in pr.paired_hits):
                    n_pairs_matched_conf += 1
            elif pr.unpaired_hits:
                if any(fh.mqv >= 10 for _, fh in pr.unpaired_hits):
                    n_matched_conf += 1
            if pr.unpaired_hits:
                n_unp_matches += len(pr.unpaired_hits)
                n_unp_reads_matched += len({nip for nip, _
                                            in pr.unpaired_hits})
            if insert_histogram is not None:
                for _fh1, _fh2, isz in pr.paired_hits:
                    insert_histogram[telemetry.insert_histogram_bucket(
                        isz, isize_min, insert_bucket_size)] += 1
            if shrimp_format:
                for line in mapper.legacy_records_pair(pr, rflag):
                    out.write(line + "\n")
            else:
                for rec in emit_pair(pr):
                    out.write(rec.line() + "\n")
            if progress and n_reads % progress < 2:
                progress_print()
    else:
        def emit_result(re_e, hits):
            nonlocal n_reads, n_matched, n_matched_conf
            n_reads += 1
            if hits:
                n_matched += 1
                if any(h.mqv >= 10 for h in hits):
                    n_matched_conf += 1
                if al_file:
                    al_recs.append(re_e)
            elif un_file:
                un_recs.append(re_e)
            if shrimp_format:
                for line in mapper.legacy_records(re_e, hits, rflag,
                                                  pretty=pflag):
                    out.write(line + "\n")
            else:
                for rec in mapper.sam_records(re_e, hits):
                    out.write(rec.line() + "\n")
            if progress and n_reads % progress == 0:
                progress_print()

        if genome_shards > 1:
            # mesh mode: batch through MeshMapper, emit merged shard hits
            while True:
                batch = []
                for rec in stream:
                    batch.append(trim_rec(rec))
                    if len(batch) >= batch_size:
                        break
                if not batch:
                    break
                triples = [(r.name, r.seq, r.qual)
                           for r in batch if rec_ok(r)]
                for re_e, shard_hits in mapper.map_batch(
                        triples, options=unpaired_option_sets or None):
                    n_reads += 1
                    if shard_hits:
                        n_matched += 1
                        if any(h.mqv >= 10 for _, h in shard_hits):
                            n_matched_conf += 1
                        if al_file:
                            al_recs.append(re_e)
                    elif un_file:
                        un_recs.append(re_e)
                    for rec2 in mapper.sam_records(re_e, shard_hits):
                        out.write(rec2.line() + "\n")
                    if progress and n_reads % progress == 0:
                        progress_print()
        elif len(unpaired_option_sets) > 1:
            # multi-round option sets go through map_batch's round loop
            while True:
                batch = []
                for rec in stream:
                    batch.append(trim_rec(rec))
                    if len(batch) >= batch_size:
                        break
                if not batch:
                    break
                triples = [(r.name, r.seq, r.qual)
                           for r in batch if rec_ok(r)]
                for re_e, hits in mapper.map_batch(
                        triples, options=unpaired_option_sets):
                    emit_result(re_e, hits)
        else:
            # single option set: the pipelined stream (host candidate work
            # overlaps the device work of neighbouring batches)
            def triples_gen():
                for rec in stream:
                    rec = trim_rec(rec)
                    if rec_ok(rec):
                        yield (rec.name, rec.seq, rec.qual)
            for re_e, hits in mapper.map_stream(
                    triples_gen(), batch_size=batch_size,
                    options=unpaired_option_sets or None,
                    n_workers=threads):
                emit_result(re_e, hits)

    dt = time.time() - t_map0
    if progress > 0:
        sys.stderr.write("\n")    # finish the \r progress line
    for path, recs in ((un_file, un_recs), (al_file, al_recs)):
        if path:
            (fastx.write_fastq if fastq else fastx.write_fasta)(path, recs)

    # closing statistics block (print_statistics, gmapper.c:695-1009)
    ms = mapper.stats
    genome_bytes = sum(int(p.nbytes) for p in idx.positions) + sum(
        int(o.nbytes) for o in idx.offsets) + int(idx.genome.nbytes)
    on_card = device.type == "cuda"
    telemetry.print_statistics(
        log, mapper.tel,
        colour_space=colour,
        load_genome_secs=load_genome_secs,
        mapping_secs=dt,
        nreads=n_reads + (n_dropped_intake if pair_mode == 0
                          else n_intake_reads_skipped),
        num_threads=threads,
        dflag=d_stats,
        engine_info={
            "pass1_engine": "cuda kernel" if on_card else "plain torch",
            "pass1_path": "device" if on_card else "host",
            "l3_choice": getattr(mapper, "_l3_choice", None),
            "l3_reason": getattr(mapper, "_l3_reason", None),
            "device_candidates": cfg.device_candidates,
            "device_l3_fallbacks": ms.get("device_l3_fallbacks", 0),
        },
        pair_mode_none=(pair_mode == 0),
        half_paired=cfg.half_paired,
        total_reads_matched=(n_matched if pair_mode == 0
                             else n_unp_reads_matched),
        total_reads_matched_conf=n_matched_conf,
        total_reads_dropped=(ms.get("reads_dropped_max_aln", 0)
                             + (n_dropped_intake if pair_mode == 0
                                else 0)),
        total_single_matches=(ms.get("total_matches", 0)
                              if pair_mode == 0 else n_unp_matches),
        total_dup_single_matches=ms.get("dup_matches_pruned", 0),
        total_pairs_matched=n_pairs_matched,
        total_pairs_matched_conf=n_pairs_matched_conf,
        total_pairs_dropped=(ms.get("pairs_dropped_max_aln", 0)
                             + (n_dropped_intake if pair_mode != 0
                                else 0)),
        total_paired_matches=n_paired_matches,
        total_dup_paired_matches=ms.get("dup_pairs_pruned", 0),
        genomemap_bytes=genome_bytes,
        xflag=x_isize_hist,
        insert_histogram=insert_histogram,
        min_insert_size=isize_min,
        insert_histogram_bucket_size=insert_bucket_size)
    return 0


if __name__ == "__main__":
    sys.exit(main())
