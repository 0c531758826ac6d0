"""The port's host tools (`shrimp_tpu_torch.tools`) and the gmapper CLI's
index branches (`-S`, `-L`, `--save-mmap`, `--load-mmap`,
`--index-format`), on the CPU: the goldens of the JAX package's tool
suites (`test_legacy_tools.py`, `test_probcalc_mp.py`,
`test_utils_tools.py`, `test_mergesam.py`), each tool's output equal to
the JAX tool's, the index round trips, and the cluster workflow (splitdb,
splitreads, one gmapper per shard pair, mergesam) through the port."""

import contextlib
import importlib
import io
import os
import sys

import pytest

from shrimp_tpu_torch import gmapper
from shrimp_tpu_torch.tools import mergesam

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
SHARDS = os.path.join(GOLDEN, "shards")
GENOME = os.path.join(GOLDEN, "golden_genome.fa")
READS = os.path.join(GOLDEN, "golden_reads.fq")
LEGACY = os.path.join(GOLDEN, "legacy_mini.out")


def run_tool(pkg, name, args, stdin=None):
    """`python -m <pkg>.tools.<name> args`, in this process: (rc, stdout,
    stderr)."""
    mod = importlib.import_module(f"{pkg}.tools.{name}")
    so, se = io.StringIO(), io.StringIO()
    prev = sys.stdin
    sys.stdin = io.StringIO(stdin or "")
    try:
        with contextlib.redirect_stdout(so), contextlib.redirect_stderr(se):
            try:
                rc = mod.main([name] + list(args))
            except SystemExit as e:
                rc = e.code if isinstance(e.code, int) else (
                    0 if e.code is None else 1)
    finally:
        sys.stdin = prev
    return rc, so.getvalue(), se.getvalue()


def run_cli(args):
    so, se = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(so), contextlib.redirect_stderr(se):
        rc = gmapper.main(["gmapper"] + list(args), device="cpu")
    return rc, so.getvalue(), se.getvalue()


def body(text):
    return [ln for ln in text.splitlines() if ln and not ln.startswith("@")]


def golden_body(name):
    with open(os.path.join(GOLDEN, name)) as fh:
        return [ln.rstrip("\n") for ln in fh if not ln.startswith("@")]


def golden_text(name):
    with open(os.path.join(GOLDEN, name)) as fh:
        return fh.read()


_CLIPPED_SAM = (
    "@HD\tVN:1.0\n"
    "r1\t0\tc\t1\t255\t5M\t*\t0\t0\tACGTA\tIIIII"
    "\tX0:i:1\tX1:i:2\tOQ:Z:JJJJJ\tOS:Z:ACGTA\n"
    "r2\t0\tc\t1\t255\t2H3M\t*\t0\t0\tGTA\tIII"
    "\tX0:i:1\tX1:i:2\tOQ:Z:JJJ\tOS:Z:GTACG\n")

# name -> (tool, args, files to write, stdin, what stdout must be: a
# golden file, "sam:" + a golden held minus @PG, or the text itself);
# "{d}" in an argument is the case's directory
TOOL_CASES = {
    "shrimp_var": ("shrimp_var", ["-r", LEGACY], {}, None,
                   "golden_shrimpvar.out"),
    "shrimp2sam": ("shrimp2sam", [LEGACY,
                                  os.path.join(GOLDEN, "mini_reads.fq"),
                                  GENOME], {}, None,
                   "sam:golden_shrimp2sam.sam"),
    "probcalc": ("probcalc", ["50000", LEGACY], {}, None,
                 "golden_probcalc.out"),
    "probcalc_sort_top": ("probcalc", ["-s", "normodds", "-t", "2",
                                       "50000", LEGACY], {}, None,
                          "golden_probcalc_normodds.out"),
    "probcalc_mp": ("probcalc_mp", [
        "-m", os.path.join(GOLDEN, "mp_pc_sorted.out"), "-f", "_F", "-b",
        "_R", "-g", "50000", "-M", "400", "-L", "0", "-G", "0.0", "-C",
        "1.0"], {}, None, "golden_probcalc_mp.out"),
    "utils_cs2ls": ("utils", ["cs2ls", "{d}/cs.txt"],
                    {"cs.txt": "T3210\n"}, None, "AGTT\n"),
    "utils_colourise": ("utils", ["colourise", "{d}/ls.txt"],
                        {"ls.txt": "AGTT\n"}, None, "T3210\n"),
    "utils_revcmpl": ("utils", ["revcmpl", "{d}/x.fa"],
                      {"x.fa": ">c\nACGTN\n"}, None, ">c\nNACGT\n"),
    "utils_fastq2fasta": ("utils", ["fastq2fasta",
                                    os.path.join(GOLDEN, "mini_reads.fq")],
                          {}, None, None),
    "utils_getcontigs": ("utils", ["getcontigs", GENOME], {}, None,
                         "chrA\t30000\nchrB\t20000\n"),
    "utils_subsequence": ("utils", ["subsequence", GENOME, "chrA", "1",
                                    "10"], {}, None, None),
    "utils_mergepairfiles": ("utils", ["mergepairfiles", "-Q", "{d}/a.fq",
                                       "{d}/b.fq"],
                             {"a.fq": "@r1:1\nAA\n+\nII\n",
                              "b.fq": "@r1:2\nCC\n+\nII\n"}, None,
                             "@r1:1\nAA\n+\nII\n@r1:2\nCC\n+\nII\n"),
    "utils_tophits": ("utils", ["tophits", "1", LEGACY], {}, None, None),
    "utils_findseq": ("utils", ["findseq", "{d}/c.fa", "aa"],
                      {"c.fa": ">c\nGGaaaaGG\n"}, None,
                      "Sequence Found at Positions:\n    3\n    4\n    5\n"),
    "utils_findseq_absent": ("utils", ["findseq", "{d}/c.fa", "TTT"],
                             {"c.fa": ">c\nGGaaaaGG\n"}, None,
                             "Sequence Not Found.\n"),
    "utils_findseq_multicontig": ("utils", ["findseq", "{d}/c.fa", "AC"],
                                  {"c.fa": ">a\nAC\n>b\nGT\n"}, None, ""),
    "utils_clippedmappings": ("utils", ["clippedmappings"], {},
                              _CLIPPED_SAM, "@r2\nGTACG\n+\nJJJ\n"),
    "fasta2fastq": ("fasta2fastq", ["{d}/r.csfasta", "{d}/r.qual"],
                    {"r.csfasta": ">r1\nT0123\n>r2\nG3210\n",
                     "r.qual": ">r1\n10 20 30 40\n>r2\n5 6 7 8\n"},
                    None, None),
}


@pytest.mark.parametrize("case", sorted(TOOL_CASES))
def test_host_tool(case, tmp_path):
    """Each host tool: the golden (or the text) the JAX suite holds it to,
    and rc, stdout and stderr equal to the JAX tool's on the same input."""
    tool, args, files, stdin, want = TOOL_CASES[case]
    for name, text in files.items():
        (tmp_path / name).write_text(text)
    args = [a.replace("{d}", str(tmp_path)) for a in args]
    got = run_tool("shrimp_tpu_torch", tool, args, stdin)
    assert got == run_tool("shrimp_tpu", tool, args, stdin)
    rc, out, err = got
    if case == "utils_findseq_multicontig":
        assert rc == 1 and "one contig per file" in err
        return
    assert rc == 0, err
    if want is None:
        assert out
    elif want.startswith("sam:"):
        assert [ln for ln in out.splitlines() if not ln.startswith("@PG")] \
            == [ln.rstrip("\n") for ln in open(os.path.join(
                GOLDEN, want[4:])) if not ln.startswith("@PG")]
    elif want.startswith(("golden_", "mp_")):
        assert out == golden_text(want)
    else:
        assert out == want


def run_merge(reads, sams, extra=None):
    opts = mergesam.Options()
    opts.sam_format = True
    for k, v in (extra or {}).items():
        setattr(opts, k, v)
    if opts.single_best:
        opts.max_outputs = 1
    buf = io.StringIO()
    mergesam.merge(reads, sams, opts, out=buf, command_line="test")
    return [ln for ln in buf.getvalue().splitlines()
            if not ln.startswith("@")]


# name -> (reads, shard SAM prefix, options, golden under shards/)
MERGE_CASES = {
    "unpaired": ("golden_reads.fq", "map", {}, "merged.sam"),
    "paired": ("golden_pairs.fq", "pmap", {}, "pmerged.sam"),
    "paired_sam-unaligned": ("golden_pairs.fq", "pmap",
                             {"sam_unaligned": True},
                             "pmerged_sam-unaligned.sam"),
    "paired_strata": ("golden_pairs.fq", "pmap", {"strata": True},
                      "pmerged_strata.sam"),
    "paired_singlebest": ("golden_pairs.fq", "pmap",
                          {"single_best": True, "all_contigs": True},
                          "pmerged_singlebest.sam"),
}


@pytest.mark.parametrize("case", sorted(MERGE_CASES))
def test_mergesam_golden(case):
    """mergesam over the reference's per-contig shard SAMs: every record
    byte-equal to the reference mergesam's."""
    reads, prefix, extra, gold = MERGE_CASES[case]
    lines = run_merge(os.path.join(GOLDEN, reads),
                      [os.path.join(SHARDS, f"{prefix}_chr{c}.sam")
                       for c in "AB"], extra)
    with open(os.path.join(SHARDS, gold)) as fh:
        assert lines == [ln.rstrip("\n") for ln in fh
                         if not ln.startswith("@")]


def _strip_z(lines):
    return ["\t".join(f for f in ln.split("\t")
                      if not f.startswith(("Z0", "Z1")))
            for ln in lines]


def test_shard_invariance_end_to_end(tmp_path):
    """The port's Mapper on each contig alone, merged by mergesam, gives
    the whole genome's SAM up to the Z fields (SPLITTING_AND_MERGING:
    100-148)."""
    from shrimp_tpu_torch import index as gindex
    from shrimp_tpu_torch.io import fastx, sam
    from shrimp_tpu_torch.pipeline.mapper import Mapper
    from shrimp_tpu_torch.pipeline.options import MapperConfig

    def sam_lines(genome_path):
        idx = gindex.build_index(list(fastx.iter_contigs(genome_path)))
        m = Mapper(idx, MapperConfig(qual_delta=64), device="cpu")
        reads = [(r.name, r.seq, r.qual) for r in fastx.iter_reads(READS)]
        hdr = sam.sam_header(idx.contig_names,
                             [int(x) for x in idx.contig_len])
        return hdr, [rec.line() for e, hits in m.map_batch(reads)
                     for rec in m.sam_records(e, hits)]

    text = open(GENOME).read()
    sam_paths = []
    for part in text.split(">")[1:]:
        name = part.split("\n", 1)[0].split()[0]
        shard = tmp_path / f"shard_{name}.fa"
        shard.write_text(">" + part)
        hdr, lines = sam_lines(str(shard))
        out = tmp_path / f"shard_{name}.sam"
        out.write_text("\n".join(hdr + lines) + "\n")
        sam_paths.append(str(out))
    merged = run_merge(READS, sam_paths)
    _, whole = sam_lines(GENOME)
    assert len(merged) == len(whole)
    assert _strip_z(merged) == _strip_z(whole)


def test_cluster_workflow(tmp_path):
    """splitdb shards the genome, splitreads the reads, one port gmapper
    per (read shard, genome shard), mergesam per read shard: the whole
    run's SAM up to the Z fields (SPLITTING_AND_MERGING:57-148)."""
    rc, out, err = run_tool("shrimp_tpu_torch", "splitdb", [
        "--ram-size", "0.6117", "--prefix", str(tmp_path / "db"), GENOME])
    assert rc == 0, err
    shards = sorted(str(tmp_path / f) for f in os.listdir(tmp_path)
                    if f.endswith(".fa"))
    assert len(shards) >= 2, (out, err)
    rc, _, err = run_tool("shrimp_tpu_torch", "splitreads",
                          ["100", READS, str(tmp_path / "rs")])
    assert rc == 0, err
    read_shards = sorted(str(tmp_path / f) for f in os.listdir(tmp_path)
                         if f.startswith("rs"))
    assert len(read_shards) >= 2
    merged = []
    for ri, rs in enumerate(read_shards):
        sams = []
        for gi, gs in enumerate(shards):
            rc, out, err = run_cli(["-Q", rs, gs])
            assert rc == 0, err[-2000:]
            p = tmp_path / f"m{ri}{gi}.sam"
            p.write_text(out)
            sams.append(str(p))
        rc, out, err = run_tool("shrimp_tpu_torch", "mergesam",
                                ["-E", "-Q", rs] + sams)
        assert rc == 0, err
        merged.extend(body(out))
    rc, out, err = run_cli(["-Q", READS, GENOME])
    assert rc == 0, err[-2000:]
    whole = body(out)
    assert len(merged) == len(whole)
    assert _strip_z(merged) == _strip_z(whole)


def test_splitdb_project_saves_loadable_indexes(tmp_path):
    """splitdb --project builds each shard's index with the port and
    saves it where gmapper -L finds it."""
    rc, out, err = run_tool("shrimp_tpu_torch", "splitdb", [
        "--ram-size", "0.6117", "--prefix", str(tmp_path / "db"),
        "--project", GENOME])
    assert rc == 0, err
    metas = sorted(f for f in os.listdir(tmp_path) if f.endswith(".meta.json"))
    assert len(metas) >= 2, (out, err, os.listdir(tmp_path))
    prefix = str(tmp_path / metas[0][:-len(".meta.json")])
    rc, out, err = run_cli(["-L", prefix, "-Q",
                            os.path.join(GOLDEN, "mini_reads.fq")])
    assert rc == 0, err[-2000:]
    assert body(out)


# ---------------------------------------------------------------------------
# the CLI's index branches
def test_cli_save_load_roundtrip(tmp_path):
    prefix = str(tmp_path / "idx")
    rc, out, err = run_cli(["-S", prefix, GENOME])
    assert (rc, out) == (0, ""), err
    assert "Saved genome projection under" in err
    assert sorted(os.listdir(tmp_path)) == ["idx.idx.npz", "idx.meta.json"]
    rc, out, err = run_cli(["-L", prefix, "-Q", READS])
    assert rc == 0, err
    assert body(out) == golden_body("golden_unpaired.sam")


def test_cli_mmap_roundtrip(tmp_path):
    prefix = str(tmp_path / "shm")
    rc, _, err = run_cli(["--save-mmap", prefix, GENOME])
    assert rc == 0, err
    mini = os.path.join(GOLDEN, "mini_reads.fq")
    rc, out, err = run_cli(["--load-mmap", prefix, "-Q", mini])
    assert rc == 0, err
    assert f"Attached shared index [{prefix}]" in err
    assert len(body(out)) == 40
    assert body(out) == body(run_cli(["-Q", mini, GENOME])[1])


@pytest.mark.parametrize("fmt", ["ref", "both"])
def test_cli_index_format(tmp_path, fmt):
    """--index-format ref writes the reference's .genome/.seed.N files,
    both writes them beside the npz; -L maps on either."""
    prefix = str(tmp_path / "idx")
    rc, _, err = run_cli(["-S", prefix, "--index-format", fmt, GENOME])
    assert rc == 0, err
    files = sorted(os.listdir(tmp_path))
    assert "idx.genome" in files and "idx.seed.0" in files
    assert ("idx.idx.npz" in files) == (fmt == "both")
    rc, out, err = run_cli(["-L", prefix, "-Q", READS])
    assert rc == 0, err
    assert body(out) == golden_body("golden_unpaired.sam")


def test_cli_maps_on_a_jax_saved_index(tmp_path):
    """An npz index that the JAX package's CLI saved maps in the port to
    the reference's SAM."""
    from cli_helper import run_gmapper
    prefix = str(tmp_path / "jidx")
    r = run_gmapper(["-S", prefix, GENOME])
    assert r.returncode == 0, r.stderr
    rc, out, err = run_cli(["-L", prefix, "-Q", READS])
    assert rc == 0, err
    assert body(out) == golden_body("golden_unpaired.sam")


def test_cli_index_errors(tmp_path):
    """A prefix with no index, and an index of the other space, exit 1
    with the JAX CLI's messages; so does an unknown index format."""
    rc, out, err = run_cli(["-L", str(tmp_path / "none"), "-Q", READS])
    assert (rc, out) == (1, "")
    assert f"no index found under prefix [{tmp_path / 'none'}]" in err
    prefix = str(tmp_path / "ls")
    assert run_cli(["--save-mmap", prefix, GENOME])[0] == 0
    rc, out, err = run_cli(["--mode", "cs", "--load-mmap", prefix, "-Q",
                            READS])
    assert (rc, out) == (1, "")
    assert "index space does not match mapper mode" in err
    rc, out, err = run_cli(["-S", prefix, "--index-format", "bam", GENOME])
    assert (rc, out) == (1, "")
    assert "invalid index format 'bam'" in err


def test_cli_load_without_reads_exits_1(tmp_path):
    prefix = str(tmp_path / "idx")
    assert run_cli(["--save-mmap", prefix, GENOME])[0] == 0
    rc, out, err = run_cli(["--load-mmap", prefix])
    assert (rc, out) == (1, "")
    assert "error: read_file not specified" in err


def test_cli_load_drops_a_low_quality_read(tmp_path):
    """On a loaded index the intake check has the index's seeds: a read
    of low average quality is dropped and the others map as from the
    FASTA (the JAX CLI raises NameError there)."""
    prefix = str(tmp_path / "idx")
    assert run_cli(["--save-mmap", prefix, GENOME])[0] == 0
    reads = tmp_path / "reads.fq"
    with open(READS) as fh:
        text = fh.read()
    reads.write_text("@lowqv\n" + "ACGT" * 10 + "\n+\n" + "@" * 40 + "\n"
                     + text)
    rc, out, err = run_cli(["--load-mmap", prefix, "-Q", str(reads)])
    assert rc == 0, err[-2000:]
    assert body(out) == golden_body("golden_unpaired.sam")
