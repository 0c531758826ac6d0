"""The port's paired modules held to the JAX package's on the CPU, on the
same inputs: the input-strand framing of the pass-1 scorers, the pass-1
launch of both mates (`_score_windows_sides`: the rows sent and their
scores), the pass-2 launch of both mates (`_run_full_sw_sides`) on a
batch whose band reaches G (where the JAX package runs its unbanded
kernels K5 / K9 and the port its packed ones at full band) and with no
band at all, `--unpaired-options` rounds, the insert-size histogram, and
a synthetic corpus.  Each package maps with its own index, built from
the same contigs.  Every compared number is an integer or a SAM line and
must be equal; the MQVs are compared as SAM prints them, exactly."""

import contextlib
import copy
import io
import os
import re

import numpy as np
import pytest

from shrimp_tpu import gmapper as jgmapper
from shrimp_tpu import index as jindex
from shrimp_tpu import seeds as jseeds
from shrimp_tpu.io import fastx as jfastx
from shrimp_tpu.ops import sw_full as jsw_full
from shrimp_tpu.ops import sw_full_cs as jsw_full_cs
from shrimp_tpu.pipeline import candidates as jcand
from shrimp_tpu.pipeline import paired as jpaired
from shrimp_tpu.pipeline.mapper import Mapper as JaxMapper
from shrimp_tpu.pipeline.options import MapperConfig as JaxConfig
from shrimp_tpu.ops.params import SWParams as JaxParams
from shrimp_tpu_torch import dna
from shrimp_tpu_torch import gmapper
from shrimp_tpu_torch import index as gindex
from shrimp_tpu_torch import seeds as seedmod
from shrimp_tpu_torch.io import fastx
from shrimp_tpu_torch.ops import sw_full, sw_full_cs
from shrimp_tpu_torch.ops.params import SWParams
from shrimp_tpu_torch.pipeline import candidates as cand
from shrimp_tpu_torch.pipeline import candidates_batch as cb
from shrimp_tpu_torch.pipeline import paired
from shrimp_tpu_torch.pipeline.mapper import Mapper
from shrimp_tpu_torch.pipeline.options import MapperConfig
from shrimp_tpu_torch.utils import synth

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def _cfgs(cs: bool, **kw):
    if cs:
        return (MapperConfig(colour_space=True, params=SWParams.colour_space(),
                             qual_delta=33, **kw),
                JaxConfig(colour_space=True, params=JaxParams.colour_space(),
                          qual_delta=33, **kw))
    return MapperConfig(qual_delta=64, **kw), JaxConfig(qual_delta=64, **kw)


def _indexes(genome: str, cs: bool):
    path = os.path.join(GOLDEN, genome)
    return (gindex.build_index(list(fastx.iter_contigs(path)),
                               colour_space=cs),
            jindex.build_index(list(jfastx.iter_contigs(path)),
                               colour_space=cs))


def _pairs(reads: str):
    recs = list(fastx.iter_reads(os.path.join(GOLDEN, reads)))
    return [((recs[i].name, recs[i].seq, recs[i].qual),
             (recs[i + 1].name, recs[i + 1].seq, recs[i + 1].qual))
            for i in range(0, len(recs), 2)]


def _pair_lines(m, results):
    return [rec.line() for pr in results for rec in m.sam_records_pair(pr)]


# ---------------------------------------------------------------------------
# input-strand framing of the pass-1 scorers
def _strand_case(cs: bool, seed: int):
    """Both packages' mappers on the golden genome, the golden reads with
    a random half reversed as paired reverses a mate (read rows and
    letter decodings swapped), every candidate row of both strands, and
    each row's input strand: 1 for the reversed reads."""
    reads = [(r.name, r.seq, r.qual) for r in fastx.iter_reads(
        os.path.join(GOLDEN, "golden_reads_cs.fq" if cs
                     else "golden_reads.fq"))][:60]
    cfg, jcfg = _cfgs(cs)
    idx, jidx = _indexes("golden_genome.fa", cs)
    m = Mapper(idx, cfg, device="cpu")
    jm = JaxMapper(jidx, jcfg)
    flip = np.random.default_rng(seed).random(len(reads)) < 0.5
    out = []
    for mod, mp in ((cand, m), (jcand, jm)):
        entries = mod.prepare_reads(reads, mp.cfg, mp.min_seed_span)
        for e, f in zip(entries, flip):
            if f:
                e.read = [e.read[1], e.read[0]]
                e.read_ls4, e.read_ls4_rc = e.read_ls4_rc, e.read_ls4
        out.append(entries)
    entries, jentries = out
    opts = cfg.unpaired_options()[0]
    parts = [cb.hit_list_batch(
        entries, idx, cb.anchors_batch(entries, idx, st,
                                       collapse=opts.anchor_list.collapse,
                                       list_cutoff=idx.list_cutoff),
        opts.hit_list, cfg) for st in (0, 1)]
    hb = cb.HitBatch(**{f: np.concatenate([getattr(h, f) for h in parts])
                        for f in cb.HitBatch.__dataclass_fields__})
    istrand = flip[hb.rid].astype(np.int8)
    return m, jm, entries, jentries, hb, istrand


@pytest.mark.parametrize("cs", [False, True], ids=["ls", "cs"])
def test_vector_scores_at_input_strand_1_equal_jax(cs):
    """`Mapper._vector_scores` with rows at input strand 1 (a reversed
    mate's): the colour-space framing is reverse where st != istrand and
    the read row is read[istrand]; letter space scores read[st].  Equal
    to the JAX `_vector_scores` on the same rows."""
    m, jm, entries, jentries, hb, istrand = _strand_case(cs, seed=5)
    assert istrand.any() and (istrand == 0).any()
    G = -(-int(hb.w_len.max()) // 128) * 128
    R = -(-max(e.read_len for e in entries) // 8) * 8
    args = (hb.rid, hb.st, hb.cn, hb.g_off, hb.w_len, istrand)
    got = m._vector_scores(entries, *args, G, R).numpy()
    want = jm._vector_scores(jentries, *args, G, R, len(hb.rid))
    assert got.shape == (hb.n,)
    np.testing.assert_array_equal(got.astype(np.int64), want)


@pytest.mark.parametrize("cs", [False, True], ids=["ls", "cs"])
def test_gapless_scores_at_input_strand_1(cs):
    """`Mapper._gapless_scores` frames rows the same way: a reversed read
    at input strand 1 with hit strand st scores as the read as given at
    input strand 0 with hit strand 1 - st (the same read row, the same
    window, the same anchors)."""
    m, _, entries, _, hb, istrand = _strand_case(cs, seed=6)
    flip = np.zeros(len(entries), bool)
    flip[hb.rid[istrand == 1]] = True
    plain = [copy.copy(e) for e in entries]
    for e, f in zip(plain, flip):
        if f:
            e.read = [e.read[1], e.read[0]]
    R = -(-max(e.read_len for e in entries) // 8) * 8
    rest = (hb.cn, hb.g_off, hb.anchor_x, hb.anchor_y, hb.anchor_length,
            hb.anchor_width, hb.w_len)
    got = m._gapless_scores(entries, hb.rid, hb.st, *rest, R, istrand)
    st0 = np.where(istrand == 1, 1 - hb.st, hb.st).astype(np.int8)
    want = m._gapless_scores(plain, hb.rid, st0, *rest, R)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


# ---------------------------------------------------------------------------
# the pass-1 launch of both mates
def _record(mapper, name, into, result):
    """Wrap mapper.<name> on the instance: keep each call's arguments and
    its result (as numpy) in `into`."""
    orig = getattr(mapper, name)

    def wrapper(*args, **kw):
        out = orig(*args, **kw)
        into.append((args, result(out)))
        return out

    setattr(mapper, name, wrapper)


# (space, reads, pair mode); every mode reverses at least one mate
PASS1_CASES = {
    "ls-opp-out": (False, "pairs_opp-out.fq", jpaired.PAIR_OPP_OUT),
    "ls-col-bw": (False, "pairs_col-bw.fq", jpaired.PAIR_COL_BW),
    "cs-col-fw": (True, "pairs_cs_col-fw.fq", jpaired.PAIR_COL_FW),
}


@pytest.mark.parametrize("case", sorted(PASS1_CASES))
def test_score_windows_sides_equal_jax(case):
    """Paired pass 1 sends the JAX package's rows, in its order, at the
    same input strands, in as many launches (both mates and the
    prefetched half-paired rows in one; cached rows never again), and
    gets its scores; the SAM lines agree."""
    cs, reads, mode = PASS1_CASES[case]
    cfg, jcfg = _cfgs(cs)
    idx, jidx = _indexes("golden_genome.fa", cs)
    m = paired.PairedMapper(idx, cfg, paired.PairedConfig(pair_mode=mode),
                            device="cpu")
    jm = jpaired.PairedMapper(jidx, jcfg,
                              jpaired.PairedConfig(pair_mode=mode))
    calls, jcalls = [], []
    _record(m, "_vector_scores", calls, lambda t: t.numpy())
    _record(jm, "_vector_scores", jcalls, np.asarray)
    pairs = _pairs(reads)
    lines = _pair_lines(m, m.map_pair_batch(pairs))
    jlines = _pair_lines(jm, jm.map_pair_batch(pairs))
    assert lines == jlines
    assert len(calls) == len(jcalls) >= 1
    for (args, sc), (jargs, jsc) in zip(calls, jcalls):
        # rid, st, cn, g_off, w_len, istrand, G, R
        for a, b in zip(args[1:9], jargs[1:9]):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        np.testing.assert_array_equal(sc.astype(np.int64), jsc)
    ist = np.concatenate([np.asarray(a[6]) for a, _ in calls])
    assert (ist == 1).any()


# ---------------------------------------------------------------------------
# the pass-2 launch of both mates
def _long_pairs(cs: bool, n: int = 24, rlen: int = 80):
    """Opp-in pairs of `rlen`-base mates cut from the golden genome (seed
    11; colour space: T primer and colours), so that a window is
    w_len = 1.4 * rlen = 112 columns, G = 128, and a band as wide as the
    window packs to W = 128 = G."""
    g = next(iter(fastx.iter_contigs(os.path.join(
        GOLDEN, "golden_genome.fa")))).codes
    rng = np.random.default_rng(11)
    pairs = []
    for i in range(n):
        p = int(rng.integers(0, len(g) - 400))
        m1 = g[p:p + rlen].copy()
        m2 = dna.reverse_complement(g[p + 250:p + 250 + rlen])
        for m_ in (m1, m2):
            err = rng.random(rlen) < 0.04
            m_[err] = (m_[err] + 1) % 4
        if cs:
            def enc(s):
                last, out = 3, ["T"]
                for b in s:
                    out.append(str(int(b) ^ last))
                    last = int(b)
                return "".join(out)
            seqs = (enc(m1), enc(m2))
            qual = "I" * rlen
        else:
            seqs = (dna.decode(m1), dna.decode(m2))
            qual = "h" * rlen
        pairs.append(((f"lp{i}/1", seqs[0], qual), (f"lp{i}/2", seqs[1],
                                                     qual)))
    return pairs


def _widen(tasks, rng):
    """Copies of the recorded tasks with the anchors of a random half of
    the rows widened past the window, so their bands cover it."""
    out = copy.deepcopy(tasks)
    for t in out:
        hb = copy.copy(t["hb"])
        hb.anchor_width = hb.anchor_width.copy()
        rows = np.asarray(t["rows"], np.int64)
        wide = rows[rng.random(len(rows)) < 0.5]
        hb.anchor_width[wide] = 400
        t["hb"] = hb
    return out


_STAT_FIELDS = ("cn", "gen_st", "g_off", "w_len", "score_full", "sw_score",
                "read_start", "genome_start", "rmapped", "gmapped",
                "matches", "mismatches", "insertions", "deletions",
                "crossovers", "score_max", "score_vector", "dbalign",
                "qralign", "qual33")


@pytest.mark.parametrize("cs", [False, True], ids=["ls", "cs"])
def test_run_full_sw_sides_at_full_band_equal_jax(cs, monkeypatch):
    """Both mates' feet in one pass-2 launch, a random half of them with
    bands as wide as the window: the JAX package runs its unbanded kernel
    (K5, or K9 in colour space) over the batch, the port its packed
    kernel (K3+K4, or K7+K8) at W = G.  Every stat and op agrees."""
    cfg, jcfg = _cfgs(cs)
    idx, jidx = _indexes("golden_genome.fa", cs)
    m = paired.PairedMapper(idx, cfg, device="cpu")
    jm = jpaired.PairedMapper(jidx, jcfg)
    recorded = []
    orig = jm._run_full_sw_sides

    def keep_tasks(tasks):
        recorded.append(copy.deepcopy(tasks))
        return orig(tasks)

    jm._run_full_sw_sides = keep_tasks
    jm.map_pair_batch(_long_pairs(cs))
    tasks = next(t for t in recorded if sum(len(x["rows"]) for x in t))
    wide = _widen(tasks, np.random.default_rng(3))

    unbanded, widths = [], []
    jmod = jsw_full_cs if cs else jsw_full
    jname = ("sw_full_cs_and_traceback_jax" if cs
             else "sw_full_and_traceback_jax")
    jorig = getattr(jmod, jname)
    monkeypatch.setattr(jmod, jname,
                        lambda *a, **k: unbanded.append(1) or jorig(*a, **k))
    pmod = sw_full_cs if cs else sw_full
    pname = ("sw_full_cs_and_traceback_packed" if cs
             else "sw_full_and_traceback_packed")
    porig = getattr(pmod, pname)

    def packed(*a, **k):
        widths.append((k["W"], a[0].shape[1]))
        return porig(*a, **k)

    monkeypatch.setattr(pmod, pname, packed)
    want = orig(copy.deepcopy(wide))
    got = m._run_full_sw_sides(copy.deepcopy(wide))
    assert unbanded == [1]
    assert widths == [(128, 128)]
    n = 0
    for g_side, w_side in zip(got, want):
        assert g_side.keys() == w_side.keys()
        for row, wfh in w_side.items():
            gfh = g_side[row]
            assert (gfh is None) == (wfh is None)
            if wfh is None:
                continue
            n += 1
            for f in _STAT_FIELDS:
                assert getattr(gfh, f) == getattr(wfh, f), (row, f)
            np.testing.assert_array_equal(gfh.ops, wfh.ops)
    assert n > 0


@pytest.mark.parametrize("cs", [False, True], ids=["ls", "cs"])
def test_no_band_pairs_equal_jax(cs):
    """-a -1 (no band): every paired launch runs the JAX package's
    unbanded kernel and the port's packed one over the full band; the SAM
    lines agree."""
    cfg, jcfg = _cfgs(cs, anchor_width=-1)
    idx, jidx = _indexes("golden_genome.fa", cs)
    m = paired.PairedMapper(idx, cfg, device="cpu")
    jm = jpaired.PairedMapper(jidx, jcfg)
    pairs = _pairs("pairs_cs_opp-in.fq" if cs else "golden_pairs.fq")[:40]
    lines = _pair_lines(m, m.map_pair_batch(pairs))
    assert lines == _pair_lines(jm, jm.map_pair_batch(pairs))
    assert len(lines) >= 40


# ---------------------------------------------------------------------------
# the CLI: --unpaired-options rounds and the insert-size histogram
def _run(main, argv, **kw):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv, **kw)
    return rc, out.getvalue(), err.getvalue()


_DEFAULTS = ("0;true/true,true,true/true,false,2,55%/true,50%,90%,2,false,30"
             "/50%,false,false,10/0")
_STRICT = ("0;true/true,true,true/true,false,2,55%/true,80%,90%,2,false,"
           "30/80%,false,false,10/1,80%")


@pytest.mark.parametrize("mode,reads", [("ls", "mini_reads.fq"),
                                        ("cs", "mini_reads_cs.fq")])
def test_unpaired_options_rounds_equal_jax(mode, reads):
    """Two --unpaired-options rounds (a strict set whose stop condition
    sends most reads to the defaults): the port's CLI prints the JAX
    CLI's SAM lines and settings banner."""
    argv = ["gmapper", "--mode", mode, "-Q",
            "--unpaired-options", _STRICT, "--unpaired-options", _DEFAULTS,
            os.path.join(GOLDEN, reads),
            os.path.join(GOLDEN, "golden_genome.fa")]
    rc, out, err = _run(gmapper.main, argv, device="cpu")
    jrc, jout, jerr = _run(jgmapper.main, argv)
    assert rc == jrc == 0, err[-2000:]

    def body(text):
        return [ln for ln in text.splitlines() if not ln.startswith("@PG")]

    def sets(text):
        return text[text.index("Unpaired mapping options, set [0]"):
                    text.index("Loaded Genome")]

    assert body(out) == body(jout)
    assert len(body(out)) >= 40
    assert sets(err) == sets(jerr)
    assert "Unpaired mapping options, set [1]" in err


def test_insert_size_histogram_equal_jax():
    """-X: the statistics block ends with the JAX CLI's histogram of the
    paired hits' insert sizes."""
    argv = ["gmapper", "-Q", "-p", "opp-in", "-I", "0,500", "-X",
            os.path.join(GOLDEN, "golden_pairs.fq"),
            os.path.join(GOLDEN, "golden_genome.fa")]
    rc, out, err = _run(gmapper.main, argv, device="cpu")
    jrc, jout, jerr = _run(jgmapper.main, argv)
    assert rc == jrc == 0, err[-2000:]

    def hist(text):
        return [ln for ln in text.splitlines()
                if re.match(r"\[\d+-\d+\]: ", ln)]

    assert len(hist(err)) == 100
    assert hist(err) == hist(jerr)
    assert any(not ln.endswith(": 0.00%") for ln in hist(err))


# ---------------------------------------------------------------------------
def test_synthetic_pairs_equal_jax():
    """256 opp-in pairs of the grid bench's generator (make_pairs, seed
    17) on a 1 Mbp synthetic genome (seed 20260817): the two packages'
    PairedMappers print the same SAM lines."""
    chroms = synth.make_genome(np.random.default_rng(20260817), 1_000_000)
    contigs = [fastx.Contig(name=f"chr{i + 1}", codes=g)
               for i, g in enumerate(chroms)]
    jcontigs = [jfastx.Contig(name=f"chr{i + 1}", codes=g)
                for i, g in enumerate(chroms)]
    idx = gindex.build_index(contigs, seedmod.make_seed_set(None))
    jidx = jindex.build_index(jcontigs, jseeds.make_seed_set(None))
    pairs, truth = synth.make_pairs(idx, np.random.default_rng(17), 256)
    assert len(truth) == 256
    cfg, jcfg = _cfgs(False)
    pcfg = dict(pair_mode=paired.PAIR_OPP_IN, min_insert_size=50,
                max_insert_size=600)
    m = paired.PairedMapper(idx, cfg, paired.PairedConfig(**pcfg),
                            device="cpu")
    jm = jpaired.PairedMapper(jidx, jcfg, jpaired.PairedConfig(**pcfg))
    lines = _pair_lines(m, m.map_pair_stream(iter(pairs), batch_size=64))
    jlines = _pair_lines(jm, jm.map_pair_batch(pairs))
    assert lines == jlines
    assert len(lines) >= 512
