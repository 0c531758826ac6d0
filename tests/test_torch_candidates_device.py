"""On-device candidate generation (K10) of the port on the CPU: the plain
PyTorch version against the JAX function `device_candidates`, column by
column, and against the host path (`anchors_batch` + `hit_list_batch`);
the Mapper's device-L3 dispatch (auto-tune, deferred ship, HBM veto); and
the SAM of `device_candidates=True` against the goldens and the JAX
Mapper.  Every output is an integer: all comparisons are exact."""

import os

import numpy as np
import pytest

from shrimp_tpu import index as jindex
from shrimp_tpu import seeds as jseeds
from shrimp_tpu.io import fastx as jfastx
from shrimp_tpu.ops import candidates_device as jcdv
from shrimp_tpu.ops.params import SWParams as JaxParams
from shrimp_tpu.pipeline.mapper import Mapper as JaxMapper
from shrimp_tpu.pipeline.options import MapperConfig as JaxConfig
from shrimp_tpu_torch import dna
from shrimp_tpu_torch import index as gindex
from shrimp_tpu_torch import seeds as seedmod
from shrimp_tpu_torch.io import fastx
from shrimp_tpu_torch.ops import candidates_device as cdv
from shrimp_tpu_torch.ops.params import SWParams
from shrimp_tpu_torch.pipeline import candidates as cand
from shrimp_tpu_torch.pipeline import candidates_batch as cb
from shrimp_tpu_torch.pipeline.mapper import Mapper
from shrimp_tpu_torch.pipeline.options import HitListOptions, MapperConfig

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def make_setup(seed=3, n_contigs=3, contig_len=60_000, n_reads=96,
               read_len=50, use_hashing=False, mutate=2):
    """Both packages' indexes of one random genome, and the port's read
    entries of mutated reads drawn from both strands."""
    rng = np.random.default_rng(seed)
    codes = [rng.integers(0, 4, contig_len).astype(np.int8)
             for _ in range(n_contigs)]
    idx = gindex.build_index(
        [fastx.Contig(name=f"c{i}", codes=c) for i, c in enumerate(codes)],
        seedmod.make_seed_set(None, use_hashing=use_hashing))
    jidx = jindex.build_index(
        [jfastx.Contig(name=f"c{i}", codes=c) for i, c in enumerate(codes)],
        jseeds.make_seed_set(None, use_hashing=use_hashing))
    cfg = MapperConfig(qual_delta=64)
    reads = []
    genome = idx.genome
    for i in range(n_reads):
        p = int(rng.integers(0, len(genome) - read_len))
        r = genome[p:p + read_len].copy()
        for _ in range(int(rng.integers(0, mutate + 1))):
            q = int(rng.integers(0, read_len))
            r[q] = (r[q] + int(rng.integers(1, 4))) % 4
        if rng.random() < 0.5:
            r = dna.reverse_complement(r)
        reads.append((f"r{i}", dna.decode(r), None))
    entries = cand.prepare_reads(reads, cfg, idx.seed_set.min_span)
    return idx, jidx, cfg, entries


def _inputs(cfg, entries, st, opts):
    B = len(entries)
    R = max(e.read_len for e in entries)
    codes = np.zeros((B, R), np.int8)
    rlen, minpos, wlen, thr = (np.zeros(B, np.int32) for _ in range(4))
    for b, e in enumerate(entries):
        codes[b, :e.read_len] = e.read[st]
        rlen[b] = e.read_len
        minpos[b] = e.min_kmer_pos
        wlen[b] = e.window_len
        base = min(e.read_len, e.window_len) * cfg.params.match
        thr[b] = (int(base * (opts.threshold / 100.0))
                  if opts.threshold >= 0 else 0)
    return codes, rlen, minpos, wlen, thr


def _kw(idx, cfg, opts, use_regions=False, collapse=True,
        list_cutoff=0x7FFFFFFF, a_cap=1 << 18, dense_region_cap=None):
    p = cfg.params
    kw = dict(a_cap=a_cap, a2_cap=max(a_cap // 2, 256), h_cap=1 << 16,
              n_regions=(idx.total_len >> cb.REGION_BITS) + 1,
              use_region_counts=use_regions, collapse=collapse,
              gapless=opts.gapless, match_mode=opts.match_mode,
              threshold=float(opts.threshold), match=p.match,
              b_gap_open=p.b_gap_open, b_gap_extend=p.b_gap_extend,
              list_cutoff=min(list_cutoff, 0x7FFFFFFF),
              num_contigs=idx.num_contigs)
    if dense_region_cap is not None:
        kw["dense_region_cap"] = dense_region_cap
    return kw


def run_plain(idx, cfg, entries, st, opts, **kw):
    return cdv.device_candidates(*_inputs(cfg, entries, st, opts),
                                 cdv.DeviceL3Index.from_host(idx, "cpu"),
                                 **_kw(idx, cfg, opts, **kw))


def run_jax(idx, jidx, cfg, entries, st, opts, **kw):
    out = jcdv.device_candidates(*_inputs(cfg, entries, st, opts),
                                 jcdv.DeviceL3Index.from_host(jidx),
                                 **_kw(idx, cfg, opts, **kw))
    return {k: np.asarray(v) for k, v in out.items()}


def run_host(idx, cfg, entries, st, opts, use_regions=False, collapse=True,
             list_cutoff=0xFFFFFFFF, **_):
    ab = cb.anchors_batch(entries, idx, st, collapse=collapse,
                          list_cutoff=list_cutoff,
                          use_region_counts=use_regions)
    return cb.hit_list_batch(entries, idx, ab, opts, cfg)


# name -> (make_setup kwargs, strand, HitListOptions kwargs, run kwargs):
# every case of the JAX package's tests/test_candidates_device.py, and
# the collapse switched off
CASES = {
    "fw": ({}, 0, {}, {}),
    "rc": ({}, 1, {}, {}),
    "regions_fw": ({}, 0, {}, {"use_regions": True}),
    "regions_rc": ({}, 1, {}, {"use_regions": True}),
    "mm1": ({"seed": 9}, 0, {"match_mode": 1}, {}),
    "hashed_fw": ({"seed": 5, "use_hashing": True, "n_reads": 48}, 0, {},
                  {}),
    "hashed_rc": ({"seed": 5, "use_hashing": True, "n_reads": 48}, 1, {},
                  {}),
    "gapless": ({"seed": 11, "n_reads": 48}, 0,
                {"match_mode": 1, "gapless": True}, {}),
    "list_cutoff": ({"seed": 17, "n_reads": 48, "contig_len": 8000}, 0, {},
                    {"list_cutoff": 2}),
    "sparse_fw": ({"seed": 23}, 0, {},
                  {"use_regions": True, "dense_region_cap": 0}),
    "sparse_rc": ({"seed": 23}, 1, {},
                  {"use_regions": True, "dense_region_cap": 0}),
    "no_collapse": ({"seed": 29}, 0, {}, {"use_regions": True,
                                          "collapse": False}),
}


def _case(name):
    setup_kw, st, opt_kw, run_kw = CASES[name]
    idx, jidx, cfg, entries = make_setup(**setup_kw)
    opts = HitListOptions(**{"match_mode": 2, "threshold": 55.0, **opt_kw})
    return idx, jidx, cfg, entries, st, opts, run_kw


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_equals_jax(name):
    idx, jidx, cfg, entries, st, opts, run_kw = _case(name)
    got = run_plain(idx, cfg, entries, st, opts, **run_kw)
    want = run_jax(idx, jidx, cfg, entries, st, opts, **run_kw)
    assert not bool(got["overflow"])
    assert int(got["n"]) > 0
    assert set(got) == set(want)
    for k, v in want.items():
        assert np.array_equal(np.asarray(got[k]).astype(np.int64),
                              v.astype(np.int64)), k


def _assert_host_order_equal(hb, out):
    n = int(out["n"])
    assert hb.n == n, (hb.n, n)
    cols = {f: out[f][:n].numpy() for f in cdv.COLUMNS}
    order = np.lexsort((cols["g_off"], cols["cn"], cols["rid"]))
    for f in cdv.COLUMNS:
        got = cols[f][order].astype(np.int64)
        want = getattr(hb, f).astype(np.int64)
        assert np.array_equal(got, want), (f, np.flatnonzero(got != want)[:5])


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_equals_host(name):
    idx, _, cfg, entries, st, opts, run_kw = _case(name)
    host_kw = dict(run_kw)
    if "list_cutoff" not in host_kw:
        host_kw["list_cutoff"] = 0xFFFFFFFF
    hb = run_host(idx, cfg, entries, st, opts, **host_kw)
    _assert_host_order_equal(hb, run_plain(idx, cfg, entries, st, opts,
                                           **run_kw))


def test_overflow_flag_equals_jax():
    """A capacity below the batch's postings: overflow is reported, and
    the cut planes give the JAX function's columns."""
    idx, jidx, cfg, entries = make_setup(seed=13, n_reads=48)
    opts = HitListOptions(match_mode=2, threshold=55.0)
    got = run_plain(idx, cfg, entries, 0, opts, a_cap=256)
    want = run_jax(idx, jidx, cfg, entries, 0, opts, a_cap=256)
    assert bool(got["overflow"]) and bool(want["overflow"])
    assert int(got["n_total"]) > 256
    for k, v in want.items():
        assert np.array_equal(np.asarray(got[k]).astype(np.int64),
                              v.astype(np.int64)), k


def test_absolute_threshold_follows_host():
    """-r without % (stored negated): the host's int(-threshold), which
    the port keeps (the JAX function compares against the negation)."""
    idx, _, cfg, entries = make_setup(seed=37)
    opts = HitListOptions(match_mode=2, threshold=-300.0)
    for st in (0, 1):
        hb = run_host(idx, cfg, entries, st, opts, use_regions=True)
        out = run_plain(idx, cfg, entries, st, opts, use_regions=True)
        _assert_host_order_equal(hb, out)
    assert 0 < hb.n < len(entries)


# ---------------------------------------------------------------------------
# The Mapper's device-L3 dispatch: past the immediate ship budget the
# index ships lazily at the ski-rental crossover (or by the expected_reads
# projection), and the verdict is decided by timing.
def _mk_reads(idx, rng, n, read_len=50):
    genome = idx.genome
    out = []
    for i in range(n):
        p = int(rng.integers(0, len(genome) - read_len))
        out.append((f"q{i:03d}", dna.decode(genome[p:p + read_len].copy()),
                    None))
    return out


def _hit_keys(results):
    return [[(h.cn, h.gen_st, h.g_off, h.score_full) for h in hits]
            for _, hits in results]


def test_l3_lazy_ship_crossover_runs_device():
    """budget 0 + amortize factor 0: the crossover is reached at the
    first batch; the index ships, both paths are timed, and the output
    equals the host path's."""
    idx, _, _, _ = make_setup(seed=31, n_reads=0)
    reads = _mk_reads(idx, np.random.default_rng(7), 64)
    m_host = Mapper(idx, MapperConfig(qual_delta=64,
                                      device_candidates=False), device="cpu")
    base = _hit_keys(m_host.map_batch(reads))
    cfg = MapperConfig(qual_delta=64, device_candidates="auto",
                       device_l3_ship_budget_secs=0.0,
                       device_l3_amortize_factor=0.0)
    m = Mapper(idx, cfg, device="cpu")
    assert _hit_keys(m.map_batch(reads)) == base
    assert m._l3_choice in ("device", "host")
    assert m._l3_model is not None
    for k in ("t_dev_batch", "t_host_batch", "ship_secs_actual"):
        assert k in m._l3_model


def test_l3_deferred_ship_stays_host_until_crossover():
    """budget 0 + a huge amortize factor: undecided (not a permanent host
    verdict); the run keeps measuring and would ship later."""
    idx, _, _, _ = make_setup(seed=31, n_reads=0)
    reads = _mk_reads(idx, np.random.default_rng(7), 48)
    cfg = MapperConfig(qual_delta=64, device_candidates="auto",
                       device_l3_ship_budget_secs=0.0,
                       device_l3_amortize_factor=1e9)
    m = Mapper(idx, cfg, device="cpu")
    m.map_batch(reads)
    assert m._l3_choice is None
    assert m._l3_reason.startswith("deferred ship")
    assert m._l3_model["ship_est_secs"] >= 0


def test_l3_expected_reads_projection_blocks_short_runs():
    """A tiny expected_reads hint projects the host-L3 total below the
    amortized ship cost: the run never ships."""
    idx, _, _, _ = make_setup(seed=31, n_reads=0)
    reads = _mk_reads(idx, np.random.default_rng(7), 48)
    cfg = MapperConfig(qual_delta=64, device_candidates="auto",
                       device_l3_ship_budget_secs=0.0,
                       device_l3_amortize_factor=1e6, expected_reads=10)
    m = Mapper(idx, cfg, device="cpu")
    m.map_batch(reads[:24])
    m.map_batch(reads[24:])          # second batch: reads_seen > 0
    assert m._l3_choice is None or m._l3_choice == "host"
    assert m._l3_reason.startswith(("projected", "deferred"))
    assert "host_l3_secs_projected" in m._l3_model or \
        m._l3_reason.startswith("deferred")
    assert m._dev_l3 is None


def test_l3_hbm_budget_veto_is_permanent():
    """Postings larger than the device residency budget never ship."""
    idx, _, _, _ = make_setup(seed=31, n_reads=0)
    reads = _mk_reads(idx, np.random.default_rng(7), 32)
    cfg = MapperConfig(qual_delta=64, device_candidates="auto",
                       device_l3_ship_budget_secs=0.0,
                       device_l3_hbm_budget_bytes=1.0)
    m = Mapper(idx, cfg, device="cpu")
    m.map_batch(reads)
    assert m._l3_choice == "host"
    assert "HBM residency budget" in m._l3_reason
    assert m._dev_l3 is None


def test_capacity_grows_then_falls_back_to_the_host():
    """Overflow doubles the plane until its maximum; past it the batch
    maps on the host (counted), with the host path's output."""
    idx, _, _, _ = make_setup(seed=31, n_reads=0)
    reads = _mk_reads(idx, np.random.default_rng(7), 48)
    base = _hit_keys(Mapper(idx, MapperConfig(
        qual_delta=64, device_candidates=False),
        device="cpu").map_batch(reads))
    m = Mapper(idx, MapperConfig(qual_delta=64, device_candidates=True),
               device="cpu")
    m._dev_l3_a_cap = m._dev_l3_a2_cap = 64
    m.DEVICE_L3_A_CAP_MAX = 128
    assert _hit_keys(m.map_batch(reads)) == base
    assert m._dev_l3_a_cap == 128
    assert m.stats["device_l3_fallbacks"] >= 1


# ---------------------------------------------------------------------------
# SAM through device_candidates=True
SAM_CASES = {
    "golden_unpaired": ("golden_genome.fa", "golden_reads.fq",
                        "golden_unpaired.sam", False, "default"),
    "med_ls": ("med_genome.fa", "med_reads.fq", "med_ls.sam", False,
               "letter_space"),
    "golden_cs": ("golden_genome.fa", "golden_reads_cs.fq", "golden_cs.sam",
                  True, "colour_space"),
}


def _sam(name, jax):
    genome, reads, _, cs, scoring = SAM_CASES[name]
    ix, fx, config, params = ((jindex, jfastx, JaxConfig, JaxParams) if jax
                              else (gindex, fastx, MapperConfig, SWParams))
    idx = ix.build_index(list(fx.iter_contigs(os.path.join(GOLDEN, genome))),
                         colour_space=cs)
    cfg = config(params=(params() if scoring == "default"
                         else getattr(params, scoring)()),
                 colour_space=cs, qual_delta=33 if cs else 64,
                 device_candidates=True)
    m = JaxMapper(idx, cfg) if jax else Mapper(idx, cfg, device="cpu")
    recs = [(r.name, r.seq, r.qual)
            for r in fx.iter_reads(os.path.join(GOLDEN, reads))]
    lines = [rec.line() for e, hits in m.map_batch(recs)
             for rec in m.sam_records(e, hits)]
    return lines, m


def _golden_body(name):
    with open(os.path.join(GOLDEN, name)) as fh:
        return [ln.rstrip("\n") for ln in fh if not ln.startswith("@")]


@pytest.mark.parametrize("name", sorted(SAM_CASES))
def test_device_candidates_golden_sam(name):
    lines, m = _sam(name, jax=False)
    assert lines == _golden_body(SAM_CASES[name][2])
    assert m._dev_l3 is not None
    assert m.stats["device_l3_fallbacks"] == 0


@pytest.mark.parametrize("name", sorted(SAM_CASES))
def test_device_candidates_sam_equals_jax_mapper(name):
    assert _sam(name, jax=False)[0] == _sam(name, jax=True)[0]
